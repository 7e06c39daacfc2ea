#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``colbert_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds both CUDA sources from ``colbert_torch/csrc/`` (stage-2
   decompress+MaxSim and flash attention; one nvcc each, started together,
   sm_90a) and prints the build time and ptxas's registers and spills per
   kernel instantiation; the paths' instantiations must not spill: the
   tensor-core flash kernel's bf16 hd=64 and the tensor-core stage-2
   kernel's nbits 2.
2. Holds the stage-2 kernels against their plain PyTorch version on the
   card at the serving path's stage-2 shapes (B=32, Lq=32, NC=1024,
   Ld=160, dim=128, nbits=2, K=32768) and at edge cases (nbits 1/4/8, byte
   words, zero doclens, odd Ld and Lq, Ld 16/17/32/48 around the
   tensor-core kernel's 16-row slices, every doclen Ld, a candidate ending
   on the last row), tolerance 1e-4 absolute, each case checked to have run
   the kernel its shapes select (``mma``, 3xTF32 on the tensor cores, for
   dim 128 and Lq <= 32; ``simt``, fp32 FMAs, otherwise).
3. Serves ``Searcher.search_batch`` end to end: a synthetic 141,431-passage
   index (avg doclen 110, dim 128, nbits 2, 32,768 partitions by the
   planner), a random-init ColBERT at bert-base width in bf16, batches of 32
   queries at k=10 plus one ``search_stream`` pass. Prints QPS, per-stage
   times and a profiler view of one batch, checks that every stage-2
   launch took the ``mma`` kernel, and re-scores one batch with the plain
   stage-2 on the card (pids equal up to ties, scores to 1e-4). On that
   batch's own stage-2 inputs it times the ``mma`` kernel, PR 1's ``simt``
   kernel (through the wrapper's private launcher) and the plain version
   in turns with CUDA events, beside both bounds (3 TF32 products per
   fp32 product at the TF32 tensor-core peak; fp32 FMAs at the fp32 peak);
   then both kernels at B = 1, 8 and 32 queries x 1024 candidates.
   On the same index and searcher:
   - ``[serve-batcher]``: 256 single queries from 16 threads through a
     ``BatchingSearcher`` (max_batch 32, max_wait 5 ms, two batches in
     flight); every future resolves, each result equals a direct
     ``search_batch`` of the batch it was served in (up to ties, 1e-4),
     fewer batches than queries, none above 32; prints queries/s;
   - ``[serve-http]``: ``make_server`` on a free port, 128 concurrent
     ``POST /search`` from a thread pool plus one ``/search_batch``,
     ``/health`` and ``/stats``; every reply 200 and equal to direct search
     as above; prints requests/s (information);
   - ``[tune]``: the exact oracle (``exhaustive_scores``) for 32 queries,
     timed, and held against the funnel's stage-2 score of every pid it
     returns (1e-4, TF32 off); ``tune_operating_point`` on the default grid
     at balance caps 1024 and 2048 with two timed repetitions, the table
     printed, the knobs restored after the sweep, ``apply`` then a search.
   Every stage-2 launch of these phases is checked to be ``mma``.
4. ``[flash]``: holds both flash-attention kernels against their plain
   version (the materialized fp32 softmax), each case checked to have run
   the kernel its dtype and head dim select (``mma``, tensor cores, for
   bf16/fp16 at hd 32/64/128; ``simt`` otherwise): the CPU tests' cases,
   bf16 at hd 32/64/128 and fp16 at hd 64 at S 128/256/512, and the build
   path's shape (B=128, H=12, S=512, hd=64, the pad bias of a real corpus
   batch) in fp32, bf16 and fp16: fp32 inputs to 1e-4, bf16/fp16 inputs
   within 8e-3 * max(1, |plain|) (one bf16 rounding step) against the plain
   version on their fp32 upcast. Times kernel and plain version in turns at
   the path's shape in bf16, beside the bound and
   ``scaled_dot_product_attention`` with the same additive mask (a
   yardstick the port never calls); then, at B*S = 65,536 rows for S 128,
   256 and 512, the kernel beside SDPA and BERT's materialized attention.
   In situ, bert-base hidden states of one 128-passage corpus batch at
   S=512 in fp32 (through the ``simt`` kernel) vs the materialized
   attention, to 5e-4 (the JAX package's own bound); the embeddings in bf16
   (through the ``mma`` kernel) to a minimum cosine of 0.999.
5. ``[build]``: ``Indexer.index`` builds a 20,000-passage long-document
   index (~450 words, padded to S=512) at bert-base width with bf16
   activations, the flash-routed configuration of ``bench.py``'s flash
   probe: sample encode, k-means, five chunks of fused encode+compress,
   IVF. Prints the phases, passages per second and the plan; checks the
   artifacts and that the flash kernel ran 12 times (once per layer) for
   every encoded batch, every launch through the ``mma`` kernel. Profiles one fused encode+compress batch and one
   Lloyd pass at the build's partition count.
6. ``[build-search]``: ``Searcher`` answers two 32-query batches over the
   built index (each query the first 40 words of a passage) through the
   ``mma`` stage-2 kernel (checked); prints the top-1 self-retrieval rate
   (random weights: information only).
   ``[update]``: the built index served through a ``BatchingSearcher``;
   ``IndexUpdater.add`` of 2,000 more passages (new pids 20,000-21,999,
   plan, doclens and IVF consistent, 12 flash launches per encoded batch,
   all ``mma``), ``remove`` of 1,000 pids (100 of them added) and a
   ``swap`` to the reloaded searcher (queries of removed passages never
   return one through the batcher), ``compact`` (no pending journal, 21,000
   documents, no tombstones; the survivors' results equal the pre-compact
   ones under the pid map, scores to 1e-4) and ``evaluate`` with
   self-retrieval qrels (information); prints the seconds of each step.
7. ``[train]``: ``ColBERTTrainer`` fine-tunes a bert-base model of its own
   (random weights from a seed, the corpus vocabulary, dim 128) with
   ``bench_quality.py``'s recipe: ``make_triples`` over 4,096 passages,
   32 triples per step (query_maxlen 32, doc_maxlen 192), in-batch
   negatives, AdamW at lr 3e-5 with 20 warmup steps and the cosine decay
   to 0 at 300, clipping at 1.0, bf16 activations, remat on. Before it:
   one step of the model's first 2 layers in fp32 (TF32 off) on the card
   and on the CPU (loss 1e-5 relative, gradients 1e-4 x their max,
   parameters 1e-2 x lr), and remat on against off at full depth (loss
   1e-6 relative, gradients 1e-3 x their max; peak memory of each). Then
   300 steps: median ms per step after 3 warm-up steps, steps/s,
   triples/s, tokens/s and model TFLOP/s, the loss at steps 1-3 and every
   50, no flash launch, the last 20 steps' mean loss below the first 20's,
   one step profiled. The checkpoint is saved and loaded back bit for bit
   (tensors and a 32-query encode); an index of the 4,096 passages is
   built with the trained encoder and searched with 64 prefix queries,
   whose embeddings must be the trained model's (all stage-2 launches
   ``mma``); success@1 and @10 are printed for information.
8. ``[examples]``: the entry points of ``colbert_torch.examples`` at their
   default device in a work directory: ``make_eval_fixture`` (8,192
   passages, 64 queries), a checkpoint of the seeded bert-base bench
   encoder (``write_bench_checkpoint``), ``indexing`` from it, ``searching``
   with and without ``--random-weights`` (the same weights; each equal to a
   direct ``Searcher.search`` up to ties and 1e-4), ``evaluate`` (metrics for
   information, QPS > 0), ``tune --apply-to config`` (the chosen knobs in
   config.json), ``update`` add 64 / remove 32 / compact (plan, doclens,
   tombstones and IVF consistent after each), ``python -m
   colbert_torch.examples.serve`` as a subprocess (healthy within 120 s, 16
   POST /search one at a time, each equal to a direct ``search_batch`` of
   that query alone; stopped after) and ``train`` on 512 triples (the
   checkpoint loads back, differs from its input, and a ``Searcher`` with
   it answers). Then the forward-step hook ``colbert_torch.graft_entry``
   at its defaults (bert-base doc encode, B=8 L=128, bf16): each kept
   token's embedding within cosine 0.999 of the same model's fp32 encode.
   Prints the seconds of each step; each step's launches are counted with
   the counts set to 0 just before it.
9. ``[quality]``: ``colbert_torch.evaluation.quality.main`` in process at
   16,384 passages and 100 training steps (bert-base, its JSON line
   printed): every recall in [0, 1], every QPS above 0, and for its 32
   queries the quality-first point (picked out by its arguments) has
   stage-2 scores, for the pids it returns, within 1e-4 of the exact
   oracle's. Every in-process stage-2 launch of
   both phases is checked to be ``mma``.
10. ``[multidevice]``: the mesh layer on the one card, shards on a
   repeated device list (the port's stand-in for virtual devices). On the
   [serve] index, ``Searcher(backend="sharded")`` over 4 shards: QPS of 3
   batches of 32 after a warm-up, traced stages, 4 ``mma`` stage-2 launches
   per batch, every score of a batch within 1e-4 of the exact MaxSim of its
   pid, set-overlap@10 with the single-device backend (information), a
   ``BatchingSearcher`` over it (64 queries, 8 threads, each result equal to
   a direct search of its batch), and the same search inside a one-process
   NCCL group (equal up to ties). Then ``Indexer`` with mesh_data_axis=2 on
   4,096 passages of the [build] corpus at the flash-probe configuration
   (every flash launch ``mma``, the sharded codec trainer and histogram
   quantiles ran, self-retrieval success@1 >= 0.95 in the single-device
   Searcher); one 32-passage S=512 batch encoded DP 2x1 and TP 1x2 (6 heads
   per shard through flash) against the one-device encode (bf16 cosine >=
   0.999, fp32 within 1e-4); ``kmeans_sharded`` on 4 shards against
   ``kmeans`` on 256 separated clusters (1e-4); ``dryrun_multichip(4)``
   (with its dp x tp training step against one device). Prints the seconds
   of each part beside the card.
11. ``[train-mesh]``: ``ColBERTTrainer`` through ``attach_mesh`` over DP
   2x1, TP 1x2 and dp x tp 2x2 meshes of the card repeated. One AdamW step
   of [train]'s model cut to 2 layers, fp32, 8 triples, per mesh against
   the one-device step (loss 1e-5 relative, every gradient entry within
   1e-4 x its max |g| + 1e-7, parameters within 1e-2 x lr), and the dp x
   tp step inside a one-process NCCL group against the step without one
   (1e-6). Then [train]'s bert-base recipe, bf16, 10 steps of 32 triples
   on one device and over each mesh from the same weights: the median ms
   per step after 3 warm-up steps (the shards run in turn on one card:
   the code path's time, not a mesh's gain), the first step's loss within
   2e-2 relative of one device's; after the dp x tp training no replica or
   shard is stale and a 32-row bf16 mesh encode is within cosine 0.999 of
   the trained model's; neither kernel launches.
12. Prints the card's name and power limit, a ``kernels`` JSON line (each
   kernel's launches on the main path and by path), and as the last line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Without a GPU, or outside
a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4
PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12  # H100 SXM, TF32 tensor cores, dense
PEAK_BF16_FLOPS = 989e12    # H100 SXM, bf16 tensor cores, dense
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
N_PASSAGES = 141_431
BATCH = 32
N_BATCHES = 3
BUILD_PASSAGES = 20_000
BUILD_MEAN_WORDS = 450
IN_SITU_TOL = 5e-4          # tests/test_flash_attention.py:72
IN_SITU_MIN_COS = 0.999     # bf16 embeddings with vs without the kernel
SWEEP_ROWS = 65_536         # B*S of each [flash] sweep shape
BATCHER_QUERIES = 256       # [serve-batcher]: single queries from 16 threads
BATCHER_THREADS = 16
HTTP_REQUESTS = 128         # [serve-http]: concurrent POST /search
TUNE_QUERIES = 32           # [tune]: the oracle's and the sweep's sample
UPDATE_ADD = 2_000          # [update]: passages added, then pids removed
UPDATE_REMOVE = 1_000
TRAIN_PASSAGES = 4_096      # [train]: bench_quality.py's recipe (:76-108)
TRAIN_BATCH = 32            # triples per step: 32 queries and 64 docs
TRAIN_STEPS = 300
TRAIN_WARMUP = 20
TRAIN_LR = 3e-5
TRAIN_QUERIES = 64          # prefix queries of the retrieval check
CHECK_LAYERS = 2            # depth of the card-vs-CPU step
CHECK_TRIPLES = 8
EXAMPLES_PASSAGES = 8_192   # [examples]: the eval fixture's collection and queries
EXAMPLES_QUERIES = 64
EXAMPLES_ADD = 64           # update add, then remove, then compact
EXAMPLES_REMOVE = 32
EXAMPLES_HTTP = 16          # POST /search to the served example, one at a time
EXAMPLES_TRIPLES = 512      # train: one epoch at the default batch of 32
SERVE_START_S = 120
MD_SHARDS = 4               # [multidevice]: data shards of the sharded searcher
MD_BATCHER_QUERIES = 64
MD_BUILD_PASSAGES = 4_096   # the mesh build's corpus (the [build] corpus' first passages)
MD_ENCODE_ROWS = 32         # rows of the DP/TP encode batch
MD_KMEANS_ROWS = 16_384
MD_KMEANS_K = 256
TRAIN_MESH_STEPS = 10       # [train-mesh]: bf16 steps per mesh, the first 3 warm-up
TRAIN_MESHES = {"dp": (2, 1), "tp": (1, 2), "dp x tp": (2, 2)}
QUALITY_PASSAGES = 16_384   # [quality]: the drill's corpus and training steps
QUALITY_STEPS = 100


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# stage-2 kernel vs plain
# ---------------------------------------------------------------------------


def stage2_inputs(rng, device, *, B, Lq, NC, Ld, dim, nbits, K, n_tokens,
                  word_bytes, zero_frac=0.0, full=False, last=False):
    """Random stage-2 inputs: flat codes/residual words over ``n_tokens``
    rows (+ Ld zeroed tail rows) and per-candidate (offs, dls); ``full``
    sets every doclen to Ld, ``last`` puts the last candidate on the last
    Ld rows (it ends on the arrays' last row)."""
    import torch

    nbytes = dim // 8 * nbits
    rows = n_tokens + Ld
    codes = np.zeros(rows, np.int32)
    codes[:n_tokens] = rng.integers(0, K, n_tokens)
    res = np.zeros((rows, nbytes), np.uint8)
    res[:n_tokens] = rng.integers(0, 256, (n_tokens, nbytes), dtype=np.uint8)
    words = res.reshape(-1).view(np.int32) if word_bytes == 4 else res.reshape(-1)
    cent = rng.standard_normal((K, dim)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    bw = np.linspace(-0.025, 0.025, 1 << nbits).astype(np.float32)
    dls = rng.integers(1, Ld + 1, (B, NC)).astype(np.int32)
    dls[rng.random((B, NC)) < zero_frac] = 0
    offs = rng.integers(0, n_tokens - Ld, (B, NC)).astype(np.int64)
    if full:
        dls[:] = Ld
    if last:
        offs[-1, -1], dls[-1, -1] = n_tokens, Ld
    Q = rng.standard_normal((B, Lq, dim)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return dict(Q=t(Q), offs=t(offs), dls=t(dls), codes=t(codes),
                residuals=t(words), centroids=t(cent), bucket_weights=t(bw)), \
        dict(nbits=nbits, max_doclen=Ld)


def stage2_bound_ms(args, kw) -> dict:
    """Least time for the work these inputs need, per kernel -> {variant:
    (ms, "operations" or "bytes")}: the larger of the operations over their
    peak and the bytes over the memory rate (each input read once: Q, offs,
    dls, the valid tokens' codes and residual bytes, the distinct centroid
    rows they touch, the weights; the output written once). ``mma`` does
    each fp32 product as 3 TF32 products on the tensor cores, beside the
    decode (4*dim per token) on the fp32 cores; ``simt`` does both in fp32."""
    import torch

    Q, dls, offs = args["Q"], args["dls"].to(torch.int64), args["offs"]
    B, Lq, dim = Q.shape
    ntok = int(dls.sum())
    nbytes = dim // 8 * kw["nbits"]
    dots = ntok * 2 * Lq * dim
    decode = ntok * 4 * dim  # decode, square-sum and scale
    ar = torch.arange(kw["max_doclen"], device=Q.device)
    valid = ar < dls[..., None]
    tok = (offs[..., None] + ar)[valid]
    distinct = int(torch.unique(args["codes"][tok]).numel())
    nbytes_moved = (Q.numel() * 4 + offs.numel() * 8 + dls.numel() * 4
                    + ntok * (4 + nbytes) + distinct * dim * 4
                    + args["bucket_weights"].numel() * 4 + offs.numel() * 4)
    t_ops = {"mma": max(3 * dots / PEAK_TF32_FLOPS, decode / PEAK_FP32_FLOPS) * 1e3,
             "simt": (dots + decode) / PEAK_FP32_FLOPS * 1e3}
    t_bytes = nbytes_moved / PEAK_BYTES * 1e3
    return {v: (max(t, t_bytes), "operations" if t >= t_bytes else "bytes")
            for v, t in t_ops.items()}


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(device) -> dict:
    """Phase 2: every case within TOL, through the kernel its shapes
    select -> the largest error."""
    import torch

    from colbert_torch.ops import fused_maxsim as fm

    rng = np.random.default_rng(0)
    main = dict(B=BATCH, Lq=32, NC=1024, Ld=160, dim=128, nbits=2, K=32768,
                n_tokens=2_000_000, word_bytes=4, zero_frac=0.0)
    edges = [
        dict(main, B=2, NC=300, nbits=1, n_tokens=100_000, zero_frac=0.1),
        dict(main, B=2, NC=300, nbits=4, n_tokens=100_000, zero_frac=0.1),
        dict(main, B=2, NC=300, nbits=8, n_tokens=100_000, zero_frac=0.1),
        dict(main, B=2, NC=300, dim=32, nbits=2, word_bytes=1, n_tokens=100_000,
             zero_frac=0.1),  # 8-byte rows stored as bytes
        dict(main, B=3, NC=257, Ld=37, Lq=13, n_tokens=50_000, zero_frac=0.2),
        dict(main, B=2, NC=100, Ld=160, Lq=45, nbits=4, n_tokens=50_000,
             zero_frac=0.5),
        # the tensor-core kernel's 16-row slices and 32 query columns
        dict(main, B=2, NC=300, Ld=16, nbits=1, n_tokens=50_000, zero_frac=0.1),
        dict(main, B=2, NC=300, Ld=17, word_bytes=1, n_tokens=50_000, zero_frac=0.1),
        dict(main, B=2, NC=300, Ld=32, nbits=4, n_tokens=50_000),
        dict(main, B=2, NC=300, Ld=48, Lq=31, n_tokens=50_000, zero_frac=0.1),
        dict(main, B=2, NC=300, n_tokens=100_000, full=True),
        dict(main, B=2, NC=300, Ld=17, nbits=8, word_bytes=1, n_tokens=50_000, last=True),
    ]
    worst = 0.0
    for i, case in enumerate([main] + edges):
        args, kw = stage2_inputs(rng, device, **case)
        variant = fm._variant(case["Lq"], case["dim"])
        before = dict(fm.stage2_maxsim.variant_launches)
        got = fm.stage2_maxsim(**args, **kw)
        want = fm.stage2_maxsim_plain(**args, **kw)
        torch.cuda.synchronize()
        before[variant] += 1
        label = "main" if i == 0 else f"edge{i}"
        check(fm.stage2_maxsim.variant_launches == before,
              f"stage2 {label}: not one {variant} launch")
        err = float((got - want).abs().max())
        zero_ok = bool((got[args["dls"] == 0] == 0).all())
        print(f"[stage2] {label} {variant} {case} max_abs_err={err:.3e} "
              f"zero_doclen_ok={zero_ok}")
        check(np.isfinite(err) and err <= TOL, f"stage2 {label}: max_abs_err {err} > {TOL}")
        check(zero_ok, f"stage2 {label}: zero-doclen candidate not 0")
        worst = max(worst, err)
    return worst


def time_stage2(args, kw) -> dict:
    """The path's ``mma`` kernel, PR 1's ``simt`` kernel (through the
    wrapper's private launcher) and the plain version in turns (plain,
    mma, simt, mma, simt, plain) on the same inputs, CUDA-event timed,
    beside both bounds."""
    from colbert_torch.ops import fused_maxsim as fm

    plain = lambda: fm.stage2_maxsim_plain(**args, **kw)  # noqa: E731
    mma = lambda: fm._launch("mma", **args, **kw)  # noqa: E731
    simt = lambda: fm._launch("simt", **args, **kw)  # noqa: E731
    want = plain()
    err = max(float((mma() - want).abs().max()), float((simt() - want).abs().max()))
    check(np.isfinite(err) and err <= TOL, f"stage2 on the main path's inputs: {err}")
    p1 = time_ms(plain, 3)
    m1, s1 = time_ms(mma, 20), time_ms(simt, 20)
    m2, s2 = time_ms(mma, 20), time_ms(simt, 20)
    p2 = time_ms(plain, 3)
    bounds = stage2_bound_ms(args, kw)
    print(f"[stage2] timing on the main path's inputs {tuple(args['offs'].shape)} "
          f"mma_ms={m1:.4f},{m2:.4f} simt_ms={s1:.4f},{s2:.4f} plain_ms={p1:.4f},{p2:.4f} "
          f"bound_ms={bounds['mma'][0]:.4f} ({bounds['mma'][1]}; 3xTF32 on the tensor cores) "
          f"fp32_bound_ms={bounds['simt'][0]:.4f} ({bounds['simt'][1]}) "
          f"tokens={int(args['dls'].sum())} max_abs_err={err:.3e}")
    return dict(kernel_ms=(m1 + m2) / 2, simt_ms=(s1 + s2) / 2, plain_ms=(p1 + p2) / 2,
                bound_ms=bounds["mma"][0], bound_by=bounds["mma"][1],
                fp32_bound_ms=bounds["simt"][0], stage2_err=err)


def stage2_sweep(device) -> None:
    """Both kernels at B = 1, 8 and 32 queries x 1024 candidates of the
    serving geometry (Lq 32, dim 128, nbits 2, 32-bit words, doclens in
    [1, 160]), beside the ``mma`` bound."""
    from colbert_torch.ops import fused_maxsim as fm

    rng = np.random.default_rng(6)
    for B in (1, 8, 32):
        args, kw = stage2_inputs(rng, device, B=B, Lq=32, NC=1024, Ld=160, dim=128, nbits=2,
                                 K=32768, n_tokens=2_000_000, word_bytes=4)
        mma = lambda: fm._launch("mma", **args, **kw)  # noqa: E731
        simt = lambda: fm._launch("simt", **args, **kw)  # noqa: E731
        m1, s1, m2 = time_ms(mma, 20), time_ms(simt, 20), time_ms(mma, 20)
        bounds = stage2_bound_ms(args, kw)
        print(f"[stage2] sweep B={B} NC=1024 tokens={int(args['dls'].sum())}: "
              f"mma_ms={m1:.4f},{m2:.4f} simt_ms={s1:.4f} bound_ms={bounds['mma'][0]:.4f} "
              f"({bounds['mma'][1]}) fp32_bound_ms={bounds['simt'][0]:.4f}")


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------


def synthetic_queries(rng, n: int, vocab_words: int) -> list[str]:
    lens = rng.integers(4, 20, n)
    return [" ".join(f"w{j}" for j in rng.integers(0, vocab_words, m)) for m in lens]


def agree_up_to_ties(p1, s1, p2, s2, tol: float) -> str | None:
    """None if two top-k results agree: scores within ``tol`` position by
    position, shared pids within ``tol``, and pids in only one list scored
    within ``tol`` of that row's k-th score (ties at the cut)."""
    if not np.allclose(s1, s2, atol=tol, rtol=0):
        return f"scores differ by {np.abs(s1 - s2).max()}"
    for r in range(p1.shape[0]):
        a = dict(zip(p1[r].tolist(), s1[r].tolist()))
        b = dict(zip(p2[r].tolist(), s2[r].tolist()))
        for pid in a.keys() & b.keys():
            if abs(a[pid] - b[pid]) > tol:
                return f"row {r} pid {pid}: {a[pid]} vs {b[pid]}"
        cut = min(s1[r].min(), s2[r].min())
        for pid in a.keys() ^ b.keys():
            s = a.get(pid, b.get(pid))
            if s - cut > tol:
                return f"row {r}: pid {pid} (score {s}) in one result only, not a tie at the cut"
    return None


def main_path(device, *, n_passages: int, bert_cfg, index_dir: str,
              batch: int = BATCH, n_batches: int = N_BATCHES) -> dict:
    """Phase 3: serve search_batch on a synthetic index; returns metrics."""
    import torch

    from colbert_torch.config import ColBERTConfig
    from colbert_torch.ops import fused_maxsim as fm
    from colbert_torch.retrieval import device_index as di
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.utils.testing import make_encoder, make_vocab, synthesize_index
    from colbert_torch.utils.tracing import Tracer

    shutil.rmtree(index_dir, ignore_errors=True)
    os.makedirs(index_dir)
    t0 = time.perf_counter()
    plan = synthesize_index(index_dir, n_passages, dim=128, nbits=2, avg_doclen=110)
    print(f"[index] {n_passages} passages, {plan['num_embeddings']} embeddings, "
          f"{plan['num_partitions']} partitions, written in {time.perf_counter() - t0:.1f}s")

    vocab = make_vocab(bert_cfg.vocab_size - len(make_vocab(0)))
    t0 = time.perf_counter()
    enc = make_encoder(dim=128, seed=0, config=ColBERTConfig(dim=128, nbits=2),
                       bert_config=bert_cfg, vocab=vocab, device=device)
    print(f"[model] {bert_cfg} params="
          f"{sum(p.numel() for p in enc.model.parameters())} "
          f"built in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    searcher = Searcher(index_dir, encoder=enc, device=device)
    dix = searcher.device_index
    res_bytes = dix.residuals.numel() * dix.residuals.element_size()
    print(f"[searcher] loaded in {time.perf_counter() - t0:.1f}s; cell_cap="
          f"{searcher.cell_cap} max_candidates={searcher.max_candidates} "
          f"search kwargs={searcher._search_kwargs(10)} residual bytes on device="
          f"{res_bytes}")

    rng = np.random.default_rng(1)
    n_words = bert_cfg.vocab_size - len(make_vocab(0))
    batches = [synthetic_queries(rng, batch, n_words) for _ in range(n_batches + 1)]
    searcher.search_batch(batches[0], k=10)  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()

    fm.stage2_maxsim.launches = 0
    fm.stage2_maxsim.variant_launches.update(mma=0, simt=0)
    t0 = time.perf_counter()
    results = [searcher.search_batch(b, k=10) for b in batches[1:]]
    dt = time.perf_counter() - t0
    qps = batch * n_batches / dt
    t0 = time.perf_counter()
    streamed = list(searcher.search_stream(batches[1:], k=10))
    dt_stream = time.perf_counter() - t0
    launches = fm.stage2_maxsim.launches
    by_variant = dict(fm.stage2_maxsim.variant_launches)
    print(f"[serve] search_batch: {n_batches} x B={batch} in {dt:.4f}s -> "
          f"QPS {qps:.2f}; search_stream: {dt_stream:.4f}s -> QPS "
          f"{batch * n_batches / dt_stream:.2f}; stage2 kernel launches {launches} "
          f"(by kernel {by_variant})")

    for (p, s), (p2, s2) in zip(results, streamed):
        check(p.shape == (batch, 10) and s.shape == (batch, 10), "result shape")
        check(bool(((p >= 0) & (p < n_passages)).all()), "pids out of range")
        check(bool(np.isfinite(s).all()), "non-finite scores")
        check(bool((np.diff(s, axis=1) <= 1e-6).all()), "scores not descending")
        why = agree_up_to_ties(p, s, p2, s2, TOL)
        check(why is None, f"search_stream differs from search_batch: {why}")

    tracer = Tracer()
    searcher.tracer = tracer
    for b in batches[1:]:
        searcher.search_batch(b, k=10)
    searcher.tracer = None
    stages = {k: v["seconds"] / v["count"] * 1e3 for k, v in tracer.as_dict().items()}
    print("[serve] per-stage ms per batch (traced, device synchronized per stage): "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}))

    if device.type == "cuda":
        print("[profile] " + json.dumps(profile_batch(searcher, batches[1])))

    # re-score one batch with the plain stage-2 on the card, keeping its
    # stage-2 inputs for the kernel timing
    pk, sk = results[0]
    recorded = {}

    def plain_recording(*args, **kw):
        names = ("Q", "offs", "dls", "codes", "residuals", "centroids", "bucket_weights")
        recorded.update(args=dict(zip(names, args)), kw=kw)
        return fm.stage2_maxsim_plain(*args, **kw)

    kernel_fn = di.stage2_maxsim
    di.stage2_maxsim = plain_recording
    try:
        pp, sp = searcher.search_batch(batches[1], k=10)
    finally:
        di.stage2_maxsim = kernel_fn
    why = agree_up_to_ties(pk, sk, pp, sp, TOL)
    err = float(np.abs(sk - sp).max())
    print(f"[serve] plain stage-2 re-score: max |score diff| {err:.3e}, "
          f"pids agree up to ties: {why is None}")
    check(why is None, f"kernel vs plain stage-2 on the main path: {why}")
    timing = time_stage2(recorded["args"], recorded["kw"]) if device.type == "cuda" else {}
    return dict(qps=qps, stream_qps=batch * n_batches / dt_stream,
                launches=launches, by_variant=by_variant, stages_ms=stages,
                rescore_err=err, encoder=enc, searcher=searcher, n_words=n_words, **timing)


def device_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device time by kernel
    (top 10, ms) and the device's busy share of the call's wall time (both
    under the profiler's own overhead), also summed by kind of kernel. Only
    device-side events (kernels, copies) are summed: a host-side operator's
    device time is that of the kernels it launched, which are listed
    themselves."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # a user annotation (``Optimizer.step#AdamW.step``) spans kernels
        # that are listed themselves
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    by_kind: dict = {}
    for ms, _, name in rows:
        by_kind[kernel_kind(name)] = by_kind.get(kernel_kind(name), 0.0) + ms
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms if busy_ms else "not measured",
                by_kind=by_kind,
                top=[dict(ms=ms, calls=n, op=name[:70]) for ms, n, name in rows[:12]])


def kernel_kind(name: str) -> str:
    """A coarse class of a device kernel, from its name."""
    low = name.lower()
    for kind, marks in (("optimizer", ("multi_tensor", "adam")),
                        ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
                        ("softmax", ("softmax",)), ("reduce", ("reduce",)),
                        ("memcpy", ("memcpy", "memset")), ("conversion", ("copy_kernel",)),
                        ("elementwise", ("elementwise", "vectorized", "unrolled"))):
        if any(m in low for m in marks):
            return kind
    return "other"


def profile_batch(searcher, queries) -> dict:
    """One untraced ``search_batch`` under the profiler."""
    return device_profile(lambda: searcher.search_batch(queries, k=10))


# ---------------------------------------------------------------------------
# flash attention: kernel vs plain, timing, in situ
# ---------------------------------------------------------------------------


def build_corpus_encoder(model, device, cfg):
    """The build path's encoder: the serving path's bert-base model over the
    corpus vocabulary (``bench_vocab_tokenizer``) and the build config."""
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.utils.testing import bench_vocab_tokenizer

    return ColBERTEncoder(model, bench_vocab_tokenizer(), cfg, device=device)


def build_config(**kw):
    """bench.py's flash-probe configuration (:111-114) with its build knobs
    (:77): doc_maxlen 512, 128-wide buckets, flash from S=512."""
    from colbert_torch.config import ColBERTConfig

    return ColBERTConfig(dim=128, doc_maxlen=512, query_maxlen=32, index_bsize=128,
                         length_bucket=128, use_pallas=True, flash_min_seqlen=512,
                         nbits=2, kmeans_niters=4, chunksize=4096, **kw)


def flash_inputs(rng, device, B, H, S, hd, dtype, mask=None):
    import torch

    q, k, v = (torch.from_numpy(rng.standard_normal((B * H, S, hd)).astype(np.float32))
               .to(device, dtype) for _ in range(3))
    if mask is None:
        mask = np.ones((B, S), bool)
        mask[1, S // 2:] = False
        if S > 128:
            mask[0, S - 128:] = False
    bias = np.where(mask, 0.0, np.finfo(np.float32).min).astype(np.float32)
    return q, k, v, torch.from_numpy(bias).to(device)


def flash_bound_ms(B, H, S, hd, itemsize) -> tuple[float, str]:
    """Least time at these shapes: 4*B*H*S^2*hd operations at the bf16
    tensor-core peak vs q, k, v, o (and the bias) read or written once."""
    t_ops = 4 * B * H * S * S * hd / PEAK_BF16_FLOPS * 1e3
    t_bytes = (4 * B * H * S * hd * itemsize + B * S * 4) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_vs_plain(device, path_mask) -> dict:
    """Every case within its tolerance -> errors and, at the path's shape in
    bf16, kernel / plain / SDPA times beside the bound."""
    import torch
    import torch.nn.functional as F

    from colbert_torch.ops import flash_attention as fa

    rng = np.random.default_rng(3)
    B, S = path_mask.shape
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    cases = [(2, 3, 128, 32, fp32, None), (2, 3, 256, 32, fp32, None),
             (4, 12, 512, 64, fp32, None), (4, 12, 512, 64, bf16, None),
             (2, 2, 256, 128, bf16, None)]
    cases += [(2, 4, Sc, hd, dtype, None) for Sc in (128, 256, 512)
              for dtype, hd in ((bf16, 32), (bf16, 64), (bf16, 128), (fp16, 64))]
    cases += [(2, 2, 128, 40, bf16, None),  # a head dim the mma kernel does not take
              (B, 12, S, 64, fp32, path_mask), (B, 12, S, 64, bf16, path_mask),
              (B, 12, S, 64, fp16, path_mask)]
    worst = 0.0
    for Bc, H, Sc, hd, dtype, mask in cases:
        q, k, v, bias = flash_inputs(rng, device, Bc, H, Sc, hd, dtype, mask)
        variant = "simt" if dtype == fp32 or hd not in (32, 64, 128) else "mma"
        before = dict(fa.flash_attention.variant_launches)
        got = fa.flash_attention(q, k, v, bias, num_heads=H).float()
        want = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, num_heads=H)
        torch.cuda.synchronize()
        before[variant] += 1
        check(fa.flash_attention.variant_launches == before,
              f"flash B={Bc} S={Sc} hd={hd} {dtype}: not one {variant} launch")
        err = (got - want).abs()
        max_err = float(err.max())
        if dtype == fp32:
            ok = max_err <= TOL
        else:
            ok = bool((err <= 8e-3 * want.abs().clamp(min=1.0)).all())
        print(f"[flash] B={Bc} H={H} S={Sc} hd={hd} {str(dtype)[6:]} {variant} "
              f"max_abs_err={max_err:.3e} within tolerance: {ok}")
        check(np.isfinite(max_err) and ok, f"flash B={Bc} S={Sc} hd={hd} {dtype}: {max_err}")
        worst = max(worst, max_err)
        del got, want

    q, k, v, bias = flash_inputs(rng, device, B, 12, S, 64, torch.bfloat16, path_mask)
    kern = lambda: fa.flash_attention(q, k, v, bias, num_heads=12)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(q, k, v, bias, num_heads=12)  # noqa: E731
    qs, ks, vs = (x.view(B, 12, S, 64) for x in (q, k, v))
    mask4 = bias.view(B, 1, 1, S).to(torch.bfloat16)
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask4)  # noqa: E731
    p1 = time_ms(plain, 3)
    k1 = time_ms(kern, 10)
    k2 = time_ms(kern, 10)
    p2 = time_ms(plain, 3)
    lib = time_ms(sdpa, 10)
    bound, by = flash_bound_ms(B, 12, S, 64, 2)
    print(f"[flash] timing at the path's shape B={B} H=12 S={S} hd=64 bf16: "
          f"kernel_ms={k1:.4f},{k2:.4f} plain_ms={p1:.4f},{p2:.4f} sdpa_ms={lib:.4f} "
          f"bound_ms={bound:.4f} ({by})")
    del q, k, v, bias, qs, ks, vs, mask4
    return dict(max_abs_err=worst, kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                library_ms=lib, bound_ms=bound, bound_by=by)


def flash_sweep(device, path_mask) -> None:
    """At B*S = SWEEP_ROWS for S 128, 256 and 512 (bert-base heads, bf16,
    the path's key lengths cut to S): the kernel beside SDPA with the same
    mask and BERT's materialized attention on its (B, S, H*hd) layout."""
    import torch
    import torch.nn.functional as F

    from colbert_torch.models.bert import _attention
    from colbert_torch.ops import flash_attention as fa

    rng = np.random.default_rng(4)
    lens = path_mask.sum(1)
    for S in (128, 256, 512):
        B = SWEEP_ROWS // S
        mask = np.arange(S)[None] < np.resize(np.minimum(lens, S), B)[:, None]
        q, k, v, bias = flash_inputs(rng, device, B, 12, S, 64, torch.bfloat16, mask)
        qs, ks, vs = (x.view(B, 12, S, 64) for x in (q, k, v))
        qb, kb, vb = (x.transpose(1, 2).reshape(B, S, 768) for x in (qs, ks, vs))
        mask4 = bias.view(B, 1, 1, S)
        kern = lambda: fa.flash_attention(q, k, v, bias, num_heads=12)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, attn_mask=mask4.to(torch.bfloat16))
        mat = lambda: _attention(qb, kb, vb, mask4, 12)  # noqa: E731
        k1, s1, m1 = time_ms(kern, 10), time_ms(sdpa, 10), time_ms(mat, 3)
        k2 = time_ms(kern, 10)
        bound, by = flash_bound_ms(B, 12, S, 64, 2)
        print(f"[flash] sweep S={S} B={B} H=12 hd=64 bf16: kernel_ms={k1:.4f},{k2:.4f} "
              f"sdpa_ms={s1:.4f} materialized_ms={m1:.4f} bound_ms={bound:.4f} ({by})")
        del q, k, v, bias, qs, ks, vs, qb, kb, vb


def flash_in_situ(enc, batch) -> dict:
    """bert-base on one real corpus batch: hidden states with the kernel vs
    the materialized attention (fp32, limit IN_SITU_TOL over real tokens),
    and the embeddings in bf16 (printed, no limit)."""
    import torch

    from colbert_torch.ops import flash_attention as fa

    idx, ids, mask, keep = batch
    ids_d, mask_d, keep_d = enc._put_batch(ids, mask, keep)
    model = enc.model
    layers = enc.bert_config.num_hidden_layers
    counts = fa.flash_attention.variant_launches
    with torch.no_grad():
        before = dict(counts)
        a = model.bert(ids_d, mask_d, torch.float32, use_flash=True)
        check(counts["simt"] - before["simt"] == layers and counts["mma"] == before["mma"],
              "flash in situ: the fp32 encode did not run the simt kernel once per layer")
        b = model.bert(ids_d, mask_d, torch.float32, use_flash=False)
        err = float((a - b).abs()[mask_d].max())
        del a, b
        before = dict(counts)
        ea = model.forward_normalized(ids_d, mask_d, keep_d, dtype_name="bfloat16",
                                      use_flash=True)
        check(counts["mma"] - before["mma"] == layers and counts["simt"] == before["simt"],
              "flash in situ: the bf16 encode did not run the mma kernel once per layer")
        eb = model.forward_normalized(ids_d, mask_d, keep_d, dtype_name="bfloat16")
        bf_err = float((ea - eb).abs()[keep_d].max())
        cos = float((ea * eb).sum(-1)[keep_d].min())
    print(f"[flash] in situ, bert-base hidden states B={ids.shape[0]} S={ids.shape[1]} "
          f"fp32 (simt): max_abs_err={err:.3e} (limit {IN_SITU_TOL}); bf16 embeddings (mma): "
          f"max_abs_err={bf_err:.3e} min_cosine={cos:.6f} (limit {IN_SITU_MIN_COS})")
    check(np.isfinite(err) and err <= IN_SITU_TOL, f"flash in situ: {err} > {IN_SITU_TOL}")
    check(np.isfinite(cos) and cos >= IN_SITU_MIN_COS,
          f"flash in situ: bf16 min cosine {cos} < {IN_SITU_MIN_COS}")
    return dict(in_situ_err=err, in_situ_bf16_err=bf_err, in_situ_min_cos=cos)


# ---------------------------------------------------------------------------
# the build path, and a search of what it built
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def counted_doc_batches(enc):
    """Count the encoder's doc batches while the block runs -> a dict of
    batches, flash-routed batches and padded token rows."""
    seen = {"batches": 0, "flash_batches": 0, "rows": 0}
    doc_batches = enc._doc_batches

    def counting(texts):
        for item in doc_batches(texts):
            seen["batches"] += 1
            seen["flash_batches"] += enc._flash_for(item[1].shape[1])
            seen["rows"] += item[1].size
            yield item

    enc._doc_batches = counting
    try:
        yield seen
    finally:
        del enc._doc_batches


def build_path(enc, passages, index_dir: str) -> dict:
    """``Indexer.index`` on ``passages``: phases, plan, artifact checks and
    the flash launches against the encoded batches."""
    import torch

    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.storage import format as fmt

    shutil.rmtree(index_dir, ignore_errors=True)
    dev = enc.device
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    fa.flash_attention.variant_launches.update(mma=0, simt=0)
    t0 = time.perf_counter()
    with counted_doc_batches(enc) as seen:
        Indexer(enc.config, encoder=enc, collection=passages, device=dev).index(index_dir)
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    by_variant = dict(fa.flash_attention.variant_launches)
    n = len(passages)
    plan = fmt.load_plan(index_dir)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    layers = enc.bert_config.num_hidden_layers
    print(f"[build] {n} passages in {wall:.2f}s -> {n / wall:.2f} passages/s; phases "
          + json.dumps(plan["timings"]))
    print("[build] plan " + json.dumps({k: v for k, v in plan.items()
                                         if k not in ("timings", "embedding_offsets")}))
    print(f"[build] encoded batches {seen['batches']} (flash-routed "
          f"{seen['flash_batches']}), padded token rows {seen['rows']}, flash kernel "
          f"launches {launches} (expected {layers} x {seen['flash_batches']}; by kernel "
          f"{by_variant}); peak device "
          f"memory {peak / 2**30:.2f} GiB")

    check(plan["num_documents"] == n and fmt.check_all_files_saved(index_dir) == [],
          "build: incomplete index")
    doclens = fmt.load_all_doclens(index_dir)
    codes = fmt.load_all_codes(index_dir)
    codec = fmt.load_codec(index_dir)
    K, dim = codec["centroids"].shape
    check(len(doclens) == n and int(doclens.sum()) == plan["num_embeddings"] == len(codes),
          "build: doclens, codes and plan disagree")
    check(bool((codes < K).all()) and K == plan["num_partitions"], "build: codes out of range")
    check(bool(np.isfinite(codec["centroids"]).all())
          and bool((np.diff(codec["bucket_cutoffs"]) >= 0).all()), "build: bad codec")
    check(fmt.load_all_residuals(index_dir).shape == (len(codes), dim // 8 * enc.config.nbits),
          "build: residual shape")
    if dev.type == "cuda":
        check(seen["flash_batches"] == seen["batches"] > 0, "build: a batch missed flash")
        check(launches >= layers * seen["flash_batches"] > 0,
              f"build: {launches} flash launches for {seen['flash_batches']} batches")
        check(by_variant == {"mma": launches, "simt": 0},
              f"build: flash launches by kernel {by_variant}, expected all mma")
    return dict(build_seconds=wall, passages_per_s=n / wall, timings=plan["timings"],
                flash_launches=launches, encoded_batches=seen["batches"],
                num_partitions=plan["num_partitions"], num_embeddings=plan["num_embeddings"])


def profile_build_steps(enc, batch, index_dir: str) -> None:
    """Profiles of the build's two device-heavy steps: one fused
    encode+compress batch (B=128, S=512) against the built codec, and one
    Lloyd pass of the codec trainer at the build's partition count over
    one million sample-like bf16 rows."""
    import torch

    from colbert_torch.models.encoder import _take_rows
    from colbert_torch.ops import kmeans
    from colbert_torch.storage import format as fmt

    codec = fmt.load_codec(index_dir)
    cent = torch.from_numpy(codec["centroids"]).to(enc.device)
    cut = torch.from_numpy(codec["bucket_cutoffs"]).to(enc.device)
    _, ids, mask, keep = batch
    take, _ = _take_rows(keep)
    args = enc._put_batch(ids, mask, keep, take)

    def encode_compress():
        with torch.no_grad():
            enc.model.encode_compress_compact_batch(
                *args[:3], cent, cut, args[3], dtype_name=enc.config.activation_dtype,
                nbits=enc.config.nbits, use_flash=enc._flash_for(ids.shape[1]))

    encode_compress()
    print("[profile] encode+compress batch " + json.dumps(device_profile(encode_compress)))
    g = torch.Generator(device=enc.device).manual_seed(0)
    rows = torch.randn((1 << 20, cent.shape[1]), generator=g, device=enc.device)
    rows = torch.nn.functional.normalize(rows, dim=-1).to(torch.bfloat16)
    step = lambda: kmeans.lloyd_step(rows, cent, k=cent.shape[0])  # noqa: E731
    step()
    print(f"[profile] Lloyd pass, {rows.shape[0]} rows, k={cent.shape[0]} "
          + json.dumps(device_profile(step)))


def build_search(enc, passages, index_dir: str, *, batch: int = BATCH) -> dict:
    """Two query batches over the built index: shapes, pid range, finite and
    descending scores, stage-2 launches; top-1 self-retrieval (printed)."""
    from colbert_torch.ops import fused_maxsim as fm
    from colbert_torch.retrieval.searcher import Searcher

    searcher = Searcher(index_dir, encoder=enc, device=enc.device)
    rng = np.random.default_rng(5)
    pids = rng.choice(len(passages), size=2 * batch, replace=False)
    queries = [" ".join(passages[p].split()[:40]) for p in pids]
    fm.stage2_maxsim.launches = 0
    fm.stage2_maxsim.variant_launches.update(mma=0, simt=0)
    results = [searcher.search_batch(queries[i:i + batch], k=10)
               for i in range(0, 2 * batch, batch)]
    launches = fm.stage2_maxsim.launches
    by_variant = dict(fm.stage2_maxsim.variant_launches)
    hits = 0
    for i, (p, s) in enumerate(results):
        check(p.shape == (batch, 10) and s.shape == (batch, 10), "build-search: shape")
        check(bool(((p >= 0) & (p < len(passages))).all()), "build-search: pids out of range")
        check(bool(np.isfinite(s).all()), "build-search: non-finite scores")
        check(bool((np.diff(s, axis=1) <= 1e-6).all()), "build-search: not descending")
        hits += int((p[:, 0] == pids[i * batch:(i + 1) * batch]).sum())
    print(f"[build-search] 2 x {batch} queries; stage-2 launches {launches} (by kernel "
          f"{by_variant}); top-1 self-retrieval {hits}/{2 * batch} (random weights: "
          f"information only)")
    if enc.device.type == "cuda":
        check(launches > 0 and by_variant == {"mma": launches, "simt": 0},
              f"build-search: stage-2 launches by kernel {by_variant}, expected all mma")
    return dict(search_launches=launches, self_top1=hits / (2 * batch))


# ---------------------------------------------------------------------------
# the life of a live index: serving fronts, the tuner, the updater
# ---------------------------------------------------------------------------


def stage2_counts() -> dict:
    from colbert_torch.ops import fused_maxsim as fm

    return dict(fm.stage2_maxsim.variant_launches, launches=fm.stage2_maxsim.launches)


def reset_counts() -> None:
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.ops import fused_maxsim as fm

    fm.stage2_maxsim.launches = 0
    fm.stage2_maxsim.variant_launches.update(mma=0, simt=0)
    fa.flash_attention.launches = 0
    fa.flash_attention.variant_launches.update(mma=0, simt=0)


def check_stage2_all_mma(device, counts: dict, phase: str) -> None:
    """On the card every stage-2 launch of a phase is the ``mma`` kernel."""
    if device.type == "cuda":
        check(counts["launches"] > 0 and counts["mma"] == counts["launches"]
              and counts["simt"] == 0, f"{phase}: stage-2 launches by kernel {counts}")


@contextlib.contextmanager
def recorded_batches(searcher):
    """Record the queries of every ``launch_search`` on ``searcher`` while
    the block runs (the batches a serving front formed), so each result can
    be held against a direct ``search_batch`` of the same batch."""
    batches = []
    launch = searcher.launch_search

    def recording(queries, k=10):
        batches.append(list(queries))
        return launch(queries, k)

    searcher.launch_search = recording
    try:
        yield batches
    finally:
        del searcher.launch_search


def check_against_direct(searcher, batches, results: dict, phase: str, k: int = 10) -> int:
    """Every served result equals, up to ties at TOL, a direct
    ``search_batch`` of the batch it was served in -> the batches checked."""
    for batch in batches:
        dp, ds = searcher.search_batch(batch, k=k)
        for i, q in enumerate(batch):
            p, s = results[q]
            why = agree_up_to_ties(np.asarray(p)[None], np.asarray(s, np.float32)[None],
                                   dp[i:i + 1], ds[i:i + 1], TOL)
            check(why is None, f"{phase}: query {q!r} differs from direct search: {why}")
    return len(batches)


def unique_queries(seed: int, n: int, n_words: int) -> list[str]:
    queries = synthetic_queries(np.random.default_rng(seed), n, n_words)
    check(len(set(queries)) == n, "synthetic queries repeat")
    return queries


def serve_batcher(searcher, n_words: int) -> dict:
    """[serve-batcher]: BATCHER_QUERIES single queries from BATCHER_THREADS
    threads through a BatchingSearcher (max_batch 32, max_wait 5 ms, two
    batches in flight); every future resolves, each result equals a direct
    search of the batch it was served in, and the batcher coalesced."""
    from colbert_torch.serving import BatchingSearcher

    queries = unique_queries(11, BATCHER_QUERIES, n_words)
    results, errors = {}, []
    reset_counts()
    with recorded_batches(searcher) as batches:
        batcher = BatchingSearcher(searcher, max_batch=BATCH, max_wait_ms=5, max_inflight=2)
        try:
            def client(i):
                futs = [(q, batcher.submit(q, k=10)) for q in queries[i::BATCHER_THREADS]]
                for q, f in futs:
                    try:
                        results[q] = f.result(timeout=600)
                    except Exception as e:  # counted and reported below
                        errors.append(f"{q!r}: {e!r}")

            t0 = time.perf_counter()
            with ThreadPoolExecutor(BATCHER_THREADS) as ex:
                list(ex.map(client, range(BATCHER_THREADS)))
            dt = time.perf_counter() - t0
            stats = dict(batcher.stats)
        finally:
            batcher.close()
    counts = stage2_counts()
    print(f"[serve-batcher] {len(queries)} queries from {BATCHER_THREADS} threads in {dt:.4f}s "
          f"-> {len(queries) / dt:.2f} queries/s in process; stats {stats}; batch sizes "
          f"{[len(b) for b in batches]}; stage-2 launches {counts}; failed futures "
          f"{len(errors)}")
    check(not errors, f"serve-batcher: failed futures {errors[:3]}")
    check(len(results) == len(queries), "serve-batcher: a query got no result")
    check(stats["queries"] == len(queries) and stats["batches"] < len(queries)
          and stats["max_batch_seen"] <= BATCH, f"serve-batcher: stats {stats}")
    check_stage2_all_mma(searcher.device, counts, "serve-batcher")
    n = check_against_direct(searcher, batches, results, "serve-batcher")
    # information: the same queries in fixed batches of 32
    same = 0
    for i in range(0, len(queries), BATCH):
        dp, ds = searcher.search_batch(queries[i:i + BATCH], k=10)
        same += sum(agree_up_to_ties(np.asarray(results[q][0])[None],
                                     np.asarray(results[q][1])[None],
                                     dp[j:j + 1], ds[j:j + 1], TOL) is None
                    for j, q in enumerate(queries[i:i + BATCH]))
    print(f"[serve-batcher] every result equals direct search_batch of its batch up to ties "
          f"at {TOL} ({n} batches); against fixed batches of {BATCH}: {same}/{len(queries)} "
          f"agree (information)")
    return dict(batcher_qps=len(queries) / dt, batcher_launches=counts["launches"],
                batcher_batches=stats["batches"])


def _http(port: int, path: str, obj=None):
    """-> (status, decoded JSON or the error text) for one request."""
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace")
    except Exception as e:  # a reset or refused connection: reported, fails the phase
        return None, repr(e)


def serve_http(searcher, n_words: int) -> dict:
    """[serve-http]: HTTP_REQUESTS concurrent POST /search from a thread pool
    through ``make_server`` (stdlib HTTP, the batcher behind it), then one
    /search_batch, /health and /stats; every reply 200 and equal to a direct
    search of the batch it was served in."""
    from colbert_torch.serving.http import make_server

    queries = unique_queries(12, HTTP_REQUESTS + 8, n_words)
    single, multi = queries[:HTTP_REQUESTS], queries[HTTP_REQUESTS:]
    reset_counts()
    with recorded_batches(searcher) as batches:
        server = make_server(searcher, port=0, max_batch=BATCH, max_wait_ms=5, max_inflight=2)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(HTTP_REQUESTS) as ex:
                replies = list(ex.map(lambda q: _http(port, "/search", {"query": q, "k": 10}),
                                      single))
            dt = time.perf_counter() - t0
            batch_reply = _http(port, "/search_batch", {"queries": multi, "k": 10})
            health = _http(port, "/health")
            stats = _http(port, "/stats")
        finally:
            server.shutdown()
            server.batcher.close()
            thread.join(timeout=60)
    counts = stage2_counts()
    codes = [r[0] for r in replies] + [batch_reply[0], health[0], stats[0]]
    failed = [(c, r) for c, r in replies + [batch_reply, health, stats] if c != 200]
    print(f"[serve-http] {len(single)} concurrent POST /search in {dt:.4f}s -> "
          f"{len(single) / dt:.2f} requests/s (information: stdlib HTTP bounds it); "
          f"/health {health[1]}; /stats {stats[1]}; batch sizes {[len(b) for b in batches]}; "
          f"stage-2 launches {counts}; non-200 replies {len(failed)}")
    check(not failed, f"serve-http: failed requests {failed[:3]}")
    check(codes.count(200) == len(codes), "serve-http: a reply was not 200")
    check(health[1]["n_passages"] == len(searcher.doclens), f"serve-http: /health {health[1]}")
    check(stats[1]["queries"] == len(queries), f"serve-http: /stats {stats[1]}")
    results = {q: (r[1]["pids"], r[1]["scores"]) for q, r in zip(single, replies)}
    results.update({q: (p, s) for q, p, s in zip(multi, batch_reply[1]["pids"],
                                                   batch_reply[1]["scores"])})
    check_stage2_all_mma(searcher.device, counts, "serve-http")
    n = check_against_direct(searcher, batches, results, "serve-http")
    print(f"[serve-http] every reply equals direct search_batch of its batch up to ties at "
          f"{TOL} ({n} batches)")
    return dict(http_rps=len(single) / dt, http_launches=counts["launches"])


def tune_phase(searcher, n_words: int) -> dict:
    """[tune]: the exact oracle over the whole index for TUNE_QUERIES
    queries, held against the funnel's stage-2 scores of the pids it
    returns (TOL), then ``tune_operating_point`` on the default grid at
    balance caps 1024 and 2048; the config is restored after the sweep and
    ``apply`` followed by one search runs."""
    import torch

    from colbert_torch.evaluation.autotune import tune_operating_point
    from colbert_torch.evaluation.oracle import exhaustive_scores

    queries = unique_queries(13, TUNE_QUERIES, n_words)
    cfg = searcher.config
    reset_counts()
    Q = searcher.encoder.encode_queries(queries)
    t0 = time.perf_counter()
    oscores = exhaustive_scores(searcher, Q)
    dt_oracle = time.perf_counter() - t0
    pids, scores = searcher.device_index.search_Q_batch(Q, **searcher._search_kwargs(10))
    valid = pids >= 0
    err = float(np.abs(scores[valid] - np.take_along_axis(oscores, np.maximum(pids, 0), 1)[valid])
                .max())
    print(f"[tune] exhaustive_scores {oscores.shape} in {dt_oracle:.4f}s "
          f"({oscores.shape[1] / dt_oracle:.0f} passages/s for {len(queries)} queries); the "
          f"funnel's {int(valid.sum())} returned pids: max |stage-2 - oracle| {err:.3e}")
    check(oscores.shape == (len(queries), len(searcher.doclens))
          and bool(np.isfinite(oscores).all()), "tune: oracle scores")
    check(np.isfinite(err) and err <= TOL, f"tune: stage-2 vs oracle {err} > {TOL}")

    def knobs():
        return (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe,
                cfg.refine_width_factor, cfg.ivf_balance_cap, searcher.max_candidates,
                searcher.cell_cap, tuple(searcher.device_index.ivf_lengths.shape))

    before = knobs()
    t0 = time.perf_counter()
    res = tune_operating_point(searcher, queries, k=10, time_reps=2, balance_caps=(1024, 2048))
    dt_tune = time.perf_counter() - t0
    print(f"[tune] tune_operating_point: {len(res.table)} points in {dt_tune:.2f}s (random "
          f"weights on a synthetic index: recall is information only)\n{res}")
    check(knobs() == before, f"tune: knobs not restored: {knobs()} vs {before}")
    check(all(t.ms_per_batch and np.isfinite(t.ms_per_batch) for t in res.table),
          "tune: a point was not timed")
    saved = before[:4]
    try:
        res.apply(searcher)
        p, s = searcher.search_batch(queries, k=10)
        check(p.shape == (len(queries), 10) and bool(np.isfinite(s).all()),
              "tune: search after apply")
    finally:
        (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe,
         cfg.refine_width_factor) = saved
        if searcher._balance_cap(cfg.ivf_balance_cap) != searcher._balance_cap(before[4]):
            searcher.set_balance_cap(before[4])
    counts = stage2_counts()
    print(f"[tune] chosen {res.chosen.point.label()}, cap {res.chosen.balance_cap}; applied "
          f"and searched; stage-2 launches {counts}")
    check_stage2_all_mma(searcher.device, counts, "tune")
    if searcher.device.type == "cuda":
        check(not torch.backends.cuda.matmul.allow_tf32, "tune: TF32 must stay off")
    return dict(oracle_s=dt_oracle, oracle_err=err, tune_s=dt_tune,
                tune_launches=counts["launches"])


# ---------------------------------------------------------------------------
# [multidevice]: the mesh layer on one card (shards on a repeated device)
# ---------------------------------------------------------------------------


def mesh_devices(device, n: int) -> list:
    """``n`` mesh cells on ``device``: the port's stand-in for virtual
    devices, a card (or the CPU) repeated explicitly."""
    import torch

    from colbert_torch.parallel.mesh import canonical

    return [canonical(torch.device(device))] * n


def multidevice_serve(searcher, n_words: int, index_dir: str) -> dict:
    """[multidevice] 1-2: ``Searcher(backend="sharded")`` over MD_SHARDS
    shards of the [serve] index on one card: QPS, traced stages, MD_SHARDS
    ``mma`` stage-2 launches per batch, every score within TOL of the exact
    MaxSim of its pid, set-overlap@10 with the single-device backend, the
    batcher over it (each result equal to a direct search of its batch),
    then the same search inside a one-process NCCL group (gloo on the CPU),
    equal up to ties."""
    import torch
    import torch.distributed as dist

    from colbert_torch.evaluation.oracle import exhaustive_scores
    from colbert_torch.parallel import launch
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.serving import BatchingSearcher
    from colbert_torch.utils.tracing import Tracer

    dev = searcher.device
    t0 = time.perf_counter()
    sh = Searcher(index_dir, encoder=searcher.encoder, backend="sharded",
                  device=mesh_devices(dev, MD_SHARDS))
    load_s = time.perf_counter() - t0
    six = sh.sharded_index
    print(f"[multidevice] sharded searcher over {sh.mesh.shape} on "
          f"{[str(d) for d in sh.mesh.devices[:, 0]]} loaded in {load_s:.2f}s; pid_base "
          f"{six.pid_base.tolist()}; cell_cap={sh.cell_cap} max_candidates="
          f"{sh.max_candidates} search kwargs={sh._search_kwargs(10)}")
    check(sh.mesh.shape == {"data": MD_SHARDS, "model": 1} and len(six.shards) == MD_SHARDS,
          "multidevice: sharded searcher mesh")
    batches = [unique_queries(21 + i, BATCH, n_words) for i in range(N_BATCHES + 1)]
    sh.search_batch(batches[0], k=10)  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = [sh.search_batch(b, k=10) for b in batches[1:]]
    dt = time.perf_counter() - t0
    counts = stage2_counts()
    qps = BATCH * N_BATCHES / dt
    tracer = Tracer()
    sh.tracer = tracer
    for b in batches[1:]:
        sh.search_batch(b, k=10)
    sh.tracer = None
    stages = {k: v["seconds"] / N_BATCHES * 1e3 for k, v in tracer.as_dict().items()}
    print(f"[multidevice] sharded search_batch: {N_BATCHES} x B={BATCH} in {dt:.4f}s -> QPS "
          f"{qps:.2f}; stage-2 launches {counts} ({MD_SHARDS} shards x {N_BATCHES} batches) "
          f"on {card_line()}")
    print("[multidevice] per-stage ms per batch, summed over the shards (traced, device "
          "synchronized per stage): " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    if dev.type == "cuda":
        check(counts == {"mma": MD_SHARDS * N_BATCHES, "simt": 0,
                         "launches": MD_SHARDS * N_BATCHES},
              f"multidevice: stage-2 launches {counts}, expected {MD_SHARDS} mma per batch")

    Q = sh.encoder.encode_queries_device(batches[1])
    oracle = exhaustive_scores(sh, Q)
    overlap = []
    for b, (p, s) in zip(batches[1:], results):
        check(p.shape == (BATCH, 10) and bool((p >= 0).all()) and bool(np.isfinite(s).all()),
              "multidevice: result shape or empty slots")
        check(bool((np.diff(s, axis=1) <= 1e-6).all()), "multidevice: scores not descending")
        sp, _ = searcher.search_batch(b, k=10)
        overlap += [len(set(p[r]) & set(sp[r])) / 10 for r in range(BATCH)]
    p, s = results[0]
    err = float(np.abs(s - np.take_along_axis(oracle, p, 1)).max())
    print(f"[multidevice] every score of batch 1 vs the exact MaxSim of its pid: max |diff| "
          f"{err:.3e} (limit {TOL}); set-overlap@10 with the single-device backend over "
          f"{len(overlap)} queries: mean {np.mean(overlap):.4f}, min {min(overlap):.1f}")
    check(err <= TOL, f"multidevice: sharded score vs exact MaxSim {err} > {TOL}")

    queries = unique_queries(23, MD_BATCHER_QUERIES, n_words)
    served, errors = {}, []
    with recorded_batches(sh) as formed:
        with BatchingSearcher(sh, max_batch=BATCH, max_wait_ms=5, max_inflight=2) as batcher:
            def client(i):
                for q, f in [(q, batcher.submit(q, k=10)) for q in queries[i::8]]:
                    try:
                        served[q] = f.result(timeout=600)
                    except Exception as e:  # counted and checked below
                        errors.append(f"{q!r}: {e!r}")

            t0 = time.perf_counter()
            with ThreadPoolExecutor(8) as ex:
                list(ex.map(client, range(8)))
            dt_b = time.perf_counter() - t0
    check(not errors and len(served) == len(queries), f"multidevice batcher: {errors[:3]}")
    n_formed = check_against_direct(sh, formed, served, "multidevice-batcher")
    print(f"[multidevice] batcher over the sharded searcher: {len(queries)} queries from 8 "
          f"threads in {dt_b:.4f}s -> {len(queries) / dt_b:.2f} queries/s; {n_formed} batches, "
          f"each result equal to a direct search of its batch; on {card_line()}")

    backend = "nccl" if dev.type == "cuda" else "gloo"
    launch.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend=backend)
    try:
        check(dist.get_backend() == backend and launch.process_count() == 1,
              "multidevice: process group")
        reset_counts()
        pn, sn = sh.search_batch(batches[1], k=10)
        nccl_counts = stage2_counts()
    finally:
        dist.destroy_process_group()
    why = agree_up_to_ties(p, s, pn, sn, TOL)
    print(f"[multidevice] the same search in a one-process {backend} group (collectives "
          f"through {backend}): equal up to ties {why is None}; stage-2 launches {nccl_counts}")
    check(why is None, f"multidevice: {backend} search differs: {why}")
    return dict(md_qps=qps, md_stages_ms=stages, md_launches=counts["launches"],
                md_oracle_err=err, md_overlap10=float(np.mean(overlap)),
                md_batcher_qps=len(queries) / dt_b, md_load_s=load_s)


def multidevice_build(model, passages, work_dir: str) -> dict:
    """[multidevice] 3: ``Indexer`` with mesh_data_axis=2 over two repeats
    of the card at the flash-probe configuration: every flash launch
    ``mma``, the sharded codec trainer and the histogram quantiles ran, the
    index loads in the single-device ``Searcher`` and finds each of 64
    passages first from its 40-word prefix (>= 0.95)."""
    from colbert_torch.indexing import codec_trainer
    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.ops import quantile
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.storage import format as fmt

    dev = next(model.parameters()).device
    enc = build_corpus_encoder(model, dev, build_config(mesh_data_axis=2))
    index_dir = os.path.join(work_dir, "smoke_mesh_index")
    shutil.rmtree(index_dir, ignore_errors=True)
    ran = {"sharded_trainer": 0, "sharded_quantiles": 0}
    trainer, quantiles = codec_trainer._train_codec_sharded, quantile.sharded_quantiles

    def counted(name, fn):
        def call(*a, **kw):
            ran[name] += 1
            return fn(*a, **kw)
        return call

    codec_trainer._train_codec_sharded = counted("sharded_trainer", trainer)
    quantile.sharded_quantiles = counted("sharded_quantiles", quantiles)
    reset_counts()
    try:
        t0 = time.perf_counter()
        with counted_doc_batches(enc) as seen:
            idx = Indexer(enc.config, encoder=enc, collection=passages,
                          device=mesh_devices(dev, 2))
            idx.index(index_dir)
        wall = time.perf_counter() - t0
    finally:
        codec_trainer._train_codec_sharded, quantile.sharded_quantiles = trainer, quantiles
    flash = dict(fa.flash_attention.variant_launches, launches=fa.flash_attention.launches)
    plan = fmt.load_plan(index_dir)
    layers = enc.bert_config.num_hidden_layers
    print(f"[multidevice] mesh build {idx.mesh.shape}: {len(passages)} passages in {wall:.2f}s "
          f"-> {len(passages) / wall:.2f} passages/s; phases (s) "
          + json.dumps({k: v["seconds"] for k, v in plan["timings"].items()})
          + f"; {plan['num_partitions']} partitions; encoded batches {seen['batches']} "
          f"(flash-routed {seen['flash_batches']}); flash launches {flash} (expected "
          f"{layers} x 2 shards x {seen['flash_batches']}); sharded codec calls {ran}; on "
          f"{card_line()}")
    check(ran == {"sharded_trainer": 1, "sharded_quantiles": 1},
          f"multidevice build: the sharded codec trainer did not run: {ran}")
    check(fmt.check_all_files_saved(index_dir) == [], "multidevice build: incomplete index")
    if dev.type == "cuda":
        check(seen["flash_batches"] == seen["batches"] > 0
              and flash["launches"] == layers * 2 * seen["flash_batches"]
              and flash["mma"] == flash["launches"] and flash["simt"] == 0,
              f"multidevice build: flash launches {flash}")
    one = build_corpus_encoder(model, dev, build_config())
    searcher = Searcher(index_dir, encoder=one, device=dev)
    rng = np.random.default_rng(6)
    pids = rng.choice(len(passages), size=64, replace=False)
    got, _ = searcher.search_batch([" ".join(passages[p].split()[:40]) for p in pids], k=10)
    success = float((got[:, 0] == pids).mean())
    print(f"[multidevice] the mesh-built index in the single-device Searcher: self-retrieval "
          f"success@1 {success:.4f} over 64 prefix queries (limit 0.95)")
    check(success >= 0.95, f"multidevice build: success@1 {success} < 0.95")
    shutil.rmtree(index_dir, ignore_errors=True)
    return dict(md_build_s=wall, md_build_phases=plan["timings"], md_build_success1=success,
                md_flash_launches=flash["launches"])


def multidevice_encodes(model, batch) -> dict:
    """[multidevice] 4: one corpus batch at S=512 encoded data-parallel
    (2x1) and tensor-parallel (1x2, 6 heads per shard through flash) on one
    card against the one-device encode: bf16 per kept token cosine >= 0.999
    (flash on), fp32 with TF32 off within 1e-4 (materialized attention);
    ``kmeans_sharded`` over 4 shards against ``kmeans`` from the same rows
    (separated clusters, one initial row in each)
    at 1e-4; then ``dryrun_multichip(4)``."""
    import torch

    from colbert_torch.graft_entry import dryrun_multichip
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.ops import kmeans as kmeans_ops
    from colbert_torch.parallel.kmeans_dist import kmeans_sharded
    from colbert_torch.parallel.mesh import make_mesh

    dev = next(model.parameters()).device
    cfg = build_config()
    one = build_corpus_encoder(model, dev, cfg)
    _, ids, mask, keep = batch
    ids, mask, keep = ids[:MD_ENCODE_ROWS], mask[:MD_ENCODE_ROWS], keep[:MD_ENCODE_ROWS]
    flash = one._flash_for(ids.shape[1])
    layers = one.bert_config.num_hidden_layers
    kept = torch.from_numpy(keep).to(dev)
    out = {}
    with torch.no_grad():
        ref16 = one._forward("encode_batch", ids, mask, keep, dtype_name="bfloat16",
                             use_flash=flash)
        ref32 = one._forward("encode_batch", ids, mask, keep, dtype_name="float32")
        for name, shape in (("dp", (2, 1)), ("tp", (1, 2))):
            enc = ColBERTEncoder(model, one.tokenizer, cfg, device=dev)
            enc.attach_mesh(make_mesh(*shape, devices=mesh_devices(dev, 2)))
            reset_counts()
            t0 = time.perf_counter()
            e16 = enc._forward("encode_batch", ids, mask, keep, dtype_name="bfloat16",
                               use_flash=flash)[:len(ids)]
            dt16 = time.perf_counter() - t0
            f = dict(fa.flash_attention.variant_launches)
            e32 = enc._forward("encode_batch", ids, mask, keep, dtype_name="float32")[:len(ids)]
            cos = float((e16 * ref16).sum(-1)[kept].min())
            err = float((e32 - ref32).abs()[kept].max())
            print(f"[multidevice] {name} {shape} encode B={len(ids)} S={ids.shape[1]}: bf16 min "
                  f"cosine {cos:.6f} (limit 0.999; {dt16:.4f}s), fp32 max |diff| {err:.3e} "
                  f"(limit 1e-4); flash launches {f}")
            check(cos >= 0.999, f"multidevice {name}: bf16 cosine {cos}")
            check(err <= 1e-4, f"multidevice {name}: fp32 diff {err}")
            if dev.type == "cuda":
                check(f == {"mma": layers * 2, "simt": 0},
                      f"multidevice {name}: flash launches {f}, expected {layers} x 2 mma")
            out[f"md_{name}_cos"], out[f"md_{name}_err"] = cos, err
            del enc

    # MD_KMEANS_K well-separated clusters, one initial row in each: every
    # assignment has a wide margin, so the two fits differ only by the
    # order of their fp32 sums (random rows in 128 dimensions sit near
    # equidistant from their two nearest centroids, and the sums' order on
    # the card, index_add_'s atomics included, flips such near-ties)
    rng = np.random.default_rng(3)
    labels = np.arange(MD_KMEANS_ROWS) % MD_KMEANS_K
    centers = rng.standard_normal((MD_KMEANS_K, 128)) * 4
    data = torch.from_numpy((centers[labels] + rng.standard_normal((MD_KMEANS_ROWS, 128)))
                            .astype(np.float32)).to(dev)
    init = np.arange(MD_KMEANS_K)
    t0 = time.perf_counter()
    a = kmeans_sharded(data, MD_KMEANS_K, make_mesh(4, 1, devices=mesh_devices(dev, 4)),
                       niters=5, init_idx=init)
    dt_k = time.perf_counter() - t0
    b = kmeans_ops.kmeans(data, MD_KMEANS_K, niters=5, init_idx=init)
    kerr = float((a.centroids - b.centroids).abs().max())
    flips = int((a.assignments != b.assignments).sum())
    print(f"[multidevice] kmeans_sharded 4x1 ({MD_KMEANS_ROWS} x 128 in {MD_KMEANS_K} "
          f"separated clusters, 5 iterations, {dt_k:.3f}s) vs kmeans: max |centroid diff| "
          f"{kerr:.3e} (limit 1e-4); assignments differing {flips}")
    check(kerr <= 1e-4, f"multidevice: kmeans_sharded vs kmeans {kerr}")
    t0 = time.perf_counter()
    line = dryrun_multichip(4, device=dev)
    out.update(md_kmeans_err=kerr, md_dryrun_s=time.perf_counter() - t0, md_dryrun=line)
    print(f"[multidevice] dryrun_multichip(4) done in {out['md_dryrun_s']:.2f}s on {card_line()}")
    return out


def update_phase(enc, passages, index_dir: str) -> dict:
    """[update]: serve the index built from ``passages`` through a
    BatchingSearcher, then add
    UPDATE_ADD passages (new pids, a consistent plan and IVF, 12 flash
    launches per encoded batch), remove UPDATE_REMOVE pids (never returned
    through the batcher after a swap), compact (scores of the survivors
    unchanged under the pid map) and evaluate self-retrieval."""
    from colbert_torch.evaluation.runner import evaluate
    from colbert_torch.indexing.updater import IndexUpdater
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.serving import BatchingSearcher
    from colbert_torch.storage import format as fmt
    from colbert_torch.utils.testing import synthetic_passages

    dev = enc.device
    layers = enc.bert_config.num_hidden_layers

    def sync():
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize()

    def query_of(passage: str) -> str:
        return " ".join(passage.split()[:40])

    n0 = len(passages)
    check(int(fmt.load_plan(index_dir)["num_documents"]) == n0, "update: not the built index")
    reset_counts()
    searcher = Searcher(index_dir, encoder=enc, device=dev)
    batcher = BatchingSearcher(searcher, max_batch=BATCH, max_wait_ms=5, max_inflight=2)
    seconds = {}
    try:
        added = synthetic_passages(UPDATE_ADD, mean_words=BUILD_MEAN_WORDS, seed=8)
        up = IndexUpdater(index_dir, enc)
        t0 = time.perf_counter()
        with counted_doc_batches(enc) as seen:
            new_pids = up.add(added)
        sync()
        seconds["add"] = time.perf_counter() - t0
        flash = dict(fa.flash_attention.variant_launches, launches=fa.flash_attention.launches)
        plan = fmt.load_plan(index_dir)
        doclens = fmt.load_all_doclens(index_dir)
        _, ivf_lengths = fmt.load_ivf(index_dir)
        print(f"[update] add: {len(added)} passages in {seconds['add']:.2f}s -> "
              f"{len(added) / seconds['add']:.2f} passages/s; pids {new_pids[0]}..{new_pids[-1]}; "
              f"encoded batches {seen['batches']} (flash-routed {seen['flash_batches']}), flash "
              f"launches {flash}; plan documents {plan['num_documents']} chunks "
              f"{plan['num_chunks']} embeddings {plan['num_embeddings']}")
        check(np.array_equal(new_pids, np.arange(n0, n0 + len(added))), "update: new pids")
        check(plan["num_documents"] == n0 + len(added)
              and fmt.check_all_files_saved(index_dir) == [], "update: plan after add")
        check(int(doclens.sum()) == plan["num_embeddings"] == int(ivf_lengths.sum()),
              "update: doclens, plan and IVF lengths disagree after add")
        if dev.type == "cuda":
            check(seen["flash_batches"] == seen["batches"] > 0, "update: a batch missed flash")
            check(flash["launches"] == layers * seen["flash_batches"]
                  and flash["mma"] == flash["launches"] and flash["simt"] == 0,
                  f"update: flash launches {flash} for {seen['flash_batches']} batches")

        t0 = time.perf_counter()
        searcher = searcher.reload()
        seconds["reload_after_add"] = time.perf_counter() - t0
        batcher.swap(searcher)
        probe = np.random.default_rng(9).choice(len(added), size=BATCH, replace=False)
        got = batcher.search_many([query_of(added[i]) for i in probe], k=10)
        hits = sum(int(p[0]) == n0 + int(i) for (p, _), i in zip(got, probe))
        print(f"[update] after swap: {hits}/{BATCH} added passages retrieve themselves at "
              f"top-1 through the batcher (random weights: information only)")

        rng = np.random.default_rng(10)
        n_new = UPDATE_REMOVE // 10
        removed = np.concatenate([rng.choice(n0, UPDATE_REMOVE - n_new, replace=False),
                                  n0 + rng.choice(len(added), n_new, replace=False)])
        t0 = time.perf_counter()
        up.remove(removed)
        seconds["remove"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        searcher = searcher.reload()
        seconds["reload_after_remove"] = time.perf_counter() - t0
        batcher.swap(searcher)
        all_passages = list(passages) + added
        gone = rng.choice(removed, size=2 * BATCH, replace=False)
        got = batcher.search_many([query_of(all_passages[p]) for p in gone], k=10)
        returned = np.concatenate([p for p, _ in got])
        print(f"[update] remove: {len(removed)} pids ({n_new} of them added) in "
              f"{seconds['remove']:.2f}s; {len(gone)} queries of removed passages through the "
              f"batcher returned {int(np.isin(returned, removed).sum())} removed pids")
        check(not np.isin(returned, removed).any(), "update: a removed pid was returned")

        keep = np.setdiff1d(np.arange(n0 + len(added)), removed)
        survivors = rng.choice(keep, size=4 * BATCH, replace=False)
        surv_q = [query_of(all_passages[p]) for p in survivors]
        p_before, s_before = searcher.search_batch(surv_q, k=10)
        t0 = time.perf_counter()
        pid_map = up.compact()
        seconds["compact"] = time.perf_counter() - t0
        plan = fmt.load_plan(index_dir)
        check(up.finish_pending_compact() is False, "update: a compact is still pending")
        check(plan["num_documents"] == n0 + len(added) - len(removed)
              and len(fmt.load_deleted(index_dir)) == 0
              and int((pid_map >= 0).sum()) == plan["num_documents"]
              and bool((pid_map[removed] == -1).all()), "update: plan after compact")
        t0 = time.perf_counter()
        searcher = searcher.reload()
        seconds["reload_after_compact"] = time.perf_counter() - t0
        batcher.swap(searcher)
        p_after, s_after = searcher.search_batch(surv_q, k=10)
        mapped = np.where(p_before >= 0, pid_map[np.maximum(p_before, 0)], -1)
        why = agree_up_to_ties(p_after, s_after, mapped, s_before, TOL)
        diff = float(np.abs(s_after - s_before).max())
        print(f"[update] compact: {plan['num_documents']} documents, {plan['num_embeddings']} "
              f"embeddings in {seconds['compact']:.2f}s; {len(surv_q)} survivor queries after "
              f"vs before under the pid map: max |score diff| {diff:.3e}, equal up to ties: "
              f"{why is None}")
        check(why is None, f"update: compaction changed results: {why}")

        qids = [str(p) for p in survivors]
        qrels = {str(p): {int(pid_map[p])} for p in survivors}
        report = evaluate(searcher, surv_q, qids, qrels, k=10)
        print("[update] evaluate (self-retrieval qrels through the pid map; random weights: "
              "information only) " + json.dumps(report))
    finally:
        batcher.close()
    counts = stage2_counts()
    print("[update] seconds " + json.dumps({k: round(v, 4) for k, v in seconds.items()})
          + f"; stage-2 launches {counts}")
    check_stage2_all_mma(dev, counts, "update")
    return dict(update_seconds=seconds, update_flash_launches=flash["launches"],
                update_launches=counts["launches"], update_eval=report,
                update_add_pps=len(added) / seconds["add"])


# ---------------------------------------------------------------------------
# [train]: fine-tune the encoder, then index and search with it
# ---------------------------------------------------------------------------


def train_config(**kw):
    """bench_quality.py's training configuration (:76-108): query_maxlen 32,
    doc_maxlen 192 (the corpus's ~110-140 tokens), and the build knobs of
    the retrieval check (nbits 2, 4 k-means iterations)."""
    from colbert_torch.config import ColBERTConfig

    return ColBERTConfig(dim=128, query_maxlen=32, doc_maxlen=192, nbits=2,
                         kmeans_niters=4, **kw)


def train_flops(model, q_shape, d_shape) -> float:
    """Model FLOPs of one step: 6 x non-embedding parameters x tokens, plus
    attention's 4*S^2*H per sequence and layer forward, x3 with the
    backward; remat's recompute is not counted."""
    cfg = model.bert_config
    embedding = {"bert.word.weight", "bert.position.weight", "bert.token_type.weight"}
    params = sum(p.numel() for n, p in model.named_parameters() if n not in embedding)
    tokens = q_shape[0] * q_shape[1] + d_shape[0] * d_shape[1]
    seq_sq = q_shape[0] * q_shape[1] ** 2 + d_shape[0] * d_shape[1] ** 2
    attention = 3 * 4 * cfg.num_hidden_layers * cfg.hidden_size * seq_sq
    return 6 * params * tokens + attention


def step_card_vs_cpu(model, tokenizer, triples, device) -> dict:
    """Check 1: one ``train_step`` of the first CHECK_LAYERS layers of
    ``model`` at full width, fp32 activations, TF32 off, constant lr, on the
    card and on the CPU: loss 1e-5 relative, each gradient within 1e-4 x its
    max |g|, the parameters after the AdamW step within 1e-2 x lr (entries
    whose CPU gradient is nonzero but below 1e-6 are counted apart: Adam
    divides by sqrt(v), so their update follows 1e-7-level differences).
    The key bias's gradient is 0 in exact arithmetic (softmax ignores a
    constant added to every key score of a query, and q.(k + b) adds q.b),
    so its entries are rounding noise and a bound relative to their max
    means nothing: they are held to |g| <= 1e-9 on both sides instead."""
    import dataclasses

    import torch

    from colbert_torch.models.colbert import ColBERT
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.training import ColBERTTrainer

    if device.type == "cuda":
        check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
              "train: TF32 must be off for the card-vs-CPU step")
    cfg = dataclasses.replace(model.bert_config, num_hidden_layers=CHECK_LAYERS)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()
          if not k.startswith("bert.layers.") or int(k.split(".")[2]) < CHECK_LAYERS}
    out = {}
    for dev in (device, torch.device("cpu")):
        small = ColBERT(cfg, model.dim)
        small.load_state_dict(sd, strict=True)
        enc = ColBERTEncoder(small, tokenizer, train_config(activation_dtype="float32"),
                             device=dev)
        trainer = ColBERTTrainer(enc, learning_rate=TRAIN_LR)
        m = trainer.train_step(triples)
        out[dev.type] = (m, [p.grad.cpu() for p in small.parameters()],
                         [p.detach().cpu() for p in small.parameters()])
    (mc, gc, pc), (mh, gh, ph) = out[device.type], out["cpu"]
    names = [n for n, _ in small.named_parameters()]
    loss_rel = abs(mc["loss"] - mh["loss"]) / abs(mh["loss"])
    zero = [n.endswith(".k.bias") for n in names]
    rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
           for a, b, z in zip(gc, gh, zero)]
    worst = max((r, n) for r, n, z in zip(rel, names, zero) if not z)
    grad_rel = worst[0]
    kbias = max(float(g.abs().max()) for gs in (gc, gh) for g, z in zip(gs, zero) if z)
    masked, total, param_err, masked_err = 0, 0, 0.0, 0.0
    for a, b, g in zip(pc, ph, gh):
        tiny = (g.abs() < 1e-6) & (g != 0)
        diff = (a - b).abs()
        masked += int(tiny.sum())
        total += g.numel()
        param_err = max(param_err, float(diff[~tiny].max()) if (~tiny).any() else 0.0)
        masked_err = max(masked_err, float(diff[tiny].max()) if tiny.any() else 0.0)
    print(f"[train] card vs CPU, {CHECK_LAYERS} layers at full width, fp32, {len(triples)} "
          f"triples, lr {TRAIN_LR}: loss {mc['loss']:.8f} vs {mh['loss']:.8f} (rel "
          f"{loss_rel:.3e}, limit 1e-5); max grad err / max |g| {grad_rel:.3e} (limit 1e-4; "
          f"{worst[1]}); key-bias |g| <= {kbias:.3e} (0 in exact arithmetic; limit 1e-9); "
          f"max param err {param_err:.3e} (limit {1e-2 * TRAIN_LR:.1e}) over "
          f"{total - masked}/{total} entries; {masked} entries with 0 < |g| < 1e-6: max "
          f"err {masked_err:.3e}")
    check(loss_rel <= 1e-5, f"train: card vs CPU loss {loss_rel}")
    check(grad_rel <= 1e-4, f"train: card vs CPU gradient {worst}")
    check(kbias <= 1e-9, f"train: key-bias gradient {kbias}")
    check(param_err <= 1e-2 * TRAIN_LR, f"train: card vs CPU parameters {param_err}")
    return dict(check_loss_rel=loss_rel, check_grad_rel=grad_rel, check_param_err=param_err,
                check_masked_err=masked_err)


def remat_on_off(model, batch, device) -> dict:
    """Check 2: loss and gradients of one full-depth bf16 step with remat on
    and off, from the same state (loss 1e-6 relative, each gradient within
    1e-3 x its max |g|), and the peak device memory of each forward +
    backward (parameters and gradients resident, no optimizer state)."""
    import torch

    from colbert_torch.training.trainer import train_loss

    params = list(model.parameters())
    res = {}
    for remat in (True, False):
        model.zero_grad(set_to_none=True)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        loss, _ = train_loss(model, batch, dtype_name="bfloat16", remat=remat)
        loss.backward()
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        res[remat] = (loss.item(), [p.grad.clone() for p in params], peak)
    model.zero_grad(set_to_none=True)
    (l1, g1, m1), (l0, g0, m0) = res[True], res[False]
    loss_rel = abs(l1 - l0) / abs(l0)
    grad_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(g1, g0))
    bit_equal = l1 == l0 and all(torch.equal(a, b) for a, b in zip(g1, g0))
    print(f"[train] remat on vs off, full depth, bf16: loss {l1:.8f} vs {l0:.8f} (rel "
          f"{loss_rel:.3e}, limit 1e-6); max grad err / max |g| {grad_rel:.3e} (limit 1e-3); "
          f"bit-equal {bit_equal}; peak device memory of a forward+backward "
          f"{m1 / 2**30:.2f} GiB with remat, {m0 / 2**30:.2f} GiB without")
    check(loss_rel <= 1e-6, f"train: remat changes the loss by {loss_rel}")
    check(grad_rel <= 1e-3, f"train: remat changes a gradient by {grad_rel}")
    return dict(remat_bit_equal=bit_equal, peak_gib_remat=m1 / 2**30,
                peak_gib_no_remat=m0 / 2**30)


def train_phase(device, *, bert_cfg, n_passages: int = TRAIN_PASSAGES,
                steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH, work_dir: str) -> dict:
    """[train]: ``ColBERTTrainer`` on a model of its own (random weights
    from a seed) over ``make_triples`` of the synthetic corpus, in-batch
    negatives, AdamW at lr TRAIN_LR with TRAIN_WARMUP warmup steps and the
    cosine decay to 0 at ``steps``, clipping at 1.0, remat on; checks 1-2
    before, the loss falling, a profiled step, the checkpoint round trip,
    and an index built and searched with the trained encoder (check 5)."""
    import statistics

    import torch

    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.models.colbert import ColBERT, init_colbert
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.models.hf_loader import load_checkpoint
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.training import ColBERTTrainer
    from colbert_torch.utils.testing import (bench_vocab_tokenizer, make_triples,
                                             synthetic_passages)

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    tokenizer = bench_vocab_tokenizer()
    model = init_colbert(bert_cfg, 128, generator=torch.Generator().manual_seed(17))
    init_sd = {k: v.clone() for k, v in model.state_dict().items()}
    passages = synthetic_passages(n_passages)
    triples = make_triples(passages, steps * batch, seed=0)
    print(f"[train] model {bert_cfg} params {sum(p.numel() for p in model.parameters())}; "
          f"{len(triples)} triples over {n_passages} passages")
    out = step_card_vs_cpu(model, tokenizer, triples[:CHECK_TRIPLES], device)

    cfg = train_config()
    enc = ColBERTEncoder(model, tokenizer, cfg, device=device)
    trainer = ColBERTTrainer(enc, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                             total_steps=steps, in_batch_negatives=True)
    host = trainer._tensorize(triples[:batch])
    first = dict(zip(host, enc._put_batch(*host.values())))
    out.update(remat_on_off(enc.model, first, device))
    q_shape, d_shape = host["q_ids"].shape, (2 * batch, host["pos_ids"].shape[1])
    flops = train_flops(enc.model, q_shape, d_shape)
    tokens = q_shape[0] * q_shape[1] + d_shape[0] * d_shape[1]

    reset_counts()
    times, step_peak = [], 0
    for step in range(steps):
        if cuda and step == 3:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = trainer.train_step(triples[step * batch:(step + 1) * batch])
        times.append(time.perf_counter() - t0)  # the metrics' read-back waits for the step
        if cuda and step == 3:
            step_peak = torch.cuda.max_memory_allocated()
        if step < 3 or (step + 1) % 50 == 0:
            print(f"[train] step {step + 1:4d}: loss {m['loss']:.4f} pairwise_acc "
                  f"{m['pairwise_acc']:.3f} margin {m['margin']:.4f} "
                  f"({times[-1] * 1e3:.2f} ms)")
    flash = fa.flash_attention.launches
    ms = statistics.median(times[3:]) * 1e3
    hist = trainer.history
    head = float(np.mean([h["loss"] for h in hist[:20]]))
    tail = float(np.mean([h["loss"] for h in hist[-20:]]))
    tail_acc = float(np.mean([h["pairwise_acc"] for h in hist[-20:]]))
    print(f"[train] {steps} steps x {batch} triples: median {ms:.3f} ms per step after 3 "
          f"warm-up steps -> {1e3 / ms:.3f} steps/s, {batch * 1e3 / ms:.2f} triples/s, "
          f"{tokens * 1e3 / ms:.0f} tokens/s ({tokens} padded positions per step: "
          f"{q_shape[0]}x{q_shape[1]} query + {d_shape[0]}x{d_shape[1]} doc); model "
          f"{flops * 1e3 / ms / 1e12:.2f} TFLOP/s ({flops / 1e12:.4f} TFLOP per step = 6 x "
          f"non-embedding params x tokens + attention 12 x layers x hidden x sum S^2; "
          f"remat's recompute not counted); peak device memory of step 4 (remat, AdamW "
          f"state resident) {step_peak / 2**30:.2f} GiB; flash launches {flash}")
    print(f"[train] mean loss of the first 20 steps {head:.4f}, of the last 20 {tail:.4f}; "
          f"tail-20 pairwise_acc {tail_acc:.3f}")
    check(flash == 0, f"train: {flash} flash launches; training never routes to flash")
    check(tail < head, f"train: the loss did not fall ({head} -> {tail})")
    if cuda:
        prof = device_profile(lambda: trainer.train_step(triples[:batch]))
        print("[profile] train step " + json.dumps(prof))
    out.update(train_ms=ms, train_steps_per_s=1e3 / ms, train_triples_per_s=batch * 1e3 / ms,
               train_tokens_per_s=tokens * 1e3 / ms, train_tflops=flops * 1e3 / ms / 1e12,
               train_step_peak_gib=step_peak / 2**30, train_loss_head=head,
               train_loss_tail=tail, train_tail_acc=tail_acc)

    # check 4: the checkpoint round trip
    ckpt = os.path.join(work_dir, "smoke_train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    trainer.save_checkpoint(ckpt)
    _, model2, tok2 = load_checkpoint(ckpt, device=device)
    sd2 = model2.state_dict()
    differ = [k for k, v in enc.model.state_dict().items() if not torch.equal(v, sd2[k])]
    enc2 = ColBERTEncoder(model2, tok2, cfg, device=device)
    queries = [q for q, _, _ in triples[:batch]]
    same_q = bool(np.array_equal(enc.encode_queries(queries), enc2.encode_queries(queries)))
    print(f"[train] checkpoint saved and loaded in {time.perf_counter() - t0:.2f}s: "
          f"{len(sd2) - len(differ)}/{len(sd2)} tensors bit-equal; {len(queries)}-query "
          f"encode bit-equal {same_q}")
    check(not differ and tok2.vocab == tokenizer.vocab, f"train: checkpoint differs {differ[:3]}")
    check(same_q, "train: the loaded checkpoint encodes queries differently")
    shutil.rmtree(ckpt, ignore_errors=True)
    del model2, enc2

    # check 5: the trained weights reach retrieval
    index_dir = os.path.join(work_dir, "smoke_train_index")
    shutil.rmtree(index_dir, ignore_errors=True)
    t0 = time.perf_counter()
    Indexer(cfg, encoder=enc, collection=passages, device=device).index(index_dir)
    sync()
    build_s = time.perf_counter() - t0
    searcher = Searcher(index_dir, encoder=enc, device=device)
    pids = np.random.default_rng(14).choice(n_passages, TRAIN_QUERIES, replace=False)
    queries = [passages[p][:200] for p in pids]
    seen = []
    encode = enc.encode_query_tokens

    def recording(ids, mask):
        Q = encode(ids, mask)
        seen.append((ids, mask, Q))
        return Q

    reset_counts()
    enc.encode_query_tokens = recording
    try:
        results = [searcher.search_batch(queries[i:i + BATCH], k=10)
                   for i in range(0, len(queries), BATCH)]
    finally:
        del enc.encode_query_tokens
    counts = stage2_counts()
    initial = ColBERT(bert_cfg, 128)
    initial.load_state_dict(init_sd)
    initial = initial.to(device)
    same, moved = True, True
    with torch.no_grad():
        for ids, mask, Q in seen:
            ids_t, mask_t = enc._put_batch(ids, mask)
            keep = torch.ones_like(mask_t)
            want = enc.model.forward_normalized(ids_t, mask_t, keep,
                                                dtype_name=cfg.activation_dtype)
            before = initial.forward_normalized(ids_t, mask_t, keep,
                                                dtype_name=cfg.activation_dtype)
            same &= bool(torch.equal(Q, want))
            moved &= not bool(torch.equal(Q, before))
    p = np.concatenate([r[0] for r in results])
    s1 = float((p[:, 0] == pids).mean())
    s10 = float((p == pids[:, None]).any(axis=1).mean())
    print(f"[train] index of {n_passages} passages built in {build_s:.2f}s with the trained "
          f"encoder; {len(queries)} prefix queries: the searcher's query embeddings equal "
          f"the trained model's forward {same}, differ from the initial model's {moved}; "
          f"stage-2 launches {counts}; self-retrieval success@1 {s1:.3f} success@10 "
          f"{s10:.3f} (information)")
    check(same and seen, "train: the searcher's query embeddings are not the trained model's")
    check(moved, "train: the searcher's query embeddings equal the untrained model's")
    check(p.shape == (TRAIN_QUERIES, 10) and all(np.isfinite(r[1]).all() for r in results),
          "train: result shape or scores")
    check_stage2_all_mma(device, counts, "train")
    shutil.rmtree(index_dir, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"[train] phase seconds {seconds:.1f}")
    out.update(train_search_launches=counts["launches"], train_flash_launches=flash,
               train_success_at_1=s1, train_success_at_10=s10, train_index_s=build_s,
               train_phase_s=seconds)
    return out


# ---------------------------------------------------------------------------
# [train-mesh]: ColBERTTrainer over a device mesh on the one card
# ---------------------------------------------------------------------------


def mesh_trainer(sd, bert_cfg, tokenizer, cfg, device, shape, **kw):
    """A ``ColBERTTrainer`` of a fresh model holding ``sd``, over a
    ``shape`` mesh of ``device`` repeated (None: no mesh)."""
    from colbert_torch.models.colbert import ColBERT
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.parallel.mesh import make_mesh
    from colbert_torch.training import ColBERTTrainer

    model = ColBERT(bert_cfg, 128)
    model.load_state_dict(sd, strict=True)
    enc = ColBERTEncoder(model, tokenizer, cfg, device=device)
    if shape is not None:
        enc.attach_mesh(make_mesh(*shape, devices=mesh_devices(device, shape[0] * shape[1])))
    return ColBERTTrainer(enc, **kw)


def mesh_step_checks(model, tokenizer, triples, device) -> dict:
    """One AdamW step (lr TRAIN_LR, clipping) of the first CHECK_LAYERS
    layers of ``model`` at full width, fp32 activations, TF32 off, over
    each mesh of TRAIN_MESHES against the same step on one device: loss
    1e-5 relative, every gradient entry within 1e-4 x its tensor's max |g|
    + 1e-7, every parameter after the update within 1e-2 x lr (entries
    whose one-device gradient is nonzero and below 1e-6, where Adam's first
    update lr * g / (|g| + 1e-8) follows the gradient's rounding, are
    counted apart as in :func:`step_card_vs_cpu`, and held to lr); then
    the dp x tp step inside a one-process NCCL group (gloo on the CPU),
    whose collectives run at world size 1, against the step without a
    group: within 1e-6."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from colbert_torch.parallel import launch

    cfg = dataclasses.replace(model.bert_config, num_hidden_layers=CHECK_LAYERS)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()
          if not k.startswith("bert.layers.") or int(k.split(".")[2]) < CHECK_LAYERS}

    def step(shape):
        trainer = mesh_trainer(sd, cfg, tokenizer, train_config(activation_dtype="float32"),
                               device, shape, learning_rate=TRAIN_LR)
        loss = trainer.train_step(triples)["loss"]
        params = list(trainer.encoder.model.parameters())
        return loss, [p.grad.clone() for p in params], [p.detach().clone() for p in params]

    loss1, g1, p1 = step(None)
    out, results = {}, {}
    for name, shape in TRAIN_MESHES.items():
        results[name] = loss, g, p = step(shape)
        loss_rel = abs(loss - loss1) / abs(loss1)
        grad_ratio = max(float((a - b).abs().max()) / (1e-4 * float(b.abs().max()) + 1e-7)
                         for a, b in zip(g, g1))
        param_err, apart_err, apart = 0.0, 0.0, 0
        for a, b, gb in zip(p, p1, g1):
            tiny = (gb.abs() < 1e-6) & (gb != 0)
            diff = (a - b).abs()
            apart += int(tiny.sum())
            param_err = max(param_err, float(diff[~tiny].max()) if (~tiny).any() else 0.0)
            apart_err = max(apart_err, float(diff[tiny].max()) if tiny.any() else 0.0)
        print(f"[train-mesh] {name} {shape} vs one device, {CHECK_LAYERS} layers at full width, "
              f"fp32, {len(triples)} triples: loss {loss:.8f} vs {loss1:.8f} (rel "
              f"{loss_rel:.3e}, limit 1e-5); max grad err / (1e-4 max|g| + 1e-7) "
              f"{grad_ratio:.3e} (limit 1); max param err {param_err:.3e} (limit "
              f"{1e-2 * TRAIN_LR:.1e}); {apart} entries with 0 < |g| < 1e-6: max err "
              f"{apart_err:.3e} (limit {TRAIN_LR:.1e})")
        check(loss_rel <= 1e-5, f"train-mesh {name}: loss {loss_rel}")
        check(grad_ratio <= 1.0, f"train-mesh {name}: gradient {grad_ratio}")
        check(param_err <= 1e-2 * TRAIN_LR and apart_err <= TRAIN_LR,
              f"train-mesh {name}: parameters {param_err}, {apart_err}")
        out[f"mesh_{name}_loss_rel"] = loss_rel
        out[f"mesh_{name}_grad_ratio"] = grad_ratio
        out[f"mesh_{name}_param_err"] = param_err

    backend = "nccl" if device.type == "cuda" else "gloo"
    launch.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend=backend)
    try:
        check(dist.get_backend() == backend and launch.process_count() == 1,
              "train-mesh: process group")
        grouped = step(TRAIN_MESHES["dp x tp"])
    finally:
        dist.destroy_process_group()
    alone = results["dp x tp"]
    err = max([abs(grouped[0] - alone[0])]
              + [float((a - b).abs().max()) for x, y in zip(grouped[1:], alone[1:])
                 for a, b in zip(x, y)])
    bit_equal = err == 0.0
    print(f"[train-mesh] dp x tp step in a one-process {backend} group vs without one: loss, "
          f"gradients and parameters max |diff| {err:.3e} (limit 1e-6); bit-equal {bit_equal}")
    check(err <= 1e-6, f"train-mesh: the {backend} step differs by {err}")
    out.update(mesh_group_err=err, mesh_group_bit_equal=bit_equal)
    return out


def train_mesh_phase(device, *, bert_cfg, n_passages: int = TRAIN_PASSAGES,
                     steps: int = TRAIN_MESH_STEPS, batch: int = TRAIN_BATCH) -> dict:
    """[train-mesh]: ``ColBERTTrainer`` through ``attach_mesh`` on the one
    card, its mesh cells a repeated device list: the fp32 checks of
    :func:`mesh_step_checks`; then a bert-base model of [train]'s recipe
    (seed 17, the corpus vocabulary, ``make_triples``, 32 triples per step,
    bf16, AdamW with its warmup and schedule, clipping, remat) trained
    ``steps`` steps on one device and over each mesh of TRAIN_MESHES from
    the same weights: the median ms per step after 3 warm-up steps, a
    finite loss, the first step's loss within 2e-2 relative of the
    one-device step's; after the dp x tp training every replica and shard
    holds the trained weights and a 32-row bf16 mesh encode is within
    cosine 0.999 of the trained model's one-device encode. Neither kernel
    launches (training never routes to flash and searches nothing)."""
    import statistics

    import torch

    from colbert_torch.models.colbert import init_colbert
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.ops import fused_maxsim as fm
    from colbert_torch.parallel.tp import param_links
    from colbert_torch.utils.testing import (bench_vocab_tokenizer, make_triples,
                                             synthetic_passages)

    t_phase = time.perf_counter()
    reset_counts()
    tokenizer = bench_vocab_tokenizer()
    model = init_colbert(bert_cfg, 128, generator=torch.Generator().manual_seed(17))
    sd = model.state_dict()
    passages = synthetic_passages(n_passages)
    triples = make_triples(passages, steps * batch, seed=0)
    out = mesh_step_checks(model, tokenizer, triples[:CHECK_TRIPLES], device)

    cfg = train_config()
    first, ms = {}, {}
    for name, shape in {"one device": None, **TRAIN_MESHES}.items():
        trainer = mesh_trainer(sd, bert_cfg, tokenizer, cfg, device, shape,
                               learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                               total_steps=TRAIN_STEPS, in_batch_negatives=True)
        times = []
        for step in range(steps):
            t0 = time.perf_counter()
            m = trainer.train_step(triples[step * batch:(step + 1) * batch])
            times.append(time.perf_counter() - t0)  # the metrics' read-back waits for the step
            check(np.isfinite(m["loss"]), f"train-mesh {name}: loss {m['loss']}")
        first[name] = trainer.history[0]["loss"]
        ms[name] = statistics.median(times[3:]) * 1e3
        rel = abs(first[name] - first["one device"]) / abs(first["one device"])
        print(f"[train-mesh] {name} {shape}: {steps} steps x {batch} triples, bf16, full depth: "
              f"median {ms[name]:.3f} ms per step after 3 warm-up steps (one device "
              f"{ms['one device']:.3f} ms); first-step loss {first[name]:.6f} (rel to one "
              f"device {rel:.3e}, limit 2e-2); last loss {m['loss']:.4f}; on {card_line()}")
        check(rel <= 2e-2, f"train-mesh {name}: first-step loss {rel}")
    enc = trainer.encoder
    stale = sum(not torch.equal(rep, full if index is None else full[index])
                for replica in set(enc._replicas.values())
                for full, rep, index in param_links(enc.model, replica))
    host = trainer._tensorize(triples[:32])
    ids, mask, keep = host["pos_ids"], host["pos_mask"], host["pos_keep"]
    with torch.no_grad():
        meshed = enc._forward("encode_batch", ids, mask, keep, dtype_name="bfloat16")[:32]
        one = enc.model.encode_batch(*enc._put_batch(ids, mask, keep), dtype_name="bfloat16")
    kept = torch.from_numpy(keep).to(one.device)
    cos = float((meshed * one).sum(-1)[kept].min())
    launches = {"stage2_maxsim": fm.stage2_maxsim.launches,
                "flash_attention": fa.flash_attention.launches}
    seconds = time.perf_counter() - t_phase
    print(f"[train-mesh] after the dp x tp training: stale replica or shard tensors {stale}; "
          f"32-row bf16 mesh encode vs the trained model's one-device encode: min cosine "
          f"{cos:.6f} (limit 0.999); kernel launches {launches}; phase seconds {seconds:.1f}. "
          f"One card runs the shards in turn: these times are the code path's, not a mesh's "
          f"gain")
    check(stale == 0, f"train-mesh: {stale} stale replica tensors")
    check(cos >= 0.999, f"train-mesh: mesh encode after training, cosine {cos}")
    check(launches == {"stage2_maxsim": 0, "flash_attention": 0},
          f"train-mesh: kernel launches {launches}; training launches neither kernel")
    out.update(mesh_ms=ms, mesh_first_loss=first,
               mesh_encode_cos=cos, mesh_stale=stale, mesh_launches=launches,
               mesh_phase_s=seconds)
    return out


# ---------------------------------------------------------------------------
# [examples] and [quality]: the entry points a user runs
# ---------------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_index_consistent(index_dir: str, n_docs: int, step: str) -> dict:
    """Plan, doclens, tombstones and IVF of an index agree -> its plan."""
    from colbert_torch.storage import format as fmt

    plan = fmt.load_plan(index_dir)
    doclens = fmt.load_all_doclens(index_dir)
    deleted = fmt.load_deleted(index_dir)
    _, ivf_lengths = fmt.load_ivf(index_dir)
    live = int(doclens.sum()) - int(doclens[deleted].sum())
    check(fmt.check_all_files_saved(index_dir) == [] and plan["num_documents"] == n_docs
          and len(doclens) == n_docs and int(doclens.sum()) == plan["num_embeddings"]
          and int(ivf_lengths.sum()) == live
          and not os.path.exists(os.path.join(index_dir, "compact_commit.json")),
          f"examples: {step}: plan, doclens, tombstones and IVF disagree")
    return plan


def examples_phase(device, work_dir: str, *, n_passages: int = EXAMPLES_PASSAGES,
                   bert_cfg=None) -> dict:
    """[examples]: the entry points of ``colbert_torch.examples`` in a work
    directory, each at its default device on the card: ``make_eval_fixture``,
    a checkpoint of the seeded bench encoder (``bert_cfg``, default
    bert-base), ``indexing`` from it, ``searching`` (and with
    ``--random-weights``, the same weights) against a direct search,
    ``evaluate``, ``tune --apply-to config``, ``update`` add / remove /
    compact, ``serve`` as a subprocess answering POST /search one request
    at a time against direct search, and ``train`` whose checkpoint loads
    back, differs from its input and searches the index."""
    import torch

    from colbert_torch.config import ColBERTConfig
    from colbert_torch.evaluation.runner import load_queries_tsv
    from colbert_torch.examples import (evaluate, indexing, make_eval_fixture, searching,
                                        train, tune, update)
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.models.hf_loader import load_checkpoint
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.storage import format as fmt
    from colbert_torch.utils.testing import (make_triples, synthetic_passages,
                                             write_bench_checkpoint)

    root = os.path.join(work_dir, "smoke_examples")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    dev_args = [] if device.type == "cuda" else ["--device", "cpu"]
    seconds = {}
    counts, flash = dict(launches=0, mma=0, simt=0), 0

    def step(name, fn):
        """Run one entry point: its seconds, and its kernel launches with
        the counts set to 0 just before and read just after (the direct
        searches its results are held against run outside any step)."""
        nonlocal flash
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        for key, n in stage2_counts().items():
            counts[key] += n
        flash += fa.flash_attention.launches
        print(f"[examples] {name}: {seconds[name]:.2f}s")
        return out

    def run(name, module, argv):
        return step(name, lambda: module.main(argv + dev_args))

    try:
        fx = os.path.join(root, "fx")
        collection_tsv, queries_tsv, qrels = (os.path.join(fx, f) for f in (
            "collection.tsv", "queries.tsv", "qrels.txt"))
        run("make_eval_fixture", make_eval_fixture,
            [fx, "--n", str(n_passages), "--queries", str(EXAMPLES_QUERIES)])
        with open(collection_tsv) as f:
            collection = [line.rstrip("\n").split("\t", 1)[1] for line in f]
        _, queries = load_queries_tsv(queries_tsv)
        check(len(collection) == n_passages and len(queries) == EXAMPLES_QUERIES,
              "examples: the fixture's sizes")
        ckpt, idx = os.path.join(root, "ckpt"), os.path.join(root, "idx")
        step("write_bench_checkpoint",
             lambda: write_bench_checkpoint(ckpt, device=device, bert_config=bert_cfg))
        run("indexing", indexing, [ckpt, collection_tsv, idx])
        plan = check_index_consistent(idx, n_passages, "indexing")
        print(f"[examples] indexing: {plan['num_embeddings']} embeddings, "
              f"{plan['num_partitions']} partitions, {plan['num_chunks']} chunks")

        direct = Searcher(idx, device=device)
        dp, ds = direct.search(queries[0], k=10)
        runs = [("searching", [])]
        if bert_cfg is None:  # --random-weights loads the checkpoint's seeded bert-base weights
            runs.append(("searching --random-weights", ["--random-weights"]))
        for name, extra in runs:
            [(p, s)] = run(name, searching, [idx, queries[0], "-k", "10"] + extra)
            why = agree_up_to_ties(p[None], s[None], dp[None], ds[None], TOL)
            check(why is None, f"examples: {name} differs from a direct Searcher.search: {why}")
        base_nprobe = direct.config.nprobe
        del direct

        report = run("evaluate", evaluate, [idx, queries_tsv, qrels])
        check(report["num_queries"] == EXAMPLES_QUERIES and report["qps"] > 0
              and all(0.0 <= report[m] <= 1.0 for m in ("mrr@10", "success@5", "ndcg@10")),
              f"examples: evaluate report {report}")
        print(f"[examples] evaluate: MRR@10 {report['mrr@10']:.4f} Success@5 "
              f"{report['success@5']:.4f} nDCG@10 {report['ndcg@10']:.4f} QPS "
              f"{report['qps']:.2f} (random weights: information only)")

        res = run("tune --apply-to config", tune, [idx, queries_tsv, "--apply-to", "config"])
        saved, p = ColBERTConfig.load(os.path.join(idx, "config.json")), res.chosen.point
        check((saved.plaid_stage2_docs, saved.plaid_stage1_refine, saved.refine_width_factor,
               saved.nprobe) == (p.ncandidates, p.stage1_refine, p.refine_width,
                                 base_nprobe + p.nprobe_delta)
              and (p.max_candidates is None or saved.search_max_candidates == p.max_candidates),
              f"examples: tune chose {p.label()} but config.json holds {saved.to_dict()}")

        added = synthetic_passages(EXAMPLES_ADD, seed=8)
        new_pids = run("update add", update, [idx, "add", *added])
        check(np.array_equal(new_pids, np.arange(n_passages, n_passages + EXAMPLES_ADD)),
              f"examples: update add gave pids {new_pids}")
        check_index_consistent(idx, n_passages + EXAMPLES_ADD, "update add")
        removed = np.random.default_rng(15).choice(n_passages + EXAMPLES_ADD, EXAMPLES_REMOVE,
                                                   replace=False)
        run("update remove", update, [idx, "remove", *map(str, removed)])
        check(np.array_equal(fmt.load_deleted(idx), np.sort(removed)),
              "examples: update remove: tombstones")
        check_index_consistent(idx, n_passages + EXAMPLES_ADD, "update remove")
        pid_map = run("update compact", update, [idx, "compact"])
        n_kept = n_passages + EXAMPLES_ADD - EXAMPLES_REMOVE
        check_index_consistent(idx, n_kept, "update compact")
        check(len(fmt.load_deleted(idx)) == 0 and int((pid_map >= 0).sum()) == n_kept
              and bool((pid_map[removed] == -1).all()), "examples: update compact: pid map")

        after = Searcher(idx, device=device)
        served = queries[:EXAMPLES_HTTP]
        port = free_port()
        log_path = os.path.join(root, "serve.log")

        def server_log() -> str:
            with open(log_path) as f:
                return f.read()[-2000:]

        with open(log_path, "w") as log:
            server = subprocess.Popen(
                [sys.executable, "-m", "colbert_torch.examples.serve", idx, "--port", str(port)]
                + dev_args, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            while _http(port, "/health")[0] != 200:
                check(server.poll() is None,
                      f"examples: serve exited with {server.returncode}: {server_log()}")
                check(time.perf_counter() - t0 < SERVE_START_S,
                      f"examples: serve not healthy in {SERVE_START_S}s")
                time.sleep(0.5)
            seconds["serve start"] = time.perf_counter() - t0
            print(f"[examples] serve start (subprocess, /health 200): "
                  f"{seconds['serve start']:.2f}s")
            replies = step(f"serve {len(served)} POST /search",
                           lambda: [_http(port, "/search", {"query": q, "k": 10}) for q in served])
            check(all(code == 200 for code, _ in replies),
                  f"examples: serve replies {[r for r in replies if r[0] != 200][:2]}")
            for q, (_, body) in zip(served, replies):
                dp, ds = after.search_batch([q], k=10)
                why = agree_up_to_ties(np.asarray(body["pids"])[None],
                                       np.asarray(body["scores"], np.float32)[None],
                                       dp, ds, TOL)
                check(why is None, f"examples: served {q!r} differs from direct search: {why}")
            health = _http(port, "/health")
            check(health[0] == 200 and health[1]["n_passages"] == n_kept,
                  f"examples: /health {health}")
            check(server.poll() is None, f"examples: serve died: {server_log()}")
        finally:
            if server.poll() is None:
                server.terminate()
                try:
                    server.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    server.kill()
                    server.wait()
        print(f"[examples] serve: {len(served)} replies equal a direct search_batch of each "
              f"query alone, up to ties at {TOL}; server stopped")
        del after

        triples_tsv, trained = os.path.join(root, "triples.tsv"), os.path.join(root, "trained")
        with open(triples_tsv, "w") as f:
            f.writelines("\t".join(t) + "\n" for t in make_triples(collection, EXAMPLES_TRIPLES))
        run("train", train, [ckpt, triples_tsv, trained])
        _, before, _ = load_checkpoint(ckpt, device=device)
        _, model, tokenizer = load_checkpoint(trained, device=device)
        moved = sum(not torch.equal(a, b) for a, b in zip(before.state_dict().values(),
                                                           model.state_dict().values()))
        check(moved > 0, "examples: train: the saved checkpoint equals its input")
        enc = ColBERTEncoder(model, tokenizer, ColBERTConfig.load(os.path.join(idx, "config.json")),
                             device=device)
        p, s = Searcher(idx, encoder=enc, device=device).search_batch(queries[:BATCH], k=10)
        check(p.shape == (BATCH, 10) and bool(((p >= 0) & (p < n_kept)).all())
              and bool(np.isfinite(s).all()), "examples: train: search with the trained encoder")
        print(f"[examples] train: the checkpoint loads back, {moved}/{len(before.state_dict())} "
              f"tensors moved; a Searcher with it answers {BATCH} queries")
        graft_check(device, step, bert_cfg)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("[examples] seconds " + json.dumps({k: round(v, 4) for k, v in seconds.items()})
          + f"; stage-2 launches {counts}; flash launches {flash}")
    check_stage2_all_mma(device, counts, "examples")
    return dict(examples_seconds=seconds, examples_launches=counts["launches"],
                examples_flash_launches=flash, examples_eval=report)


def graft_check(device, step, bert_cfg=None) -> None:
    """The forward-step hook at its defaults on the card (a bert-base
    ColBERT doc encode, B=8 L=128, bf16; ``bert_cfg`` narrows it for a
    CPU rehearsal): finite embeddings of the hook's shape, each kept
    token's within cosine IN_SITU_MIN_COS of the same model's fp32 encode
    of the same batch, and dropped tokens zero in both."""
    import torch

    from colbert_torch.graft_entry import entry
    from colbert_torch.models.colbert import ColBERT

    fn, args = entry(**({} if device.type == "cuda" else {"device": "cpu"}),
                     bert_config=bert_cfg)
    model, ids, mask, keep = args
    check(ids.device.type == device.type, f"graft_entry: args on {ids.device}, not {device}")
    fn(*args)  # warm-up
    got = step("graft_entry forward (bf16)", lambda: fn(*args))
    with torch.no_grad():
        want = ColBERT.encode_batch(model, ids, mask, keep, dtype_name="float32")
    got, want = got.float(), want.float()
    cos = float((got * want).sum(-1)[keep].min())
    zero = bool((got[~keep] == 0).all() and (want[~keep] == 0).all())
    print(f"[examples] graft_entry: {tuple(got.shape)} embeddings in bf16 against fp32: "
          f"least cosine of a kept token {cos:.6f} (limit {IN_SITU_MIN_COS}); "
          f"dropped tokens zero: {zero}")
    check(got.shape == (8, 128, 128) and bool(torch.isfinite(got).all()) and zero
          and cos >= IN_SITU_MIN_COS, f"graft_entry: bf16 vs fp32 cosine {cos}, zero {zero}")


def quality_phase(device, *, n_passages: int = QUALITY_PASSAGES,
                  steps: int = QUALITY_STEPS) -> dict:
    """[quality]: ``quality.main`` in process (its JSON line printed), every
    recall in [0, 1], and the quality-first point's stage-2 scores of the
    pids it returns within TOL of the exact oracle's (TF32 off). The point
    is picked out by its arguments, whatever order ``measure`` runs its
    searches in."""
    from colbert_torch.evaluation import quality
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.retrieval.device_index import DeviceIndex

    seen = {"quality-first": []}
    oracle, search = quality.exhaustive_scores, DeviceIndex.search_Q_batch

    def recording_oracle(searcher, Q, **kw):
        seen["oracle"] = oracle(searcher, Q, **kw)
        c = searcher.config
        seen["quality-first point"] = dict(
            nprobe=searcher.device_index.compensated_nprobe(c.nprobe),
            ncandidates=c.plaid_stage2_docs or max(16 * 100, 1024), stage1_refine=True)
        return seen["oracle"]

    def recording_search(index, Q, **kw):
        out = search(index, Q, **kw)
        # measure()'s quality-first point: the compensated nprobe, the
        # default stage-2 budget and the refine at its default width
        point = seen.get("quality-first point", {})
        if "refine_width" not in kw and point and all(kw.get(k) == v for k, v in point.items()):
            seen["quality-first"].append(out)
        return out

    reset_counts()
    quality.exhaustive_scores, DeviceIndex.search_Q_batch = recording_oracle, recording_search
    try:
        t0 = time.perf_counter()
        summary = quality.main([str(n_passages), str(steps)]
                               + ([] if device.type == "cuda" else ["--device", "cpu"]))
        dt = time.perf_counter() - t0
    finally:
        quality.exhaustive_scores, DeviceIndex.search_Q_batch = oracle, search
    counts = stage2_counts()
    flash = fa.flash_attention.launches
    # one search, or more where another point has the same arguments
    check(len(seen["quality-first"]) >= 1, "quality: no search at the quality-first point")
    pids, scores = (np.concatenate(a) for a in zip(*seen["quality-first"]))
    oscores = np.concatenate([seen["oracle"]] * len(seen["quality-first"]))
    valid = pids >= 0
    err = float(np.abs(scores[valid] - np.take_along_axis(oscores, np.maximum(pids, 0), 1)[valid])
                .max())
    recalls = {k: summary[k] for k in ("value", "recall_at_100", "score_recall_at_10",
                                       "self_retrieval_s1")}
    print(f"[quality] {n_passages} passages, {steps} training steps in {dt:.1f}s; recalls "
          f"{recalls}; the quality-first point's {int(valid.sum())} returned pids in "
          f"{len(seen['quality-first'])} search(es) of 32 queries: max |stage-2 - oracle| "
          f"{err:.3e}; stage-2 launches "
          f"{counts}; flash launches {flash}")
    check(all(0.0 <= v <= 1.0 for v in recalls.values()), f"quality: recalls {recalls}")
    check(pids.shape[0] == 32 * len(seen["quality-first"]) and np.isfinite(err) and err <= TOL,
          f"quality: stage-2 vs oracle {err} > {TOL}")
    check(all(summary[k] > 0 for k in ("qps_b64_quality", "qps_b64_quality_rw2",
                                       "qps_b64_probes_no_refine", "qps_b64_tuned")),
          "quality: a QPS is not positive")
    check_stage2_all_mma(device, counts, "quality")
    return dict(quality=summary, quality_s=dt, quality_launches=counts["launches"],
                quality_flash_launches=flash, quality_oracle_err=err)


def kernel_label(mangled: str) -> str:
    """``flash_mma_kernel<bf16,64>`` (``stage2_mma_kernel<2>``) for the
    mangled name of that instantiation of one of the repo's kernels, else
    the name as it is."""
    import re

    m = re.search(r"\d+(flash_mma_kernel|flash_kernel|stage2_mma_kernel|stage2_kernel)"
                  r"I(.+?)EEv", mangled)
    if m is None:
        return mangled
    args = re.sub(r"Li(\d+)E", r",\1", m.group(2)).lstrip(",")
    args = args.replace("13__nv_bfloat16", "bf16").replace("6__half", "fp16")
    args = {"f": "fp32", "j": "uint32", "h": "uint8"}.get(args, args)
    return f"{m.group(1)}<{args}>"


def ptxas_resources(log: str) -> list[tuple[str, str, str]]:
    """(kernel, stack and spill line, registers line) for each kernel in a
    ``-Xptxas -v`` log."""
    lines = [line.strip() for line in log.splitlines()]
    return [(kernel_label(line.split()[-1]), lines[i + 1],
             lines[i + 2].replace("ptxas info    : ", ""))
            for i, line in enumerate(lines)
            if "Function properties for" in line and i + 2 < len(lines)]


def card_line() -> str:
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:  # a CPU rehearsal
        return "no nvidia-smi"
    return done.stdout.strip().splitlines()[0] if done.returncode == 0 else "unknown"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "colbert_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    from colbert_torch.models.bert import BertConfig
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.ops import fused_maxsim as fm
    from colbert_torch.utils.build import BUILD_DIR
    from colbert_torch.utils.testing import bench_vocab_tokenizer, synthetic_passages

    # one nvcc per kernel source, started together; always from the sources
    # (a library left by an earlier run would hide ptxas's report)
    for so in ("libstage2_maxsim.so", "libflash_attention.so"):
        if os.path.exists(os.path.join(BUILD_DIR, so)):
            os.remove(os.path.join(BUILD_DIR, so))
    t0 = time.perf_counter()
    kernels_src = {"stage2_maxsim.cu": fm.build_kernel, "flash_attention.cu": fa.build_kernel}
    with ThreadPoolExecutor(len(kernels_src)) as ex:
        logs = dict(zip(kernels_src, ex.map(lambda build: build(), kernels_src.values())))
    print(f"[build] {', '.join(kernels_src)} built in {time.perf_counter() - t0:.1f}s")
    for src, log in logs.items():
        for name, spills, regs in ptxas_resources(log):
            print(f"[build] {src}: {name}: {spills}; {regs}")
    no_spill = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    for src, path_kernel in (("flash_attention.cu", "flash_mma_kernel<bf16,64>"),
                             ("stage2_maxsim.cu", "stage2_mma_kernel<2>")):
        found = [spills for name, spills, _ in ptxas_resources(logs[src]) if name == path_kernel]
        check(found == [no_spill], f"{path_kernel}: ptxas reports {found}")

    max_err = kernel_vs_plain(device)
    stage2_sweep(device)
    index_dir = os.path.join(BUILD_DIR, "smoke_index")
    try:
        mp = main_path(device, n_passages=N_PASSAGES, bert_cfg=BertConfig(),
                       index_dir=index_dir)
        check(mp["launches"] > 0 and mp["by_variant"] == {"mma": mp["launches"], "simt": 0},
              f"stage-2 launches on the main path by kernel {mp['by_variant']}, expected all mma")
        searcher = mp.pop("searcher")
        live = serve_batcher(searcher, mp["n_words"])
        live.update(serve_http(searcher, mp["n_words"]))
        live.update(tune_phase(searcher, mp["n_words"]))
        t_md = time.perf_counter()
        md = multidevice_serve(searcher, mp["n_words"], index_dir)
        md_seconds = {"serve": time.perf_counter() - t_md}
        del searcher
    finally:
        shutil.rmtree(index_dir, ignore_errors=True)

    t0 = time.perf_counter()
    passages = synthetic_passages(BUILD_PASSAGES, mean_words=BUILD_MEAN_WORDS)
    enc = build_corpus_encoder(mp.pop("encoder").model, device, build_config())
    first = next(enc._doc_batches(passages[:enc.config.index_bsize]))
    print(f"[build] corpus of {len(passages)} passages made in "
          f"{time.perf_counter() - t0:.1f}s; first batch {first[1].shape}, "
          f"flash-routed {enc._flash_for(first[1].shape[1])}")
    fl = flash_vs_plain(device, first[2])
    flash_sweep(device, first[2])
    fl.update(flash_in_situ(enc, first))

    build_dir = os.path.join(BUILD_DIR, "smoke_build_index")
    try:
        bp = build_path(enc, passages, build_dir)
        bs = build_search(enc, passages, build_dir)
        live.update(update_phase(enc, passages, build_dir))
        profile_build_steps(enc, first, build_dir)
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)
    t_md = time.perf_counter()
    md.update(multidevice_build(enc.model, passages[:MD_BUILD_PASSAGES], BUILD_DIR))
    md_seconds["build"] = time.perf_counter() - t_md
    t_md = time.perf_counter()
    md.update(multidevice_encodes(enc.model, first))
    md_seconds["encodes_kmeans_dryrun"] = time.perf_counter() - t_md
    print(f"[multidevice] seconds {json.dumps({k: round(v, 2) for k, v in md_seconds.items()})} "
          f"on {card_line()}")

    del enc
    train_cfg = BertConfig(vocab_size=len(bench_vocab_tokenizer().vocab))
    tm = train_mesh_phase(device, bert_cfg=train_cfg)
    tr = train_phase(device, bert_cfg=train_cfg, work_dir=BUILD_DIR)
    ex = examples_phase(device, BUILD_DIR)
    ql = quality_phase(device)

    print(json.dumps({"qps": mp["qps"], "stream_qps": mp["stream_qps"],
                      "stages_ms": mp["stages_ms"],
                      "build_passages_per_s": bp["passages_per_s"],
                      "build_phases": bp["timings"], "self_top1": bs["self_top1"],
                      "batcher_qps": live["batcher_qps"], "http_rps": live["http_rps"],
                      "oracle_s": live["oracle_s"], "tune_s": live["tune_s"],
                      "update_add_passages_per_s": live["update_add_pps"],
                      "update_seconds": live["update_seconds"],
                      "update_eval": live["update_eval"],
                      "train": {k: v for k, v in tr.items()
                                if k not in ("train_search_launches", "train_flash_launches")},
                      "examples_seconds": ex["examples_seconds"],
                      "examples_eval": ex["examples_eval"], "quality": ql["quality"],
                      "quality_s": ql["quality_s"],
                      "multidevice": {k: v for k, v in md.items() if k != "md_dryrun"},
                      "train_mesh": {k: v for k, v in tm.items() if k != "mesh_launches"}}))
    print(card_line())
    kernels = [dict(
        name="stage2_maxsim", route="cuda", variant="mma.sync-3xtf32",
        source="colbert_torch/csrc/stage2_maxsim.cu",
        replaces="colbert_tpu/ops/fused_maxsim.py:121",
        launches=mp["launches"], max_abs_err=max(max_err, mp["stage2_err"]),
        ms=mp["kernel_ms"], kernel_ms=mp["kernel_ms"], plain_ms=mp["plain_ms"],
        bound_ms=mp["bound_ms"], bound_by=mp["bound_by"], library_ms=None,
        simt_ms=mp["simt_ms"], fp32_bound_ms=mp["fp32_bound_ms"],
        launches_by_path={"serve": mp["launches"], "build-search": bs["search_launches"],
                          "serve-batcher": live["batcher_launches"],
                          "serve-http": live["http_launches"], "tune": live["tune_launches"],
                          "update": live["update_launches"], "train": tr["train_search_launches"],
                          "examples": ex["examples_launches"], "quality": ql["quality_launches"],
                          "multidevice": md["md_launches"],
                          "train-mesh": tm["mesh_launches"]["stage2_maxsim"]},
    ), dict(
        name="flash_attention", route="cuda", variant="mma.sync",
        source="colbert_torch/csrc/flash_attention.cu",
        replaces="colbert_tpu/ops/flash_attention.py:65",
        launches=bp["flash_launches"], max_abs_err=fl["max_abs_err"],
        ms=fl["kernel_ms"], kernel_ms=fl["kernel_ms"], plain_ms=fl["plain_ms"],
        bound_ms=fl["bound_ms"], bound_by=fl["bound_by"], library_ms=fl["library_ms"],
        launches_by_path={"build": bp["flash_launches"],
                          "update": live["update_flash_launches"],
                          "train": tr["train_flash_launches"],
                          "examples": ex["examples_flash_launches"],
                          "quality": ql["quality_flash_launches"],
                          "multidevice": md["md_flash_launches"],
                          "train-mesh": tm["mesh_launches"]["flash_attention"]},
    )]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
