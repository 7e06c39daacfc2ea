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
7. Prints the card's name and power limit, a ``kernels`` JSON line (each
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
    under the profiler's own overhead). Only device-side events (kernels,
    copies) are summed: a host-side operator's device time is that of the
    kernels it launched, which are listed themselves."""
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
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key[:70]))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms if busy_ms else "not measured",
                top=[dict(ms=ms, calls=n, op=name) for ms, n, name in rows[:10]])


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

    from colbert_torch.models.bert import BertConfig, BertLayer
    from colbert_torch.ops import flash_attention as fa

    rng = np.random.default_rng(4)
    layer = BertLayer(BertConfig())  # its attention has no weights; they stay on the host
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
        mat = lambda: layer._attention(qb, kb, vb, mask4)  # noqa: E731
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
    done = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
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
    from colbert_torch.utils.testing import synthetic_passages

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

    print(json.dumps({"qps": mp["qps"], "stream_qps": mp["stream_qps"],
                      "stages_ms": mp["stages_ms"],
                      "build_passages_per_s": bp["passages_per_s"],
                      "build_phases": bp["timings"], "self_top1": bs["self_top1"],
                      "batcher_qps": live["batcher_qps"], "http_rps": live["http_rps"],
                      "oracle_s": live["oracle_s"], "tune_s": live["tune_s"],
                      "update_add_passages_per_s": live["update_add_pps"],
                      "update_seconds": live["update_seconds"],
                      "update_eval": live["update_eval"]}))
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
                          "update": live["update_launches"]},
    ), dict(
        name="flash_attention", route="cuda", variant="mma.sync",
        source="colbert_torch/csrc/flash_attention.cu",
        replaces="colbert_tpu/ops/flash_attention.py:65",
        launches=bp["flash_launches"], max_abs_err=fl["max_abs_err"],
        ms=fl["kernel_ms"], kernel_ms=fl["kernel_ms"], plain_ms=fl["plain_ms"],
        bound_ms=fl["bound_ms"], bound_by=fl["bound_by"], library_ms=fl["library_ms"],
        launches_by_path={"build": bp["flash_launches"],
                          "update": live["update_flash_launches"]},
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
