#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``colbert_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the four CUDA sources from ``colbert_torch/csrc/`` (stage-2
   decompress+MaxSim, flash attention, the refine and k-means' nearest
   centroid; one nvcc each, started together, sm_90a) and prints the
   build time and ptxas's registers and spills per kernel instantiation;
   the paths' instantiations must not spill: the tensor-core flash
   kernel's bf16 hd=64, unwindowed and windowed, the tensor-core stage-2
   kernel's nbits 2, the refine's ``approx_maxsim_kernel<8>`` and
   ``nearest_centroid_kernel<4>``.
   ``[kmeans]``: the nearest-centroid kernel at both build cells' shapes
   (2,883,584 bf16 rows x 16,384 centroids and 1,179,648 x 8,192, dim 128):
   one launch a Lloyd pass (checked), its assignments against the plain
   fp32 ``addmm`` + ``argmax`` on 65,536 rows strided across the whole
   range (any disagreement a near tie within 1e-5 relative), then the
   kernel, a whole Lloyd pass through
   it and the plain version timed beside two bounds (the model's FLOPs at
   the bf16 rate, and the three bf16 terms' products at that rate).
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
   planner), a random-init ColBERT at bert-base width in bf16, 16 batches
   of 32 queries at k=10 plus one ``search_stream`` pass, each batch one
   captured program's replay. Against the eager entry on the same batches,
   in turns (graphed, eager, eager, graphed): QPS of ``search_batch`` and
   ``search_stream``, results equal up to ties at 1e-4, a profiled batch
   each way (device busy share); the B=32 program's replay timed with CUDA
   events, the host's time to launch it, its capture seconds and device
   memory, and one launch under
   ``torch.cuda.set_sync_debug_mode("error")``. Prints per-stage times
   (traced, so eager), checks that every stage-2 launch took the ``mma``
   kernel and was counted, and re-scores one batch with the plain
   stage-2 on the card (pids equal up to ties, scores to 1e-4). On that
   batch's own stage-2 inputs it times the ``mma`` kernel, PR 1's ``simt``
   kernel (through the wrapper's private launcher) and the plain version
   in turns with CUDA events, beside both bounds (3 TF32 products per
   fp32 product at the TF32 tensor-core peak; fp32 FMAs at the fp32 peak);
   then both kernels at B = 1, 8 and 32 queries x 1024 candidates. On
   the same batch's refine inputs (B=32 queries x 4,096 candidates) it
   holds the refine on the card (the bf16 table product and the refine
   kernel) against the same function on the CPU and against its plain
   ``embedding_bag`` route on the card (1e-4), times the kernel route and
   the plain route in turns (plain, kernel, kernel, plain) with CUDA
   events, the table product and the kernel alone beside them, beside
   three bounds: the function's (its inputs read once and its output
   written once, or the table product's bf16 FLOPs), the design's (the
   table written and read once) and the per-token figure (each valid
   token's code and Lq table entries read once at 3.35 TB/s). Every
   search of the serving passes, graphed and eager, is checked to have
   made exactly one counted refine launch.
   On the same index and searcher:
   - ``[serve-batcher]``: 256 single queries from 16 threads through a
     ``BatchingSearcher`` (max_batch 32, max_wait 5 ms, two batches in
     flight); every future resolves, each result equals a direct
     ``search_batch`` of the batch it was served in (up to ties, 1e-4),
     fewer batches than queries, none above 32, its batches replayed as
     captured programs from the batcher's thread; prints queries/s;
   - ``[serve-http]``: ``make_server`` on a free port, 128 concurrent
     ``POST /search`` from a thread pool plus one ``/search_batch``,
     ``/health`` and ``/stats``; every reply 200 and equal to direct search
     as above; prints requests/s (information);
   - ``[tune]``: the exact oracle (``exhaustive_scores``) for 32 queries,
     timed, and held against the funnel's stage-2 score of every pid it
     returns (1e-4, TF32 off); ``tune_operating_point`` on the default grid
     at balance caps 1024 and 2048 with two timed repetitions, the table
     printed, the knobs restored after the sweep, ``apply`` then a search.
   Every stage-2 launch of these phases is checked to be ``mma``, and in
   every in-process phase each search launch whose knobs run the refine
   (counted by wrapping ``DeviceIndex._static_kwargs``) one refine launch.
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
   ``[attention]``: BERT's materialized attention (the route off flash),
   whose two products take bf16 operands into fp32 on the card, against
   the fp32-upcast formulation it replaced, at B*S = 65,536 for S 128 and
   160 (the headline build's padded lengths) and 512: the output within
   one bf16 step, its time beside the upcast's and SDPA's (a yardstick);
   the gradients at S=160 within 1e-2 x their max; in situ, bert-base bf16
   embeddings of a ~110-word batch and of the S=512 corpus batch, new
   against upcast, to a minimum cosine of 0.999.
   ``[flash-window]``: ``flash_mma_window_kernel`` (ModernBERT's local
   layers, window 64) at the ``index-build.modern-long`` cell's doc batch
   (B=64, H=12, hd=64, bf16) at its shortest, mean and longest padded
   lengths S 4,224, 6,144 and 8,192, with ragged pads: one counted
   windowed ``mma`` launch (counters zeroed just before), the tile pairs
   counted, the longest and the shortest row against the plain version
   with the window on their fp32 upcast (8e-3 * max(1, |plain|), the bf16
   tolerance above), which the unwindowed kernel on the same inputs must
   fail; then the windowed kernel, the unwindowed one and the plain
   version (one batch row) timed in turns beside the windowed bound (4 hd
   FLOPs per pair inside the window of every padded row at the bf16
   peak vs q, k, v, o and the bias read or written once).
5. ``[build]``: ``Indexer.index`` builds a 20,000-passage long-document
   index (~450 words, padded to S=512) at bert-base width with bf16
   activations, the flash-routed configuration of ``bench.py``'s flash
   probe: sample encode, k-means, five chunks of fused encode+compress,
   IVF. Prints the phases, passages per second and the plan; checks the
   artifacts, that the flash kernel ran 12 times (once per layer) for
   every encoded batch, every launch through the ``mma`` kernel, and that
   the codec's k-means launched the nearest-centroid kernel once per
   Lloyd pass (the tracing counters, recorded over the build). Profiles
   one fused encode+compress batch and one Lloyd pass at the build's
   partition count.
   ``[build-modernbert]``: GTE-ModernColBERT at its published widths (22
   layers, 768 hidden, 12 heads, GeGLU 1,152, 50,368 vocabulary; random
   weights) indexes 128 passages of 4,096-8,187 words through
   ``Indexer.index`` (doc_maxlen 8,192, 128-wide buckets, flash from
   S=1,024, index_bsize 64): every encoded batch takes 8 global
   (``flash_mma_kernel``) and 14 windowed (``flash_mma_window_kernel``)
   launches, all ``mma``, none materialized; prints the build's seconds
   and the top-1 self-retrieval of 8 passages through ``Searcher``
   (random weights: information only).
   ``[build-moe]``: Moonlight-16B-A3B at every published width (27 layers,
   DeepSeek-V3's latent attention, 26 MoE layers of 64 experts, top-6, 2
   shared; 163,840 vocabulary; random bf16 weights drawn on the card)
   indexes 128 passages of 256-1,020 words through ``Indexer.index``
   (doc_maxlen 1,024, index_bsize 64): every batch counts 27 attention
   calls, 26 MoE layer calls and 52 grouped expert launches; then 8
   queries through ``Searcher`` three times, the last two replays of the
   captured serving program with the expert layer inside (52 grouped
   launches a search counted).
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
   parameters 1e-2 x lr), remat on against off at full depth (loss
   1e-6 relative, gradients 1e-3 x their max; peak memory of each), and
   a full-depth step through the card's bf16 attention route against the
   same step with the fp32-upcast attention standing in for it (the
   route's hand-written backward in situ; limits ATTN_STEP_*), and four
   steps of the 2-layer fp32 model through the trainer's captured step
   against ``make_train_step`` op by op from the same state (warm-up and
   cosine, clipping; loss 1e-5 relative, gradients 1e-4 x their max,
   parameters 1e-2 x lr, the lr the schedule's). Then 300 steps, each a
   replay of the captured step from the second on: median ms per step
   after 3 warm-up steps, steps/s, triples/s, tokens/s and model TFLOP/s,
   the loss at steps 1-3 and every 50, no flash launch, the last 20 steps'
   mean loss below the first 20's. Then the captured step against the same
   step op by op, 20 steps each in turns (graphed, eager, eager, graphed),
   one launch under ``set_sync_debug_mode("error")``, one step of each
   route profiled (busy share, kernels run), the capture's seconds and
   pool bytes. The checkpoint is saved and loaded back bit for bit
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
12. ``[bench]``: the port's benchmark scripts as subprocesses, the way a
   user runs them, each within its own time limit: ``bench_torch.py`` at
   its defaults (4,096 passages, bert-base, bf16): exit 0, stdout exactly
   seven identical four-key ``index_build_passages_per_sec`` lines with a
   positive value, no flash launch in the headline build, 12 ``mma`` flash
   launches per ``flash_probe`` batch, every serving stage-2 launch
   ``mma``, some refine launches but fewer than stage-2 launches (its
   tuned points run without the refine); ``bench_mfu_torch.py 128``,
   ``bench_scale_torch.py 16384`` and ``bench_sharded_torch.py`` over a
   65,536-passage ``synthesize_index`` index on 4 shards of the card:
   exit 0 and the JSON summary with its keys as the last line. Every
   stage-2 score ``bench_torch.py``'s serving stage returns (B=128 and
   B=64 batches, the funnel's three points, the self-retrieval probe) is
   within TOL of the exact MaxSim of its pid.
   Prints each script's stderr, seconds and summary; the ``kernels``
   line's ``bench`` entries count only ``bench_torch.py``'s serving stage
   (stage 2, the refine) and ``flash_probe`` (flash), as that script logs
   them.
13. Prints the card's name and power limit, a ``kernels`` JSON line (each
   of the four kernels' launches on the main path and by path, its time,
   its plain version's and its bound), and as the last line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Without a GPU, or outside
a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import gc
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
# [kmeans]: (cell, bf16 rows, centroids) of the build cells' Lloyd passes:
# the padded sample buffer's rows, zero-weight padding included, as the
# cells' kmeans_assign_rows counters read them
KMEANS_SHAPES = (("index-build.large", 2_883_584, 16_384),
                 ("index-build.modern-long", 1_179_648, 8_192))
KMEANS_CHECK_ROWS = 65_536  # rows held against the plain version at each shape
N_PASSAGES = 141_431
BATCH = 32
N_BATCHES = 3
SERVE_BATCHES = 16          # [serve]: batches of each pass, captured and eager
BUILD_PASSAGES = 20_000
BUILD_MEAN_WORDS = 450
IN_SITU_TOL = 5e-4          # tests/test_flash_attention.py:72
IN_SITU_MIN_COS = 0.999     # bf16 embeddings with vs without the kernel
# [train] check 3, bf16 steps through the attention route vs the upcast, on
# [train]'s first three batches. Read on an NVIDIA H100 80GB HBM3 (700 W):
# loss 2.9e-4 relative, gradients 0.064 of their norm (the word embedding's),
# key bias 4.7e-7 of the largest |g|, at most.
ATTN_STEP_LOSS_REL = 1e-3
ATTN_STEP_GRAD_REL = 0.1
ATTN_STEP_KBIAS = 1e-5
SWEEP_ROWS = 65_536         # B*S of each [flash] sweep shape
WINDOW = 64                 # [flash-window]: ModernBERT's local half-width
WINDOW_B = 64               # the index-build.modern-long cell's doc batch
WINDOW_SHAPES = (4224, 6144, 8192)  # its shortest, mean and longest padded lengths
MB_PASSAGES = 128           # [build-modernbert]: two doc batches of 64
MB_WORDS = (4096, 8188)     # words per passage (the cell's range)
MOE_PASSAGES = 128          # [build-moe]: two doc batches of 64
MOE_WORDS = (256, 1021)     # words per passage (index-build.moe-chunks' range)
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
GRAPH_CHECK_STEPS = 4       # [train]: the captured step vs eager (warmup 2, cosine to 4)
TRAIN_TURN_STEPS = 20       # [train]: steps per turn, captured step vs eager
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
BENCH_SHARDED_PASSAGES = 65_536  # [bench]: the synthesized index bench_sharded_torch serves
# [bench]: each benchmark script's arguments (the sharded one's index comes
# first) and its wall-clock limit in seconds
BENCH_RUNS = {"bench_torch.py": ([], 420), "bench_mfu_torch.py": (["128"], 180),
              "bench_scale_torch.py": (["16384"], 300),
              "bench_sharded_torch.py": (["32", "--devices", "4"], 180)}
HEADLINE_KEYS = ["metric", "value", "unit", "vs_baseline"]
BENCH_STAGES = ["build", "encode_stages", "device_mfu_stage", "flash_probe",
                "serve_and_probe", "host_backend_stage"]
# the last stdout line of the other three scripts (CHANGES.md lists them)
BENCH_SUMMARY_KEYS = {
    "bench_mfu_torch.py": ["metric", "seqlen", "unit", "value"],
    "bench_scale_torch.py": ["metric", "n_passages", "value", "unit", "vs_baseline",
                             "build_seconds", "peak_host_rss_gb", "device_gb", "index_gb",
                             "qps_b64_tuned", "qps_b64_stream_tuned",
                             "qps_b64_stream_quality", "self_retrieval_s1",
                             "score_recall_at_10"],
    "bench_sharded_torch.py": ["metric", "n_passages", "value", "unit", "per_shard_gb",
                               "total_device_gb", "peak_host_rss_gb", "qps_one_card",
                               "probe_dup_max"],
}


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

    reset_counts()
    results, dt, streamed, dt_stream = serve_pass(searcher, batches[1:])
    counts = search_counts()
    launches = counts["launches"]
    by_variant = {v: counts[v] for v in ("mma", "simt")}
    qps = batch * n_batches / dt
    route = "captured program" if device.type == "cuda" else "eager (CPU)"
    print(f"[serve] search_batch ({route}): {n_batches} x B={batch} in {dt:.4f}s -> "
          f"QPS {qps:.2f}; search_stream: {dt_stream:.4f}s -> QPS "
          f"{batch * n_batches / dt_stream:.2f}; stage2 kernel launches {launches} "
          f"(by kernel {by_variant}); refine kernel launches {counts['refine']} for "
          f"{counts['refine_batches']} batches with the refine on")
    # every batch of both passes runs the refine at the default knobs
    check_search_launches(device, counts, "serve", refine_batches=2 * n_batches)

    for (p, s), (p2, s2) in zip(results, streamed):
        check(p.shape == (batch, 10) and s.shape == (batch, 10), "result shape")
        check(bool(((p >= 0) & (p < n_passages)).all()), "pids out of range")
        check(bool(np.isfinite(s).all()), "non-finite scores")
        check(bool((np.diff(s, axis=1) <= 1e-6).all()), "scores not descending")
        why = agree_up_to_ties(p, s, p2, s2, TOL)
        check(why is None, f"search_stream differs from search_batch: {why}")
    program = program_phase(searcher, batches, results, (dt, dt_stream)) \
        if device.type == "cuda" else {}

    tracer = Tracer()
    searcher.tracer = tracer
    for b in batches[1:]:
        searcher.search_batch(b, k=10)
    searcher.tracer = None
    stages = {k: v["seconds"] / v["count"] * 1e3 for k, v in tracer.as_dict().items()}
    print("[serve] per-stage ms per batch (traced, device synchronized per stage): "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}))


    # re-score one batch with the plain stage-2 on the card, keeping its
    # stage-2 inputs for the kernel timing
    pk, sk = results[0]
    recorded = {}

    def plain_recording(*args, **kw):
        names = ("Q", "offs", "dls", "codes", "residuals", "centroids", "bucket_weights")
        recorded.update(args=dict(zip(names, args)), kw=kw)
        return fm.stage2_maxsim_plain(*args, **kw)

    refine_fn = di._approx_maxsim

    def refine_recording(index, Q, pids, **kw):
        recorded.update(refine=(index, Q, pids))
        return refine_fn(index, Q, pids, **kw)

    kernel_fn = di.stage2_maxsim
    di.stage2_maxsim, di._approx_maxsim = plain_recording, refine_recording
    try:
        with eager_route(searcher):  # a captured program never re-enters Python
            pp, sp = searcher.search_batch(batches[1], k=10)
    finally:
        di.stage2_maxsim, di._approx_maxsim = kernel_fn, refine_fn
    why = agree_up_to_ties(pk, sk, pp, sp, TOL)
    err = float(np.abs(sk - sp).max())
    print(f"[serve] plain stage-2 re-score: max |score diff| {err:.3e}, "
          f"pids agree up to ties: {why is None}")
    check(why is None, f"kernel vs plain stage-2 on the main path: {why}")
    timing = time_stage2(recorded["args"], recorded["kw"]) if device.type == "cuda" else {}
    if device.type == "cuda":
        timing.update(refine_check(*recorded["refine"]))
        timing.update(stage_costs(searcher, *recorded["refine"]))
    return dict(qps=qps, stream_qps=batch * n_batches / dt_stream,
                launches=launches, by_variant=by_variant, refine_launches=counts["refine"],
                stages_ms=stages,
                rescore_err=err, encoder=enc, searcher=searcher, n_words=n_words,
                program=program, **timing)


def serve_pass(searcher, batches) -> tuple:
    """Every batch through ``search_batch``, then all of them through
    ``search_stream`` -> (results, seconds, streamed results, seconds)."""
    t0 = time.perf_counter()
    results = [searcher.search_batch(b, k=10) for b in batches]
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    streamed = list(searcher.search_stream(batches, k=10))
    return results, dt, streamed, time.perf_counter() - t0


@contextlib.contextmanager
def eager_route(searcher):
    """The searcher's index launching every batch through the eager entry
    (``DeviceIndex._search_tokens_eager``), the yardstick of the captured
    route: the same funnel op by op."""
    dix = searcher.device_index
    dix.search_tokens_batch_async = dix._search_tokens_eager
    try:
        yield
    finally:
        del dix.search_tokens_batch_async


def program_phase(searcher, batches, graphed, graphed_s) -> dict:
    """[serve] on the card: the captured route against the eager entry on
    the same batches, in turns (graphed, eager, eager, graphed) through
    ``search_batch`` and ``search_stream``: QPS, results equal up to ties at
    TOL; the B=32 program's replay timed with CUDA events; capture seconds,
    programs and the device memory they hold; one launch under
    ``set_sync_debug_mode("error")``; a profiled batch each way."""
    import torch

    queries = batches[1:]
    n = sum(len(b) for b in queries)
    dix = searcher.device_index
    reset_counts()
    with eager_route(searcher):
        e1 = serve_pass(searcher, queries)
        e2 = serve_pass(searcher, queries)
    eager_counts = search_counts()
    reset_counts()
    g2 = serve_pass(searcher, queries)
    graphed_counts = search_counts()
    # each pass searches every batch twice (search_batch, search_stream),
    # every search with the refine on: one refine launch each, eager or replayed
    check_search_launches(searcher.device, eager_counts, "serve eager",
                          refine_batches=4 * len(queries))
    check_search_launches(searcher.device, graphed_counts, "serve graphed",
                          refine_batches=2 * len(queries))
    turns = {"graphed": [graphed_s, (g2[1], g2[3])], "eager": [(e1[1], e1[3]), (e2[1], e2[3])]}
    for (p, s), (pe, se), (p2, s2) in zip(graphed, e1[0], g2[0]):
        why = agree_up_to_ties(p, s, pe, se, TOL)
        check(why is None, f"serve: the captured program differs from the eager entry: {why}")
        why = agree_up_to_ties(p, s, p2, s2, TOL)
        check(why is None, f"serve: two passes of the captured program differ: {why}")
    qps = {route: [[round(n / t, 2) for t in pair] for pair in pairs]
           for route, pairs in turns.items()}

    ids, mask = searcher.encoder.tensorize_queries(queries[0])
    kw = searcher._search_kwargs(10)
    launch_ms = []  # the host's time to launch a tokenized batch
    for _ in range(10):
        t0 = time.perf_counter()
        pending = dix.search_tokens_batch_async(searcher.encoder, ids, mask, **kw)
        launch_ms.append((time.perf_counter() - t0) * 1e3)
        dix.finalize(pending)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = dix.search_tokens_batch_async(searcher.encoder, ids, mask, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    why = agree_up_to_ties(*dix.finalize(pending), *graphed[0], TOL)
    check(why is None, f"serve: the launch under sync debug mode differs: {why}")

    prog = next(p for p in dix.programs.programs() if p.inputs[0].shape[0] == len(queries[0]))
    replay = [time_ms(prog.graph.replay, 20) for _ in range(2)]
    stats = dix.programs.stats()
    graphed_prof = profile_batch(searcher, queries[0])
    with eager_route(searcher):
        eager_prof = profile_batch(searcher, queries[0])
    print(f"[serve] captured program vs eager entry, {len(queries)} batches of "
          f"{len(queries[0])}, QPS [search_batch, search_stream] in turns (graphed, eager, "
          f"eager, graphed): {json.dumps(qps)}; results equal up to ties at {TOL}; "
          f"B={len(queries[0])} replay_ms={replay[0]:.4f},{replay[1]:.4f} (CUDA events), "
          f"launch host ms median {float(np.median(launch_ms)):.4f} of 10; "
          f"programs {stats['held']} held, {stats['built']} built, capture "
          f"{stats['capture_s']:.3f}s, pool {stats['pool_bytes'] / 2**20:.1f} MiB, replays "
          f"{stats['replays']}; refine kernel launches eager {eager_counts['refine']} and "
          f"graphed {graphed_counts['refine']}, one per batch; one launch under sync debug "
          f"mode 'error' passed; device busy "
          f"share graphed {graphed_prof['busy_share']} ({graphed_prof['device_busy_ms']:.3f} of "
          f"{graphed_prof['wall_ms']:.3f} ms), eager {eager_prof['busy_share']} "
          f"({eager_prof['device_busy_ms']:.3f} of {eager_prof['wall_ms']:.3f} ms) on "
          f"{card_line()}")
    print("[profile] graphed batch " + json.dumps(graphed_prof))
    print("[profile] eager batch " + json.dumps(eager_prof))
    return dict(qps=qps, replay_ms=replay, launch_host_ms=float(np.median(launch_ms)),
                programs=stats,
                busy_share={"graphed": graphed_prof["busy_share"],
                            "eager": eager_prof["busy_share"]},
                wall_ms={"graphed": graphed_prof["wall_ms"], "eager": eager_prof["wall_ms"]})


def refine_bounds(index, Q, pids) -> dict:
    """The least time, in ms at the H100's published peaks, for the refine
    on these inputs -> {"function": (ms, "bytes" or "operations"),
    "design": (ms, ...), "token": ms}. ``function``: what the function must
    move (Q, the (B, W) offsets and doclens, the valid tokens' codes and the
    centroids read once, the (B, W) output written once) against what its
    table formulation computes (2*B*K*Lq*dim bf16 FLOPs on the tensor
    cores), the larger; ``design``: the kernel's design, whose (B, K, Lq)
    fp32 table is written and read once beside the codes, offsets, doclens
    and output, against the same FLOPs; ``token``: the per-token figure, each
    valid token's code and its Lq table entries read once."""
    B, W = pids.shape
    Lq, dim = Q.shape[1:]
    K = index.centroids.shape[0]
    tokens = int(index.doclens[pids].sum())
    flops = 2 * B * K * Lq * dim
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    pairs = B * W * (8 + 4 + 4)  # offsets, doclens, output
    moved = {"function": Q.numel() * 4 + pairs + tokens * 4 + K * dim * 4,
             "design": 2 * B * K * Lq * 4 + pairs + tokens * 4}
    out = {}
    for name, nbytes in moved.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    out["token"] = tokens * 4 * (1 + Lq) / PEAK_BYTES * 1e3
    out["tokens"] = tokens
    return out


def refine_check(index, Q, pids) -> dict:
    """On one served batch's refine inputs: the refine on the card (the
    table product and the kernel, through ``device_index._approx_maxsim``)
    against the same function on the CPU and against its plain
    ``embedding_bag`` route on the card (TOL); the kernel route and the
    plain route timed in turns (plain, kernel, kernel, plain) with CUDA
    events, the table product and the kernel alone beside them, and the
    three bounds of :func:`refine_bounds`."""
    import types

    import torch

    from colbert_torch.ops import approx_maxsim as am
    from colbert_torch.retrieval import device_index as di

    with torch.no_grad():
        cpu_index = types.SimpleNamespace(
            max_doclen=index.max_doclen,
            **{n: getattr(index, n).cpu() for n in ("centroids", "codes", "emb_offsets",
                                                    "doclens")})
        t0 = time.perf_counter()
        want = di._approx_maxsim(cpu_index, Q.cpu(), pids.cpu())
        cpu_s = time.perf_counter() - t0

        def kernel():
            return di._approx_maxsim(index, Q, pids)

        def plain():
            return am.approx_maxsim_plain(Q, index.emb_offsets[pids], index.doclens[pids],
                                          index.codes, index.centroids,
                                          max_doclen=index.max_doclen)

        got = kernel()
        err = float((got.cpu() - want).abs().max())
        err_plain = float((got - plain()).abs().max())
        p1 = time_ms(plain, 5)
        k1, k2 = time_ms(kernel, 20), time_ms(kernel, 20)
        p2 = time_ms(plain, 5)
        offs, dls = index.emb_offsets[pids], index.doclens[pids]
        table = am.score_table(Q, index.centroids)
        table_ms = time_ms(lambda: am.score_table(Q, index.centroids), 20)
        gather_ms = time_ms(lambda: am._launch(table, offs, dls, index.codes), 20)
    B, W = pids.shape
    Lq = Q.shape[1]
    bounds = refine_bounds(index, Q, pids)
    chunk = max(1, di.REFINE_CHUNK_BYTES // di.refine_column_bytes(B, index.max_doclen, Lq))
    print(f"[serve] refine on one batch's inputs (B={B} W={W} Ld={index.max_doclen} Lq={Lq}, "
          f"{bounds['tokens']} valid tokens): kernel route (table product + kernel) vs CPU "
          f"max_abs_err={err:.3e}, vs the plain route on the card {err_plain:.3e} (limit {TOL}; "
          f"CPU {cpu_s:.2f}s); in turns plain_ms={p1:.4f},{p2:.4f} ({-(-W // chunk)} "
          f"embedding_bag chunks of {chunk} columns) kernel_ms={k1:.4f},{k2:.4f} (table "
          f"product {table_ms:.4f}, kernel alone {gather_ms:.4f}); bound_ms="
          f"{bounds['function'][0]:.4f} ({bounds['function'][1]}; the function) design_bound_ms="
          f"{bounds['design'][0]:.4f} ({bounds['design'][1]}; the table written and read once) "
          f"token_bound_ms={bounds['token']:.4f} (bytes; each token's code and Lq table "
          f"entries) on {card_line()}")
    check(np.isfinite(err) and err <= TOL, f"refine: card vs CPU {err} > {TOL}")
    check(np.isfinite(err_plain) and err_plain <= TOL,
          f"refine: kernel vs plain route on the card {err_plain} > {TOL}")
    return dict(refine_err=err, refine_plain_err=err_plain, refine_ms=(k1 + k2) / 2,
                refine_plain_ms=(p1 + p2) / 2, refine_table_ms=table_ms,
                refine_gather_ms=gather_ms, refine_bound_ms=bounds["function"][0],
                refine_bound_by=bounds["function"][1],
                refine_design_bound_ms=bounds["design"][0],
                refine_token_bound_ms=bounds["token"], refine_tokens=bounds["tokens"])


def graph_replay_ms(fn, reps: int = 20) -> float:
    """``fn`` captured alone into a CUDA graph (after one eager run on the
    capture stream) -> the replay's ms, CUDA-event timed."""
    import torch

    from colbert_torch.retrieval.program import capture

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with capture(graph, stream):
        fn()
    return time_ms(graph.replay, reps)


def stage_costs(searcher, index, Q, pids) -> dict:
    """The tuner's refine weight (ROADMAP C15) re-measured on captured
    programs: stage 1 and the refine of one served batch (``pids``, its
    refine window, and ``Q``), each captured alone on that batch's inputs
    and replayed -> ms per stage-1 entry (Lq x nprobe x cell_cap per query),
    ms per refine row (window x max doclen per query, as the tuner's
    ``cost()`` counts them) and their ratio, the weight of a refine row in
    stage-1 entries."""
    import torch

    from colbert_torch.retrieval import device_index as di

    B, Lq = Q.shape[:2]
    st = index._static_kwargs(Lq, **searcher._search_kwargs(10))
    with torch.no_grad():
        probe, cells = di._probe_topk(index, Q, st["nprobe"])
        stage1_ms = graph_replay_ms(lambda: di._stage1(
            index, probe, cells, cell_cap=st["cell_cap"],
            centroid_threshold=st["centroid_threshold"]))
        refine_ms = graph_replay_ms(lambda: di._approx_maxsim(index, Q, pids))
    entries = Lq * st["nprobe"] * st["cell_cap"]
    rows = pids.shape[1] * index.max_doclen
    weight = (refine_ms / rows) / (stage1_ms / entries)
    print(f"[serve] captured alone on one batch's inputs (B={B}): stage 1 {stage1_ms:.4f} ms "
          f"for {entries} entries per query, the refine {refine_ms:.4f} ms for {rows} rows "
          f"per query -> a refine row weighs {weight:.4f} stage-1 entries (the tuner's "
          f"_W_REFINE_ROW: 0.13) on {card_line()}")
    return dict(refine_cost_stage1_ms=stage1_ms, refine_cost_refine_ms=refine_ms,
                refine_cost_weight=weight)


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
                kernels=sum(n for _, n, name in rows if kernel_kind(name) != "memcpy"),
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


def window_bound_ms(B, H, S, hd, window, itemsize) -> tuple[float, str]:
    """Least time of a windowed launch at these shapes: 4*hd operations per
    (query, key) pair inside the window of every padded row at the bf16
    tensor-core peak vs q, k, v, o (and the bias) read or written once."""
    m = min(window, S - 1)
    pairs = S + 2 * m * S - m * (m + 1)
    t_ops = 4 * B * H * pairs * hd / PEAK_BF16_FLOPS * 1e3
    t_bytes = (4 * B * H * S * hd * itemsize + B * S * 4) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_window_phase(device) -> dict:
    """[flash-window]: the windowed kernel at the modern-long cell's padded
    shapes against the plain version, then timed -> per S the times,
    bound and error."""
    import torch

    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.utils import tracing

    rng = np.random.default_rng(21)
    B, H, hd = WINDOW_B, 12, 64
    out = {}
    for S in WINDOW_SHAPES:
        # ragged as the cell's buckets make them: the longest row ends in
        # the last 128-token tile, the others anywhere from 4,099 tokens
        lens = rng.integers(min(4099, S - 127), S + 1, B)
        lens[0] = S - int(rng.integers(0, 128))
        mask = np.arange(S)[None] < lens[:, None]
        q, k, v, bias = flash_inputs(rng, device, B, H, S, hd, torch.bfloat16, mask)
        fa.flash_attention.launches = fa.flash_attention.window_launches = 0
        fa.flash_attention.variant_launches.update(mma=0, simt=0)
        with tracing.recording() as t:
            got = fa.flash_attention(q, k, v, bias, num_heads=H, window=WINDOW)
        torch.cuda.synchronize()
        counts = (fa.flash_attention.launches, fa.flash_attention.window_launches,
                  fa.flash_attention.variant_launches["mma"])
        check(counts == (1, 1, 1), f"[flash-window] S={S}: launches, windowed, mma {counts}")
        check(t.counters == {"attn_window_tile_pairs": B * H * fa.window_tile_pairs(S, WINDOW)},
              f"[flash-window] S={S}: counters {t.counters}")
        full = fa.flash_attention(q, k, v, bias, num_heads=H)
        worst, ok, full_ok = 0.0, True, True
        for b in (int(lens.argmax()), int(lens.argmin())):
            rows = slice(b * H, (b + 1) * H)
            want = fa.flash_attention_plain(q[rows].float(), k[rows].float(), v[rows].float(),
                                            bias[b:b + 1], num_heads=H, window=WINDOW)
            real = torch.from_numpy(mask[b]).to(device)[None, :, None].expand_as(want)
            tol = 8e-3 * want.abs().clamp(min=1.0)
            err = (got[rows].float() - want).abs()
            ok &= bool(((err <= tol) | ~real).all())
            full_ok &= bool((((full[rows].float() - want).abs() <= tol) | ~real).all())
            worst = max(worst, float(err[real].max()))
            del want, real, tol, err
        check(np.isfinite(worst) and ok, f"[flash-window] S={S}: max_abs_err {worst}")
        check(not full_ok, f"[flash-window] S={S}: the unwindowed kernel is within the "
                           "tolerance, which then cannot tell the window")
        del got, full
        kern = lambda: fa.flash_attention(q, k, v, bias, num_heads=H, window=WINDOW)  # noqa: E731
        unwin = lambda: fa.flash_attention(q, k, v, bias, num_heads=H)  # noqa: E731
        plain = lambda: fa.flash_attention_plain(  # noqa: E731
            q[:H], k[:H], v[:H], bias[:1], num_heads=H, window=WINDOW)
        k1 = time_ms(kern, 10)
        u1 = time_ms(unwin, 3)
        p1 = time_ms(plain, 3)
        k2 = time_ms(kern, 10)
        bound, by = window_bound_ms(B, H, S, hd, WINDOW, 2)
        print(f"[flash-window] B={B} H={H} S={S} hd={hd} w={WINDOW} bf16: "
              f"kernel_ms={k1:.4f},{k2:.4f} unwindowed_ms={u1:.4f} plain_ms_one_row={p1:.4f} "
              f"bound_ms={bound:.4f} ({by}) max_abs_err={worst:.3e} within tolerance: {ok}; "
              f"unwindowed within it: {full_ok}")
        out[S] = dict(kernel_ms=(k1 + k2) / 2, unwindowed_ms=u1, plain_ms_one_row=p1,
                      bound_ms=bound, bound_by=by, max_abs_err=worst)
        del q, k, v, bias
        torch.cuda.empty_cache()
    return out


def modernbert_build(device, work_dir: str) -> dict:
    """[build-modernbert]: a GTE-ModernColBERT index through the kernels ->
    launches, seconds and the self-retrieval count."""
    import torch

    from colbert_torch.config import ColBERTConfig
    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.models.colbert import init_colbert
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.models.modernbert import ModernBertConfig
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.tokenization.wordpiece import WordPieceTokenizer
    from colbert_torch.utils import tracing
    from colbert_torch.utils.testing import make_vocab

    cfg = ModernBertConfig()
    model = init_colbert(cfg, 128, generator=torch.Generator().manual_seed(21))
    ccfg = ColBERTConfig(dim=128, doc_maxlen=8192, query_maxlen=32, index_bsize=64,
                         length_bucket=128, use_pallas=True, flash_min_seqlen=1024,
                         nbits=2, kmeans_niters=4)
    enc = ColBERTEncoder(model, WordPieceTokenizer(make_vocab(cfg.vocab_size - 52)), ccfg,
                         device=device)
    rng = np.random.default_rng(21)
    passages = [" ".join(f"w{j}" for j in rng.integers(0, cfg.vocab_size - 52, n))
                for n in rng.integers(*MB_WORDS, MB_PASSAGES)]
    path = os.path.join(work_dir, "smoke_modernbert_index")
    reset_counts()
    fa.flash_attention.window_launches = 0
    try:
        t0 = time.perf_counter()
        with tracing.recording() as t:
            Indexer(ccfg, encoder=enc, collection=passages, device=device).index(
                path, overwrite=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        c = t.counters
        batches = c.get("doc_batches", 0)
        launches = (c.get("attn_global_launches", 0), c.get("attn_window_launches", 0),
                    c.get("attn_materialized_launches", 0))
        print(f"[build-modernbert] {MB_PASSAGES} passages in {seconds:.2f}s "
              f"({MB_PASSAGES / seconds:.1f} passages/s, first build); {batches} doc batches; "
              f"global, windowed, materialized launches {launches}; flash launches by kernel "
              f"{fa.flash_attention.variant_launches}, windowed {fa.flash_attention.window_launches}")
        check(batches > 0 and launches == (8 * batches, 14 * batches, 0),
              f"[build-modernbert] launches {launches} over {batches} batches, expected 8 "
              "global, 14 windowed and 0 materialized a batch")
        check(fa.flash_attention.variant_launches == {"mma": 22 * batches, "simt": 0}
              and fa.flash_attention.window_launches == 14 * batches,
              f"[build-modernbert] kernel launches {fa.flash_attention.variant_launches}, "
              f"windowed {fa.flash_attention.window_launches}")
        searcher = Searcher(path, encoder=enc, config=ccfg, device=device)
        pids, scores = searcher.search_batch([" ".join(p.split()[:25]) for p in passages[:8]],
                                             k=5)
        check(pids.shape == (8, 5) and bool(np.isfinite(scores).all()),
              f"[build-modernbert] search gave {pids.shape}")
        top1 = int((pids[:, 0] == np.arange(8)).sum())
        print(f"[build-modernbert] self-retrieval top-1 {top1}/8 (random weights: "
              f"information only) on {card_line()}")
        del searcher
    finally:
        shutil.rmtree(path, ignore_errors=True)
    flash = fa.flash_attention.launches
    del enc, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(seconds=seconds, batches=batches, flash_launches=flash, self_top1=top1)


def moe_build(device, work_dir: str) -> dict:
    """[build-moe]: a Moonlight-16B-A3B ColBERT index (DeepSeek-V3 block at
    every published width, bf16 matrices drawn on the card) -> launches,
    seconds and the self-retrieval count."""
    import torch

    from colbert_torch.config import ColBERTConfig
    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.models.colbert import ColBERT
    from colbert_torch.models.deepseek_v3 import DeepseekV3Config
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.tokenization.wordpiece import WordPieceTokenizer
    from colbert_torch.utils import tracing
    from colbert_torch.utils.testing import make_vocab

    cfg = DeepseekV3Config()
    # 15.6 B parameters: built on the card in bf16 (fp32 would take 62.5 GB)
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.bfloat16)
    try:
        with torch.device(device):
            model = ColBERT(cfg, 128)
    finally:
        torch.set_default_dtype(default)
    g = torch.Generator(device=device).manual_seed(25)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith("scale"):
                p.normal_(0.0, 0.02, generator=g)
        for layer in model.bert.layers[1:]:
            layer.mlp.router_bias.normal_(0.0, 0.02, generator=g)
    ccfg = ColBERTConfig(dim=128, doc_maxlen=1024, query_maxlen=32, index_bsize=64,
                         length_bucket=64, use_pallas=True, flash_min_seqlen=2048, nbits=2,
                         kmeans_niters=4)
    enc = ColBERTEncoder(model, WordPieceTokenizer(make_vocab(cfg.vocab_size - 52)), ccfg,
                         device=device)
    rng = np.random.default_rng(25)
    passages = [" ".join(f"w{j}" for j in rng.integers(0, cfg.vocab_size - 52, n))
                for n in rng.integers(*MOE_WORDS, MOE_PASSAGES)]
    path = os.path.join(work_dir, "smoke_moe_index")
    try:
        t0 = time.perf_counter()
        with tracing.recording() as t:
            Indexer(ccfg, encoder=enc, collection=passages, device=device).index(
                path, overwrite=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        c = t.counters
        batches = c.get("doc_batches", 0)
        counts = (c.get("attn_mla_calls", 0), c.get("moe_layer_calls", 0),
                  c.get("moe_grouped_launches", 0))
        print(f"[build-moe] {MOE_PASSAGES} passages in {seconds:.2f}s "
              f"({MOE_PASSAGES / seconds:.1f} passages/s, first build); {batches} doc batches; "
              f"attention, MoE layer calls, grouped launches {counts}; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        check(batches > 0 and counts == (27 * batches, 26 * batches, 52 * batches),
              f"[build-moe] counts {counts} over {batches} batches, expected 27 attention "
              "calls, 26 MoE layer calls and 52 grouped launches a batch")
        searcher = Searcher(path, encoder=enc, config=ccfg, device=device)
        queries = [" ".join(p.split()[:25]) for p in passages[:8]]
        with tracing.recording() as t:
            for _ in range(3):  # warm-up and capture, then replays
                pids, scores = searcher.search_batch(queries, k=5)
        check(pids.shape == (8, 5) and bool(np.isfinite(scores).all())
              and t.counters.get("program_replays", 0) == 2
              and t.counters.get("moe_grouped_launches", 0) == 3 * 52,
              f"[build-moe] search gave {pids.shape}, counters {t.counters}")
        top1 = int((pids[:, 0] == np.arange(8)).sum())
        print(f"[build-moe] served queries replayed with the expert layer; self-retrieval "
              f"top-1 {top1}/8 (random weights: information only) on {card_line()}")
        del searcher
    finally:
        shutil.rmtree(path, ignore_errors=True)
    del enc, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(seconds=seconds, batches=batches, counts=counts, self_top1=top1)


def upcast_stand_in(q, k, v, mask_bias, num_heads: int, use_flash: bool = False):
    """``models.bert.upcast_attention`` with ``_attention``'s arguments, so
    it can stand in for the card's bf16-operand route inside a forward or a
    training step."""
    from colbert_torch.models import bert

    check(not use_flash, "upcast_stand_in stands in for the materialized route only")
    return bert.upcast_attention(q, k, v, mask_bias, num_heads)


def attention_phase(enc, batches) -> dict:
    """BERT's materialized attention on bf16 operands with fp32 products
    (``models.bert._attention`` on the card) against the upcast formulation:
    at B*S = SWEEP_ROWS for the headline's S 128 and 160 and the build's
    512 (bert-base heads, each row's length drawn from [S/2, S]), the
    output within one bf16 step, times beside SDPA with the same mask (a
    yardstick); at S=160 the gradients of q, k, v within 1e-2 x their max;
    in situ, bert-base embeddings of each of ``batches`` with the new
    branch against the upcast one, minimum cosine over kept tokens 0.999."""
    import torch
    import torch.nn.functional as F

    from colbert_torch.models import bert

    device = torch.device("cuda")
    a = torch.ones(2, 4, 8, device=device, dtype=torch.bfloat16, requires_grad=True)
    try:
        torch.bmm(a, a.mT, out_dtype=torch.float32).sum().backward()
        derivative = "has a derivative"
    except RuntimeError as e:
        derivative = f"has no derivative ({e})"
    print(f"[attention] torch {torch.__version__}: aten::bmm.dtype {derivative}; the route's "
          "backward is models.bert._MatmulF32's")
    rng = np.random.default_rng(5)
    out = {"shapes": {}}
    for S in (128, 160, 512):
        B = SWEEP_ROWS // S
        q, k, v = (torch.from_numpy(rng.standard_normal((B, S, 768)).astype(np.float32))
                   .to(device, torch.bfloat16) for _ in range(3))
        lens = rng.integers(S // 2, S + 1, B)
        mask = np.arange(S)[None] < lens[:, None]
        bias = torch.from_numpy(np.where(mask, 0.0, np.finfo(np.float32).min)
                                .astype(np.float32)).to(device)[:, None, None, :]
        new = lambda: bert._attention(q, k, v, bias, 12)  # noqa: E731
        old = lambda: bert.upcast_attention(q, k, v, bias, 12)  # noqa: E731
        qs, ks, vs = (x.view(B, S, 12, 64).transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, attn_mask=bias.to(torch.bfloat16))
        with torch.no_grad():
            got, want = new().float(), old().float()
            err = (got - want).abs()
            ok = bool((err <= 8e-3 * want.abs().clamp(min=1.0)).all())
            max_err = float(err.max())
            del got, want, err
            o1, n1 = time_ms(old, 3), time_ms(new, 10)
            n2, o2 = time_ms(new, 10), time_ms(old, 3)
            lib = time_ms(sdpa, 10)
        print(f"[attention] S={S} B={B} H=12 hd=64 bf16: bf16-operand vs upcast "
              f"max_abs_err={max_err:.3e} within one bf16 step: {ok}; ms={n1:.4f},{n2:.4f} "
              f"upcast_ms={o1:.4f},{o2:.4f} sdpa_ms={lib:.4f}")
        check(np.isfinite(max_err) and ok, f"attention S={S}: bf16 branch vs upcast {max_err}")
        out["shapes"][S] = dict(max_abs_err=max_err, ms=(n1 + n2) / 2, upcast_ms=(o1 + o2) / 2,
                                sdpa_ms=lib)
        if S == 160:
            rows = 64
            w = torch.randn(rows, S, 768, device=device, generator=torch.Generator(
                device).manual_seed(0))
            grads = []
            for fn in (bert._attention, bert.upcast_attention):
                xs = [x[:rows].detach().clone().requires_grad_(True) for x in (q, k, v)]
                loss = (fn(*xs, bias[:rows], 12).float() * w).sum()
                grads.append(torch.autograd.grad(loss, xs))
            rel = max(float((a - b).float().abs().max() / b.float().abs().max())
                      for a, b in zip(*grads))
            print(f"[attention] backward S={S} B={rows}: max grad err / max |g| over q, k, "
                  f"v {rel:.3e} (limit 1e-2)")
            check(np.isfinite(rel) and rel <= 1e-2, f"attention backward: {rel}")
            out["grad_rel"] = rel
            del w, grads, xs, loss
        del q, k, v, bias, qs, ks, vs
        torch.cuda.empty_cache()

    model = enc.model
    cos = []
    for _, ids, mask, keep in batches:
        ids_d, mask_d, keep_d = enc._put_batch(ids, mask, keep)
        with torch.no_grad():
            ea = model.forward_normalized(ids_d, mask_d, keep_d, dtype_name="bfloat16")
            bert._attention, new_attention = upcast_stand_in, bert._attention
            try:
                eb = model.forward_normalized(ids_d, mask_d, keep_d, dtype_name="bfloat16")
            finally:
                bert._attention = new_attention
            cos.append(float((ea * eb).sum(-1)[keep_d].min()))
        print(f"[attention] in situ, bert-base bf16 embeddings B={ids.shape[0]} "
              f"S={ids.shape[1]}: bf16-operand vs upcast min_cosine={cos[-1]:.6f} "
              f"(limit {IN_SITU_MIN_COS})")
        del ea, eb
    check(all(np.isfinite(c) and c >= IN_SITU_MIN_COS for c in cos),
          f"attention in situ: min cosine {cos} < {IN_SITU_MIN_COS}")
    out["in_situ_min_cos"] = min(cos)
    return out


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
    from colbert_torch.utils import tracing

    shutil.rmtree(index_dir, ignore_errors=True)
    dev = enc.device
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    fa.flash_attention.variant_launches.update(mma=0, simt=0)
    t0 = time.perf_counter()
    with counted_doc_batches(enc) as seen, tracing.recording() as rec:
        Indexer(enc.config, encoder=enc, collection=passages, device=dev).index(index_dir)
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    by_variant = dict(fa.flash_attention.variant_launches)
    km_iters = rec.counters.get("kmeans_iters", 0)
    km_launches = rec.counters.get("kmeans_assign_launches", 0)
    n = len(passages)
    plan = fmt.load_plan(index_dir)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    layers = enc.bert_config.num_hidden_layers
    print(f"[build] {n} passages in {wall:.2f}s -> {n / wall:.2f} passages/s; phases "
          + json.dumps(plan["timings"]))
    print("[build] plan " + json.dumps({k: v for k, v in plan.items()
                                         if k not in ("timings", "embedding_offsets")}))
    programs = enc.programs.stats()
    print(f"[build] encoded batches {seen['batches']} (flash-routed "
          f"{seen['flash_batches']}), padded token rows {seen['rows']}, flash kernel "
          f"launches {launches} (expected {layers} x {seen['flash_batches']}; by kernel "
          f"{by_variant}); nearest-centroid launches {km_launches} for {km_iters} Lloyd "
          f"passes; peak device memory {peak / 2**30:.2f} GiB; doc programs "
          f"{json.dumps(programs)}")

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
        check(km_launches == km_iters > 0,
              f"build: {km_launches} nearest-centroid launches for {km_iters} Lloyd passes")
    return dict(build_seconds=wall, passages_per_s=n / wall, timings=plan["timings"],
                flash_launches=launches, kmeans_launches=km_launches,
                encoded_batches=seen["batches"], doc_programs=programs,
                num_partitions=plan["num_partitions"], num_embeddings=plan["num_embeddings"])


def profile_build_steps(enc, batch, index_dir: str) -> None:
    """Profiles of the build's two device-heavy steps: one encode+compress
    batch (B=128, S=512: the doc step's eager route, its copy-in included,
    then the codec) against the built codec, and one
    Lloyd pass of the codec trainer at the build's partition count over
    one million sample-like bf16 rows."""
    import torch

    from colbert_torch.models.colbert import compress_rows
    from colbert_torch.ops import kmeans
    from colbert_torch.storage import format as fmt

    codec = fmt.load_codec(index_dir)
    cent = torch.from_numpy(codec["centroids"]).to(enc.device)
    cut = torch.from_numpy(codec["bucket_cutoffs"]).to(enc.device)
    _, ids, mask, keep = batch
    embed = enc._doc_step(compact=True)

    def encode_compress():
        with torch.no_grad():
            rows, _ = embed(ids, mask, keep)
            compress_rows(rows, cent, cut, enc.config.nbits)

    encode_compress()
    print("[profile] encode+compress batch " + json.dumps(device_profile(encode_compress)))
    g = torch.Generator(device=enc.device).manual_seed(0)
    rows = torch.randn((1 << 20, cent.shape[1]), generator=g, device=enc.device)
    rows = torch.nn.functional.normalize(rows, dim=-1).to(torch.bfloat16)
    step = lambda: kmeans.lloyd_step(rows, cent, k=cent.shape[0])  # noqa: E731
    step()
    print(f"[profile] Lloyd pass, {rows.shape[0]} rows, k={cent.shape[0]} "
          + json.dumps(device_profile(step)))


def kmeans_bounds_ms(n: int, k: int, dim: int) -> dict:
    """The nearest-centroid launch's bounds: ``model``, its 2 n K dim FLOPs
    at the bf16 tensor rate (the roofline rule of
    ``kmeans.assign_roofline.build``), or the bf16 rows read once, the
    int64 assignments written once and the fp32 centroids read once at the
    memory's rate, whichever is longer; ``terms``, the three bf16 terms'
    products at the bf16 rate (the design's least)."""
    flops = 2.0 * n * k * dim
    nbytes = n * dim * 2 + n * 8 + k * dim * 4
    model = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    return {"model": model, "terms": 3 * flops / PEAK_BF16_FLOPS * 1e3}


def kmeans_phase(device) -> dict:
    """``[kmeans]``: see the module's docstring, step 1."""
    import torch

    from colbert_torch.ops import kmeans
    from colbert_torch.utils import tracing

    out = {}
    for cell, n, k in KMEANS_SHAPES:
        g = torch.Generator(device=device).manual_seed(n + k)
        rows = torch.nn.functional.normalize(
            torch.randn((n, 128), generator=g, device=device), dim=-1).to(torch.bfloat16)
        cent = rows[torch.randperm(n, generator=g, device=device)[:k]].float()
        with tracing.recording() as rec:
            kmeans.lloyd_step(rows, cent, k=k)
        launches = rec.counters.get("kmeans_assign_launches", 0)
        check(launches == 1, f"[kmeans] {cell}: {launches} launches a Lloyd pass")
        got = kmeans.assign_clusters(rows, cent)
        # rows strided across the whole range, so far-out blocks are held too
        sample = torch.arange(0, n, n // KMEANS_CHECK_ROWS, device=device)[:KMEANS_CHECK_ROWS]
        ct, neg_c_sq = kmeans._centroid_terms(cent)
        plain_scores = torch.addmm(neg_c_sq, rows[sample].float(), ct, alpha=2.0)
        want = plain_scores.argmax(dim=-1)
        off = (got[sample] != want).nonzero().flatten()
        sa = plain_scores[off, want[off]]
        sb = plain_scores[off, got[off]]
        gap = float(((sa - sb).abs() / torch.maximum(sa.abs(), sb.abs())).max()) if len(off) else 0.0
        check(gap <= 1e-5, f"[kmeans] {cell}: a disagreement with the plain version {gap:.3g} apart")
        del plain_scores

        def plain():
            bs = kmeans._adaptive_bsize(k, 1024)
            for s0 in range(0, n, bs):
                kmeans._assign_chunk(rows[s0:s0 + bs], ct, neg_c_sq)

        kern = time_ms(lambda: kmeans.assign_clusters(rows, cent), 3)
        lloyd = time_ms(lambda: kmeans.lloyd_stats(rows, cent, k=k), 3)
        plain_ms = time_ms(plain, 1)
        kern2 = time_ms(lambda: kmeans.assign_clusters(rows, cent), 3)
        b = kmeans_bounds_ms(n, k, 128)
        res = dict(rows=n, k=k, launches_per_pass=launches, kernel_ms=[kern, kern2], lloyd_pass_ms=lloyd, plain_ms=plain_ms,
                   bound_ms=b["model"], terms_bound_ms=b["terms"],
                   roofline_pct=100.0 * b["model"] / min(kern, kern2),
                   disagreements=int(len(off)), checked=KMEANS_CHECK_ROWS, max_tie_gap=gap)
        print(f"[kmeans] {cell}: " + json.dumps(res) + f" on {card_line()}")
        out[cell] = res
        del rows, cent, got, sample
        torch.cuda.empty_cache()
    return out


def build_search(enc, passages, index_dir: str, *, batch: int = BATCH) -> dict:
    """Two query batches over the built index: shapes, pid range, finite and
    descending scores, stage-2 and refine launches; top-1 self-retrieval
    (printed)."""
    from colbert_torch.retrieval.searcher import Searcher

    searcher = Searcher(index_dir, encoder=enc, device=enc.device)
    rng = np.random.default_rng(5)
    pids = rng.choice(len(passages), size=2 * batch, replace=False)
    queries = [" ".join(passages[p].split()[:40]) for p in pids]
    reset_counts()
    results = [searcher.search_batch(queries[i:i + batch], k=10)
               for i in range(0, 2 * batch, batch)]
    counts = search_counts()
    hits = 0
    for i, (p, s) in enumerate(results):
        check(p.shape == (batch, 10) and s.shape == (batch, 10), "build-search: shape")
        check(bool(((p >= 0) & (p < len(passages))).all()), "build-search: pids out of range")
        check(bool(np.isfinite(s).all()), "build-search: non-finite scores")
        check(bool((np.diff(s, axis=1) <= 1e-6).all()), "build-search: not descending")
        hits += int((p[:, 0] == pids[i * batch:(i + 1) * batch]).sum())
    print(f"[build-search] 2 x {batch} queries; stage-2 and refine launches {counts}; top-1 "
          f"self-retrieval {hits}/{2 * batch} (random weights: information only)")
    check_search_launches(enc.device, counts, "build-search")
    return dict(search_launches=counts["launches"], search_refine_launches=counts["refine"],
                self_top1=hits / (2 * batch))


# ---------------------------------------------------------------------------
# the life of a live index: serving fronts, the tuner, the updater
# ---------------------------------------------------------------------------


# search launches of single-index searches whose knobs run the refine,
# counted by count_refine_batches' wrapper of DeviceIndex._static_kwargs
REFINE_BATCHES = {"n": 0}


def count_refine_batches() -> None:
    """Make every single-index search launch (eager, or a captured
    program's launch or replay) whose static knobs run the refine add one to
    ``REFINE_BATCHES``: ``DeviceIndex._static_kwargs``, which each launch
    calls once, wrapped (once per process). The sharded backend never calls
    it: ``[multidevice]`` counts its batches itself."""
    from colbert_torch.retrieval.device_index import DeviceIndex

    static = DeviceIndex._static_kwargs
    if getattr(static, "counts_refine", False):
        return

    def counting(self, Lq, k, **kw):
        out = static(self, Lq, k, **kw)
        if out["stage1_refine"] and out["ncandidates"] < out["max_candidates"]:
            REFINE_BATCHES["n"] += 1
        return out

    counting.counts_refine = True
    DeviceIndex._static_kwargs = counting


def search_counts() -> dict:
    """The stage-2 launches by kernel (``mma``, ``simt``, ``launches``), the
    refine kernel's launches (``refine``) and the search launches that ran
    the refine (``refine_batches``) since :func:`reset_counts`."""
    from colbert_torch.ops import approx_maxsim as am
    from colbert_torch.ops import fused_maxsim as fm

    return dict(fm.stage2_maxsim.variant_launches, launches=fm.stage2_maxsim.launches,
                refine=am.approx_maxsim.launches, refine_batches=REFINE_BATCHES["n"])


def reset_counts() -> None:
    from colbert_torch.ops import approx_maxsim as am
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.ops import fused_maxsim as fm

    count_refine_batches()
    fm.stage2_maxsim.launches = 0
    fm.stage2_maxsim.variant_launches.update(mma=0, simt=0)
    fa.flash_attention.launches = 0
    fa.flash_attention.variant_launches.update(mma=0, simt=0)
    am.approx_maxsim.launches = 0
    am.approx_maxsim.variant_launches.update(table=0)
    REFINE_BATCHES["n"] = 0


def check_search_launches(device, counts: dict, phase: str, refine_batches=None) -> None:
    """On the card every stage-2 launch of a phase is the ``mma`` kernel,
    and every search launch that ran the refine made exactly one counted
    launch of the refine kernel (``refine_batches``: those launches, by
    default as counted by :func:`count_refine_batches`)."""
    if device.type == "cuda":
        check(counts["launches"] > 0 and counts["mma"] == counts["launches"]
              and counts["simt"] == 0, f"{phase}: stage-2 launches by kernel {counts}")
        want = counts["refine_batches"] if refine_batches is None else refine_batches
        check(counts["refine"] == want,
              f"{phase}: {counts['refine']} refine kernel launches for {want} searches "
              f"that ran the refine")


def program_replays(searcher) -> int:
    return searcher.device_index.programs.stats()["replays"]


def check_through_programs(searcher, replays: int, phase: str) -> None:
    """On the card a serving front's batches run as captured programs."""
    if searcher.device.type == "cuda":
        check(replays > 0, f"{phase}: no captured program was replayed")


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
    replays = program_replays(searcher)
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
    counts = search_counts()
    replays = program_replays(searcher) - replays
    print(f"[serve-batcher] {len(queries)} queries from {BATCHER_THREADS} threads in {dt:.4f}s "
          f"-> {len(queries) / dt:.2f} queries/s in process; stats {stats}; batch sizes "
          f"{[len(b) for b in batches]}; stage-2 launches {counts}; program replays "
          f"{replays}; failed futures {len(errors)}")
    check_through_programs(searcher, replays, "serve-batcher")
    check(not errors, f"serve-batcher: failed futures {errors[:3]}")
    check(len(results) == len(queries), "serve-batcher: a query got no result")
    check(stats["queries"] == len(queries) and stats["batches"] < len(queries)
          and stats["max_batch_seen"] <= BATCH, f"serve-batcher: stats {stats}")
    check_search_launches(searcher.device, counts, "serve-batcher")
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
                batcher_refine_launches=counts["refine"],
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
    replays = program_replays(searcher)
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
    counts = search_counts()
    replays = program_replays(searcher) - replays
    codes = [r[0] for r in replies] + [batch_reply[0], health[0], stats[0]]
    failed = [(c, r) for c, r in replies + [batch_reply, health, stats] if c != 200]
    print(f"[serve-http] {len(single)} concurrent POST /search in {dt:.4f}s -> "
          f"{len(single) / dt:.2f} requests/s (information: stdlib HTTP bounds it); "
          f"/health {health[1]}; /stats {stats[1]}; batch sizes {[len(b) for b in batches]}; "
          f"stage-2 launches {counts}; program replays {replays}; non-200 replies "
          f"{len(failed)}")
    check_through_programs(searcher, replays, "serve-http")
    check(not failed, f"serve-http: failed requests {failed[:3]}")
    check(codes.count(200) == len(codes), "serve-http: a reply was not 200")
    check(health[1]["n_passages"] == len(searcher.doclens), f"serve-http: /health {health[1]}")
    check(stats[1]["queries"] == len(queries), f"serve-http: /stats {stats[1]}")
    results = {q: (r[1]["pids"], r[1]["scores"]) for q, r in zip(single, replies)}
    results.update({q: (p, s) for q, p, s in zip(multi, batch_reply[1]["pids"],
                                                   batch_reply[1]["scores"])})
    check_search_launches(searcher.device, counts, "serve-http")
    n = check_against_direct(searcher, batches, results, "serve-http")
    print(f"[serve-http] every reply equals direct search_batch of its batch up to ties at "
          f"{TOL} ({n} batches)")
    return dict(http_rps=len(single) / dt, http_launches=counts["launches"],
                http_refine_launches=counts["refine"])


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
          f"weights on a synthetic index: recall is information only); captured programs "
          f"{searcher.device_index.programs.stats()}\n{res}")
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
    counts = search_counts()
    print(f"[tune] chosen {res.chosen.point.label()}, cap {res.chosen.balance_cap}; applied "
          f"and searched; stage-2 launches {counts}")
    check_search_launches(searcher.device, counts, "tune")
    if searcher.device.type == "cuda":
        check(not torch.backends.cuda.matmul.allow_tf32, "tune: TF32 must stay off")
    return dict(oracle_s=dt_oracle, oracle_err=err, tune_s=dt_tune,
                tune_launches=counts["launches"], tune_refine_launches=counts["refine"])


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
    counts = search_counts()
    qps = BATCH * N_BATCHES / dt
    tracer = Tracer()
    sh.tracer = tracer
    for b in batches[1:]:
        sh.search_batch(b, k=10)
    sh.tracer = None
    stages = {k: v["seconds"] / N_BATCHES * 1e3 for k, v in tracer.as_dict().items()}
    print(f"[multidevice] sharded search_batch: {N_BATCHES} x B={BATCH} in {dt:.4f}s -> QPS "
          f"{qps:.2f}; stage-2 and refine launches {counts} ({MD_SHARDS} shards x "
          f"{N_BATCHES} batches) "
          f"on {card_line()}")
    print("[multidevice] per-stage ms per batch, summed over the shards (traced, device "
          "synchronized per stage): " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    if dev.type == "cuda":
        check(counts["launches"] == MD_SHARDS * N_BATCHES,
              f"multidevice: stage-2 launches {counts}, expected {MD_SHARDS} mma per batch")
    # every shard of every batch runs the refine at the default knobs
    check_search_launches(dev, counts, "multidevice", refine_batches=MD_SHARDS * N_BATCHES)

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
        nccl_counts = search_counts()
    finally:
        dist.destroy_process_group()
    why = agree_up_to_ties(p, s, pn, sn, TOL)
    print(f"[multidevice] the same search in a one-process {backend} group (collectives "
          f"through {backend}): equal up to ties {why is None}; stage-2 launches {nccl_counts}")
    check(why is None, f"multidevice: {backend} search differs: {why}")
    return dict(md_qps=qps, md_stages_ms=stages, md_launches=counts["launches"],
                md_refine_launches=counts["refine"],
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
    from colbert_torch.utils import tracing

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
        with counted_doc_batches(enc) as seen, tracing.recording() as rec:
            idx = Indexer(enc.config, encoder=enc, collection=passages,
                          device=mesh_devices(dev, 2))
            idx.index(index_dir)
        wall = time.perf_counter() - t0
    finally:
        codec_trainer._train_codec_sharded, quantile.sharded_quantiles = trainer, quantiles
    flash = dict(fa.flash_attention.variant_launches, launches=fa.flash_attention.launches)
    km_iters = rec.counters.get("kmeans_iters", 0)
    km_launches = rec.counters.get("kmeans_assign_launches", 0)
    shards = idx.mesh.shape["data"]
    plan = fmt.load_plan(index_dir)
    layers = enc.bert_config.num_hidden_layers
    print(f"[multidevice] mesh build {idx.mesh.shape}: {len(passages)} passages in {wall:.2f}s "
          f"-> {len(passages) / wall:.2f} passages/s; phases (s) "
          + json.dumps({k: v["seconds"] for k, v in plan["timings"].items()})
          + f"; {plan['num_partitions']} partitions; encoded batches {seen['batches']} "
          f"(flash-routed {seen['flash_batches']}); flash launches {flash} (expected "
          f"{layers} x 2 shards x {seen['flash_batches']}); nearest-centroid launches "
          f"{km_launches} for {km_iters} Lloyd passes over {shards} shards; sharded codec "
          f"calls {ran}; on {card_line()}")
    check(ran == {"sharded_trainer": 1, "sharded_quantiles": 1},
          f"multidevice build: the sharded codec trainer did not run: {ran}")
    check(fmt.check_all_files_saved(index_dir) == [], "multidevice build: incomplete index")
    if dev.type == "cuda":
        check(seen["flash_batches"] == seen["batches"] > 0
              and flash["launches"] == layers * 2 * seen["flash_batches"]
              and flash["mma"] == flash["launches"] and flash["simt"] == 0,
              f"multidevice build: flash launches {flash}")
        check(km_launches == shards * km_iters > 0,
              f"multidevice build: {km_launches} nearest-centroid launches for {km_iters} "
              f"Lloyd passes over {shards} shards")
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
                md_flash_launches=flash["launches"], md_kmeans_launches=km_launches)


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
        ref16 = one.model.encode_batch(*one._put_batch(ids, mask, keep), dtype_name="bfloat16",
                                       use_flash=flash)
        ref32 = one.model.encode_batch(*one._put_batch(ids, mask, keep), dtype_name="float32")
        for name, shape in (("dp", (2, 1)), ("tp", (1, 2))):
            enc = ColBERTEncoder(model, one.tokenizer, cfg, device=dev)
            enc.attach_mesh(make_mesh(*shape, devices=mesh_devices(dev, 2)))
            reset_counts()
            t0 = time.perf_counter()
            e16 = enc._shard_forward(ids, mask, keep, dtype_name="bfloat16",
                                     use_flash=flash)[:len(ids)]
            dt16 = time.perf_counter() - t0
            f = dict(fa.flash_attention.variant_launches)
            e32 = enc._shard_forward(ids, mask, keep, dtype_name="float32")[:len(ids)]
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
    from colbert_torch.utils import tracing
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
        with counted_doc_batches(enc) as seen, tracing.recording() as rec:
            new_pids = up.add(added)
        sync()
        seconds["add"] = time.perf_counter() - t0
        km_launches = rec.counters.get("kmeans_assign_launches", 0)
        flash = dict(fa.flash_attention.variant_launches, launches=fa.flash_attention.launches)
        plan = fmt.load_plan(index_dir)
        doclens = fmt.load_all_doclens(index_dir)
        _, ivf_lengths = fmt.load_ivf(index_dir)
        print(f"[update] add: {len(added)} passages in {seconds['add']:.2f}s -> "
              f"{len(added) / seconds['add']:.2f} passages/s; pids {new_pids[0]}..{new_pids[-1]}; "
              f"encoded batches {seen['batches']} (flash-routed {seen['flash_batches']}), flash "
              f"launches {flash}, nearest-centroid launches {km_launches} (the codec is "
              f"kept); plan documents {plan['num_documents']} chunks "
              f"{plan['num_chunks']} embeddings {plan['num_embeddings']}")
        check(np.array_equal(new_pids, np.arange(n0, n0 + len(added))), "update: new pids")
        check(km_launches == 0, f"update: {km_launches} nearest-centroid launches, the codec "
              f"is kept")
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
    counts = search_counts()
    print("[update] seconds " + json.dumps({k: round(v, 4) for k, v in seconds.items()})
          + f"; stage-2 launches {counts}")
    check_search_launches(dev, counts, "update")
    return dict(update_seconds=seconds, update_flash_launches=flash["launches"],
                update_kmeans_launches=km_launches,
                update_launches=counts["launches"], update_refine_launches=counts["refine"],
                update_eval=report,
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


def first_layers(model) -> tuple:
    """(config, CPU state dict) of ``model`` cut to its first CHECK_LAYERS
    layers at full width."""
    import dataclasses

    cfg = dataclasses.replace(model.bert_config, num_hidden_layers=CHECK_LAYERS)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()
          if not k.startswith("bert.layers.") or int(k.split(".")[2]) < CHECK_LAYERS}
    return cfg, sd


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
    import torch

    from colbert_torch.models.colbert import ColBERT
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.training import ColBERTTrainer

    if device.type == "cuda":
        check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
              "train: TF32 must be off for the card-vs-CPU step")
    cfg, sd = first_layers(model)
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


def graphed_vs_eager(model, tokenizer, triples, device) -> dict:
    """The captured step against the eager one: GRAPH_CHECK_STEPS steps of
    CHECK_TRIPLES triples each on the first CHECK_LAYERS layers of
    ``model`` at full width, fp32 activations, TF32 off, warm-up 2 and the
    cosine to step GRAPH_CHECK_STEPS, clipping at 1.0:
    ``ColBERTTrainer.train_step`` (on a card step 1 the eager warm-up, step
    2 the capture and its replay, then replays) against ``make_train_step``
    over a twin with the same optimizer (``default_optimizer``: on the card
    capturable, its lr a device tensor) under the same schedule, run op by
    op, from the same state. Loss 1e-5 relative per step;
    ``p.grad`` readable after every step and within 1e-4 x its max |g| +
    1e-7; every parameter within 1e-2 x lr, entries whose gradient was ever
    nonzero but below 1e-6 apart (Adam moves them +-lr by a sign that
    rounding may flip: 2 x lr per step since); the lr after step n
    ``lr_multiplier(n)`` x peak within 1e-6 x peak (an fp32 tensor on the
    card, filled in place)."""
    import copy
    import torch

    from colbert_torch.models.colbert import ColBERT
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.training import trainer as pt

    cfg, sd = first_layers(model)
    small = ColBERT(cfg, model.dim)
    small.load_state_dict(sd, strict=True)
    enc = ColBERTEncoder(small, tokenizer, train_config(activation_dtype="float32"),
                         device=device)
    twin = copy.deepcopy(enc.model)
    sched = dict(warmup_steps=2, total_steps=GRAPH_CHECK_STEPS)
    trainer = pt.ColBERTTrainer(enc, learning_rate=TRAIN_LR, **sched)
    opt = pt.default_optimizer(twin.parameters(), TRAIN_LR, 0.01, device)
    eager = pt.make_train_step(twin, opt, dtype_name="float32", max_grad_norm=1.0,
                               scheduler=torch.optim.lr_scheduler.LambdaLR(
                                   opt, pt.lr_multiplier(**sched)))
    mult = pt.lr_multiplier(**sched)
    lr_tensor = trainer.optimizer.param_groups[0]["lr"]
    named = list(enc.model.named_parameters())
    ever = [torch.zeros_like(p, dtype=torch.bool) for _, p in named]
    loss_rel = grad_ratio = param_err = apart_ratio = lr_err = 0.0
    unreadable, in_place, losses = 0, True, []
    for step in range(GRAPH_CHECK_STEPS):
        batch = triples[step * CHECK_TRIPLES:(step + 1) * CHECK_TRIPLES]
        host = trainer._tensorize(batch)
        got = trainer.train_step(batch)
        want = eager(dict(zip(host, enc._put_batch(*host.values()))))
        losses.append((got["loss"], want["loss"]))
        loss_rel = max(loss_rel, abs(got["loss"] - want["loss"]) / abs(want["loss"]))
        lr_now = trainer.optimizer.param_groups[0]["lr"]
        in_place &= lr_now is lr_tensor
        lr_err = max(lr_err, abs(float(lr_now) - TRAIN_LR * mult(step + 1)) / TRAIN_LR)
        for i, ((name, p), q) in enumerate(zip(named, twin.parameters())):
            if p.grad is None:
                unreadable += 1
                continue
            g = q.grad.abs()
            grad_ratio = max(grad_ratio, float((p.grad - q.grad).abs().max())
                             / (1e-4 * float(g.max()) + 1e-7))
            ever[i] |= (g < 1e-6) & (g != 0)
            diff = (p - q).detach().abs()
            param_err = max(param_err, float(torch.where(ever[i], 0, diff).max()))
            apart_ratio = max(apart_ratio, float(torch.where(ever[i], diff, 0).max())
                              / (2 * TRAIN_LR * (step + 1)))
    (prog,) = trainer.programs.programs()
    apart = int(sum(int(e.sum()) for e in ever))
    print(f"[train] captured step vs make_train_step, {CHECK_LAYERS} layers at full width, fp32, "
          f"{GRAPH_CHECK_STEPS} steps of {CHECK_TRIPLES} triples (warmup 2, cosine, clipping): "
          f"losses {[(round(a, 8), round(b, 8)) for a, b in losses]}, max rel {loss_rel:.3e} "
          f"(limit 1e-5); max grad err / (1e-4 max|g| + 1e-7) "
          f"{grad_ratio:.3e} (limit 1), unreadable grads {unreadable}; max param err "
          f"{param_err:.3e} (limit {1e-2 * TRAIN_LR:.1e}); {apart} entries ever 0 < |g| < "
          f"1e-6: max err / (2 lr x steps) {apart_ratio:.3e} (limit 1); lr err / peak "
          f"{lr_err:.3e} (limit 1e-6), filled in place "
          f"{in_place if device.type == 'cuda' else 'n/a (a float lr on the CPU)'}; program: "
          f"{prog.launches} launches, {prog.replays} replays, capture {prog.capture_s:.3f}s, "
          f"pool {prog.pool_bytes / 2**20:.1f} MiB")
    check(loss_rel <= 1e-5, f"train: captured step loss {loss_rel}")
    check(unreadable == 0 and grad_ratio <= 1.0, f"train: captured step gradients "
          f"({unreadable} unreadable, ratio {grad_ratio})")
    check(param_err <= 1e-2 * TRAIN_LR and apart_ratio <= 1.0,
          f"train: captured step parameters {param_err}, {apart_ratio}")
    check(lr_err <= 1e-6 and (in_place or device.type != "cuda"), f"train: lr {lr_err}")
    if device.type == "cuda":
        check(prog.graph is not None and prog.replays == GRAPH_CHECK_STEPS - 1,
              f"train: {prog.replays} replays of the captured step")
    return dict(graph_check_loss_rel=loss_rel, graph_check_grad_ratio=grad_ratio,
                graph_check_param_err=param_err, graph_check_lr_err=lr_err)


def train_routes(trainer, triples, batch: int) -> dict:
    """On the card, after [train]'s run: the captured step against the same
    step op by op (``make_train_step`` over the trainer's own model,
    optimizer and schedule, after tokenizing and putting the batch, as
    ``train_step`` ran before its step was captured), TRAIN_TURN_STEPS
    steps each in turns (graphed, eager, eager, graphed): each turn's
    median ms per step; one launch under ``set_sync_debug_mode("error")``;
    one profiled step each way (busy share, kernels run); the program's
    capture seconds and pool bytes."""
    import statistics

    import torch

    from colbert_torch.training.trainer import make_train_step

    enc = trainer.encoder
    eager_step = make_train_step(enc.model, trainer.optimizer,
                                 dtype_name=enc.config.activation_dtype,
                                 in_batch_negatives=trainer.in_batch_negatives,
                                 scheduler=trainer.scheduler,
                                 max_grad_norm=trainer._max_grad_norm)

    def eager(texts):
        host = trainer._tensorize(texts)
        return eager_step(dict(zip(host, enc._put_batch(*host.values()))))

    routes = {"graphed": trainer.train_step, "eager": eager}
    turns = {"graphed": [], "eager": []}
    for route in ("graphed", "eager", "eager", "graphed"):
        times = []
        for step in range(TRAIN_TURN_STEPS):
            t0 = time.perf_counter()
            m = routes[route](triples[step * batch:(step + 1) * batch])
            times.append(time.perf_counter() - t0)
            check(np.isfinite(m["loss"]), f"train: {route} loss {m['loss']}")
        turns[route].append(statistics.median(times) * 1e3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        values, ready = trainer._launch(trainer._tensorize(triples[:batch]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ready.synchronize()
    check(bool(np.isfinite(values.numpy()).all()), "train: the launch under sync debug mode")
    prof = {"graphed": device_profile(lambda: trainer.train_step(triples[:batch])),
            "eager": device_profile(lambda: eager(triples[:batch]))}
    stats = trainer.programs.stats()
    print(f"[train] captured step vs eager, {batch} triples, bf16, remat, in turns (graphed, "
          f"eager, eager, graphed) of {TRAIN_TURN_STEPS} steps: median ms per step "
          f"{json.dumps({k: [round(v, 3) for v in t] for k, t in turns.items()})}; one launch "
          f"under sync debug mode 'error' passed; profiled step: graphed busy "
          f"{prof['graphed']['busy_share']} ({prof['graphed']['device_busy_ms']:.3f} of "
          f"{prof['graphed']['wall_ms']:.3f} ms, {prof['graphed']['kernels']} kernels in one "
          f"graph launch), eager {prof['eager']['busy_share']} "
          f"({prof['eager']['device_busy_ms']:.3f} of {prof['eager']['wall_ms']:.3f} ms, "
          f"{prof['eager']['kernels']} kernel launches); programs {stats['held']} held, "
          f"capture {stats['capture_s']:.3f}s, pool {stats['pool_bytes'] / 2**30:.3f} GiB, "
          f"replays {stats['replays']}; on {card_line()}")
    for route, p in prof.items():
        print(f"[profile] train step {route} " + json.dumps(p))
    check(stats["held"] == 1 and stats["replays"] > 0, f"train: programs {stats}")
    return dict(train_turn_ms=turns,
                train_busy_share={k: p["busy_share"] for k, p in prof.items()},
                train_kernels={k: p["kernels"] for k, p in prof.items()},
                train_profile_wall_ms={k: p["wall_ms"] for k, p in prof.items()},
                train_capture_s=stats["capture_s"], train_pool_bytes=stats["pool_bytes"])


def bf16_step(model, batch, device, *, remat: bool):
    """Loss, gradients and peak device memory of one full-depth bf16
    forward + backward of ``model`` from its state (parameters and
    gradients resident, no optimizer state, no step taken)."""
    import torch

    from colbert_torch.training.trainer import train_loss

    model.zero_grad(set_to_none=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    loss, _ = train_loss(model, batch, dtype_name="bfloat16", remat=remat)
    loss.backward()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return loss.item(), grads, peak


def remat_on_off(model, batch, device) -> dict:
    """Check 2: loss and gradients of one full-depth bf16 step with remat on
    and off, from the same state (loss 1e-6 relative, each gradient within
    1e-3 x its max |g|), and the peak device memory of each forward +
    backward."""
    import torch

    (l1, g1, m1), (l0, g0, m0) = (bf16_step(model, batch, device, remat=r) for r in (True, False))
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


def attention_route_step(model, batches, device) -> dict:
    """Check 3: one full-depth bf16 step (remat on, as the trainer runs it)
    on each of ``batches`` through the card's attention route (bf16
    operands into fp32 products, whose backward is
    ``models.bert._MatmulF32``'s own) against the same step with
    ``bert.upcast_attention`` standing in for it, from the same state: loss
    within ATTN_STEP_LOSS_REL relative, each gradient within
    ATTN_STEP_GRAD_REL of its norm (||g - g_upcast|| / ||g_upcast||). The
    key bias's gradient is 0 in exact arithmetic (see check 1), so each
    side's is rounding noise: their difference is held to ATTN_STEP_KBIAS
    x the largest |g| of any leaf."""
    from colbert_torch.models import bert

    names = [n for n, _ in model.named_parameters()]
    zero = [n.endswith(".k.bias") for n in names]
    loss_rel, worst, kbias = 0.0, (0.0, ""), 0.0
    for batch in batches:
        l1, g1, _ = bf16_step(model, batch, device, remat=True)
        bert._attention, route = upcast_stand_in, bert._attention
        try:
            l0, g0, _ = bf16_step(model, batch, device, remat=True)
        finally:
            bert._attention = route
        scale = max(float(b.abs().max()) for b in g0)
        loss_rel = max(loss_rel, abs(l1 - l0) / abs(l0))
        worst = max([worst] + [(float((a - b).norm() / b.norm().clamp(min=1e-30)), n)
                               for a, b, n, z in zip(g1, g0, names, zero) if not z])
        kbias = max([kbias] + [float((a - b).abs().max()) / scale
                               for a, b, z in zip(g1, g0, zero) if z])
    print(f"[train] attention route vs upcast, full depth, bf16, remat on, {len(batches)} "
          f"batches: loss rel err {loss_rel:.3e} (limit {ATTN_STEP_LOSS_REL}); max ||grad err|| "
          f"/ ||g|| {worst[0]:.3e} ({worst[1]}; limit {ATTN_STEP_GRAD_REL}); key-bias grad err "
          f"/ largest |g| {kbias:.3e} (limit {ATTN_STEP_KBIAS})")
    check(loss_rel <= ATTN_STEP_LOSS_REL, f"train: attention route changes the loss {loss_rel}")
    check(worst[0] <= ATTN_STEP_GRAD_REL, f"train: attention route changes a gradient {worst}")
    check(kbias <= ATTN_STEP_KBIAS, f"train: attention route, key-bias gradient {kbias}")
    return dict(attn_step_loss_rel=loss_rel, attn_step_grad_rel=worst[0],
                attn_step_kbias_rel=kbias)


def train_phase(device, *, bert_cfg, n_passages: int = TRAIN_PASSAGES,
                steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH, work_dir: str) -> dict:
    """[train]: ``ColBERTTrainer`` on a model of its own (random weights
    from a seed) over ``make_triples`` of the synthetic corpus, in-batch
    negatives, AdamW at lr TRAIN_LR with TRAIN_WARMUP warmup steps and the
    cosine decay to 0 at ``steps``, clipping at 1.0, remat on; checks 1-3
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
    out.update(graphed_vs_eager(model, tokenizer, triples, device))

    cfg = train_config()
    enc = ColBERTEncoder(model, tokenizer, cfg, device=device)
    trainer = ColBERTTrainer(enc, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                             total_steps=steps, in_batch_negatives=True)

    def device_batch(i: int) -> dict:
        h = trainer._tensorize(triples[i * batch:(i + 1) * batch])
        return dict(zip(h, enc._put_batch(*h.values())))

    host = trainer._tensorize(triples[:batch])
    first = device_batch(0)
    out.update(remat_on_off(enc.model, first, device))
    if cuda:
        out.update(attention_route_step(enc.model, [first, device_batch(1), device_batch(2)],
                                        device))
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
    route = (f"captured: step 1 the eager warm-up, step 2 the capture {times[1] * 1e3:.2f} ms, "
             f"then replays" if cuda else "eager")
    print(f"[train] {steps} steps x {batch} triples ({route}): median {ms:.3f} ms per step after "
          f"3 warm-up steps -> {1e3 / ms:.3f} steps/s, {batch * 1e3 / ms:.2f} triples/s, "
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
        out.update(train_routes(trainer, triples, batch))
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
    results = [searcher.search_batch(queries[i:i + BATCH], k=10)
               for i in range(0, len(queries), BATCH)]
    counts = search_counts()
    # the same batches through the eager entry, its query encode recorded:
    # the embeddings are the trained model's, and the served results equal
    # these up to ties
    enc.encode_query_tokens = recording
    try:
        with eager_route(searcher):
            eager = [searcher.search_batch(queries[i:i + BATCH], k=10)
                     for i in range(0, len(queries), BATCH)]
    finally:
        del enc.encode_query_tokens
    for (p, s), (pe, se) in zip(results, eager):
        why = agree_up_to_ties(p, s, pe, se, TOL)
        check(why is None, f"train: the served results differ from the eager entry's: {why}")
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
          f"encoder; {len(queries)} prefix queries, served results equal the eager entry's "
          f"up to ties; the searcher's query embeddings equal "
          f"the trained model's forward {same}, differ from the initial model's {moved}; "
          f"stage-2 launches {counts}; self-retrieval success@1 {s1:.3f} success@10 "
          f"{s10:.3f} (information)")
    check(same and seen, "train: the searcher's query embeddings are not the trained model's")
    check(moved, "train: the searcher's query embeddings equal the untrained model's")
    check(p.shape == (TRAIN_QUERIES, 10) and all(np.isfinite(r[1]).all() for r in results),
          "train: result shape or scores")
    check_search_launches(device, counts, "train")
    shutil.rmtree(index_dir, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"[train] phase seconds {seconds:.1f}")
    out.update(train_search_launches=counts["launches"], train_refine_launches=counts["refine"],
               train_flash_launches=flash,
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
    whose gradient is below 1e-6 on both sides and nonzero on at least one,
    where Adam's first update lr * g / (|g| + 1e-8) follows the gradient's
    rounding, are counted apart and held to lr); then
    the dp x tp step inside a one-process NCCL group (gloo on the CPU),
    whose collectives run at world size 1, against the step without a
    group: within 1e-6."""
    import torch
    import torch.distributed as dist

    from colbert_torch.parallel import launch

    cfg, sd = first_layers(model)

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
        for a, b, ga, gb in zip(p, p1, g, g1):
            # below 1e-6 on both sides and nonzero on one (ROADMAP C1)
            tiny = (gb.abs() < 1e-6) & (ga.abs() < 1e-6) & ((gb != 0) | (ga != 0))
            diff = (a - b).abs()
            apart += int(tiny.sum())
            param_err = max(param_err, float(diff[~tiny].max()) if (~tiny).any() else 0.0)
            apart_err = max(apart_err, float(diff[tiny].max()) if tiny.any() else 0.0)
        print(f"[train-mesh] {name} {shape} vs one device, {CHECK_LAYERS} layers at full width, "
              f"fp32, {len(triples)} triples: loss {loss:.8f} vs {loss1:.8f} (rel "
              f"{loss_rel:.3e}, limit 1e-5); max grad err / (1e-4 max|g| + 1e-7) "
              f"{grad_ratio:.3e} (limit 1); max param err {param_err:.3e} (limit "
              f"{1e-2 * TRAIN_LR:.1e}); {apart} entries below 1e-6, nonzero on a side: max err "
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
        meshed = enc._shard_forward(ids, mask, keep, dtype_name="bfloat16")[:32]
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
    counts, flash = dict.fromkeys(("launches", "mma", "simt", "refine", "refine_batches"), 0), 0

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
        for key, n in search_counts().items():
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
    check_search_launches(device, counts, "examples")
    return dict(examples_seconds=seconds, examples_launches=counts["launches"],
                examples_refine_launches=counts["refine"],
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
    counts = search_counts()
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
    check_search_launches(device, counts, "quality")
    return dict(quality=summary, quality_s=dt, quality_launches=counts["launches"],
                quality_refine_launches=counts["refine"],
                quality_flash_launches=flash, quality_oracle_err=err)


# ---------------------------------------------------------------------------
# [bench]: the benchmark scripts as a user runs them
# ---------------------------------------------------------------------------


def run_bench_script(script: str, argv: list[str], timeout: int):
    """``python <script> <argv>`` from the checkout's root, its stderr
    printed line by line -> (the finished process, its seconds). Fails
    unless it exits 0 within ``timeout`` seconds."""
    t0 = time.perf_counter()
    try:
        done = subprocess.run([sys.executable, os.path.join(ROOT, script)] + argv, cwd=ROOT,
                              capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"[bench] {script} ran past its {timeout} s limit: "
                           f"{(e.stderr or b'')[-2000:]!r}") from e
    dt = time.perf_counter() - t0
    for line in done.stderr.splitlines():
        print(f"[bench] {script} | {line}")
    check(done.returncode == 0, f"[bench] {script} {argv} exited {done.returncode}")
    print(f"[bench] {script} {' '.join(argv)}: exit 0 in {dt:.1f}s")
    return done, dt


def bench_summary(script: str, stdout: str) -> dict:
    """The JSON summary on the last stdout line, with the keys CHANGES.md lists."""
    out = json.loads(stdout.strip().splitlines()[-1])
    check(list(out) == BENCH_SUMMARY_KEYS[script],
          f"[bench] {script} printed keys {list(out)}, expected {BENCH_SUMMARY_KEYS[script]}")
    return out


def bench_phase(device, work_dir: str) -> dict:
    """Run the four benchmark scripts as subprocesses and check what they
    print: ``bench_torch.py``'s stdout is seven identical four-key headline
    lines with a positive value; its headline build launched no flash
    kernel, its ``flash_probe`` launched the ``mma`` flash kernel once per
    layer per batch and its serving stage only ``mma`` stage-2 kernels (on
    the card), each of whose returned scores is within TOL of the exact
    MaxSim of its pid; the other three print their JSON summary last. The
    sharded rehearsal serves a ``synthesize_index`` index of
    BENCH_SHARDED_PASSAGES made here."""
    from colbert_torch.utils.testing import synthesize_index

    out = {"seconds": {}}
    done, out["seconds"]["bench_torch.py"] = run_bench_script(
        "bench_torch.py", *BENCH_RUNS["bench_torch.py"])
    lines = done.stdout.splitlines()
    check(len(lines) == 7 and len(set(lines)) == 1,
          f"[bench] bench_torch.py stdout is not 7 identical lines: {lines}")
    head = json.loads(lines[0])
    check(list(head) == HEADLINE_KEYS and head["metric"] == "index_build_passages_per_sec"
          and head["value"] > 0, f"[bench] bench_torch.py headline {head}")
    stages = {line.split()[1]: json.loads(line.split(" ", 2)[2])
              for line in done.stderr.splitlines() if line.startswith("stage ")}
    check(list(stages) == BENCH_STAGES, f"[bench] bench_torch.py stages {list(stages)}")
    on_card = device.type == "cuda"
    build, fl, serve = stages["build"], stages["flash_probe"], stages["serve_and_probe"]
    check(build["flash_launches"] == {"mma": 0, "simt": 0},
          f"[bench] the headline build launched flash kernels {build['flash_launches']}")
    want = fl["layers"] * fl["batches"] if on_card else 0
    check(fl["flash_launches"] == {"mma": want, "simt": 0},
          f"[bench] flash_probe launches {fl['flash_launches']}, expected {want} mma "
          f"({fl['layers']} per batch)")
    s2, rf = serve["stage2_launches"], serve["refine_launches"]["table"]
    check(not on_card or (s2["mma"] > 0 and s2["simt"] == 0),
          f"[bench] serving stage-2 launches {s2}, expected all mma")
    # the stage's refined searches launch the refine kernel, at most once each
    check(not on_card or 0 < rf < s2["mma"],
          f"[bench] serving refine launches {rf} beside {s2['mma']} stage-2 launches")
    errs = serve["stage2_vs_oracle"]
    check(len(errs) == 6 and all(np.isfinite(e) and e <= TOL for e in errs.values()),
          f"[bench] serving stage-2 scores vs the exact MaxSim, max |diff| {errs} (limit {TOL})")
    print(f"[bench] bench_torch.py serving stage-2 scores vs the exact MaxSim of each "
          f"returned pid: max |diff| {max(errs.values()):.3e} over {list(errs)} (limit {TOL})")
    out["bench_torch"] = {"headline": head, "stages": stages}

    for script in ("bench_mfu_torch.py", "bench_scale_torch.py"):
        done, out["seconds"][script] = run_bench_script(script, *BENCH_RUNS[script])
        out[script.removesuffix(".py")] = summary = bench_summary(script, done.stdout)
        print(f"[bench] {script}: {json.dumps(summary)}")
    check(all(v is not None and v > 0 for v in out["bench_mfu_torch"]["value"].values())
          or not on_card, f"[bench] MFU sweep {out['bench_mfu_torch']['value']}")
    check(out["bench_scale_torch"]["value"] > 0, "[bench] scale build p/s")

    index_dir = os.path.join(work_dir, "smoke_bench_sharded")
    try:
        t0 = time.perf_counter()
        synthesize_index(index_dir, BENCH_SHARDED_PASSAGES)
        print(f"[bench] synthesize_index of {BENCH_SHARDED_PASSAGES} passages in "
              f"{time.perf_counter() - t0:.1f}s")
        argv, limit = BENCH_RUNS["bench_sharded_torch.py"]
        done, out["seconds"]["bench_sharded_torch.py"] = run_bench_script(
            "bench_sharded_torch.py", [index_dir] + argv, limit)
    finally:
        shutil.rmtree(index_dir, ignore_errors=True)
    out["bench_sharded_torch"] = sharded = bench_summary("bench_sharded_torch.py", done.stdout)
    print(f"[bench] bench_sharded_torch.py: {json.dumps(sharded)}")
    check(sharded["n_passages"] == BENCH_SHARDED_PASSAGES and sharded["qps_one_card"] > 0,
          f"[bench] sharded summary {sharded}")
    out["stage2_launches"] = s2["mma"] + s2["simt"]
    out["refine_launches"] = rf
    out["flash_launches"] = fl["flash_launches"]["mma"] + fl["flash_launches"]["simt"]
    print(f"[bench] seconds {json.dumps({k: round(v, 1) for k, v in out['seconds'].items()})}; "
          f"headline {json.dumps(head)} on {card_line()}")
    return out


def kernel_label(mangled: str) -> str:
    """``flash_mma_kernel<bf16,64>`` (``stage2_mma_kernel<2>``,
    ``approx_maxsim_kernel<8>``, ``nearest_centroid_kernel<4>``) for the
    mangled name of that instantiation of one of the repo's kernels, else
    the name as it is."""
    import re

    m = re.search(r"\d+(flash_mma_kernel|flash_mma_window_kernel|flash_kernel|"
                  r"stage2_mma_kernel|stage2_kernel|approx_maxsim_kernel|"
                  r"nearest_centroid_kernel)I(.+?)EEv", mangled)
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


def build_kernels() -> dict:
    """Phase 1: one nvcc per kernel source, started together, always from
    the sources (a library left by an earlier run would hide ptxas's
    report) -> the logs; the paths' instantiations must not spill."""
    from colbert_torch.ops import approx_maxsim as am
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.ops import fused_maxsim as fm
    from colbert_torch.ops import nearest_centroid as nc
    from colbert_torch.utils.build import BUILD_DIR

    for so in ("libstage2_maxsim.so", "libflash_attention.so", "libapprox_maxsim.so",
               "libnearest_centroid.so"):
        if os.path.exists(os.path.join(BUILD_DIR, so)):
            os.remove(os.path.join(BUILD_DIR, so))
    t0 = time.perf_counter()
    kernels_src = {"stage2_maxsim.cu": fm.build_kernel, "flash_attention.cu": fa.build_kernel,
                   "approx_maxsim.cu": am.build_kernel, "nearest_centroid.cu": nc.build_kernel}
    with ThreadPoolExecutor(len(kernels_src)) as ex:
        logs = dict(zip(kernels_src, ex.map(lambda build: build(), kernels_src.values())))
    print(f"[build] {', '.join(kernels_src)} built in {time.perf_counter() - t0:.1f}s")
    for src, log in logs.items():
        for name, spills, regs in ptxas_resources(log):
            print(f"[build] {src}: {name}: {spills}; {regs}")
    no_spill = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    for src, path_kernel in (("flash_attention.cu", "flash_mma_kernel<bf16,64>"),
                             ("flash_attention.cu", "flash_mma_window_kernel<bf16,64>"),
                             ("stage2_maxsim.cu", "stage2_mma_kernel<2>"),
                             ("approx_maxsim.cu", "approx_maxsim_kernel<8>"),
                             ("nearest_centroid.cu", "nearest_centroid_kernel<4>")):
        found = [spills for name, spills, _ in ptxas_resources(logs[src]) if name == path_kernel]
        check(found == [no_spill], f"{path_kernel}: ptxas reports {found}")
    return logs


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
    from colbert_torch.utils.build import BUILD_DIR
    from colbert_torch.utils.testing import bench_vocab_tokenizer, synthetic_passages

    build_kernels()
    max_err = kernel_vs_plain(device)
    stage2_sweep(device)
    kmeans_res = kmeans_phase(device)
    index_dir = os.path.join(BUILD_DIR, "smoke_index")
    try:
        mp = main_path(device, n_passages=N_PASSAGES, bert_cfg=BertConfig(),
                       index_dir=index_dir, n_batches=SERVE_BATCHES)
        check(mp["launches"] > 0 and mp["by_variant"] == {"mma": mp["launches"], "simt": 0},
              f"stage-2 launches on the main path by kernel {mp['by_variant']}, expected all mma")
        check(mp["refine_launches"] == mp["launches"] > 0,
              f"refine launches on the main path {mp['refine_launches']}, expected one per "
              f"batch ({mp['launches']})")
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
    fl["window"] = flash_window_phase(device)
    fl.update(flash_in_situ(enc, first))
    short = next(enc._doc_batches(synthetic_passages(enc.config.index_bsize, mean_words=110,
                                                     seed=11)))
    attn = attention_phase(enc, [short, first])

    build_dir = os.path.join(BUILD_DIR, "smoke_build_index")
    try:
        bp = build_path(enc, passages, build_dir)
        bs = build_search(enc, passages, build_dir)
        live.update(update_phase(enc, passages, build_dir))
        profile_build_steps(enc, first, build_dir)
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)
    mb = modernbert_build(device, BUILD_DIR)
    moe_build(device, BUILD_DIR)
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
    gc.collect()
    torch.cuda.empty_cache()
    bn = bench_phase(device, BUILD_DIR)

    print(json.dumps({"qps": mp["qps"], "stream_qps": mp["stream_qps"],
                      "stages_ms": mp["stages_ms"], "program": mp["program"],
                      "refine": {k[7:]: mp[k] for k in mp if k.startswith("refine_")},
                      "attention": attn,
                      "build_passages_per_s": bp["passages_per_s"],
                      "build_phases": bp["timings"], "self_top1": bs["self_top1"],
                      "batcher_qps": live["batcher_qps"], "http_rps": live["http_rps"],
                      "oracle_s": live["oracle_s"], "tune_s": live["tune_s"],
                      "update_add_passages_per_s": live["update_add_pps"],
                      "update_seconds": live["update_seconds"],
                      "update_eval": live["update_eval"],
                      "train": {k: v for k, v in tr.items()
                                if k not in ("train_search_launches", "train_flash_launches",
                                             "train_refine_launches")},
                      "examples_seconds": ex["examples_seconds"],
                      "examples_eval": ex["examples_eval"], "quality": ql["quality"],
                      "quality_s": ql["quality_s"],
                      "multidevice": {k: v for k, v in md.items() if k != "md_dryrun"},
                      "train_mesh": {k: v for k, v in tm.items() if k != "mesh_launches"},
                      "bench": {k: bn[k] for k in ("seconds", "bench_mfu_torch",
                                                   "bench_scale_torch", "bench_sharded_torch")}
                      | {"headline": bn["bench_torch"]["headline"]}}))
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
                          "train-mesh": tm["mesh_launches"]["stage2_maxsim"],
                          "bench: bench_torch.py serve_and_probe": bn["stage2_launches"]},
    ), dict(
        name="flash_attention", route="cuda", variant="mma.sync",
        source="colbert_torch/csrc/flash_attention.cu",
        replaces="colbert_tpu/ops/flash_attention.py:65",
        launches=bp["flash_launches"], max_abs_err=fl["max_abs_err"],
        ms=fl["kernel_ms"], kernel_ms=fl["kernel_ms"], plain_ms=fl["plain_ms"],
        bound_ms=fl["bound_ms"], bound_by=fl["bound_by"], library_ms=fl["library_ms"],
        window=fl["window"],
        launches_by_path={"build": bp["flash_launches"],
                          "build-modernbert": mb["flash_launches"],
                          "update": live["update_flash_launches"],
                          "train": tr["train_flash_launches"],
                          "examples": ex["examples_flash_launches"],
                          "quality": ql["quality_flash_launches"],
                          "multidevice": md["md_flash_launches"],
                          "train-mesh": tm["mesh_launches"]["flash_attention"],
                          "bench: bench_torch.py flash_probe": bn["flash_launches"]},
    ), dict(
        name="approx_maxsim", route="cuda", variant="warp-per-candidate over a bf16 table",
        source="colbert_torch/csrc/approx_maxsim.cu",
        replaces="colbert_tpu/retrieval/device_index.py:878",
        launches=mp["refine_launches"], max_abs_err=max(mp["refine_err"], mp["refine_plain_err"]),
        ms=mp["refine_ms"], kernel_ms=mp["refine_gather_ms"], table_ms=mp["refine_table_ms"],
        plain_ms=mp["refine_plain_ms"], bound_ms=mp["refine_bound_ms"],
        bound_by=mp["refine_bound_by"], design_bound_ms=mp["refine_design_bound_ms"],
        token_bound_ms=mp["refine_token_bound_ms"], library_ms=None,
        launches_by_path={"serve": mp["refine_launches"],
                          "serve-batcher": live["batcher_refine_launches"],
                          "serve-http": live["http_refine_launches"],
                          "tune": live["tune_refine_launches"],
                          "update": live["update_refine_launches"],
                          "build-search": bs["search_refine_launches"],
                          "train": tr["train_refine_launches"],
                          "examples": ex["examples_refine_launches"],
                          "quality": ql["quality_refine_launches"],
                          "multidevice": md["md_refine_launches"],
                          "bench: bench_torch.py serve_and_probe": bn["refine_launches"]},
    ), dict(
        name="nearest_centroid", route="cuda", variant="mma.sync bf16, three centroid terms",
        source="colbert_torch/csrc/nearest_centroid.cu",
        replaces="colbert_tpu/ops/kmeans.py:64",
        launches=bp["kmeans_launches"],
        ms={c: min(r["kernel_ms"]) for c, r in kmeans_res.items()},
        lloyd_pass_ms={c: r["lloyd_pass_ms"] for c, r in kmeans_res.items()},
        plain_ms={c: r["plain_ms"] for c, r in kmeans_res.items()},
        bound_ms={c: r["bound_ms"] for c, r in kmeans_res.items()}, bound_by="operations",
        terms_bound_ms={c: r["terms_bound_ms"] for c, r in kmeans_res.items()},
        library_ms=None,
        launches_by_path={"build": bp["kmeans_launches"],
                          "update": live["update_kmeans_launches"],
                          "multidevice": md["md_kmeans_launches"],
                          "kmeans": {c: r["launches_per_pass"] for c, r in kmeans_res.items()}},
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
