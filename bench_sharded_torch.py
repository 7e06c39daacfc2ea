"""Rehearsal of the sharded serving backend of the PyTorch port (the
counterpart of ``bench_sharded.py``).

    python bench_sharded_torch.py [INDEX_DIR] [n_queries] [--devices N] [--device cuda|cpu]

Serves the index at INDEX_DIR (default ``idx4m``) through
``colbert_torch.parallel.sharded_index.ShardedDeviceIndex`` over N data
shards (default 8) on the device list ``[device] * N``: one card repeated
stands in for N devices, and the shards then run in turn, so the QPS here
times the code path and not a mesh's gain. Reports on stderr the sharded
load's seconds, the per-shard and total device bytes, peak host RSS, the
capacity sizing, warm QPS over 3 batches of ``n_queries`` (default 32)
random unit queries, and ``merge_shard_topk`` timed on same-shaped tables;
checks the shape, that every pid is below n, and that scores descend.
Prints one JSON summary as the last stdout line. ``--device cuda`` (the
default) raises without a GPU.

Make an index to serve with ``colbert_torch.utils.testing.synthesize_index``
(random but consistent codec, chunks and IVF, no encoder); e.g.

    python -c "from colbert_torch.utils.testing import synthesize_index; \\
               synthesize_index('idx4m', 4_000_000)"

writes the 4M-passage index of ``bench_sharded.py``'s default (~17 GB on
disk; ~2.2 GB per shard over 8 shards).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from bench_torch import card, log, sync
from colbert_torch.config import ColBERTConfig
from colbert_torch.parallel.mesh import make_mesh
from colbert_torch.parallel.sharded_index import ShardedDeviceIndex, merge_shard_topk
from colbert_torch.storage import format as fmt
from colbert_torch.utils.build import resolve_device

BATCH_REPS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("index_dir", nargs="?", default="idx4m")
    ap.add_argument("n_queries", nargs="?", type=int, default=32)
    ap.add_argument("--devices", type=int, default=8, help="data shards")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    path, n_q = args.index_dir, args.n_queries

    plan = fmt.load_plan(path)
    n = int(plan["num_documents"])
    codec = fmt.load_codec(path)
    doclens = np.asarray(fmt.load_all_doclens(path), np.int64)
    nbits = ColBERTConfig.load(os.path.join(path, "config.json")).nbits
    mesh = make_mesh(args.devices, 1, devices=[device] * args.devices)
    log(f"index: {n} passages, {plan['num_embeddings']} embeddings, "
        f"{plan['num_partitions']} partitions; {args.devices} shards on "
        f"[{device}] x {args.devices} ({card(device)['smi']})")

    t0 = time.perf_counter()
    sharded = ShardedDeviceIndex.build(
        mesh, centroids=codec["centroids"], stream_from=path, doclens=doclens,
        bucket_weights=codec["bucket_weights"], nbits=nbits, balance_cap=1024)
    sync(device)
    load_s = time.perf_counter() - t0
    shard_bytes = {
        s: sum(t.numel() * t.element_size() for t in (
            sh.codes, sh.residuals, sh.ivf, sh.ivf_offsets, sh.ivf_lengths, sh.doclens,
            sh.emb_offsets, sh.centroids, sh.bucket_weights))
        for s, sh in sharded.shards.items()}
    total_bytes = sum(shard_bytes.values())
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log(f"sharded load (each shard's rows streamed from the chunk files): {load_s:.2f}s; "
        f"per shard {max(shard_bytes.values()) / 1e9:.3f} GB at most "
        f"({', '.join(f'{b / 1e9:.3f}' for b in shard_bytes.values())}), total device "
        f"{total_bytes / 1e9:.3f} GB over {len(shard_bytes)} shards (each shard holds its "
        f"own copy of the {codec['centroids'].shape[0]} centroids); peak host RSS "
        f"{rss:.2f} GB")
    shards = list(sharded.shards.values())
    log(f"capacity sizing: probe_dup_max={sharded.probe_dup_max} (worst shard), "
        f"split mass {sharded.probe_split_mass:.4f}, longest probe cell "
        f"{sharded.max_cell_length}; per-shard probe tables K'="
        f"{[sh.ivf_lengths.numel() for sh in shards]}, passages "
        f"{[sh.n_passages for sh in shards]} (merge sentinel Ps={sharded.shard_passages}), "
        f"padded doc rows {[sh.max_doclen for sh in shards]}")

    rng = np.random.default_rng(0)
    dim = codec["centroids"].shape[1]
    Q = rng.normal(size=(n_q, 32, dim)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    Qd = torch.from_numpy(Q).to(device)
    kw = dict(k=10, nprobe=sharded.compensated_nprobe(2), ncandidates=1024,
              cell_cap=1024, max_candidates=8192)

    t1 = time.perf_counter()
    pids, scores = sharded.search_Q_batch(Qd, **kw)
    log(f"first batch: {time.perf_counter() - t1:.2f}s")
    t2 = time.perf_counter()
    for _ in range(BATCH_REPS):
        pids, scores = sharded.search_Q_batch(Qd, **kw)
    dt = (time.perf_counter() - t2) / BATCH_REPS
    qps = n_q / dt
    # the host merge alone, on same-shaped tables: (D, B, k_local) local
    # pids and scores as finalize gathers them
    D = len(sharded.pid_base)
    lp = rng.integers(0, sharded.shard_passages + 1, size=(D, n_q, kw["k"]))
    ls = rng.normal(size=(D, n_q, kw["k"])).astype(np.float32)
    t3 = time.perf_counter()
    for _ in range(20):
        merge_shard_topk(lp, ls, sharded.pid_base, sharded.shard_passages, kw["k"])
    merge_ms = (time.perf_counter() - t3) / 20 * 1000
    valid = pids[pids >= 0]
    log(f"warm sharded search (B={n_q}): {dt * 1000:.1f} ms per batch = {qps:.2f} QPS on "
        f"one {device.type} device with the {D} shards in turn (the code path, not a "
        f"mesh's gain; host merge ~{merge_ms:.3f} ms of it); {len(np.unique(valid))} "
        f"unique pids in [0, {n})")
    if pids.shape != (n_q, 10) or not (pids < n).all():
        raise AssertionError(f"pids of shape {pids.shape}, max {pids.max()}, n {n}")
    desc = bool(np.all(np.diff(scores, axis=1) <= 1e-6))
    log(f"scores monotone per query: {desc}")
    if not desc:
        raise AssertionError("scores do not descend along k")

    print(json.dumps({
        "metric": "sharded_rehearsal_load_seconds",
        "n_passages": n,
        "value": round(load_s, 2),
        "unit": "s",
        "per_shard_gb": round(max(shard_bytes.values()) / 1e9, 3),
        "total_device_gb": round(total_bytes / 1e9, 3),
        "peak_host_rss_gb": round(rss, 2),
        "qps_one_card": round(qps, 2),
        "probe_dup_max": sharded.probe_dup_max,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
