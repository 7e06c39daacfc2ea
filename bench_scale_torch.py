"""At-scale build and serve of the PyTorch port on one NVIDIA GPU (the
counterpart of ``bench_scale.py``).

    python bench_scale_torch.py [n_passages] [scaled] [--device cuda|cpu]
                                [--bert base|narrow]

Builds and serves a synthetic corpus the size of the reference's one real
measurement, 141,431 passages (~16M embeddings; the Julia reference took
8,771.6 s on one CUDA GPU, 16.1 passages/s), with ``bench_torch``'s
encoder and configuration at the scale's capacities (search_max_candidates
8192, chunksize 25,000), and reports on stderr:

  - the build's wall time and passages/s, the index's size on disk,
  - peak host RSS (``ru_maxrss``) and the device's peak allocation
    (``torch.cuda.max_memory_allocated()``) after the build and after the
    Searcher's load, and the load's seconds,
  - the Searcher's static capacities (cell_cap, max_candidates,
    probe_dup_max, the split mass and the compensated nprobe),
  - QPS at B = 32/64/128 quality-first and B = 128/64 throughput-tuned,
    ``search_stream`` (B=64, 2 in flight) in both modes, and the candidates
    the stage-1 selection dropped,
  - funnel recall against the exact oracle over all n passages for 16
    queries, and self-retrieval success@1 of 32 passage-prefix queries.

The last stdout line is one JSON summary (``bench_scale.py``'s keys, its
``hbm_gb`` as ``device_gb``). The default corpus keeps 64 topics, so
per-topic ties grow with n (the adversarial regime for centroid pruning);
``scaled`` grows the topics with the corpus (n/64 topics over 30,000 words).
``--device cuda`` (the default) raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from bench_torch import (
    BASELINE_BUILD_PASSAGES_PER_SEC,
    _recall,
    _score_recall,
    card,
    log,
    narrow_bert_config,
)
from colbert_torch.evaluation.oracle import exhaustive_scores
from colbert_torch.utils.build import resolve_device
from colbert_torch.utils.testing import (
    bench_bert_config,
    make_bench_encoder,
    synthetic_passages,
    synthetic_queries,
    time_qps,
)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6  # KB -> GB


def device_gb(device: torch.device) -> float | None:
    """The device's peak allocation so far, GB (None on the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def memory_text(device: torch.device) -> str:
    d = device_gb(device)
    dev = "n/a on the CPU" if d is None else f"{d:.2f} GB"
    return f"peak host RSS {rss_gb():.2f} GB, device peak allocated {dev}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=141_431)
    ap.add_argument("scaled", nargs="?", choices=("scaled",))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bert", choices=("base", "narrow"), default="base")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.n
    n_topics = max(64, n // 64) if args.scaled else 64
    n_words = 30_000 if args.scaled else 2_000
    bert = bench_bert_config() if args.bert == "base" else narrow_bert_config()
    encoder, cfg = make_bench_encoder(n_words=n_words, device=device, bert_config=bert)
    # at-scale capacities: cell_cap auto-sized from the balanced IVF, the
    # stage-2 budget at PLAID's operating point
    cfg.search_max_candidates = 8192
    cfg.chunksize = 25_000  # the reference's default at this corpus size
    log(f"[scale] BERT {bert}, {cfg.activation_dtype}, on {card(device)['smi']}")

    t = time.perf_counter()
    passages = synthetic_passages(n, n_words=n_words, n_topics=n_topics)
    log(f"synthesized {n} passages in {time.perf_counter() - t:.1f}s "
        f"({n_topics} topics over {n_words} words, ~110 words each)")

    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.retrieval.searcher import Searcher

    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "idx")
        t0 = time.perf_counter()
        Indexer(cfg, encoder=encoder, collection=passages, device=device).index(path)
        build_s = time.perf_counter() - t0
        build_pps = n / build_s
        log(f"index build: {n} passages in {build_s:.2f}s = {build_pps:.1f} p/s "
            f"(reference: the same size took 8771.6s = 16.1 p/s -> "
            f"{build_pps / BASELINE_BUILD_PASSAGES_PER_SEC:.1f}x)")
        with open(os.path.join(path, "plan.json")) as f:
            timings = json.load(f).get("timings", {})
        log("build phases: " + ", ".join(
            f"{k} {v['seconds']:.2f}s" for k, v in sorted(timings.items())))
        log(f"after build: {memory_text(device)}")
        idx_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        log(f"on-disk index: {idx_bytes / 1e9:.3f} GB ({idx_bytes / max(1, n):.0f} B/passage)")

        t1 = time.perf_counter()
        s = Searcher(path, encoder=encoder, device=device)
        load_s = time.perf_counter() - t1
        log(f"searcher load (chunks streamed from their mmaps to the device): "
            f"{load_s:.2f}s; {memory_text(device)}")
        di = s.device_index
        log(f"static capacities: cell_cap={s.cell_cap}, max_candidates={s.max_candidates}, "
            f"probe_dup_max={di.probe_dup_max} (split mass {di.probe_split_mass:.4f} -> "
            f"effective nprobe {di.compensated_nprobe(cfg.nprobe)})")

        queries = synthetic_queries(192, n_words=n_words, n_topics=n_topics)
        qps = {}
        for B in (32, 64, 128):
            qps[f"b{B}_quality"] = time_qps(s, queries, B)
            log(f"batched search (B={B}, warm, quality-first): {qps[f'b{B}_quality']:.1f} QPS")
        s.config.plaid_stage1_refine = False
        s.config.probe_dup_compensation = False
        for B in (128, 64):
            qps[f"b{B}_tuned"] = time_qps(s, queries, B)
            log(f"batched search (B={B}, warm, throughput-tuned): {qps[f'b{B}_tuned']:.1f} QPS")
        batches = [queries[(i * 64) % 128:(i * 64) % 128 + 64] for i in range(8)]
        for mode in ("tuned", "quality"):
            if mode == "quality":
                s.config.plaid_stage1_refine = True
                s.config.probe_dup_compensation = True
            list(s.search_stream(batches[:2], k=10))
            t3 = time.perf_counter()
            list(s.search_stream(batches, k=10, max_inflight=2))
            qps[f"b64_stream_{mode}"] = 64 * len(batches) / (time.perf_counter() - t3)
            log(f"pipelined search_stream (B=64, {mode}, 2 in flight): "
                f"{qps[f'b64_stream_{mode}']:.1f} QPS")
        log(f"candidate overflow after the QPS runs: {di.overflow_candidates} dropped "
            f"beyond the stage-1 selection width (lowest stage-1 scores)")

        Qe = torch.from_numpy(s.encoder.encode_queries(list(
            synthetic_queries(16, n_words=n_words, n_topics=n_topics))))
        t2 = time.perf_counter()
        oscores = exhaustive_scores(s, Qe)
        log(f"exhaustive oracle over {n} passages x 16 queries: "
            f"{time.perf_counter() - t2:.2f}s")
        oracle = np.argsort(-oscores, axis=1)[:, :100]
        pids, _ = di.search_Q_batch(
            Qe, k=100, nprobe=di.compensated_nprobe(cfg.nprobe),
            ncandidates=cfg.plaid_stage2_docs or max(16 * 100, 1024),
            cell_cap=s.cell_cap, max_candidates=s.max_candidates,
            centroid_threshold=cfg.centroid_score_threshold)
        r10 = _recall(pids, oracle, 10)
        sr10 = _score_recall(pids, oscores, 10)
        log(f"funnel recall vs exhaustive (quality-first): set@10 {r10:.3f}, "
            f"score@10 {sr10:.3f}")

        probe = list(range(0, n, n // 32))[:32]
        pp, _ = s.search_batch([passages[i][:200] for i in probe], k=3)
        s1 = float(np.mean([pp[b][0] == probe[b] for b in range(32)]))
        log(f"self-retrieval success@1 over {n} passages: {s1:.3f}")
        dgb = device_gb(device)
        print(json.dumps({
            "metric": "scale_build_passages_per_sec",
            "n_passages": n,
            "value": round(build_pps, 2),
            "unit": "passages/s",
            "vs_baseline": round(build_pps / BASELINE_BUILD_PASSAGES_PER_SEC, 2),
            "build_seconds": round(build_s, 2),
            "peak_host_rss_gb": round(rss_gb(), 2),
            "device_gb": None if dgb is None else round(dgb, 2),
            "index_gb": round(idx_bytes / 1e9, 3),
            "qps_b64_tuned": round(qps["b64_tuned"], 1),
            "qps_b64_stream_tuned": round(qps["b64_stream_tuned"], 1),
            "qps_b64_stream_quality": round(qps["b64_stream_quality"], 1),
            "self_retrieval_s1": s1,
            "score_recall_at_10": round(sr10, 3),
        }), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
