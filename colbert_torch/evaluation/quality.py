"""Funnel quality where it can be measured: train margins into the encoder,
rebuild the index, then funnel recall against the exact oracle; the
counterpart of the JAX package's ``bench_quality.py``.

With random weights the exact oracle's top-k over a large synthetic corpus
is dominated by ties, so funnel recall measured against it says nothing
about the funnel. This drill:

  1. fine-tunes the seeded bench ColBERT on (prefix query, passage,
     same-topic negative) triples (:func:`train_encoder`): same-topic
     negatives share ~60% of the positive's words, so the encoder must
     learn per-passage margins, not topic membership;
  2. rebuilds the index at the requested scale with the trained encoder;
  3. reports the oracle's margins (top1 - top10 must be far above tie
     noise) and the funnel's recall@10/@100 against the exhaustive
     exact-codec oracle at five operating points, with QPS beside them,
     plus self-retrieval success@1 (:func:`measure`).

Usage:
    python -m colbert_torch.evaluation.quality [n_passages] [train_steps]
        [num_partitions] [balance_cap] [tune] [probesweep] [depthsweep]
        [--device cuda]

The numbers default to 141431, 300, the planner's partition count and 1024
(0 keeps the default); the last two are the per-corpus A/B knobs
(``config.num_partitions`` / ``ivf_balance_cap``). The words are flags:
``tune`` runs the autotuner drill (balance-cap sweep with a depth target),
``probesweep`` the probe-compensation sweep and ``depthsweep`` the
depth@100 sweep. Prints one JSON summary as its last line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np

from colbert_torch.evaluation.metrics import score_recall_at_k, set_recall_at_k
from colbert_torch.evaluation.oracle import exhaustive_scores
from colbert_torch.utils.build import resolve_device

__all__ = ["train_encoder", "measure", "main", "FLAGS"]

FLAGS = ("tune", "probesweep", "depthsweep")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def train_encoder(encoder, passages, *, steps: int, batch_size: int = 32,
                  seed: int = 0) -> dict:
    """Fine-tune ``encoder`` in place on ``make_triples`` over ``passages``
    (AdamW at 3e-5, warmup min(20, steps // 5), cosine decay to 0 at
    ``steps``, in-batch negatives) -> training stats."""
    from colbert_torch.training.trainer import ColBERTTrainer
    from colbert_torch.utils.testing import make_triples

    # train at the corpus's length (~110-140 tokens): the trainer pads docs
    # to doc_maxlen, and the bench's 300 would pay 2x attention for padding
    doc_maxlen_full = encoder.config.doc_maxlen
    encoder.config.doc_maxlen = min(192, doc_maxlen_full)
    try:
        trainer = ColBERTTrainer(
            encoder, learning_rate=3e-5, warmup_steps=min(20, steps // 5),
            total_steps=steps, in_batch_negatives=True,
        )
        triples = make_triples(passages, steps * batch_size, seed=seed)
        t0 = time.perf_counter()
        for step in range(steps):
            batch = triples[step * batch_size:(step + 1) * batch_size]
            m = trainer.train_step(batch)
            if step < 3 or (step + 1) % 25 == 0:
                log(f"  step {step + 1:4d}: loss {m['loss']:.4f} "
                    f"acc {m['pairwise_acc']:.3f} margin {m['margin']:.3f}")
        dt = time.perf_counter() - t0
    finally:
        encoder.config.doc_maxlen = doc_maxlen_full
    last = trainer.history[-1]
    acc_tail = float(np.mean([h["pairwise_acc"] for h in trainer.history[-20:]]))
    log(f"trained {steps} steps x {batch_size} triples in {dt:.1f}s "
        f"({steps / dt:.2f} steps/s); tail-20 pairwise acc {acc_tail:.3f}")
    return {"steps": steps, "train_seconds": round(dt, 1),
            "final_loss": round(last["loss"], 4),
            "tail_acc": round(acc_tail, 4),
            "final_margin": round(last["margin"], 4)}


def measure(encoder, cfg, passages, *, flags=frozenset()) -> dict:
    """Index ``passages`` with ``encoder`` under ``cfg`` in a temporary
    directory, then the oracle's margins, funnel recall at the five
    operating points, self-retrieval, QPS at B=64 and the ``flags``'
    sweeps -> the summary (without ``train``)."""
    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.utils.testing import synthetic_queries, time_qps

    n = len(passages)
    device = encoder.device
    tmp = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        Indexer(cfg, encoder=encoder, collection=passages, device=device).index(tmp + "/idx")
        build_s = time.perf_counter() - t0
        log(f"index rebuilt with trained encoder: {build_s:.1f}s = {n / build_s:.1f} p/s")
        s = Searcher(tmp + "/idx", encoder=encoder, device=device)

        # eval queries: passage prefixes (the training distribution) over a
        # spread of pids; the ground truth of self-retrieval is the pid
        probe = list(range(0, n, max(1, n // 32)))[:32]
        queries = [passages[i][:200] for i in probe]
        Qe = encoder.encode_queries(queries)

        t1 = time.perf_counter()
        oscores = exhaustive_scores(s, Qe)
        log(f"exhaustive oracle over {n} x {len(probe)} queries: "
            f"{time.perf_counter() - t1:.1f}s")
        osorted = -np.sort(-oscores, axis=1)
        margin_1_10 = float(np.mean(osorted[:, 0] - osorted[:, 9]))
        margin_10_100 = float(np.mean(osorted[:, 9] - osorted[:, 99]))
        log(f"oracle margins (trained space): top1-top10 {margin_1_10:.3f}, "
            f"top10-top100 {margin_10_100:.3f} "
            f"(tie threshold ~0.01: recall@k is now a funnel property)")
        oracle = np.argsort(-oscores, axis=1)[:, :100]
        s1_oracle = float(np.mean([oracle[b, 0] == probe[b] for b in range(len(probe))]))

        kw = dict(k=100, cell_cap=s.cell_cap, max_candidates=s.max_candidates)
        nprobe_c = s.device_index.compensated_nprobe(cfg.nprobe)
        ncand = cfg.plaid_stage2_docs or max(16 * 100, 1024)
        threshold = cfg.centroid_score_threshold
        points = {
            "quality-first": dict(nprobe=nprobe_c, ncandidates=ncand,
                                  centroid_threshold=threshold, stage1_refine=True),
            "throughput-tuned (ncand=512, no refine)": dict(
                nprobe=cfg.nprobe, ncandidates=512, centroid_threshold=threshold,
                stage1_refine=False),
            "no refine, nprobe+2 (refine-vs-probes tradeoff)": dict(
                nprobe=nprobe_c + 2, ncandidates=ncand, centroid_threshold=threshold,
                stage1_refine=False),
            "quality-first rw=2 (half refine window)": dict(
                nprobe=nprobe_c, ncandidates=ncand, centroid_threshold=threshold,
                stage1_refine=True, refine_width=2),
            "tight (ncand=128)": dict(nprobe=nprobe_c, ncandidates=128,
                                      centroid_threshold=threshold, stage1_refine=True),
        }
        recalls = {}
        for name, p in points.items():
            pids_np, _ = s.device_index.search_Q_batch(Qe, **p, **kw)
            r10 = set_recall_at_k(pids_np, oracle, 10)
            r100 = set_recall_at_k(pids_np, oracle, 100)
            sr10 = score_recall_at_k(pids_np, oscores, 10)
            recalls[name] = (r10, r100, sr10)
            log(f"funnel recall vs exhaustive [{name}]: set@10 {r10:.3f} / "
                f"@100 {r100:.3f}; score@10 {sr10:.3f}")

        pp, _ = s.search_batch(queries, k=3)
        s1 = float(np.mean([pp[b][0] == probe[b] for b in range(len(probe))]))
        log(f"self-retrieval success@1: funnel {s1:.3f} vs oracle {s1_oracle:.3f}")

        # serving QPS on the trained index: a trained model clusters its
        # space, so this is the production-shaped number
        qs = synthetic_queries(192)
        qps_quality = time_qps(s, qs, 64)
        log(f"batched search on trained index (B=64, quality-first): "
            f"{qps_quality:.1f} QPS (probe_dup_max={s.device_index.probe_dup_max}, "
            f"split_mass={s.device_index.probe_split_mass:.4f}, effective nprobe="
            f"{s.device_index.compensated_nprobe(cfg.nprobe)})")
        s.config.refine_width_factor = 2
        qps_rw2 = time_qps(s, qs, 64)
        log(f"batched search on trained index (B=64, quality-first rw=2): {qps_rw2:.1f} QPS")
        s.config.refine_width_factor = 4
        s.config.plaid_stage1_refine = False
        s.config.nprobe = cfg.nprobe + 2
        qps_probes = time_qps(s, qs, 64)
        log(f"batched search on trained index (B=64, no refine, nprobe+2): "
            f"{qps_probes:.1f} QPS")
        s.config.nprobe = cfg.nprobe
        s.config.probe_dup_compensation = False
        s.config.plaid_stage2_docs = 512
        qps_tuned = time_qps(s, qs, 64)
        log(f"batched search on trained index (B=64, throughput-tuned): {qps_tuned:.1f} QPS")
        s.config.plaid_stage1_refine = True
        s.config.probe_dup_compensation = True
        s.config.plaid_stage2_docs = None

        if "probesweep" in flags:
            # probe_comp_saturation calibration at this geometry: recall and
            # QPS at 0..dup_max-1 extra probes (the knee is where recall
            # stops moving)
            dup = s.device_index.probe_dup_max
            mass = s.device_index.probe_split_mass
            for extra in range(0, dup):
                p = dict(nprobe=cfg.nprobe + extra, ncandidates=ncand,
                         centroid_threshold=threshold, stage1_refine=True)
                pids_np, _ = s.device_index.search_Q_batch(Qe, **p, **kw)
                s.config.probe_dup_compensation = False
                s.config.nprobe = cfg.nprobe + extra
                qps_e = time_qps(s, qs, 64)
                s.config.nprobe = cfg.nprobe
                s.config.probe_dup_compensation = True
                log(f"probe-comp sweep [dup_max={dup} split_mass={mass:.3f}] "
                    f"extra={extra}: set@10 {set_recall_at_k(pids_np, oracle, 10):.3f} "
                    f"score@10 {score_recall_at_k(pids_np, oscores, 10):.3f} "
                    f"@100 {set_recall_at_k(pids_np, oracle, 100):.3f} {qps_e:.1f} QPS")

        if "depthsweep" in flags:
            # depth@100 beyond the tuner's grid: the static candidate and
            # selection budgets at cap 2048, each priced in ms per batch
            s.set_balance_cap(2048)
            kw_d = dict(k=100, cell_cap=s.cell_cap)
            np_c = s.device_index.compensated_nprobe(cfg.nprobe)
            log(f"depth sweep at cap=2048 (compensated nprobe {np_c}, "
                f"cell_cap {s.cell_cap})")
            for nc, maxc, npr in ((4096, 8192, np_c), (8192, 8192, np_c),
                                  (8192, 16384, np_c), (8192, 16384, np_c + 2),
                                  (16384, 32768, np_c)):
                p = dict(nprobe=npr, ncandidates=nc, centroid_threshold=threshold,
                         stage1_refine=True, max_candidates=maxc)
                t0 = time.perf_counter()
                pids_np, _ = s.device_index.search_Q_batch(Qe, **p, **kw_d)
                first = time.perf_counter() - t0
                best = float("inf")  # best of 2 warm repetitions
                for _ in range(2):
                    t0 = time.perf_counter()
                    s.device_index.search_Q_batch(Qe, **p, **kw_d)
                    best = min(best, time.perf_counter() - t0)
                log(f"depth sweep [ncand={nc} maxcand={maxc} nprobe={npr}]: "
                    f"set@10 {set_recall_at_k(pids_np, oracle, 10):.3f} "
                    f"score@10 {score_recall_at_k(pids_np, oscores, 10):.3f} "
                    f"set@100 {set_recall_at_k(pids_np, oracle, 100):.3f} "
                    f"{best * 1e3:.0f} ms/batch(B={Qe.shape[0]}) (first {first:.1f}s)")
            s.set_balance_cap(cfg.ivf_balance_cap)

        tune_report = None
        if "tune" in flags:
            # does the autotuner pick a >= 0.95 score@10 point (with a depth
            # floor) at this scale on its own?
            from colbert_torch.evaluation.autotune import tune_operating_point

            t0 = time.perf_counter()
            res = tune_operating_point(
                s, queries, k=10, target_score_recall=0.95,
                balance_caps=(1024, 2048, 4096),
                depth_k=100, target_depth_recall=0.90, time_reps=2,
            )
            log(f"autotune (balance_caps x grid, depth@100) took "
                f"{time.perf_counter() - t0:.1f}s")
            log(str(res))
            res.apply(s)
            qps_tuned_auto = time_qps(s, qs, 64)
            log(f"autotuned point [{res.chosen.point.label()}, cap="
                f"{res.chosen.balance_cap}]: {qps_tuned_auto:.1f} QPS, "
                f"score@10 {res.chosen.score_recall:.3f}, "
                f"score@100 {res.chosen.depth_score_recall:.3f}, "
                f"met_target={res.met_target}")
            tune_report = {
                "chosen": res.chosen.point.label(),
                "balance_cap": res.chosen.balance_cap,
                "met_target": res.met_target,
                "score_recall_10": round(res.chosen.score_recall, 3),
                "score_recall_100": round(res.chosen.depth_score_recall, 3),
                "qps_b64": round(qps_tuned_auto, 1),
            }

        qf = recalls["quality-first"]
        return {
            "metric": "trained_funnel_recall_at_10",
            "n_passages": n,
            "value": round(qf[0], 3),
            "unit": "set-recall@10 vs exhaustive",
            "recall_at_100": round(qf[1], 3),
            "score_recall_at_10": round(qf[2], 3),
            "oracle_margin_top1_top10": round(margin_1_10, 3),
            "self_retrieval_s1": s1,
            "qps_b64_quality": round(qps_quality, 1),
            "qps_b64_quality_rw2": round(qps_rw2, 1),
            "qps_b64_probes_no_refine": round(qps_probes, 1),
            "qps_b64_tuned": round(qps_tuned, 1),
            "tune": tune_report,
            "build_seconds": round(build_s, 1),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: list[str] | None = None) -> dict:
    """Train, rebuild, measure; prints and returns the JSON summary."""
    ap = argparse.ArgumentParser(
        prog="python -m colbert_torch.evaluation.quality",
        description="numbers: n_passages train_steps num_partitions balance_cap; "
                    f"words: {', '.join(FLAGS)}")
    ap.add_argument("args", nargs="*", metavar="NUMBER_OR_FLAG")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; needs a GPU) or cpu")
    args = ap.parse_intermixed_args(argv)
    flags = {a for a in args.args if not a.lstrip("-").isdigit()}
    nums = [int(a) for a in args.args if a.lstrip("-").isdigit()]
    if flags - set(FLAGS) or len(nums) > 4:
        ap.error(f"expected up to 4 numbers and the words {', '.join(FLAGS)}; "
                 f"got {args.args}")
    n = nums[0] if len(nums) > 0 else 141_431
    steps = nums[1] if len(nums) > 1 else 300
    partitions = (nums[2] if len(nums) > 2 else 0) or None
    balance_cap = (nums[3] if len(nums) > 3 else 0) or None
    device = resolve_device(args.device)

    from colbert_torch.utils.testing import N_TOPICS, make_bench_encoder, synthetic_passages

    encoder, cfg = make_bench_encoder(device=device)
    cfg.chunksize = 25_000
    cfg.search_max_candidates = 8192
    if partitions:
        cfg.num_partitions = partitions
        log(f"num_partitions override: {partitions}")
    if balance_cap is not None:
        cfg.ivf_balance_cap = balance_cap
        log(f"ivf_balance_cap override: {balance_cap}")
    passages = synthetic_passages(n)
    log(f"corpus: {n} passages, {N_TOPICS} topics")

    train_stats = train_encoder(encoder, passages, steps=steps)
    summary = measure(encoder, cfg, passages, flags=flags)
    summary["train"] = train_stats
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
