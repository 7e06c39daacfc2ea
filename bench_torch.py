"""Benchmark of the PyTorch port (``colbert_torch``) on one NVIDIA GPU: the
index build's passages/s, then the encode, MFU, flash, serving and
host-backend stages. The counterpart of ``bench.py``, with its corpus, its
configuration and its stdout contract.

    python bench_torch.py [--device cuda|cpu] [--n 4096] [--bert base|narrow]

Headline: ``Indexer.index`` passages/s over ``--n`` synthetic ~110-word
passages (``make_bench_encoder``: doc_maxlen 300, length buckets of 32,
index_bsize 256, nbits 2, 4 k-means iterations, chunksize 4096, a
random-weight ColBERT at bert-base width with bf16 activations). One cold
build, then three warm builds; the headline is the best warm build,
against 16.1 passages/s: the Julia reference's 141,431 passages on one CUDA
GPU (BASELINE.md).

stdout holds only the headline line
``{"metric": "index_build_passages_per_sec", "value", "unit", "vs_baseline"}``,
printed and flushed after the build, again after each of the five
secondary stages, and once more at the end: seven identical lines. A build
failure propagates before any headline. A secondary stage that raises
does not stop the others or the repeats; its traceback goes to stderr and
the process exits 1 at the end. Everything else goes to stderr, each
stage's numbers also as one ``stage <name> {json}`` line.

MFU counts the model FLOPs from the shapes: per padded token and layer
2*(4h^2 + 2hf) + 4Sh (the four projections, the MLP, the two attention
products), plus 2*h*dim for the head; against the card's dense bf16 peak
from ``BF16_PEAK_TFLOPS``, keyed by ``torch.cuda.get_device_name()``, and
printed beside ``nvidia-smi``'s name and power limit. A card not in the
table gets a share of null. Timing is ``time.perf_counter()`` around work
that ends in a read-back or a ``torch.cuda.synchronize()``.

``--device cuda`` (the default) raises without a GPU; ``--device cpu``
runs every stage on the CPU, where the kernels' plain versions stand in
and no time means anything about a device. ``--bert narrow`` (2 layers,
hidden 64, 4 heads) is for tests on the CPU.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from colbert_torch.config import ColBERTConfig
from colbert_torch.evaluation.metrics import score_recall_at_k as _score_recall
from colbert_torch.evaluation.metrics import set_recall_at_k as _recall
from colbert_torch.evaluation.oracle import exhaustive_scores
from colbert_torch.models.bert import BertConfig
from colbert_torch.models.encoder import ColBERTEncoder
from colbert_torch.ops import approx_maxsim as am
from colbert_torch.ops import flash_attention as fa
from colbert_torch.ops import fused_maxsim as fm
from colbert_torch.utils.build import resolve_device
from colbert_torch.utils.testing import (
    bench_bert_config,
    make_bench_encoder,
    synthetic_passages,
    synthetic_queries,
    time_qps,
)

BASELINE_ENCODE_PASSAGES_PER_SEC = 40.0  # checkpoint.jl:151-155 (25.25s / 1000)
BASELINE_BUILD_PASSAGES_PER_SEC = 16.1   # examples/AIHelpMe/indexing_output:121
# dense bf16 tensor-core peak by torch.cuda.get_device_name(): NVIDIA's
# data sheet, H100 SXM at its 700 W limit
BF16_PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}
FLASH_PASSAGES = 256


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def narrow_bert_config() -> BertConfig:
    """bert-base's vocabulary at 2 layers, hidden 64, 4 heads: for the CPU."""
    return BertConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=128, max_position_embeddings=512)


def card(device: torch.device) -> dict:
    """The device's name, peak and ``nvidia-smi``'s name and power limit."""
    if device.type != "cuda":
        return {"name": "cpu", "smi": "cpu", "peak_tflops": None}
    name = torch.cuda.get_device_name(device)
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        smi = done.stdout.strip().splitlines()[0] if done.returncode == 0 else "unknown"
    except (FileNotFoundError, subprocess.TimeoutExpired):
        smi = "unknown"
    return {"name": name, "smi": smi, "peak_tflops": BF16_PEAK_TFLOPS.get(name)}


def flops_per_token(bert: BertConfig, seqlen: int, dim: int) -> float:
    """Model FLOPs of one padded token of a length-``seqlen`` batch: per
    layer the q/k/v/output projections (4h^2 MACs), the MLP (2hf) and the
    two attention products (2Sh), plus the head (h*dim); 2 FLOPs a MAC."""
    h, f = bert.hidden_size, bert.intermediate_size
    per_layer = 2 * (4 * h * h + 2 * h * f) + 4 * seqlen * h
    return bert.num_hidden_layers * per_layer + 2 * h * dim


def batch_flops(bert: BertConfig, dim: int, shapes) -> float:
    """Model FLOPs of encoding padded batches of ``shapes`` [(B, S), ...]."""
    return sum(B * S * flops_per_token(bert, S, dim) for B, S in shapes)


def mfu_fields(flops: float, seconds: float, dev: dict) -> dict:
    """TFLOP/s and its share of the card's bf16 peak (None off the table)."""
    tflops = flops / seconds / 1e12
    peak = dev["peak_tflops"]
    return {"tflops": tflops, "mfu": None if peak is None else tflops / peak,
            "peak_tflops": peak, "card": dev["smi"]}


def mfu_text(m: dict) -> str:
    share = "null" if m["mfu"] is None else f"{m['mfu'] * 100:.2f}%"
    peak = "no bf16 peak on record" if m["peak_tflops"] is None else (
        f"of {m['peak_tflops']:g} TFLOP/s bf16")
    return f"{m['tflops']:.2f} TFLOP/s = MFU {share} {peak} ({m['card']})"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> dict:
    """The kernels' launch counts by variant so far."""
    return {"stage2": dict(fm.stage2_maxsim.variant_launches),
            "flash": dict(fa.flash_attention.variant_launches),
            "refine": dict(am.approx_maxsim.variant_launches)}


def launches_since(before: dict) -> dict:
    now = launches()
    return {k: {v: now[k][v] - before[k][v] for v in now[k]} for k in now}


def oracle_err(pids: np.ndarray, scores: np.ndarray, oscores: np.ndarray) -> float:
    """The largest |served score - the oracle's score of that pid| over the
    pids a search returned (-1 marks an empty slot)."""
    valid = pids >= 0
    ref = np.take_along_axis(oscores, np.maximum(pids, 0), 1)
    return float(np.abs(np.asarray(scores)[valid] - ref[valid]).max())


def staged_batches(encoder, passages) -> list:
    """Every doc batch of ``passages`` as (ids, mask, keep) on the device."""
    return [encoder._put_batch(ids, mask, keep)
            for _, ids, mask, keep in encoder._doc_batches(passages)]


def timed_encode(encoder, batches, *, use_flash: bool = False) -> float:
    """Seconds of ``encode_batch`` over pre-staged batches, between two
    synchronizations."""
    model, dtype = encoder.model, encoder.config.activation_dtype
    sync(encoder.device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for ids, mask, keep in batches:
            model.encode_batch(ids, mask, keep, dtype_name=dtype, use_flash=use_flash)
    sync(encoder.device)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# secondary stages: each returns its numbers as a dict and logs them
# ---------------------------------------------------------------------------


def encode_stages(encoder, passages) -> dict:
    """``encode_passages`` throughput, bf16 wire then int8 wire, each the
    best of two passes over 2,048 passages (a first pass of 512 warms up).
    The time covers the host's tokenization and the embeddings' read-back."""
    dev = card(encoder.device)
    t = time.perf_counter()
    encoder.encode_passages(passages[:512])
    log(f"warmup encode (512 passages): {time.perf_counter() - t:.1f}s")
    sub = passages[:2048]
    shapes = [ids.shape for _, ids, _, _ in encoder._doc_batches(sub)]
    flops = batch_flops(encoder.bert_config, encoder.dim, shapes)

    def best_of_two():
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            _, doclens = encoder.encode_passages(sub)
            times.append(time.perf_counter() - t0)
        return min(times), doclens

    dt, doclens = best_of_two()
    pps = len(sub) / dt
    padded = sum(B * S for B, S in shapes)
    m = mfu_fields(flops, dt, dev)
    log(f"encode: {len(sub)} passages ({int(doclens.sum())} kept embeddings, {padded} "
        f"padded tokens) in {dt:.3f}s = {pps:.1f} passages/s, "
        f"{int(doclens.sum()) / dt / 1e3:.1f}k kept tokens/s, {padded / dt / 1e3:.1f}k "
        f"padded tokens/s; {flops / padded / 1e9:.4f} GFLOP per padded token: "
        f"{mfu_text(m)} (vs reference {BASELINE_ENCODE_PASSAGES_PER_SEC:g} p/s: "
        f"{pps / BASELINE_ENCODE_PASSAGES_PER_SEC:.1f}x; "
        f"{encoder.config.transfer_dtype} read-back; best of 2 passes)")
    encoder.config.transfer_dtype = "int8"
    try:
        dt8, _ = best_of_two()
    finally:
        encoder.config.transfer_dtype = "bfloat16"
    log(f"encode with int8 read-back (transfer_dtype): {len(sub) / dt8:.1f} passages/s "
        f"({dt / dt8:.2f}x bf16; best of 2 passes)")
    return {"passages": len(sub), "pps_bf16": pps, "pps_int8": len(sub) / dt8,
            "kept_tokens_per_s": int(doclens.sum()) / dt, "padded_tokens_per_s": padded / dt,
            "gflop_per_padded_token": flops / padded / 1e9, **m}


def device_mfu_stage(encoder) -> dict:
    """The bf16 BERT forward alone (``ColBERT.encode_batch``) over 2,048
    passages whose batches sit on the device already: a warm pass, then a
    timed pass between two synchronizations."""
    dev = card(encoder.device)
    passages = synthetic_passages(2048)
    batches = staged_batches(encoder, passages)
    shapes = [tuple(b[0].shape) for b in batches]
    kept = int(sum(int(b[2].sum()) for b in batches))
    padded = sum(B * S for B, S in shapes)
    flops = batch_flops(encoder.bert_config, encoder.dim, shapes)
    timed_encode(encoder, batches)
    dt = timed_encode(encoder, batches)
    m = mfu_fields(flops, dt, dev)
    seqlens = sorted({S for _, S in shapes})
    log(f"device-only encode, {len(batches)} batches of B<={shapes[0][0]} at S "
        f"{seqlens}: {len(passages) / dt:.0f} p/s, {padded / dt / 1e3:.0f}k padded "
        f"tokens/s ({kept / dt / 1e3:.0f}k kept), {flops / padded / 1e9:.4f} GFLOP per "
        f"padded token: encode_mfu {mfu_text(m)}")
    return {"passages": len(passages), "seconds": dt, "padded_tokens_per_s": padded / dt,
            "kept_tokens_per_s": kept / dt, "gflop_per_padded_token": flops / padded / 1e9,
            "encode_mfu": m.pop("mfu"), **m}


def flash_probe(encoder, n: int = FLASH_PASSAGES) -> dict:
    """Encode ``n`` ~450-word passages at doc_maxlen 512 (128-wide buckets,
    so every batch pads to S=512) with ``use_flash`` off, then on, each
    timed after a warm pass. Off is the port's materialized attention (bf16
    operands, fp32 products); on is the flash kernel, which must launch once
    per layer per batch, every launch the tensor-core ``mma`` kernel. On the
    CPU both passes run plain PyTorch and nothing launches."""
    cfg = ColBERTConfig(dim=128, doc_maxlen=512, query_maxlen=32, index_bsize=128,
                        length_bucket=128, use_pallas=True, flash_min_seqlen=512)
    enc = ColBERTEncoder(encoder.model, encoder.tokenizer, cfg, device=encoder.device)
    passages = synthetic_passages(n, mean_words=450)
    batches = staged_batches(enc, passages)
    seqlens = sorted({int(b[0].shape[1]) for b in batches})
    layers = enc.bert_config.num_hidden_layers
    pps, counts = {}, {}
    for flash in (False, True):
        timed_encode(enc, batches, use_flash=flash)
        before = launches()
        dt = timed_encode(enc, batches, use_flash=flash)
        counts[flash] = launches_since(before)["flash"]
        pps[flash] = n / dt
    want = layers * len(batches) if enc.device.type == "cuda" else 0
    if counts[False] != {"mma": 0, "simt": 0} or counts[True] != {"mma": want, "simt": 0}:
        raise RuntimeError(f"flash launches off {counts[False]}, on {counts[True]}; "
                           f"expected on = {{'mma': {want}, 'simt': 0}}")
    ratio = pps[True] / pps[False]
    log(f"flash attention at S={seqlens}, {len(batches)} batches of "
        f"{cfg.index_bsize}, device work only: flash kernel {pps[True]:.1f} p/s vs "
        f"the materialized attention {pps[False]:.1f} p/s ({ratio:.2f}x); flash "
        f"launches in the timed pass {counts[True]} ({layers} layers x {len(batches)} "
        f"batches)")
    return {"passages": n, "batches": len(batches), "seqlens": seqlens, "layers": layers,
            "pps_flash": pps[True], "pps_materialized": pps[False], "ratio": ratio,
            "flash_launches": counts[True], "flash_launches_off": counts[False]}


def serve_and_probe(encoder, cfg, tmp, passages, n) -> dict:
    """Serving QPS and latency, then funnel recall against the exact oracle
    over the index at ``tmp/idx``. Every stage-2 score the stage's searches
    return (B=128 quality-first, B=64 throughput-tuned, the funnel's three
    points and the self-retrieval probe) is held against the exact MaxSim
    of its pid: ``stage2_vs_oracle`` holds the largest difference of each."""
    from colbert_torch.retrieval.searcher import Searcher

    out = {}
    errs = out["stage2_vs_oracle"] = {}
    before = launches()
    s = Searcher(tmp + "/idx", encoder=encoder, device=encoder.device)
    queries = synthetic_queries(192)
    for B in (32, 64, 128):
        out[f"qps_b{B}_quality"] = qps = time_qps(s, queries, B)
        log(f"batched search (B={B}, warm, quality-first defaults): {qps:.1f} QPS")
    # the widest timed batch's scores against the oracle, at the served
    # operating point (the encoded queries feed both)
    Qw = torch.from_numpy(s.encoder.encode_queries(queries[:128]))
    owide = exhaustive_scores(s, Qw)
    errs["B=128 quality-first"] = oracle_err(
        *s.device_index.search_Q_batch(Qw, **s._search_kwargs(10)), owide)
    # throughput-tuned: no stage-1 refine, exactly nprobe probes, half the
    # stage-2 budget (the recall cost of each is measured below)
    s.config.plaid_stage1_refine = False
    s.config.probe_dup_compensation = False
    s.config.plaid_stage2_docs = 512
    for B in (32, 64, 128):
        out[f"qps_b{B}_tuned"] = qps = time_qps(s, queries, B)
        log(f"batched search (B={B}, warm, throughput-tuned): {qps:.1f} QPS")
    errs["B=64 throughput-tuned"] = oracle_err(
        *s.device_index.search_Q_batch(Qw[:64], **s._search_kwargs(10)), owide[:64])
    # search_stream: two batches in flight, so the host's tokenize and
    # read-back overlap the device's work
    batches = [queries[(i * 64) % 128:(i * 64) % 128 + 64] for i in range(8)]
    list(s.search_stream(batches[:2], k=10))
    t0 = time.perf_counter()
    list(s.search_stream(batches, k=10, max_inflight=2))
    out["qps_b64_stream_tuned"] = 64 * len(batches) / (time.perf_counter() - t0)
    log(f"pipelined search_stream (B=64, throughput-tuned, 2 in flight): "
        f"{out['qps_b64_stream_tuned']:.1f} QPS")
    s.config.plaid_stage2_docs = None

    s.config.plaid_stage1_refine = True
    s.config.probe_dup_compensation = True
    lat = {}
    for refine in (True, False):
        s.config.plaid_stage1_refine = refine
        s.search(queries[0], k=10)
        t3 = time.perf_counter()
        for i in range(20):
            s.search(queries[i % len(queries)], k=10)
        lat[refine] = (time.perf_counter() - t3) / 20 * 1000
    s.config.plaid_stage1_refine = True
    out.update(latency_ms_refine=lat[True], latency_ms_no_refine=lat[False])
    log(f"single-query latency (warm, mean of 20): {lat[True]:.2f} ms with the stage-1 "
        f"refine, {lat[False]:.2f} ms without")

    # retrieval sanity on the topical corpus: a passage is its own best match
    p_self, _ = s.search_batch([passages[5], passages[900]], k=3)
    if not (p_self[0][0] == 5 and p_self[1][0] == 900):
        raise AssertionError(f"self-retrieval of passages 5 and 900: top-3 {p_self.tolist()}")

    # funnel recall against exhaustive scoring of every passage with the
    # same codec; set recall and tie-aware score recall, and the oracle's
    # own spread (this corpus is tie-heavy by construction)
    Qe = torch.from_numpy(s.encoder.encode_queries(list(synthetic_queries(32))))
    oscores = exhaustive_scores(s, Qe)
    oracle = np.argsort(-oscores, axis=1)[:, :100]
    osorted = -np.sort(-oscores, axis=1)
    out["oracle_spread"] = {"top1_top10": float(np.mean(osorted[:, 0] - osorted[:, 9])),
                            "top10_top100": float(np.mean(osorted[:, 9] - osorted[:, 99])),
                            "top1": float(np.mean(osorted[:, 0]))}
    log(f"oracle score spread: top1-top10 {out['oracle_spread']['top1_top10']:.3f}, "
        f"top10-top100 {out['oracle_spread']['top10_top100']:.3f} "
        f"(score scale: top1 {out['oracle_spread']['top1']:.2f})")
    kw = dict(k=100, nprobe=cfg.nprobe, cell_cap=s.cell_cap, max_candidates=s.max_candidates)
    points = {
        "quality-first": dict(
            ncandidates=cfg.plaid_stage2_docs or max(16 * 100, 1024),
            centroid_threshold=cfg.centroid_score_threshold, stage1_refine=True),
        "throughput-tuned (ncand=512)": dict(
            ncandidates=512, centroid_threshold=cfg.centroid_score_threshold,
            stage1_refine=False),
        "tight (ncand=128)": dict(
            ncandidates=128, centroid_threshold=cfg.centroid_score_threshold,
            stage1_refine=True),
    }
    out["funnel"] = {}
    for name, p in points.items():
        pids, scores = s.device_index.search_Q_batch(Qe, **p, **kw)
        errs[name] = oracle_err(pids, scores, oscores)
        r = {"set_recall_at_10": _recall(pids, oracle, 10),
             "set_recall_at_100": _recall(pids, oracle, 100),
             "score_recall_at_10": _score_recall(pids, oscores, 10),
             "score_recall_at_100": _score_recall(pids, oscores, 100)}
        out["funnel"][name] = r
        log(f"funnel recall vs exhaustive [{name}]: "
            f"set recall@10 {r['set_recall_at_10']:.3f} / @100 {r['set_recall_at_100']:.3f}; "
            f"score-recall@10 {r['score_recall_at_10']:.3f} / "
            f"@100 {r['score_recall_at_100']:.3f}")

    # pruning with a real relevance signal: queries are passage prefixes,
    # the truth is the passage; the funnel must not lose it against
    # exhaustive scoring
    probe = list(range(0, n, n // 32))[:32]
    Qp = torch.from_numpy(s.encoder.encode_queries([passages[i][:200] for i in probe]))
    p_pruned, s_pruned = s.device_index.search_Q_batch(
        Qp, ncandidates=cfg.plaid_stage2_docs or 1024,
        centroid_threshold=cfg.centroid_score_threshold, **dict(kw, k=10))
    out["self_s1_pruned"] = float(np.mean([p_pruned[b][0] == probe[b] for b in range(32)]))
    oscores_p = exhaustive_scores(s, Qp)
    errs["self-retrieval probe"] = oracle_err(p_pruned, s_pruned, oscores_p)
    oracle_p = np.argmax(oscores_p, axis=1)
    out["self_s1_exhaustive"] = float(np.mean([oracle_p[b] == probe[b] for b in range(32)]))
    log(f"self-retrieval success@1: pruned funnel {out['self_s1_pruned']:.3f} vs "
        f"exhaustive {out['self_s1_exhaustive']:.3f}")
    log("served stage-2 scores vs the exact MaxSim of each returned pid, max |diff|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    since = launches_since(before)
    out["stage2_launches"], out["refine_launches"] = since["stage2"], since["refine"]
    log(f"stage-2 launches in the serving stage by kernel {out['stage2_launches']}; refine "
        f"kernel launches {out['refine_launches']}")
    if s.device.type == "cuda" and (out["stage2_launches"]["simt"]
                                    or not out["stage2_launches"]["mma"]):
        raise RuntimeError(f"stage-2 launches {out['stage2_launches']}, expected all mma")
    if s.device.type == "cuda" and not out["refine_launches"]["table"]:
        raise RuntimeError("no refine kernel launch in the serving stage's refined searches")
    return out


def host_backend_stage(encoder, tmp) -> dict:
    """The host backend (per-query IVF gather and scoring orchestrated from
    the host, the reference's searching.jl:93-128 shape) against the device
    backend on the same index and queries at B=32, best of reps on both
    sides (2 for the host, whose batch takes seconds; 3 for the device)."""
    from colbert_torch.retrieval.searcher import Searcher

    queries = synthetic_queries(64)
    B = 32
    s_host = Searcher(tmp + "/idx", encoder=encoder, backend="host", device=encoder.device)
    host_qps = time_qps(s_host, queries, B, reps=2)
    s_dev = Searcher(tmp + "/idx", encoder=encoder, backend="device", device=encoder.device)
    dev_qps = time_qps(s_dev, queries, B)
    log(f"host backend: {host_qps:.2f} QPS vs device backend {dev_qps:.1f} QPS at B={B} "
        f"-> qps_vs_host_backend = {dev_qps / host_qps:.1f}x")
    return {"host_qps": host_qps, "device_qps": dev_qps,
            "qps_vs_host_backend": dev_qps / host_qps}


# ---------------------------------------------------------------------------


def headline_build(encoder, cfg, passages, tmp) -> dict:
    """One cold build, then three warm builds -> the best warm p/s, the
    phases of ``tmp/idx`` and the kernels' launches over the four builds."""
    from colbert_torch.indexing.builder import Indexer

    n = len(passages)
    before = launches()
    t1 = time.perf_counter()
    Indexer(cfg, encoder=encoder, collection=passages, device=encoder.device).index(
        tmp + "/warm")
    cold = time.perf_counter() - t1
    log(f"index build #1 (cold): {n} passages in {cold:.2f}s = {n / cold:.1f} p/s")
    best = 0.0
    for i in (2, 3, 4):
        t1 = time.perf_counter()
        Indexer(cfg, encoder=encoder, collection=passages, device=encoder.device).index(
            tmp + (f"/idx{i}" if i > 2 else "/idx"))
        bt = time.perf_counter() - t1
        best = max(best, n / bt)
        log(f"index build #{i} (warm): {n} passages in {bt:.2f}s = {n / bt:.1f} p/s "
            f"(baseline {BASELINE_BUILD_PASSAGES_PER_SEC})")
    counts = launches_since(before)
    log(f"steady-state headline: {best:.1f} p/s (best of 3 warm builds)")
    with open(tmp + "/idx/plan.json") as f:
        timings = json.load(f).get("timings", {})
    log("build phases: " + ", ".join(
        f"{k} {v['seconds']:.2f}s" for k, v in sorted(timings.items())))
    return {"passages": n, "cold_pps": n / cold, "best_warm_pps": best,
            "phases": {k: v["seconds"] for k, v in timings.items()},
            "flash_launches": counts["flash"], "stage2_launches": counts["stage2"]}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=4096, help="passages indexed")
    ap.add_argument("--bert", choices=("base", "narrow"), default="base")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    bert = bench_bert_config() if args.bert == "base" else narrow_bert_config()
    encoder, cfg = make_bench_encoder(device=device, bert_config=bert)
    n = args.n
    passages = synthetic_passages(n)
    log(f"[bench] {n} passages, BERT {bert}, {cfg.activation_dtype} activations, on "
        f"{card(device)['smi']}")
    tmp = tempfile.mkdtemp()
    failed = []
    try:
        build = headline_build(encoder, cfg, passages, tmp)  # a failure propagates
        log("stage build " + json.dumps(build))
        headline = json.dumps({
            "metric": "index_build_passages_per_sec",
            "value": round(build["best_warm_pps"], 2),
            "unit": "passages/s",
            "vs_baseline": round(build["best_warm_pps"] / BASELINE_BUILD_PASSAGES_PER_SEC, 2),
        })
        print(headline, flush=True)
        stages = {
            "encode_stages": lambda: encode_stages(encoder, passages),
            "device_mfu_stage": lambda: device_mfu_stage(encoder),
            "flash_probe": lambda: flash_probe(encoder),
            "serve_and_probe": lambda: serve_and_probe(encoder, cfg, tmp, passages, n),
            "host_backend_stage": lambda: host_backend_stage(encoder, tmp),
        }
        for name, stage in stages.items():
            t0 = time.perf_counter()
            try:
                result = stage()
            except Exception:
                failed.append(name)
                log(f"secondary bench stage {name} failed:")
                traceback.print_exc(file=sys.stderr)
            else:
                result["stage_seconds"] = time.perf_counter() - t0
                log(f"stage {name} " + json.dumps(result))
            # the identical headline after every stage, so that a cut run's
            # tail is never more than one stage past a headline
            print(headline, flush=True)
        print(headline, flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        log(f"[bench] failed stages: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
