"""Helpers the per-layer readers share (not a metric: the registry skips
files whose name starts with ``_``)."""

from __future__ import annotations

from benchmark import harness, roofline


def idle_share(r) -> float | None:
    t = r.device_trace
    if t is None or not t.window_s > 0 or not t.busy_s > 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def served_queries(r) -> int:
    return r.counters.get("batches", 0) * r.work.get("batch", 0)


def kernel_share(r, name: str, match, work) -> float | None:
    """Roofline share of the device operations ``match`` accepts, for the
    (FLOPs, bytes) ``work`` of every query served in the traced window;
    notes under ``name`` what bound it."""
    t = r.device_trace
    if t is None or "stage2_tokens_per_query" not in r.work:
        return None
    seconds, launches = harness.kernel_seconds(t, match)
    if not launches:
        return None
    got = roofline.share(*work, seconds, r.card["name"])
    if got is None:
        return None
    r.notes[name] = f"bound by {got[1]}"
    return got[0]


def is_stage2(name: str) -> bool:
    return "stage2" in name and "kernel" in name


def is_refine(name: str) -> bool:
    return "approx_maxsim" in name


GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")


def refine_ops(r):
    """The refine's device operations: each ``approx_maxsim`` kernel and,
    where the operation just before it on its stream is a matrix product,
    that product (the score table it reads)."""
    t = r.device_trace
    last = {}
    keep = set()
    for i, (name, _, _, stream) in enumerate(t.kernels):
        if is_refine(name):
            keep.add(i)
            j = last.get(stream)
            if j is not None and any(m in t.kernels[j][0].lower() for m in GEMM_MARKS):
                keep.add(j)
        last[stream] = i
    return keep


def stage2_work(r):
    c = r.config
    n = served_queries(r)
    return roofline.stage2_work(c["query_maxlen"], c["dim"], c["nbits"],
                                c["index"]["num_partitions"], n,
                                n * r.work["stage2_passages_per_query"],
                                n * r.work["stage2_tokens_per_query"])


def refine_work(r):
    c = r.config
    n = served_queries(r)
    return roofline.refine_work(c["query_maxlen"], c["dim"], c["index"]["num_partitions"], n,
                                n * r.work["refine_passages_per_query"],
                                n * r.work["refine_tokens_per_query"])


def served_flops(r) -> float:
    """Model FLOPs of every query served: the query encode (every
    position of a [MASK]-augmented query attends to its true tokens, markers
    included), the probe, the refine and stage 2."""
    c = r.config
    n = served_queries(r)
    enc = n * r.arch.encoder_flops(r.widths, c["dim"], c["query_maxlen"],
                                   r.work["true_tokens_per_query"])
    probe = roofline.probe_flops(c["query_maxlen"], c["dim"], c["index"]["num_partitions"], n)
    return enc + probe + refine_work(r)[0] + stage2_work(r)[0]
