"""The routed experts' grouped products' share of their roofline: the work
of every MoE layer call in the traced window, from the program's counters
(``moe_layer_calls``, ``moe_dispatch_rows``, ``moe_grouped_launches``) and
the doc encode's (``doc_tokens``, ``doc_batches``), over the traced time of
the device operations that are grouped products (:func:`is_expert_product`).

Work (``moe_work`` of the configuration's architecture): FLOPs of the true
tokens only, each through its chosen experts' SwiGLU (padding counts
against the products); bytes of the held experts' weights once per launch
and of the dispatched rows in and out in bf16. The true tokens over the
window's MoE layer calls are ``doc_tokens`` times the calls per doc batch.
The bound is the larger of the FLOPs at the card's bf16 tensor rate and
the bytes at its memory's rate (``benchmark/roofline.py``). The notes say
how many device operations matched against the launches counted.

None without a trace, for an architecture without experts, or for a
program that counts no grouped launch.
"""

from benchmark import harness, roofline
from benchmark.metrics import _spans

LAYER = "expert layer (ops/moe.py, models/deepseek_v3.py)"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def is_expert_product(name: str) -> bool:
    """The grouped GEMM that ``torch._grouped_mm`` launches on the card
    (CUTLASS's kernel over a ``GroupProblemShape``)."""
    return "GroupProblemShape" in name


def read(r):
    t = r.device_trace
    pt = _spans.get(r)
    c = pt.counters if pt else {}
    if t is None or not hasattr(r.arch, "moe_work") or not c.get("moe_grouped_launches") \
            or not c.get("doc_batches"):
        return None
    seconds, launches = harness.kernel_seconds(t, is_expert_product)
    if not launches:
        return None
    tokens = c.get("doc_tokens", 0) * c.get("moe_layer_calls", 0) / c["doc_batches"]
    got = roofline.share(*r.arch.moe_work(r.widths, tokens, c.get("moe_dispatch_rows", 0),
                                          c["moe_grouped_launches"]),
                         seconds, r.card["name"])
    if got is None:
        return None
    r.notes["moe.expert_roofline.build"] = (
        f"bound by {got[1]}; {launches} device operations matched, "
        f"{c['moe_grouped_launches']} grouped launches counted, {seconds:.4f} s")
    return got[0]
