"""The refine's share of its roofline: the work of the refine window
(benchmark/roofline.py) over the traced time of the refine kernels and of
the score-table product launched just before each on its stream."""

from benchmark import roofline
from benchmark.metrics import _common

LAYER = "refine kernel (ops/approx_maxsim.py, csrc/approx_maxsim.cu)"
UNIT = "%"
MOVES = "search_qps"
DRIVERS = ("stream",)


def read(r):
    if r.device_trace is None or not r.work.get("refine_tokens_per_query"):
        return None
    keep = _common.refine_ops(r)
    if not keep:
        return None
    kernels = r.device_trace.kernels
    seconds = sum(kernels[i][2] - kernels[i][1] for i in keep)
    got = roofline.share(*_common.refine_work(r), seconds, r.card["name"])
    if got is None:
        return None
    r.notes["refine_roofline"] = f"bound by {got[1]}"
    return got[0]
