"""Stage 2's share of its roofline: the work of the stage-2 candidates
(benchmark/roofline.py) over the traced time of the stage-2 kernels."""

from benchmark.metrics import _common

LAYER = "stage-2 kernel (ops/fused_maxsim.py, csrc/stage2_maxsim.cu)"
UNIT = "%"
MOVES = "search_qps"
DRIVERS = ("stream",)


def read(r):
    if "stage2_tokens_per_query" not in r.work:
        return None
    return _common.kernel_share(r, "stage2_roofline", _common.is_stage2, _common.stage2_work(r))
