"""The served batch's model FLOPs (query encode at the queries' true
lengths with [MASK] augmentation, probe, refine, stage 2; counted by
benchmark/roofline.py) over the window's wall time, as a percent of the
card's peak."""

from benchmark import roofline
from benchmark.metrics import _common

LAYER = "serving program (retrieval/program.py, retrieval/device_index.py)"
UNIT = "%"
MOVES = "search_qps"
DRIVERS = ("stream",)


def read(r):
    if "stage2_tokens_per_query" not in r.work or not r.window_s:
        return None
    return roofline.mfu(_common.served_flops(r), r.window_s, r.card["name"])
