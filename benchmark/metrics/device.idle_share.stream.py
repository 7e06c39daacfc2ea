"""Share of the traced window in which no device operation ran."""

from benchmark.metrics import _common

LAYER = "device"
UNIT = "%"
MOVES = "search_qps"
DRIVERS = ("stream",)


def read(r):
    return _common.idle_share(r)
