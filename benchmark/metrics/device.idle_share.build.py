"""Share of the traced window in which no device operation ran."""

from benchmark.metrics import _common

LAYER = "device"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def read(r):
    return _common.idle_share(r)
