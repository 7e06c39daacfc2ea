"""Share of the builds' device idle that no program span below a root
explains: idle while the innermost program span open on the driver's
thread is ``index`` itself, or while none is open
(benchmark/metrics/_spans.py)."""

from benchmark.metrics import _spans

LAYER = "device"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def read(r):
    pt = _spans.get(r)
    if pt is None or not pt.idle_s() > 0:
        return None
    return 100.0 * pt.unexplained_s() / pt.idle_s()
