"""Share of the traced window in which the device is idle while the host is
inside codec training: the innermost program span open on the driver's
thread is ``codec_train`` or one of its descendants (``kmeans``,
``quantiles``; benchmark/metrics/_spans.py)."""

from benchmark.metrics import _spans

LAYER = "codec training (ops/kmeans.py, indexing/codec_trainer.py)"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def read(r):
    pt = _spans.get(r)
    if pt is None or not pt.window_s > 0:
        return None
    idle = pt.idle_where(
        lambda i: any(pt.spans[j][0] == "codec_train" for j in pt.ancestry(i)))
    return 100.0 * idle / pt.window_s
