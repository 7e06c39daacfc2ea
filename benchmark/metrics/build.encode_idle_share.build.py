"""Share of the traced window in which the device is idle while the host is
inside the doc encode: a ``doc_*`` span (``doc_tokenize``,
``doc_tensorize``, ``doc_dispatch`` with its ``h2d`` and ``forward``,
``doc_drain`` with its ``doc_wait``, ``doc_scatter``) is open on the
driver's thread (benchmark/metrics/_spans.py)."""

from benchmark.metrics import _spans

LAYER = "build facade and doc encode (indexing/builder.py, models/encoder.py)"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def read(r):
    pt = _spans.get(r)
    if pt is None or not pt.window_s > 0:
        return None
    idle = pt.idle_where(
        lambda i: any(pt.spans[j][0].startswith("doc_") for j in pt.ancestry(i)))
    return 100.0 * idle / pt.window_s
