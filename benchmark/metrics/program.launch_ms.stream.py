"""Host milliseconds per captured program launch in the stream (copy-in,
the replay call, copy-out): the mean of the program's ``program_launch``
spans (benchmark/metrics/_spans.py)."""

from benchmark.metrics import _spans

LAYER = "serving program (retrieval/program.py, retrieval/device_index.py)"
UNIT = "ms"
MOVES = "search_qps"
DRIVERS = ("stream",)


def read(r):
    pt = _spans.get(r)
    d = pt.durations("program_launch") if pt else []
    return 1e3 * sum(d) / len(d) if d else None
