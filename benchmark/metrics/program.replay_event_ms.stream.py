"""Device milliseconds per replay of the captured serving program in the
stream, from the program's own CUDA timing events around each replay: its
``program_replay_device_ns`` counter over ``program_replays_timed``."""

from benchmark.metrics import _spans

LAYER = "serving program (retrieval/program.py, retrieval/device_index.py)"
UNIT = "ms"
MOVES = "search_qps"
DRIVERS = ("stream",)


def read(r):
    pt = _spans.get(r)
    n = pt.counters.get("program_replays_timed", 0) if pt else 0
    return pt.counters["program_replay_device_ns"] / n / 1e6 if n else None
