"""Device-busy milliseconds per served batch in the stream: the union of
the traced window's device operations over the batches answered."""

LAYER = "serving program (retrieval/program.py, retrieval/device_index.py)"
UNIT = "ms"
MOVES = "search_qps"
DRIVERS = ("stream",)


def read(r):
    t, n = r.device_trace, r.counters.get("batches", 0)
    if t is None or not n or not t.busy_s > 0:
        return None
    return 1e3 * t.busy_s / n
