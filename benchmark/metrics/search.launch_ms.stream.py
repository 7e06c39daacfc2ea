"""Host milliseconds per ``Searcher.launch_search`` call in the stream
(tokenize, program key, copy-in, replay launch), from the benchmark's span
around the call."""

LAYER = "search facade, host (retrieval/searcher.py launch_search)"
UNIT = "ms"
MOVES = "search_qps"
DRIVERS = ("stream",)


def read(r):
    s = r.spans.get("launch_search")
    return 1e3 * sum(s) / len(s) if s else None
