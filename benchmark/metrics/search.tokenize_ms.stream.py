"""Host milliseconds of query tokenization per ``Searcher.launch_search``
call in the stream: the self time of the program's ``tokenize`` spans over
its ``launch_search`` spans (benchmark/metrics/_spans.py)."""

from benchmark.metrics import _spans

LAYER = "search facade, host (retrieval/searcher.py launch_search)"
UNIT = "ms"
MOVES = "search_qps"
DRIVERS = ("stream",)


def read(r):
    pt = _spans.get(r)
    launches = len(pt.durations("launch_search")) if pt else 0
    if not launches:
        return None
    return 1e3 * pt.self_s().get("tokenize", 0.0) / launches
