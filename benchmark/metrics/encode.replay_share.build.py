"""Share of the doc encoder's batches that replayed a captured program:
100 x ``doc_replays`` / ``doc_batches``, the program's counters over every
encoded doc batch. A batch runs op by op (``doc_eager_batches``) where it
is a group's last, partial one, is padded past the program's token limit
(long documents) or is a key's first. None on a run whose program counts
neither route."""

from benchmark.metrics import _spans

LAYER = "build facade and doc encode (indexing/builder.py, models/encoder.py)"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def read(r):
    pt = _spans.get(r)
    c = pt.counters if pt else {}
    if "doc_replays" not in c and "doc_eager_batches" not in c or not c.get("doc_batches"):
        return None
    return 100.0 * c.get("doc_replays", 0) / c["doc_batches"]
