"""Share of the doc encoder's token slots that are padding: 100 x (1 -
``doc_tokens`` / ``doc_slots``), the program's counters of attention-mask
ones and of batch rows x padded length over every encoded doc batch."""

from benchmark.metrics import _spans

LAYER = "build facade and doc encode (indexing/builder.py, models/encoder.py)"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def read(r):
    pt = _spans.get(r)
    slots = pt.counters.get("doc_slots", 0) if pt else 0
    return 100.0 * (1.0 - pt.counters.get("doc_tokens", 0) / slots) if slots else None
