"""The doc encoder's model FLOPs over every passage's true tokens (one
encode per passage and build; benchmark/roofline.py), over the wall time
from the window's start to the end of its last completed build, as a
percent of the card's peak."""

from benchmark import roofline

LAYER = "build facade and doc encode (indexing/builder.py, models/encoder.py)"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def read(r):
    if not r.work.get("build_seconds"):
        return None
    flops = r.work["encode_flops_per_build"] * r.counters["builds"]
    return roofline.mfu(flops, r.work["build_seconds"], r.card["name"])
