"""k-means' assignment kernel's share of its roofline: the work of every
nearest-centroid launch in the traced window, from the program's counters
(``kmeans_assign_launches``, ``kmeans_assign_rows``,
``kmeans_assign_pairs``), over the traced time of the device operations
whose name holds ``nearest_centroid``.

Work, each operation and byte once: ``2 dim`` FLOPs per (row, centroid)
pair scored; bytes: every row read once as the build's bf16 sample rows,
one int64 assignment written per row, and each launch's fp32 centroids
(K x dim, K = pairs / rows) read once. The bound is the larger of the
FLOPs at the card's bf16 tensor rate and the bytes at its memory's rate
(``benchmark/roofline.py``, as ``stage2_roofline`` counts its products):
a kernel that keeps the fp32 class by three bf16 products per centroid
can read at most about 33%, one by two TF32 products about 25%.

None without a trace, without the counters (a program that has no such
kernel) or without a launch of it in the window.
"""

from benchmark import harness, roofline
from benchmark.metrics import _spans

LAYER = "codec training (ops/kmeans.py, indexing/codec_trainer.py)"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)

ROW_BYTES = 2  # the build's sample rows are bf16


def is_nearest_centroid(name: str) -> bool:
    return "nearest_centroid" in name


def work(dim: int, launches: int, rows: int, pairs: int) -> tuple[float, float]:
    """-> (FLOPs, bytes) of ``launches`` launches assigning ``rows`` rows in
    all over ``pairs`` (row, centroid) pairs."""
    k_per_launch = pairs / rows if rows else 0.0
    flops = 2.0 * dim * pairs
    nbytes = rows * (dim * ROW_BYTES + 8) + launches * k_per_launch * dim * 4
    return flops, nbytes


def read(r):
    t = r.device_trace
    pt = _spans.get(r)
    c = pt.counters if pt else {}
    if t is None or not c.get("kmeans_assign_launches") or not c.get("kmeans_assign_rows"):
        return None
    seconds, launches = harness.kernel_seconds(t, is_nearest_centroid)
    if not launches:
        return None
    got = roofline.share(*work(r.config["dim"], c["kmeans_assign_launches"],
                               c["kmeans_assign_rows"], c.get("kmeans_assign_pairs", 0)),
                         seconds, r.card["name"])
    if got is None:
        return None
    r.notes["kmeans.assign_roofline.build"] = (
        f"bound by {got[1]}; {launches} launches, {seconds:.4f} s")
    return got[0]
