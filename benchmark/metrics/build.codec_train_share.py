"""The share of the last build's time spent training the codec (k-means
and quantiles): its ``codec_train`` phase over its total seconds, both as
the build wrote them to ``plan.json``."""

LAYER = "codec training (ops/kmeans.py, indexing/codec_trainer.py)"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def read(r):
    t, total = r.work.get("timings", {}), r.work.get("build_total_s")
    if "codec_train" not in t or not total:
        return None
    return 100.0 * t["codec_train"]["seconds"] / total
