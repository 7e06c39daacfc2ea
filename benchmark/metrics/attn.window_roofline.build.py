"""The windowed attention kernel's share of its roofline: the local
layers' attention work over the passages' true lengths (each key within
the window of each query, the configuration's architecture counting it:
``attention_work``), times the window's builds, over the traced time of
the ``flash_mma_window_kernel`` launches. None on a run without such
launches (a BERT build)."""

from benchmark.metrics import _attn

LAYER = "doc encoder attention (models/modernbert.py, ops/flash_attention.py, csrc/flash_attention.cu)"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def read(r):
    return _attn.share(r, "attn.window_roofline.build", "local", _attn.is_window)
