"""The global attention kernel's share of its roofline: the global
layers' attention work over the passages' true lengths (every real key of
each query, the configuration's architecture counting it:
``attention_work``), times the window's builds, over the traced time of
the unwindowed ``flash_mma_kernel`` launches. None on a run whose
architecture counts no attention work (a BERT build) or without such
launches."""

from benchmark.metrics import _attn

LAYER = "doc encoder attention (models/modernbert.py, ops/flash_attention.py, csrc/flash_attention.cu)"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def read(r):
    return _attn.share(r, "attn.global_roofline.build", "global", _attn.is_global)
