"""Share of the windowed kernel's (query, key) pairs that lie outside the
window or on padding: 100 x (1 - true pairs / ``attn_window_tile_pairs``).
The program counts the pairs inside the key tiles its windowed launches
visit (``attn_window_tile_pairs``); the architecture counts the window's
true pairs over the passages' true lengths (``window_pairs``), times the
window's builds. None on a run without that counter or an architecture
without a window (a BERT build)."""

from benchmark.metrics import _attn, _spans

LAYER = "doc encoder attention (models/modernbert.py, ops/flash_attention.py, csrc/flash_attention.cu)"
UNIT = "%"
MOVES = "index_passages_per_s"
DRIVERS = ("build",)


def read(r):
    pt = _spans.get(r)
    tiles = pt.counters.get("attn_window_tile_pairs", 0) if pt else 0
    pairs = getattr(r.arch, "window_pairs", None)
    builds = r.counters.get("builds", 0)
    if not tiles or pairs is None or not builds:
        return None
    return 100.0 * (1.0 - pairs(r.widths, _attn.encoded_lengths(r)) * builds / tiles)
