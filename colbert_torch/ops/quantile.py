"""Quantiles of data sharded over a mesh (port of ``colbert_tpu.ops.quantile``).

The reference takes codec bucket cutoffs with one ``quantile`` call over
the heldout residuals (collection_indexer.jl:147-152). Sharded, each data
shard builds a weighted histogram over a common range and the histograms
are summed in shard order: one exchange of O(bins) values per pass whatever
the data size, with an error bounded by ``(max - min) / bins`` (default
2^16 bins). Two passes: the first finds the weighted rows' range, the
second histograms over it. Rows of weight 0 (padding) count nowhere.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["histogram_quantiles", "sharded_quantiles"]


def histogram_quantiles(hist: torch.Tensor, qs: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor) -> torch.Tensor:
    """Quantiles ``qs`` interpolated from ``hist`` ((bins,) weights over
    ``[lo, hi]``), linearly inside the bin that holds each."""
    bins = hist.shape[0]
    cdf = torch.cumsum(hist, 0)
    targets = qs * cdf[-1]
    idx = torch.searchsorted(cdf, targets, side="left").clamp(0, bins - 1)
    prev = torch.where(idx > 0, cdf[(idx - 1).clamp(min=0)], 0.0)
    h = hist[idx]
    in_bin = torch.where(h > 0, (targets - prev) / h, 0.5).clamp(0.0, 1.0)
    width = (hi - lo) / bins
    return lo + (idx.to(torch.float32) + in_bin) * width


def _shard_stats(x: torch.Tensor, w: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 bins: int) -> torch.Tensor:
    """One shard's [histogram (bins,), sum |x|·w, sum w, min, max] over its
    weighted elements (each row's weight applies to all of its columns)."""
    xf = x.to(torch.float32).reshape(x.shape[0], -1)
    wf = w.to(torch.float32)[:, None].expand_as(xf).reshape(-1)
    xf = xf.reshape(-1)
    width = torch.clamp(hi - lo, min=1e-30)
    pos = torch.clamp((xf - lo) / width * bins, 0, bins - 1).to(torch.int64)
    hist = torch.zeros(bins, dtype=torch.float32, device=x.device).index_add_(0, pos, wf)
    live = wf > 0
    inf = torch.tensor(float("inf"), device=x.device)
    lo_s = torch.where(live, xf, inf).min() if xf.numel() else inf
    hi_s = torch.where(live, xf, -inf).max() if xf.numel() else -inf
    return torch.cat([hist, (xf.abs() * wf).sum()[None], wf.sum()[None],
                      lo_s[None], hi_s[None]])


def _mesh_stats(shards: dict, weights: dict, mesh, lo, hi, bins: int):
    """Every shard's stats combined: histograms, |x| sums and weights added
    in shard order, the range's min and max -> (hist, lo, hi, abs_sum, w)."""
    from colbert_torch.parallel import launch

    parts = {s: _shard_stats(shards[s], weights[s], lo.to(shards[s].device),
                             hi.to(shards[s].device), bins) for s in shards}
    gathered, _ = launch.gather_shards(parts, mesh)
    total = gathered[0][:bins + 2].clone()
    for g in gathered[1:]:
        total += g[:bins + 2]
    stacked = torch.stack(gathered)
    return (total[:bins], stacked[:, bins + 2].min(), stacked[:, bins + 3].max(),
            total[bins], total[bins + 1])


def sharded_quantiles(data: torch.Tensor, qs, mesh, *, weights: torch.Tensor | None = None,
                      bins: int = 1 << 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantiles of the row-weighted ``data`` split over ``mesh``'s data
    axis (its rows must divide the axis: pad with weight-0 rows) ->
    (one value per ``qs``, weighted mean ``|x|``), on shard 0's device (the
    gather device across processes)."""
    from colbert_torch.parallel import launch

    if weights is None:
        weights = torch.ones(data.shape[0], dtype=torch.float32, device=data.device)
    shards = launch.put_data_sharded(data, mesh)
    wsh = launch.put_data_sharded(weights, mesh)
    lo0 = torch.tensor(-1e30, dtype=torch.float32)
    hi0 = torch.tensor(1e30, dtype=torch.float32)
    _, lo, hi, abs_sum, w_total = _mesh_stats(shards, wsh, mesh, lo0, hi0, bins)
    hi = torch.maximum(hi, lo + 1e-12)
    hist, _, _, _, _ = _mesh_stats(shards, wsh, mesh, lo, hi, bins)
    qs_t = torch.as_tensor(np.asarray(qs, np.float32), device=hist.device)
    values = histogram_quantiles(hist, qs_t, lo, hi)
    return values, abs_sum / torch.clamp(w_total, min=1.0)
