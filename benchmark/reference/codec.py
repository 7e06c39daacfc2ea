"""The residual codec's training in plain PyTorch (ColBERT's
``collection_indexer``): the sample of passages and the number of
partitions by the planner's published formulas, Lloyd's k-means from given
initial rows (each row to the centroid of least squared distance, weighted
means, an empty cluster keeping its centroid, stopping when no centroid
moves by ``tol`` or more in any coordinate or after ``niters`` passes),
then the heldout rows' codes (largest inner product), their residuals, and
the residuals' quantiles at ``i / 2^nbits`` (cutoffs) and
``(i + 0.5) / 2^nbits`` (weights), linearly interpolated, with the mean
absolute residual. The caller turns TF32 off."""

from __future__ import annotations

import math

import numpy as np
import torch

ROWS = 4096  # rows a pass scores at once against every centroid


def sample_pids(n: int, rng: np.random.Generator) -> np.ndarray:
    """The passages the codec trains on: ``min(1 + floor(16 sqrt(120 n)), n)``
    drawn without replacement, sorted (collection_indexer.jl ``_sample_pids``)."""
    size = int(min(1 + math.floor(16 * math.sqrt(120 * n)), n))
    return np.sort(rng.choice(n, size=size, replace=False))


def num_heldout(rows: int) -> int:
    """Heldout rows of a sample: 5% of it, at least 1 and at most 50,000."""
    return int(min(50_000, max(1, round(0.05 * rows))))


def num_partitions(n: int, avg_doclen: float, train_rows: int) -> int:
    """``min(train rows, 2^floor(log2(16 sqrt(n * avg_doclen))))``."""
    return int(min(train_rows, 2 ** math.floor(math.log2(16 * math.sqrt(max(1.0, n * avg_doclen))))))


def _nearest(x: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (index of the centroid of least squared distance, that distance)
    per row, ``ROWS`` rows at a time."""
    c_sq = (c * c).sum(1)
    idx, dist = [], []
    for s in range(0, len(x), ROWS):
        xs = x[s:s + ROWS]
        best, a = (2 * xs @ c.T - c_sq).max(dim=1)
        idx.append(a)
        dist.append((xs * xs).sum(1) - best)
    return torch.cat(idx), torch.cat(dist)


def objective(x: torch.Tensor, c: torch.Tensor) -> float:
    """k-means' objective: the mean squared distance of a row to its
    nearest centroid."""
    return float(_nearest(x, c)[1].double().mean())


def kmeans(x: torch.Tensor, init: torch.Tensor, w: torch.Tensor, *, niters: int,
           tol: float = 1e-4) -> torch.Tensor:
    c = init.clone()
    for _ in range(niters):
        a = _nearest(x, c)[0]
        sums = torch.zeros_like(c).index_add_(0, a, x * w[:, None])
        counts = torch.zeros(len(c), dtype=x.dtype, device=x.device).index_add_(0, a, w)
        new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], c)
        shift = float((new - c).abs().max())
        c = new
        if shift < tol:
            break
    return c


def train(sample: torch.Tensor, weights: torch.Tensor, heldout: torch.Tensor,
          init_rows: np.ndarray, *, niters: int, nbits: int):
    """-> (centroids, cutoffs, bucket weights, mean |residual|)."""
    c = kmeans(sample, sample[torch.as_tensor(init_rows, device=sample.device)], weights,
               niters=niters)
    codes = torch.cat([(heldout[s:s + ROWS] @ c.T).argmax(dim=1)
                       for s in range(0, len(heldout), ROWS)])
    res = (heldout - c[codes]).reshape(-1).double()
    n = 1 << nbits
    qs = torch.tensor(np.arange(n) / n, dtype=torch.float64, device=res.device)
    return (c, torch.quantile(res, qs[1:]).float(), torch.quantile(res, qs + 0.5 / n).float(),
            float(res.abs().mean()))
