"""Batched Lloyd's k-means on one device (port of ``colbert_tpu.ops.kmeans``).

Same algorithm as the JAX package (reference utils.jl:253-318): assignment
by the max of ``2·x·c − ‖c‖²`` in fp32, per-cluster sums and counts by
scatter-add (``index_add_``), empty clusters keeping their previous
centroid, and the reference's early exit: stop when the largest centroid
move is below ``tol`` or after ``niters`` iterations.

The assignment takes one of two routes by the rows' device:

- CUDA tensors: one launch of the nearest-centroid kernel per pass
  (:mod:`colbert_torch.ops.nearest_centroid`: bf16 terms on the tensor
  cores, products in the fp32 class, the argmax fused, no score tile).
  Anything the kernel refuses raises.
- CPU tensors: the plain version, an fp32 ``addmm`` (callers keep TF32
  off) and ``argmax`` over row chunks whose ``(bsize, k)`` score tile
  stays under 64 MB. ``bsize`` is read by this route only.

Either way the scatter then runs over as few chunks of ``SCATTER_BYTES``
of fp32 rows as memory allows.

The JAX package runs the loop as one ``lax.while_loop`` program; here it is
a Python loop that reads the shift on the host each iteration. On CUDA,
``index_add_`` adds with atomics in no fixed order, so the sums differ run
to run at the fp32 rounding level and a near-tied assignment can flip; on
the CPU the port is deterministic.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from colbert_torch.ops.nearest_centroid import nearest_centroid

__all__ = ["KMeansResult", "assign_clusters", "lloyd_stats", "centroids_from_stats",
           "lloyd_step", "kmeans"]


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # (k, dim) float32
    assignments: torch.Tensor  # (n,) int64; empty without compute_assignments
    iterations: int
    shift: float               # final max-abs centroid move


# the fp32 rows one scatter launch of a pass takes at most
SCATTER_BYTES = 1 << 30


def _adaptive_bsize(k: int, requested: int) -> int:
    """The plain version's row-chunk size, capped so the (bsize, k) fp32
    score tile stays <= 64 MB."""
    cap = (64 << 20) // (4 * max(1, k))
    return max(64, min(requested, (cap // 64) * 64))


def _centroid_terms(centroids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (centroidsᵀ fp32, −‖c‖² per centroid)."""
    c = centroids.float()
    return c.t(), -(c * c).sum(dim=-1)


def _assign_chunk(chunk: torch.Tensor, ct: torch.Tensor, neg_c_sq: torch.Tensor) -> torch.Tensor:
    """argmin_c ‖x − c‖² for one chunk via the max of 2·x·c − ‖c‖², in one
    GEMM that scales and adds the row bias in its epilogue (the scaling and
    the negation are exact, so the scores are rounded once, as
    ``2.0 * x @ ct - c_sq`` rounds them). A 1-D bias at beta 1 lets the
    card's GEMM add it without first copying it across the tile."""
    scores = torch.addmm(neg_c_sq, chunk.float(), ct, alpha=2.0)
    return torch.argmax(scores, dim=-1)


def assign_clusters(data: torch.Tensor, centroids: torch.Tensor, *,
                    bsize: int = 1024) -> torch.Tensor:
    """Nearest centroid (squared distance) per row -> int64 ``(n,)``
    (reference utils.jl:71-79): one kernel launch for CUDA tensors, the
    plain version for CPU tensors."""
    if data.device.type == "cuda":
        return nearest_centroid(data, centroids)
    if data.device.type != "cpu":
        raise ValueError(f"k-means runs on cuda or cpu, not {data.device}")
    bsize = _adaptive_bsize(centroids.shape[0], bsize)
    ct, neg_c_sq = _centroid_terms(centroids)
    out = torch.empty(data.shape[0], dtype=torch.int64, device=data.device)
    for s in range(0, data.shape[0], bsize):
        out[s:s + bsize] = _assign_chunk(data[s:s + bsize], ct, neg_c_sq)
    return out


def lloyd_stats(data: torch.Tensor, centroids: torch.Tensor, *, k: int,
                bsize: int = 1024, weights: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass over ``data``: per-cluster (weighted sum, weighted count)
    under the current centroids. ``weights`` (0 = ignore the row) mark the
    valid rows of a padded sample."""
    assign = assign_clusters(data, centroids, bsize=bsize)
    sums = torch.zeros((k, data.shape[1]), dtype=torch.float32, device=data.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=data.device)
    step = max(1, SCATTER_BYTES // (4 * data.shape[1]))
    for s in range(0, data.shape[0], step):
        rows = data[s:s + step].to(torch.float32, copy=True)
        if weights is None:
            w = torch.ones(rows.shape[0], dtype=torch.float32, device=data.device)
        else:
            w = weights[s:s + step].float()
            rows.mul_(w[:, None])
        sums.index_add_(0, assign[s:s + step], rows)
        counts.index_add_(0, assign[s:s + step], w)
    return sums, counts


def centroids_from_stats(sums: torch.Tensor, counts: torch.Tensor,
                         old_centroids: torch.Tensor) -> torch.Tensor:
    """sums / counts, with empty clusters keeping their previous centroid."""
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, old_centroids.float())


def lloyd_step(data: torch.Tensor, centroids: torch.Tensor, *, k: int,
               bsize: int = 1024, weights: torch.Tensor | None = None,
               ) -> tuple[torch.Tensor, float]:
    """One Lloyd iteration -> (new centroids, max-abs shift)."""
    sums, counts = lloyd_stats(data, centroids, k=k, bsize=bsize, weights=weights)
    new = centroids_from_stats(sums, counts, centroids)
    return new, float((new - centroids.float()).abs().max())


def kmeans(
    data: torch.Tensor,
    k: int,
    *,
    niters: int = 20,
    tol: float = 1e-4,
    seed: int = 0,
    bsize: int = 1024,
    compute_assignments: bool = True,
    weights: torch.Tensor | None = None,
    init_idx=None,
) -> KMeansResult:
    """Full k-means fit. ``init_idx`` picks the initial centroids' rows
    (callers with weighted data pick them from the valid rows); without it
    they are ``k`` rows drawn by ``np.random.default_rng(seed)``, which are
    not the JAX package's ``jax.random`` draws. ``weights`` as in
    :func:`lloyd_stats`."""
    if init_idx is None:
        if k > data.shape[0]:
            raise ValueError(f"k={k} > number of points n={data.shape[0]}")
        init_idx = np.random.default_rng(seed).permutation(data.shape[0])[:k]
    idx = torch.as_tensor(np.asarray(init_idx), dtype=torch.int64, device=data.device)
    centroids = data[idx].float()
    it, shift = 0, math.inf
    while it < niters and shift >= tol:
        centroids, shift = lloyd_step(data, centroids, k=k, bsize=bsize, weights=weights)
        it += 1
    if compute_assignments:
        assignments = assign_clusters(data, centroids, bsize=bsize)
    else:
        assignments = torch.zeros((0,), dtype=torch.int64, device=data.device)
    return KMeansResult(centroids, assignments, it, shift)
