"""Sharded k-means: Lloyd's over the data axis of a mesh (port of
``colbert_tpu.parallel.kmeans_dist``).

Each data shard computes its own (k, dim) centroid sums and (k,) counts
with the port's :func:`colbert_torch.ops.kmeans.lloyd_stats`; the parts are
added in shard order (:func:`colbert_torch.parallel.launch.sum_shards`, the
JAX package's ``psum``) and the new centroids go back to every shard. The
exchange is O(k·dim) per iteration whatever the data size. A fixed order
keeps a run reproducible and a multi-process run equal to a single-process
one on the CPU; on CUDA each shard's ``index_add_`` still sums in no fixed
order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from colbert_torch.ops import kmeans as kmeans_ops
from colbert_torch.ops.kmeans import KMeansResult

__all__ = ["kmeans_sharded", "lloyd_step_sharded", "assign_clusters_sharded",
           "pad_rows"]


def pad_rows(data: torch.Tensor, weights: torch.Tensor | None, ndev: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad rows to a multiple of ``ndev`` with weight-0 zero rows -> (data,
    weights fp32)."""
    n = data.shape[0]
    w = (torch.ones(n, dtype=torch.float32, device=data.device) if weights is None
         else weights.to(torch.float32))
    pad = -(-n // ndev) * ndev - n
    if pad:
        data = torch.cat([data, data.new_zeros((pad,) + tuple(data.shape[1:]))])
        w = torch.cat([w, w.new_zeros(pad)])
    return data, w


def _step(data_sh: dict, w_sh: dict, cents: dict, mesh, *, k: int, bsize: int
          ) -> tuple[dict, float]:
    """One sharded Lloyd iteration over already-placed shards ->
    ({shard: new centroids on its device}, max-abs shift)."""
    from colbert_torch.parallel import launch

    parts = {}
    for s in data_sh:
        sums, counts = kmeans_ops.lloyd_stats(data_sh[s], cents[s], k=k, bsize=bsize,
                                              weights=w_sh[s])
        parts[s] = torch.cat([sums, counts[:, None]], dim=1)
    total, dev = launch.sum_shards(parts, mesh)
    old = cents[min(cents)].to(dev)
    new = kmeans_ops.centroids_from_stats(total[:, :-1], total[:, -1], old)
    shift = float((new - old.float()).abs().max())
    return {s: new.to(cents[s].device) for s in cents}, shift


def lloyd_step_sharded(data: torch.Tensor, centroids: torch.Tensor, weights: torch.Tensor,
                       mesh, *, k: int, bsize: int = 1024) -> tuple[torch.Tensor, float]:
    """One sharded Lloyd iteration -> (new centroids on ``centroids``'s
    device, max-abs shift). ``data``/``weights`` rows must divide the
    data-axis size (pad with weight-0 rows)."""
    from colbert_torch.parallel import launch

    new, shift = _step(launch.put_data_sharded(data, mesh),
                       launch.put_data_sharded(weights, mesh),
                       launch.put_replicated(centroids, mesh), mesh, k=k, bsize=bsize)
    return new[min(new)].to(centroids.device), shift


def _assign(data_sh: dict, cents: dict, mesh, *, bsize: int) -> torch.Tensor:
    """Per-shard nearest centroids, gathered in shard order."""
    from colbert_torch.parallel import launch

    parts = {s: kmeans_ops.assign_clusters(data_sh[s], cents[s], bsize=bsize)
             for s in data_sh}
    gathered, _ = launch.gather_shards(parts, mesh)
    return torch.cat(gathered)


def assign_clusters_sharded(data: torch.Tensor, centroids: torch.Tensor, mesh, *,
                            bsize: int = 1024) -> torch.Tensor:
    """Nearest centroid of every row, each data shard assigning its own rows
    -> int64 ``(n,)`` on the gather device. Rows must divide the data axis."""
    from colbert_torch.parallel import launch

    return _assign(launch.put_data_sharded(data, mesh),
                   launch.put_replicated(centroids, mesh), mesh, bsize=bsize)


def kmeans_sharded(data, k: int, mesh, *, niters: int = 20, tol: float = 1e-4,
                   seed: int = 0, bsize: int = 1024, init_idx=None) -> KMeansResult:
    """Full k-means fit over ``mesh``'s data axis, with the single-device
    fit's convergence rule (stop once the largest centroid move is below
    ``tol``). The data is padded to the data-axis size with weight-0 rows
    and placed once. ``init_idx`` picks the initial centroids' rows; without
    it they are ``k`` rows drawn by ``np.random.default_rng(seed)``, which
    are not the JAX package's ``jax.random`` draws. Every process returns the
    same result."""
    from colbert_torch.parallel import launch

    data = torch.as_tensor(data, dtype=torch.float32)
    n = data.shape[0]
    if k > n:
        raise ValueError(f"k={k} > number of points n={n}")
    if init_idx is None:
        init_idx = np.random.default_rng(seed).permutation(n)[:k]
    idx = torch.as_tensor(np.array(init_idx), dtype=torch.int64, device=data.device)
    padded, w = pad_rows(data, None, mesh.shape["data"])
    data_sh = launch.put_data_sharded(padded, mesh)
    w_sh = launch.put_data_sharded(w, mesh)
    cents = launch.put_replicated(data[idx], mesh)
    it, shift = 0, math.inf
    while it < niters and shift >= tol:
        cents, shift = _step(data_sh, w_sh, cents, mesh, k=k, bsize=bsize)
        it += 1
    assignments = _assign(data_sh, cents, mesh, bsize=bsize)[:n]
    return KMeansResult(cents[min(cents)], assignments, it, shift)
