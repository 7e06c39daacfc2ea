"""Codec training: k-means centroids + residual bucket statistics (port of
``colbert_tpu.indexing.codec_trainer``).

Reference collection_indexer.jl:219-237 ``train`` and :177-195
``_compute_avg_residuals!``: k-means over the sample, code the heldout
split, quantile cutoffs and weights from the heldout residuals. With a
``mesh`` the sample is split over its data axis: sharded Lloyd
(:mod:`colbert_torch.parallel.kmeans_dist`) and the histogram quantiles of
:mod:`colbert_torch.ops.quantile`, as the JAX package's sharded trainer
does; its cutoffs are those of a 2^16-bin histogram, not the exact
quantiles of the single-device path.
"""

from __future__ import annotations

import torch

from colbert_torch.ops import codec as codec_ops
from colbert_torch.ops import kmeans as kmeans_ops
from colbert_torch.utils import tracing

__all__ = ["train_codec", "sample_bucket_step"]


def sample_bucket_step(n: int) -> int:
    """Row-count bucket of a codec-training sample: the next multiple of
    ~n/16 (min 4096). The encoder preallocates its sample buffer at this
    granularity, so :func:`_bucket_rows` never has to copy the sample."""
    return max(4096, 1 << max(0, (n - 1).bit_length() - 4))


def train_codec(
    sample: torch.Tensor,
    heldout: torch.Tensor,
    *,
    num_partitions: int,
    nbits: int,
    kmeans_niters: int = 20,
    seed: int = 0,
    sample_weights: torch.Tensor | None = None,
    init_idx=None,
    mesh=None,
    tol: float = 1e-4,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]:
    """-> (centroids (k, dim), bucket_cutoffs, bucket_weights, avg_residual),
    the tensors on the sample's device. ``sample_weights`` mark the valid
    rows of a padded sample (0 = padding) and ``init_idx`` picks the initial
    centroids among them. With ``mesh`` the results lie on shard 0's
    device."""
    if mesh is not None:
        return _train_codec_sharded(
            sample, heldout, mesh, num_partitions=num_partitions, nbits=nbits,
            kmeans_niters=kmeans_niters, seed=seed, sample_weights=sample_weights,
            init_idx=init_idx, tol=tol)
    with tracing.span("kmeans"):
        sample, sample_weights = _bucket_rows(sample, sample_weights)
        result = kmeans_ops.kmeans(
            sample, num_partitions, niters=kmeans_niters, seed=seed,
            compute_assignments=False, weights=sample_weights, init_idx=init_idx,
            tol=tol,
        )
    tracing.count("kmeans_iters", result.iterations)
    centroids = result.centroids
    with tracing.span("quantiles"):
        codes = codec_ops.compress_into_codes(heldout, centroids)
        residuals = heldout.float() - centroids[codes.long()]
        cutoffs, weights, avg = codec_ops.bucket_cutoffs_and_weights(nbits, residuals)
        return centroids, cutoffs, weights, float(avg)


def _bucket_rows(sample: torch.Tensor, weights: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad rows to the next multiple of :func:`sample_bucket_step` with
    zero-weight rows (the JAX package does so to keep program shapes
    recurring; here it keeps the two packages' k-means inputs the same).
    The sample's dtype is kept."""
    n = sample.shape[0]
    step = sample_bucket_step(n)
    padded = -(-n // step) * step
    if padded == n and weights is not None:
        return sample, weights
    w = (torch.ones((n,), dtype=torch.float32, device=sample.device) if weights is None
         else weights.float())
    if padded != n:
        sample = torch.cat([sample, sample.new_zeros((padded - n, sample.shape[1]))])
        w = torch.cat([w, w.new_zeros((padded - n,))])
    return sample, w


# the sharded fit reads the centroid shift on the host only every few
# iterations, as the JAX sharded trainer does, so it may run up to
# SYNC_EVERY - 1 iterations past the single-device fit's stopping point
SYNC_EVERY = 5


def _train_codec_sharded(sample, heldout, mesh, *, num_partitions, nbits, kmeans_niters,
                         seed, sample_weights, init_idx, tol):
    """The JAX package's ``_train_codec_sharded``: sharded Lloyd over the
    (dtype-kept) sample, then the heldout residuals' cutoffs and weights
    from one pass of the sharded histogram quantiles."""
    import numpy as np

    from colbert_torch.ops.quantile import sharded_quantiles
    from colbert_torch.parallel import launch
    from colbert_torch.parallel.kmeans_dist import _step, pad_rows

    ndev = mesh.shape["data"]
    n = sample.shape[0]
    data, weights = pad_rows(sample, sample_weights, ndev)
    if init_idx is None:
        init_idx = np.random.default_rng(seed).permutation(n)[:num_partitions]
    idx = torch.as_tensor(np.array(init_idx), dtype=torch.int64, device=data.device)
    data_sh = launch.put_data_sharded(data, mesh)
    w_sh = launch.put_data_sharded(weights, mesh)
    cents = launch.put_replicated(data[idx].float(), mesh)
    it = 0
    for it in range(1, kmeans_niters + 1):
        cents, shift = _step(data_sh, w_sh, cents, mesh, k=num_partitions, bsize=1024)
        if (it % SYNC_EVERY == 0 or it == kmeans_niters) and shift < tol:
            break
    tracing.count("kmeans_iters", it)
    centroids = cents[min(cents)]
    home = centroids.device
    heldout = heldout.to(home, torch.float32)
    codes = codec_ops.compress_into_codes(heldout, centroids)
    residuals = heldout - centroids[codes.long()]

    num_options = 1 << nbits
    base = np.arange(num_options, dtype=np.float64) / num_options
    qs = np.concatenate([base[1:], base + 0.5 / num_options]).astype(np.float32)
    res_pad, w_h = pad_rows(residuals, None, ndev)
    values, avg = sharded_quantiles(res_pad, qs, mesh, weights=w_h)
    values = values.to(home)
    return (centroids, values[:num_options - 1].float(), values[num_options - 1:].float(),
            float(avg))
