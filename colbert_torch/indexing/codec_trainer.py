"""Codec training: k-means centroids + residual bucket statistics (port of
``colbert_tpu.indexing.codec_trainer``, single device).

Reference collection_indexer.jl:219-237 ``train`` and :177-195
``_compute_avg_residuals!``: k-means over the sample, code the heldout
split, quantile cutoffs and weights from the heldout residuals. The
sharded trainer (``mesh=``, with the histogram quantiles of
``colbert_tpu/ops/quantile.py``) waits for the multi-device layer,
ROADMAP A12.
"""

from __future__ import annotations

import torch

from colbert_torch.ops import codec as codec_ops
from colbert_torch.ops import kmeans as kmeans_ops

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
    centroids among them."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded codec trainer is not ported yet (ROADMAP A12)")
    sample, sample_weights = _bucket_rows(sample, sample_weights)
    result = kmeans_ops.kmeans(
        sample, num_partitions, niters=kmeans_niters, seed=seed,
        compute_assignments=False, weights=sample_weights, init_idx=init_idx,
        tol=tol,
    )
    centroids = result.centroids
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
