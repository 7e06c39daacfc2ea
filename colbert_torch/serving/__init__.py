"""Serving layer: cross-request batching and a minimal HTTP front (port of
``colbert_tpu.serving``).

No reference equivalent (serving infrastructure is on the reference's
roadmap, README.md:179-190). A batched search costs a fixed host and
launch overhead, so batched execution is the serving model: the
:class:`~colbert_torch.serving.batcher.BatchingSearcher` coalesces
concurrent requests into one bucketed batched search.
"""

from colbert_torch.serving.batcher import BatchingSearcher

__all__ = ["BatchingSearcher"]
