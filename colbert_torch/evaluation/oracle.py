"""Exact-codec oracle: decompress + MaxSim EVERY passage, with no funnel
(port of ``colbert_tpu.evaluation.oracle``).

It scores exactly what the reference scores when its probes surface every
passage (reference: src/search/ranking.jl:23-87), and is the yardstick the
funnel's recall is measured against and the ground truth the tuner
(:mod:`.autotune`) sweeps its knobs over.

One contiguous pid block's rows at a time are read from the chunk mmaps
(:func:`colbert_torch.storage.format.read_embedding_rows`), so host memory
holds one block, and scored on ``searcher.device`` through
:func:`~colbert_torch.retrieval.ranking.score_full`. On CUDA the fp32
products must not run in TF32: one TF32 product moves a 32-token MaxSim
sum by ~4e-4, which would put the yardstick further from the exact scores
than the stage-2 kernel's 1e-4 contract. So :func:`exhaustive_scores`
refuses to run while ``torch.backends.cuda.matmul.allow_tf32`` is set.
"""

from __future__ import annotations

import numpy as np
import torch

from colbert_torch.retrieval import ranking
from colbert_torch.storage import format as fmt

__all__ = ["exhaustive_scores", "oracle_topk"]


@torch.no_grad()
def exhaustive_scores(searcher, Q, *, block: int = 1024) -> np.ndarray:
    """Score every passage against every query -> (B, P) float32.

    ``searcher`` is a :class:`colbert_torch.retrieval.searcher.Searcher` of
    either backend (reads go through the index chunk mmaps, not its serving
    tensors); ``Q`` is (B, Lq, dim) query embeddings (numpy or tensor).
    """
    dev = searcher.device
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exhaustive_scores needs fp32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    Q = torch.as_tensor(Q, dtype=torch.float32).to(dev)
    doclens = np.asarray(searcher.doclens, np.int64)
    offsets = np.concatenate([[0], np.cumsum(doclens)]).astype(np.int64)
    P = len(doclens)
    scores = np.full((Q.shape[0], P), -np.inf, np.float32)
    for lo in range(0, P, block):
        hi = min(P, lo + block)
        r0, r1 = int(offsets[lo]), int(offsets[hi])
        codes_blk, res_blk = fmt.read_embedding_rows(searcher.index_path, r0, r1)
        idx, mask = ranking.gather_padded(np.arange(hi - lo), doclens[lo:hi],
                                          offsets[lo:hi] - r0)
        sc = ranking.score_full(
            Q, torch.from_numpy(codes_blk[idx].view(np.int32)).to(dev),
            torch.from_numpy(res_blk[idx]).to(dev), torch.from_numpy(mask).to(dev),
            searcher.centroids, searcher.bucket_weights, nbits=searcher.config.nbits,
        )
        scores[:, lo:hi] = sc[:, :hi - lo].cpu().numpy()
    return scores


def oracle_topk(scores: np.ndarray, k: int) -> np.ndarray:
    """Top-k pids per query from an (B, P) oracle score matrix."""
    return np.argsort(-scores, axis=1)[:, :k]
