"""Candidate generation and MaxSim ranking for the host backend (port of
``colbert_tpu.retrieval.ranking``).

The staged pipeline of the reference-shaped ``Searcher(backend="host")``
and of the exact oracle: centroid probing, IVF candidates gathered on the
host (numpy CSR slicing), padded index matrices, then scoring on the
device, either fully (decompress + MaxSim) or from centroids only (PLAID's
stage-1 approximation).

Differences from the JAX module, none of which changes what is computed:
the two scorers are plain loops over passage chunks (``lax.map`` there),
and :func:`probe_centroids` orders ties by the lowest centroid index, as
``lax.top_k`` does, with a stable sort by descending score (the rule that
``device_index._probe_topk`` applies to its tie groups, here over the
whole row).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from colbert_torch.ops import codec as codec_ops
from colbert_torch.ops.maxsim import NEG, maxsim_scores

__all__ = [
    "build_emb2pid",
    "probe_centroids",
    "candidate_pids",
    "gather_padded",
    "score_full",
    "score_approx",
]


def build_emb2pid(doclens: np.ndarray) -> np.ndarray:
    """Embedding id -> passage id (reference: searching.jl:82-91)."""
    return np.repeat(
        np.arange(len(doclens), dtype=np.int64), np.asarray(doclens).astype(np.int64)
    )


def probe_centroids(Q: torch.Tensor, centroids: torch.Tensor, *, nprobe: int) -> torch.Tensor:
    """Top-``nprobe`` centroid ids per query token -> (B, Lq, nprobe) int32,
    best first; fp32 scores, ties to the lowest index."""
    scores = torch.einsum("bqd,kd->bqk", Q.to(torch.float32), centroids.to(torch.float32))
    order = torch.argsort(scores, dim=-1, descending=True, stable=True)
    return order[..., :nprobe].to(torch.int32)


def candidate_pids(
    cells: np.ndarray,
    ivf: np.ndarray,
    ivf_lengths: np.ndarray,
    emb2pid: np.ndarray,
) -> np.ndarray:
    """Probed centroid ids -> unique candidate passage ids (host side).

    The IVF is a CSR layout (``ivf`` = eids grouped by centroid,
    ``ivf_lengths`` = group sizes); the gather is numpy slicing over the
    unique probed cells (reference ranking.jl:7-21, :39-43).
    """
    offsets = np.concatenate([[0], np.cumsum(ivf_lengths)]).astype(np.int64)
    cids = np.unique(np.asarray(cells).reshape(-1))
    if len(cids) == 0:
        return np.zeros((0,), np.int64)
    eids = np.concatenate([ivf[offsets[c]:offsets[c + 1]] for c in cids])
    if len(eids) == 0:
        return np.zeros((0,), np.int64)
    return np.unique(emb2pid[eids])


def _bucket(x: int, step: int) -> int:
    return max(step, -(-x // step) * step)


def gather_padded(
    pids: np.ndarray,
    doclens: np.ndarray,
    emb_offsets: np.ndarray,
    *,
    len_bucket: int = 32,
    pid_bucket: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """Candidate pids -> (gather_idx (P', Ld) int32, mask (P', Ld) bool),
    padded index matrices into the flat embedding (codes/residuals) arrays.

    ``P'`` and ``Ld`` are bucketed to multiples of ``pid_bucket`` and
    ``len_bucket``; padded rows have all-False masks (score 0)."""
    if len(pids) == 0:
        return (np.zeros((pid_bucket, len_bucket), np.int32),
                np.zeros((pid_bucket, len_bucket), bool))
    dl = doclens[pids].astype(np.int64)
    Ld = _bucket(int(dl.max()), len_bucket)
    P = _bucket(len(pids), pid_bucket)
    idx = np.zeros((P, Ld), np.int64)
    mask = np.zeros((P, Ld), bool)
    ar = np.arange(Ld)
    idx[:len(pids)] = emb_offsets[pids][:, None] + np.minimum(ar[None, :], dl[:, None] - 1)
    mask[:len(pids)] = ar[None, :] < dl[:, None]
    return idx.astype(np.int32), mask


def score_full(
    Q: torch.Tensor,            # (B, Lq, dim)
    codes_g: torch.Tensor,      # (P, Ld) int — gathered codes
    residuals_g: torch.Tensor,  # (P, Ld, nbytes) uint8 — gathered packed residuals
    dmask: torch.Tensor,        # (P, Ld) bool
    centroids: torch.Tensor,
    bucket_weights: torch.Tensor,
    *,
    nbits: int,
    pid_chunk: int = 128,
) -> torch.Tensor:
    """Decompress + MaxSim -> (B, P) fp32 scores: :func:`ops.codec.decompress`
    of every gathered row, then :func:`ops.maxsim.maxsim_scores`."""
    P, Ld = codes_g.shape
    embs = codec_ops.decompress(
        codes_g.reshape(P * Ld), residuals_g.reshape(P * Ld, -1), centroids,
        bucket_weights, nbits=nbits,
    )
    return maxsim_scores(Q, embs.reshape(P, Ld, -1), dmask, pid_chunk=pid_chunk)


def score_approx(
    Q: torch.Tensor,        # (B, Lq, dim)
    codes_g: torch.Tensor,  # (P, Ld) int
    dmask: torch.Tensor,    # (P, Ld) bool
    centroids: torch.Tensor,
    *,
    pid_chunk: int = 512,
) -> torch.Tensor:
    """Centroid-only approximate MaxSim -> (B, P) (PLAID stage-1 scoring).

    Each candidate token is approximated by its centroid: scores are
    gathered by code from the (B, Lq, K) centroid score table, with no
    residual decompression."""
    cs = torch.einsum("bqd,kd->bqk", Q.to(torch.float32), centroids.to(torch.float32))
    B = cs.shape[0]
    P = codes_g.shape[0]
    dmask = dmask.to(torch.bool)
    out = torch.empty((B, P), dtype=torch.float32, device=cs.device)
    for s in range(0, P, pid_chunk):
        c = codes_g[s:s + pid_chunk].to(torch.int64)
        m = dmask[s:s + pid_chunk]
        sc = cs[:, :, c]                                          # (B, Lq, pc, Ld)
        sc = sc.masked_fill(~m[None, None], NEG)
        per_q = sc.amax(dim=-1)                                   # (B, Lq, pc)
        per_q = torch.where(m.any(dim=-1)[None, None], per_q, 0.0)
        out[:, s:s + pid_chunk] = per_q.sum(dim=1)
    return out
