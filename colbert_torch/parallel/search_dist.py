"""Sharded exhaustive scoring with a top-k merge (port of
``colbert_tpu.parallel.search_dist``).

The candidate rows split over the data axis of a mesh: each shard
decompresses its rows, scores them with
:func:`colbert_torch.ops.maxsim.maxsim_scores` and keeps its own top-k,
offset to global rows by ``shard * rows_per_shard``; the merge is a host
sort of the ``n_shards * k`` winners. Only the (score, row) pairs leave a
shard, not the candidate embeddings.
"""

from __future__ import annotations

import numpy as np
import torch

from colbert_torch.ops import codec as codec_ops
from colbert_torch.ops.maxsim import maxsim_scores

__all__ = ["score_full_sharded_topk"]


def score_full_sharded_topk(
    Q: torch.Tensor,            # (B, Lq, dim)
    codes_g: np.ndarray,        # (P, Ld) uint32, P divisible by the data axis
    residuals_g: np.ndarray,    # (P, Ld, nbytes) uint8
    dmask: np.ndarray,          # (P, Ld) bool
    centroids: torch.Tensor,
    bucket_weights: torch.Tensor,
    mesh,
    *,
    nbits: int,
    k: int,
    pid_chunk: int = 128,
) -> tuple[np.ndarray, np.ndarray]:
    """-> (scores (B, k), candidate rows (B, k)) after the cross-shard merge."""
    from colbert_torch.parallel import launch

    ndev = mesh.shape["data"]
    if codes_g.shape[0] % ndev:
        raise ValueError("candidate rows must divide the data axis; pad first")
    Pl = codes_g.shape[0] // ndev
    k_local = min(k, Pl)
    codes_sh = launch.put_data_sharded(np.asarray(codes_g, np.uint32).view(np.int32), mesh)
    res_sh = launch.put_data_sharded(np.asarray(residuals_g, np.uint8), mesh)
    mask_sh = launch.put_data_sharded(np.asarray(dmask, bool), mesh)
    Q = torch.as_tensor(Q, dtype=torch.float32)
    parts = {}
    with torch.no_grad():
        for s in codes_sh:
            dev = mesh.data_device(s)
            Ld = codes_sh[s].shape[1]
            embs = codec_ops.decompress(codes_sh[s].reshape(Pl * Ld),
                                        res_sh[s].reshape(Pl * Ld, -1),
                                        centroids.to(dev), bucket_weights.to(dev), nbits=nbits)
            scores = maxsim_scores(Q.to(dev), embs.reshape(Pl, Ld, -1), mask_sh[s],
                                   pid_chunk=pid_chunk)          # (B, Pl)
            top, idx = torch.topk(scores, k_local, dim=1)
            parts[s] = torch.stack([top.double(), (idx + s * Pl).double()])
    gathered, _ = launch.gather_shards(parts, mesh)
    t = torch.cat(gathered, dim=2).cpu().numpy()     # (2, B, ndev * k_local)
    top, gidx = t[0].astype(np.float32), t[1].astype(np.int64)
    order = np.argsort(-top, axis=1)[:, :k]
    return np.take_along_axis(top, order, 1), np.take_along_axis(gidx, order, 1)
