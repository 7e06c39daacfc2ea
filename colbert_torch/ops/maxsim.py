"""MaxSim late-interaction scoring over a padded candidate block (port of
``colbert_tpu.ops.maxsim``).

``sum over query tokens of max over doc tokens of Q·D`` for a dense
``(P, Ld, dim)`` candidate tensor, in chunks of ``pid_chunk`` passages:
one fp32 product per chunk and masked max/sum reductions. The JAX package
computes this outside any Pallas kernel, as one XLA program; here each
chunk is one ``torch.einsum`` (a library matmul), on whatever device the
inputs live on.
"""

from __future__ import annotations

import torch

__all__ = ["maxsim_scores"]

NEG = -1e30


def maxsim_scores(
    Q: torch.Tensor,       # (B, Lq, dim) query token embeddings (zeros for unused)
    D: torch.Tensor,       # (P, Ld, dim) padded candidate doc token embeddings
    dmask: torch.Tensor,   # (P, Ld) bool — True for real doc tokens
    *,
    pid_chunk: int = 256,
) -> torch.Tensor:
    """MaxSim scores ``(B, P)`` float32.

    Padding rows of ``D`` are masked to -1e30 before the per-query-token
    max, so they contribute nothing; passages with no real tokens score 0.
    """
    B = Q.shape[0]
    P = D.shape[0]
    Qf = Q.to(torch.float32)
    dmask = dmask.to(torch.bool)
    out = torch.empty((B, P), dtype=torch.float32, device=Q.device)
    for s in range(0, P, pid_chunk):
        d = D[s:s + pid_chunk].to(torch.float32)
        m = dmask[s:s + pid_chunk]
        sc = torch.einsum("bqd,pld->bpql", Qf, d)                 # (B, pc, Lq, Ld)
        sc = sc.masked_fill(~m[None, :, None, :], NEG)
        per_q = sc.amax(dim=-1)                                   # (B, pc, Lq)
        per_q = torch.where(m.any(dim=-1)[None, :, None], per_q, 0.0)
        out[:, s:s + pid_chunk] = per_q.sum(dim=-1)
    return out
