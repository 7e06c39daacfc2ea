"""The PLAID search funnel in plain PyTorch, one query at a time, from the
index arrays (the semantics ``colbert_torch.retrieval.device_index``
documents, written out without its static shapes, sorts and kernels):

1. probe: each query token's ``nprobe`` best centroids by inner product;
   a probed cell below ``centroid_threshold`` is dropped, except each
   token's best;
2. stage 1: every passage with an embedding in a kept cell of a token is a
   candidate; its bound is the sum over the tokens that reach it of
   ``max(0, s - i_q) + i_q / 2``, where ``s`` is its best kept cell's probe
   score for that token and ``i_q`` the token's ``nprobe``-th probe score;
   the ``sel_width`` best bounds go on;
3. refine (when the stage-2 budget is below the candidate capacity):
   ``sum_q max_t <bf16(q), bf16(centroid[code_t])>`` over each candidate's
   tokens, products summed in fp32; the ``ncandidates`` best go on;
4. stage 2: ``sum_q max_t <q, normalize(centroid[code_t] + residual_t)>``
   over each candidate's tokens in fp32, residual ``t`` read from its
   packed bucket indices; the ``k`` best are the answer.

Capacities follow ``colbert_torch.retrieval.searcher.Searcher``'s auto
rules (restated in :func:`params`); an index whose cells would be split or
truncated by them is refused, since the funnel here reads whole cells."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class RefIndex:
    centroids: torch.Tensor      # (K, dim) f32
    bucket_weights: torch.Tensor  # (2^nbits,) f32
    codes: torch.Tensor          # (N,) int64
    residuals: torch.Tensor      # (N, dim * nbits / 8) uint8
    doclens: torch.Tensor        # (P,) int64
    offsets: torch.Tensor        # (P,) int64, first embedding of each passage
    emb2pid: torch.Tensor        # (N,) int64
    ivf: torch.Tensor            # (N,) int64 embedding ids grouped by code
    ivf_offsets: torch.Tensor    # (K,) int64
    ivf_lengths: torch.Tensor    # (K,) int64
    nbits: int


def load_index(ix, device) -> RefIndex:
    """A :class:`benchmark.gen.index.SyntheticIndex` -> tensors on ``device``;
    the IVF is derived here again from the codes."""
    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    dl = ix.doclens.astype(np.int64)
    K = ix.centroids.shape[0]
    codes = ix.codes.astype(np.int64)
    lengths = np.bincount(codes, minlength=K)
    return RefIndex(
        centroids=t(ix.centroids, torch.float32),
        bucket_weights=t(ix.bucket_weights, torch.float32),
        codes=t(codes), residuals=t(ix.residuals), doclens=t(dl),
        offsets=t(np.concatenate([[0], np.cumsum(dl)[:-1]])),
        emb2pid=t(np.repeat(np.arange(len(dl)), dl)),
        ivf=t(np.argsort(codes, kind="stable")),
        ivf_offsets=t(np.concatenate([[0], np.cumsum(lengths)[:-1]])),
        ivf_lengths=t(lengths), nbits=ix.nbits)


def params(search: dict, ix: RefIndex, Lq: int, k: int) -> dict:
    """The funnel's widths for ``k`` results: the stage-2 budget is
    ``min(ncandidates, plaid_stage2_docs or max(16k, 1024))``; the cell
    capacity ``min(4096, max(32, ceil32(largest cell)))``; the candidate
    capacity ``min(8192, max(128, ceil128(P + 1)), Lq * nprobe * cell_cap)``;
    the refine runs when the budget is below that capacity, on the best
    ``min(refine_width_factor * budget, capacity)`` stage-1 bounds."""
    largest = int(ix.ivf_lengths.max())
    balance = search.get("ivf_balance_cap") or 1024
    if largest > balance:
        raise NotImplementedError("cells above the balance cap are split by the program")
    cell_cap = min(4096, max(32, -(-largest // 32) * 32))
    P = ix.doclens.shape[0]
    nprobe = search["nprobe"]
    cap = min(8192, max(128, -(-(P + 1) // 128) * 128), Lq * nprobe * cell_cap)
    budget = min(search["ncandidates"], search.get("plaid_stage2_docs") or max(16 * k, 1024))
    budget = min(budget, cap)
    refine = bool(search["plaid_stage1_refine"]) and budget < cap
    width = min(search["refine_width_factor"] * budget, cap) if refine else budget
    return dict(nprobe=nprobe, threshold=search["centroid_score_threshold"],
                budget=budget, width=width, refine=refine, k=min(k, budget))


def _tokens(ix: RefIndex, pids: torch.Tensor):
    """-> (embedding ids (n, Ld), valid (n, Ld)) of passages ``pids``."""
    dl = ix.doclens[pids]
    Ld = max(1, int(dl.max())) if len(pids) else 1
    ar = torch.arange(Ld, device=pids.device)
    valid = ar[None] < dl[:, None]
    rows = torch.where(valid, ix.offsets[pids][:, None] + ar, 0)
    return rows, valid


def decompress(ix: RefIndex, rows: torch.Tensor) -> torch.Tensor:
    """Embedding ids -> unit fp32 embeddings ``(..., dim)``: the centroid of
    the code plus the residual's bucket weights, normalized. Dim ``d``'s
    bucket index is bits ``d*nbits .. d*nbits+nbits-1`` of the row's bytes
    read least significant bit first."""
    nb = ix.nbits
    packed = ix.residuals[rows].to(torch.int64)            # (..., nbytes)
    per_byte = 8 // nb
    shifts = torch.arange(per_byte, device=rows.device) * nb
    idx = ((packed[..., None] >> shifts) & ((1 << nb) - 1)).flatten(-2)
    emb = ix.centroids[ix.codes[rows]] + ix.bucket_weights[idx]
    return emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def maxsim(ix: RefIndex, Q: torch.Tensor, pids: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Stage 2: exact late-interaction scores of ``pids`` for ``Q (Lq, dim)``."""
    out = []
    for s in range(0, len(pids), chunk):
        rows, valid = _tokens(ix, pids[s:s + chunk])
        sim = decompress(ix, rows) @ Q.T                    # (c, Ld, Lq)
        sim = sim.masked_fill(~valid[..., None], -float("inf"))
        out.append(sim.amax(dim=1).sum(dim=1))
    return torch.cat(out) if out else Q.new_zeros(0)


def refine_scores(ix: RefIndex, Q: torch.Tensor, pids: torch.Tensor,
                  chunk: int = 1024) -> torch.Tensor:
    table = (Q.to(torch.bfloat16).float() @ ix.centroids.to(torch.bfloat16).float().T)  # (Lq, K)
    out = []
    for s in range(0, len(pids), chunk):
        rows, valid = _tokens(ix, pids[s:s + chunk])
        sim = table[:, ix.codes[rows]]                      # (Lq, c, Ld)
        sim = sim.masked_fill(~valid[None], -float("inf"))
        out.append(sim.amax(dim=2).sum(dim=0))
    return torch.cat(out) if out else Q.new_zeros(0)


def search(ix: RefIndex, Q: torch.Tensor, p: dict) -> dict:
    """One query ``Q (Lq, dim)`` through the funnel -> ``pids``, ``scores``
    (the ``k`` best, descending) and the work of each stage."""
    Lq = Q.shape[0]
    vals, cells = (Q @ ix.centroids.T).topk(p["nprobe"], dim=1)    # (Lq, nprobe)
    keep = torch.ones_like(vals, dtype=torch.bool)
    if p["threshold"] is not None:
        keep = vals >= p["threshold"]
        keep[:, 0] = True
    impute = vals[:, -1]
    q_of, j_of = keep.nonzero(as_tuple=True)
    cell = cells[q_of, j_of]
    adj = vals[q_of, j_of] - impute[q_of]
    lens = ix.ivf_lengths[cell]
    rep = torch.repeat_interleave(torch.arange(len(cell), device=Q.device), lens)
    first = torch.cumsum(lens, 0) - lens
    pos = ix.ivf_offsets[cell][rep] + torch.arange(len(rep), device=Q.device) - first[rep]
    pid = ix.emb2pid[ix.ivf[pos]]
    key = pid * Lq + q_of[rep]
    ukey, inv = torch.unique(key, return_inverse=True)
    best = torch.full((len(ukey),), -float("inf"), device=Q.device)
    best = best.scatter_reduce(0, inv, adj[rep], "amax")
    contrib = best.clamp(min=0.0) + impute[ukey % Lq] * 0.5
    pids, pinv = torch.unique(ukey // Lq, return_inverse=True)
    bound = torch.zeros(len(pids), device=Q.device).index_add_(0, pinv, contrib)
    sel = pids[bound.topk(min(p["width"], len(pids))).indices]
    work = {"candidates": len(pids), "refine_passages": 0, "refine_tokens": 0}
    refined = sel
    if p["refine"]:
        work["refine_passages"] = len(sel)
        work["refine_tokens"] = int(ix.doclens[sel].sum())
        approx = refine_scores(ix, Q, sel)
        refined = sel[approx.topk(min(p["budget"], len(sel))).indices]
    work["stage2_passages"] = len(refined)
    work["stage2_tokens"] = int(ix.doclens[refined].sum())
    exact = maxsim(ix, Q, refined)
    top = exact.topk(min(p["k"], len(refined)))
    return {"pids": refined[top.indices], "scores": top.values, "work": work}
