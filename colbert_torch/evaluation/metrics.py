"""Retrieval quality metrics: MRR@k, Success@k, nDCG@k, and the reference's
LCS-distance hit-rate protocol (a copy of ``colbert_tpu.evaluation.metrics``,
numpy only).

The reference has no benchmark suite; its only quality protocol is an
example script computing hit-rate@5 with a longest-common-subsequence
distance threshold of 0.33 (reference: examples/AIHelpMe/evals.jl:29-43,
juliadocsindex.py:100). That protocol is reproduced here
(:func:`lcs_hit_rate`) alongside the standard IR metrics the north-star
targets require (MS MARCO MRR@10, LoTTe Success@5, BEIR nDCG@10).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

__all__ = ["mrr_at_k", "success_at_k", "ndcg_at_k", "lcs_distance",
           "lcs_hit_rate", "set_recall_at_k", "score_recall_at_k"]


def mrr_at_k(
    rankings: Sequence[Sequence[int]], relevant: Sequence[set[int]], k: int = 10
) -> float:
    """Mean reciprocal rank of the first relevant pid within the top k."""
    total = 0.0
    for ranked, rel in zip(rankings, relevant):
        for i, pid in enumerate(ranked[:k]):
            if pid in rel:
                total += 1.0 / (i + 1)
                break
    return total / max(1, len(rankings))


def success_at_k(
    rankings: Sequence[Sequence[int]], relevant: Sequence[set[int]], k: int = 5
) -> float:
    """Fraction of queries with >= 1 relevant pid in the top k (LoTTe metric)."""
    hits = sum(
        any(pid in rel for pid in ranked[:k])
        for ranked, rel in zip(rankings, relevant)
    )
    return hits / max(1, len(rankings))


def ndcg_at_k(
    rankings: Sequence[Sequence[int]],
    relevance: Sequence[Mapping[int, float]],
    k: int = 10,
) -> float:
    """Normalized discounted cumulative gain with graded relevance (BEIR)."""
    total = 0.0
    for ranked, rels in zip(rankings, relevance):
        dcg = sum(
            rels.get(pid, 0.0) / np.log2(i + 2) for i, pid in enumerate(ranked[:k])
        )
        ideal = sorted(rels.values(), reverse=True)[:k]
        idcg = sum(g / np.log2(i + 2) for i, g in enumerate(ideal))
        total += dcg / idcg if idcg > 0 else 0.0
    return total / max(1, len(rankings))


def lcs_distance(a: str, b: str) -> float:
    """1 - |LCS(a, b)| / min(|a|, |b|) — the reference eval's distance
    (examples/AIHelpMe/evals.jl:29-43 semantics)."""
    if not a or not b:
        return 1.0
    la, lb = len(a), len(b)
    prev = np.zeros(lb + 1, np.int32)
    for i in range(1, la + 1):
        cur = np.zeros(lb + 1, np.int32)
        ai = a[i - 1]
        for j in range(1, lb + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return 1.0 - prev[lb] / min(la, lb)


def lcs_hit_rate(
    retrieved_texts: Sequence[Sequence[str]],
    gold_texts: Sequence[str],
    *,
    threshold: float = 0.33,
) -> float:
    """Hit-rate: query counts as a hit if any retrieved passage is within
    ``threshold`` LCS distance of the gold passage (reference protocol)."""
    hits = 0
    for cands, gold in zip(retrieved_texts, gold_texts):
        if any(lcs_distance(c, gold) < threshold for c in cands):
            hits += 1
    return hits / max(1, len(gold_texts))


def set_recall_at_k(got: np.ndarray, oracle_topk: np.ndarray, k: int) -> float:
    """Set recall@k vs an oracle ranking: |got top-k ∩ oracle top-k| / k."""
    hits = [
        len(set(got[b, :k].tolist()) & set(oracle_topk[b, :k].tolist())) / k
        for b in range(got.shape[0])
    ]
    return float(np.mean(hits))


def score_recall_at_k(
    got: np.ndarray, oracle_scores: np.ndarray, k: int, eps: float = 0.01
) -> float:
    """Tie-aware recall@k: fraction of the funnel's top-k whose EXACT score
    reaches the oracle's k-th best (within ``eps``). On corpora with many
    near-tied passages, set-recall charges the funnel for returning a
    different but equally-scored passage; score-recall doesn't."""
    k = min(k, oracle_scores.shape[1])  # tiny corpus: fewer than k passages
    kth = -np.sort(-oracle_scores, axis=1)[:, k - 1]  # (B,)
    idx = np.clip(got[:, :k], 0, oracle_scores.shape[1] - 1)
    got_scores = np.take_along_axis(oracle_scores, idx, axis=1)
    got_scores = np.where(got[:, :k] >= 0, got_scores, -np.inf)
    return float((got_scores >= kth[:, None] - eps).mean())
