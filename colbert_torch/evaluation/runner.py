"""Dataset eval runners: MS MARCO / LoTTe / BEIR-style file formats (a copy
of ``colbert_tpu.evaluation.runner``, numpy only apart from the searcher it
is given).

File conventions (the public formats these corpora ship in):
  - collection: TSV ``pid \\t passage`` (MS MARCO / LoTTe)
  - queries:    TSV ``qid \\t query``
  - qrels:      TSV ``qid \\t 0 \\t pid \\t relevance`` (TREC) or
                JSONL ``{"qid": ..., "answer_pids": [...]}`` (LoTTe)

Runners take a built index's searcher, run batched search, and report the
metric suite. The tests cover the runners with synthetic corpora; with real
data these are the MS MARCO MRR@10 / LoTTe Success@5 entry points.
"""

from __future__ import annotations

import json
import time
from typing import Sequence

import numpy as np

from colbert_torch.evaluation.metrics import mrr_at_k, ndcg_at_k, success_at_k

__all__ = ["load_queries_tsv", "load_qrels_trec", "load_qrels_lotte", "evaluate"]


def load_queries_tsv(path: str) -> tuple[list[str], list[str]]:
    qids, texts = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            qid, text = line.split("\t", 1)
            qids.append(qid)
            texts.append(text)
    return qids, texts


def load_qrels_trec(path: str) -> dict[str, set[int]]:
    rel: dict[str, set[int]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            qid, _, pid, grade = parts[:4]
            if float(grade) > 0:
                rel.setdefault(qid, set()).add(int(pid))
    return rel


def load_qrels_lotte(path: str) -> dict[str, set[int]]:
    rel: dict[str, set[int]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            d = json.loads(line)
            rel[str(d["qid"])] = set(int(p) for p in d["answer_pids"])
    return rel


def evaluate(
    searcher,
    queries: Sequence[str],
    qids: Sequence[str],
    qrels: dict[str, set[int]],
    *,
    k: int = 10,
    batch_size: int = 32,
) -> dict:
    """Batched retrieval over the query set -> metric dict + latency stats."""
    rankings: list[list[int]] = []
    latencies = []
    for start in range(0, len(queries), batch_size):
        batch = list(queries[start : start + batch_size])
        t = time.time()
        pids, _ = searcher.search_batch(batch, k=k)
        latencies.append((time.time() - t) / len(batch))
        rankings.extend([[int(p) for p in row if p >= 0] for row in pids])
    relevant = [qrels.get(q, set()) for q in qids]
    graded = [{p: 1.0 for p in rel} for rel in relevant]
    lat = np.asarray(latencies)
    return {
        "num_queries": len(queries),
        "mrr@10": mrr_at_k(rankings, relevant, k=min(10, k)),
        "success@5": success_at_k(rankings, relevant, k=min(5, k)),
        "ndcg@10": ndcg_at_k(rankings, graded, k=min(10, k)),
        "mean_latency_s": float(lat.mean()) if len(lat) else 0.0,
        "qps": float(1.0 / lat.mean()) if len(lat) and lat.mean() > 0 else 0.0,
    }
