"""Run a retrieval-quality eval over an index (MS MARCO / LoTTe formats);
the counterpart of the JAX package's ``examples/evaluate.py``.

Usage:
    python -m colbert_torch.examples.evaluate <index_dir> <queries.tsv> <qrels> [--lotte]

``qrels`` is TREC format (``qid 0 pid rel``) by default, or LoTTe JSONL
(``{"qid":..., "answer_pids":[...]}``) with ``--lotte``. Reports MRR@10,
Success@5, nDCG@10 and QPS as one JSON object. ``--random-weights`` for an
index built with it; ``--device cpu`` without a GPU.
"""

from __future__ import annotations

import argparse
import json

from colbert_torch.evaluation.runner import (
    evaluate,
    load_qrels_lotte,
    load_qrels_trec,
    load_queries_tsv,
)
from colbert_torch.examples.searching import DEVICE_HELP, make_searcher
from colbert_torch.utils.build import resolve_device


def main(argv: list[str] | None = None) -> dict:
    """-> the report (``evaluation.runner.evaluate``'s metric dict)."""
    ap = argparse.ArgumentParser(prog="python -m colbert_torch.examples.evaluate")
    ap.add_argument("index_dir")
    ap.add_argument("queries")
    ap.add_argument("qrels")
    ap.add_argument("--lotte", action="store_true")
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--random-weights", action="store_true",
                    help="use the deterministic random-weight bench encoder "
                         "(for indexes built with indexing --random-weights)")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    searcher = make_searcher(args.index_dir, args.random_weights, device)
    qids, queries = load_queries_tsv(args.queries)
    qrels = (load_qrels_lotte if args.lotte else load_qrels_trec)(args.qrels)
    report = evaluate(searcher, queries, qids, qrels, k=args.k,
                      batch_size=args.batch_size)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
