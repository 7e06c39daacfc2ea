"""Auto-tune the serving funnel's knobs for an index (counterpart of the JAX
package's ``examples/tune.py``).

Usage:
    python -m colbert_torch.examples.tune <index_dir> <queries.tsv> [--k 10]
        [--target 0.98] [--apply-to config] [--device cuda]

Sweeps operating points (stage-2 doc budget x stage-1 refine x extra
probes) through the serving path, measures tie-aware score-recall@k
against the exact-codec oracle, and prints the table with the cheapest
qualifying point marked. With ``--apply-to config`` the chosen knobs are
written back into the index's config.json, so every later
``Searcher(index_dir)`` serves at the tuned point.
"""

from __future__ import annotations

import argparse
import os

from colbert_torch.evaluation.autotune import TuneResult, tune_operating_point
from colbert_torch.evaluation.runner import load_queries_tsv
from colbert_torch.examples.searching import DEVICE_HELP
from colbert_torch.retrieval.searcher import Searcher
from colbert_torch.utils.build import resolve_device


def main(argv: list[str] | None = None) -> TuneResult:
    """-> the tune result (table and chosen point)."""
    ap = argparse.ArgumentParser(prog="python -m colbert_torch.examples.tune")
    ap.add_argument("index_dir")
    ap.add_argument("queries_tsv", help="qid\\tquery text, one per line")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--target", type=float, default=0.98,
                    help="target score-recall@k")
    ap.add_argument("--sample", type=int, default=32,
                    help="queries sampled for the oracle sweep")
    ap.add_argument("--balance-caps", default=None,
                    help="comma-separated ivf_balance_cap values to sweep "
                         "in-process (e.g. '1024,2048,4096'; 0 = no "
                         "splitting) — the build-side quality lever")
    ap.add_argument("--depth-k", type=int, default=None,
                    help="also require score-recall at this depth (e.g. 100)")
    ap.add_argument("--target-depth", type=float, default=None,
                    help="score-recall target at --depth-k (defaults to "
                         "--target)")
    ap.add_argument("--apply-to", choices=["config"], default=None,
                    help="'config': persist the chosen knobs to config.json")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    caps = None
    if args.balance_caps:
        caps = tuple(int(c) for c in args.balance_caps.split(","))
    _, queries = load_queries_tsv(args.queries_tsv)
    queries = queries[: args.sample]
    searcher = Searcher(args.index_dir, device=device)
    result = tune_operating_point(
        searcher, queries, k=args.k, target_score_recall=args.target,
        balance_caps=caps, depth_k=args.depth_k,
        target_depth_recall=args.target_depth,
    )
    print(result)
    if args.apply_to == "config":
        result.apply(searcher)
        searcher.config.save(os.path.join(args.index_dir, "config.json"))
        print(f"applied {result.chosen.point.label()} to "
              f"{args.index_dir}/config.json")
    return result


if __name__ == "__main__":
    main()
