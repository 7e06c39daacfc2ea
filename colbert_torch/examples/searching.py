"""Query an index (counterpart of the JAX package's ``examples/searching.py``).

Usage:
    python -m colbert_torch.examples.searching <index_dir> "your query" [-k 5]
    python -m colbert_torch.examples.searching <index_dir> --interactive
    # --random-weights for an index built with it; --device cpu without a GPU
"""

from __future__ import annotations

import argparse

import torch

from colbert_torch.retrieval.searcher import Searcher
from colbert_torch.utils.build import resolve_device

DEVICE_HELP = "cuda (the default; needs a GPU) or cpu"


def make_searcher(index_dir: str, random_weights: bool,
                  device: str | torch.device = "cuda") -> Searcher:
    """Searcher for the index; ``random_weights`` injects the seeded bench
    encoder (an index built with ``--random-weights`` stores no checkpoint,
    so it must be searched with that encoder too)."""
    if random_weights:
        from colbert_torch.utils.testing import make_bench_encoder

        encoder, _ = make_bench_encoder(device=device)
        return Searcher(index_dir, encoder=encoder, device=device)
    return Searcher(index_dir, device=device)


def main(argv: list[str] | None = None) -> list[tuple]:
    """-> (pids, scores) of each query run, in order."""
    ap = argparse.ArgumentParser(prog="python -m colbert_torch.examples.searching")
    ap.add_argument("index_dir")
    ap.add_argument("query", nargs="?")
    ap.add_argument("-k", type=int, default=5)
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--random-weights", action="store_true",
                    help="use the deterministic random-weight bench encoder "
                         "(for indexes built with indexing --random-weights)")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    if not args.interactive and not args.query:
        ap.error("query required unless --interactive")
    device = resolve_device(args.device)

    searcher = make_searcher(args.index_dir, args.random_weights, device)
    results = []

    def run(q: str) -> None:
        pids, scores = searcher.search(q, k=args.k)
        for rank, (pid, score) in enumerate(zip(pids, scores), 1):
            if pid < 0:
                break
            print(f"{rank:2d}. pid={pid} score={score:.4f}")
        results.append((pids, scores))

    if args.interactive:
        while True:
            try:
                q = input("query> ").strip()
            except EOFError:
                break
            if q:
                run(q)
    else:
        run(args.query)
    return results


if __name__ == "__main__":
    main()
