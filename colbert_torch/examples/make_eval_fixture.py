"""Write a synthetic MS-MARCO-shaped eval fixture (TREC format); the
counterpart of the JAX package's ``examples/make_eval_fixture.py``, whose
files it writes byte for byte.

It writes ``collection.tsv``, ``queries.tsv`` and TREC ``qrels.txt`` over
the bench corpus (each query is a prefix of a passage; that passage is the
relevant document), so the whole real-data pipeline runs through the
entry points on the card:

    python -m colbert_torch.examples.make_eval_fixture /tmp/fx --n 141431 --queries 64
    python -m colbert_torch.examples.indexing none /tmp/fx/collection.tsv /tmp/fx/idx --random-weights
    python -m colbert_torch.examples.evaluate /tmp/fx/idx /tmp/fx/queries.tsv /tmp/fx/qrels.txt --random-weights

With a real checkpoint and MS MARCO, the same three commands without the
random-weights flag (and with the real files) give the quality number.
``--device cpu`` is accepted by every entry point for machines without a
GPU.
"""

from __future__ import annotations

import argparse
import os

from colbert_torch.examples.searching import DEVICE_HELP
from colbert_torch.utils.build import resolve_device


def main(argv: list[str] | None = None) -> str:
    """-> the fixture directory."""
    ap = argparse.ArgumentParser(prog="python -m colbert_torch.examples.make_eval_fixture")
    ap.add_argument("out_dir")
    ap.add_argument("--n", type=int, default=141_431,
                    help="collection size (bench topical corpus)")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--prefix-chars", type=int, default=200,
                    help="query = this many chars of its source passage")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    from colbert_torch.utils.testing import synthetic_passages

    os.makedirs(args.out_dir, exist_ok=True)
    passages = synthetic_passages(args.n)
    with open(os.path.join(args.out_dir, "collection.tsv"), "w") as f:
        for pid, text in enumerate(passages):
            f.write(f"{pid}\t{text}\n")

    # queries over a pid spread; ground truth = the source passage
    probe = list(range(0, args.n, max(1, args.n // args.queries)))
    probe = probe[: args.queries]
    with open(os.path.join(args.out_dir, "queries.tsv"), "w") as f:
        for qid, pid in enumerate(probe):
            f.write(f"q{qid}\t{passages[pid][: args.prefix_chars]}\n")
    with open(os.path.join(args.out_dir, "qrels.txt"), "w") as f:
        for qid, pid in enumerate(probe):
            f.write(f"q{qid} 0 {pid} 1\n")
    print(f"fixture at {args.out_dir}: {args.n} passages, "
          f"{len(probe)} queries (TREC qrels)")
    return args.out_dir


if __name__ == "__main__":
    main()
