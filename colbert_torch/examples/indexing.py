"""Build an index over a TSV collection (counterpart of the JAX package's
``examples/indexing.py``).

Usage:
    python -m colbert_torch.examples.indexing <checkpoint_dir> <collection.tsv> <index_dir>

``checkpoint_dir`` is an HF ColBERT checkpoint (``colbert-ir/colbertv2.0``,
or one written by ``colbert_torch.utils.testing.write_bench_checkpoint``).
Without one, pass ``--random-weights`` to run the whole pipeline with the
seeded random bert-base bench model; such an index stores no checkpoint,
so search it with ``--random-weights`` too. ``--device cpu`` runs on the
CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys

from colbert_torch.config import ColBERTConfig
from colbert_torch.examples.searching import DEVICE_HELP
from colbert_torch.indexing.builder import Indexer
from colbert_torch.models.encoder import ColBERTEncoder
from colbert_torch.utils.build import resolve_device


def main(argv: list[str] | None = None) -> str:
    """-> the index directory."""
    ap = argparse.ArgumentParser(prog="python -m colbert_torch.examples.indexing")
    ap.add_argument("checkpoint")
    ap.add_argument("collection")
    ap.add_argument("index_dir")
    ap.add_argument("--nbits", type=int, default=2)
    ap.add_argument("--doc-maxlen", type=int, default=300)
    ap.add_argument("--random-weights", action="store_true",
                    help="use a deterministic random bert-base model instead of "
                         "loading the checkpoint (no checkpoint required; "
                         "its synthetic vocab is word00000-style tokens, so "
                         "natural-language text tokenizes to [UNK])")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    device = resolve_device(args.device)

    config = ColBERTConfig(
        checkpoint=args.checkpoint,
        collection=args.collection,
        index_path=args.index_dir,
        nbits=args.nbits,
        doc_maxlen=args.doc_maxlen,
    )
    encoder = None
    if args.random_weights:
        from colbert_torch.utils.testing import make_bench_encoder

        bench_enc, _ = make_bench_encoder(device=device)
        encoder = ColBERTEncoder(bench_enc.model, bench_enc.tokenizer, config, device=device)
    path = Indexer(config, encoder=encoder, device=device).index()
    print(f"index built at {path}")
    return path


if __name__ == "__main__":
    main()
