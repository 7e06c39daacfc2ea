"""Fine-tune a ColBERT checkpoint on (query, positive, negative) triples;
the counterpart of the JAX package's ``examples/train.py``.

Usage:
    python -m colbert_torch.examples.train <checkpoint_dir> <triples.tsv> <out_checkpoint> \
        [--batch-size 32] [--epochs 1] [--lr 3e-5] [--pairwise] [--device cuda]

``triples.tsv``: one ``query\\tpositive\\tnegative`` per line (the standard
MS MARCO triples format). The fine-tuned weights are written as an
HF-compatible checkpoint directory that ``Indexer``/``Searcher`` of either
package load.
"""

from __future__ import annotations

import argparse
import logging
import sys

from colbert_torch.examples.searching import DEVICE_HELP
from colbert_torch.utils.build import resolve_device


def read_triples(path: str) -> list[tuple[str, str, str]]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3:
                out.append((parts[0], parts[1], parts[2]))
    return out


def main(argv: list[str] | None = None) -> str:
    """-> the fine-tuned checkpoint's directory."""
    ap = argparse.ArgumentParser(prog="python -m colbert_torch.examples.train")
    ap.add_argument("checkpoint")
    ap.add_argument("triples")
    ap.add_argument("out_checkpoint")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-5)
    ap.add_argument("--pairwise", action="store_true",
                    help="plain (pos, neg) CE instead of in-batch negatives")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    device = resolve_device(args.device)

    from colbert_torch.config import ColBERTConfig
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.models.hf_loader import load_checkpoint
    from colbert_torch.training import ColBERTTrainer

    _, model, tokenizer = load_checkpoint(args.checkpoint, device=device)
    encoder = ColBERTEncoder(model, tokenizer, ColBERTConfig(), device=device)
    trainer = ColBERTTrainer(
        encoder, learning_rate=args.lr,
        in_batch_negatives=not args.pairwise,
    )
    triples = read_triples(args.triples)
    print(f"{len(triples)} triples", file=sys.stderr)
    for epoch in range(args.epochs):
        metrics = trainer.train(triples, batch_size=args.batch_size,
                                epochs=1, seed=epoch)
        last = metrics[-1] if metrics else {}
        print(f"epoch {epoch}: steps={len(metrics)} "
              f"loss={last.get('loss', float('nan')):.4f} "
              f"acc={last.get('pairwise_acc', float('nan')):.3f}",
              file=sys.stderr)
    trainer.save_checkpoint(args.out_checkpoint)
    print(f"saved fine-tuned checkpoint to {args.out_checkpoint}", file=sys.stderr)
    return args.out_checkpoint


if __name__ == "__main__":
    main()
