"""Serve an index over HTTP with cross-request batching (counterpart of the
JAX package's ``examples/serve.py``).

Usage:
    python -m colbert_torch.examples.serve <index_dir> [--port 8080] [--checkpoint DIR]
    curl -XPOST localhost:8080/search -d '{"query": "...", "k": 5}'
    curl localhost:8080/health ; curl localhost:8080/stats

Concurrent clients share device dispatches through
:class:`colbert_torch.serving.batcher.BatchingSearcher`. Blocks until
interrupted. ``--device cpu`` serves from the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from colbert_torch.examples.searching import DEVICE_HELP
from colbert_torch.utils.build import resolve_device


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m colbert_torch.examples.serve")
    ap.add_argument("index_dir")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max-batch", type=int, default=128)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint dir (overrides the index config's)")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    device = resolve_device(args.device)

    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.serving.http import serve

    encoder = None
    if args.checkpoint:
        from colbert_torch.config import ColBERTConfig
        from colbert_torch.models.encoder import ColBERTEncoder
        from colbert_torch.models.hf_loader import load_checkpoint

        config = ColBERTConfig.load(os.path.join(args.index_dir, "config.json"))
        _, model, tokenizer = load_checkpoint(args.checkpoint, device=device)
        encoder = ColBERTEncoder(model, tokenizer, config, device=device)
    searcher = Searcher(args.index_dir, encoder=encoder, device=device)
    print(f"serving {args.index_dir} on http://{args.host}:{args.port}",
          file=sys.stderr)
    serve(searcher, args.host, args.port,
          max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)


if __name__ == "__main__":
    main()
