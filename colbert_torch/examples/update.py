"""Incrementally update an existing index: add, remove, compact; the
counterpart of the JAX package's ``examples/update.py``.

Usage:
    python -m colbert_torch.examples.update <index_dir> add "new passage one" "two" ...
    python -m colbert_torch.examples.update <index_dir> remove 17 42
    python -m colbert_torch.examples.update <index_dir> compact
    # pass --checkpoint DIR if the index's config points elsewhere,
    # --device cpu without a GPU

Open searchers keep their snapshot; serving fronts can switch with
``BatchingSearcher.swap(Searcher(index_dir))``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from colbert_torch.config import ColBERTConfig
from colbert_torch.examples.searching import DEVICE_HELP
from colbert_torch.indexing.updater import IndexUpdater
from colbert_torch.models.encoder import ColBERTEncoder
from colbert_torch.models.hf_loader import load_checkpoint
from colbert_torch.utils.build import resolve_device


def main(argv: list[str] | None = None) -> np.ndarray:
    """-> the added pids (add), the removed pids (remove) or the pid map
    old -> new, -1 for dropped (compact)."""
    ap = argparse.ArgumentParser(prog="python -m colbert_torch.examples.update")
    ap.add_argument("index_dir")
    ap.add_argument("action", choices=["add", "remove", "compact"])
    ap.add_argument("items", nargs="*",
                    help="passages for add, pids for remove")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint dir (overrides the index config's)")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    device = resolve_device(args.device)

    config = ColBERTConfig.load(os.path.join(args.index_dir, "config.json"))
    _, model, tokenizer = load_checkpoint(args.checkpoint or config.checkpoint, device=device)
    encoder = ColBERTEncoder(model, tokenizer, config, device=device)
    updater = IndexUpdater(args.index_dir, encoder)

    if args.action == "add":
        pids = updater.add(list(args.items))
        print(f"added pids {pids.tolist()}", file=sys.stderr)
        return pids
    if args.action == "remove":
        pids = np.asarray([int(p) for p in args.items], np.int64)
        updater.remove(pids)
        print(f"removed {args.items}", file=sys.stderr)
        return pids
    pid_map = updater.compact()
    kept = int((pid_map >= 0).sum())
    print(f"compacted: {kept} pids remain", file=sys.stderr)
    return pid_map


if __name__ == "__main__":
    main()
