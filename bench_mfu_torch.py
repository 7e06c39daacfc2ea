"""The bf16 encoder forward's model FLOP/s over batch size, on one NVIDIA GPU
(the counterpart of ``bench_mfu.py``).

    python bench_mfu_torch.py [S] [--device cuda|cpu] [--bert base|narrow]

Times ``ColBERT.encode_batch`` (the build's doc forward, bert-base at bf16
from ``make_bench_encoder``) at B in {128, 256, 512, 1024} and padded
length S (default 128), on one batch of random token ids already on the
device run about 524k tokens' worth of times: a warm pass, then the best
of 2 timed passes, each between two ``torch.cuda.synchronize()`` calls.
The FLOP count and the card's bf16 peak are ``bench_torch``'s. Prints one
stderr line per B, with ``torch.cuda.max_memory_allocated()`` since a
reset before that B, and as the last stdout line
``{"metric": "encode_mfu_sweep", "seqlen", "unit", "value"}``, ``value``
keyed by B: the MFU in percent, or null on a card without a peak on record.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from bench_torch import batch_flops, card, log, mfu_fields, mfu_text, narrow_bert_config, sync
from colbert_torch.utils.build import resolve_device
from colbert_torch.utils.testing import bench_bert_config, make_bench_encoder

BATCHES = (128, 256, 512, 1024)
TOKENS_PER_PASS = 1 << 19


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seqlen", nargs="?", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bert", choices=("base", "narrow"), default="base")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    S = args.seqlen
    bert = bench_bert_config() if args.bert == "base" else narrow_bert_config()
    encoder, cfg = make_bench_encoder(device=device, bert_config=bert)
    dev = card(device)
    log(f"[mfu] BERT {bert}, {cfg.activation_dtype}, S={S}, on {dev['smi']}")
    rng = np.random.default_rng(0)
    results = {}
    for B in BATCHES:
        n_batches = max(2, TOKENS_PER_PASS // (B * S))
        ids = rng.integers(1000, 2000, size=(B, S), dtype=np.int32)
        ids[:, 0] = 101  # [CLS]
        mask = np.ones((B, S), dtype=bool)
        ids_d, mask_d, keep_d = encoder._put_batch(ids, mask, mask)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        def run() -> float:
            sync(device)
            t0 = time.perf_counter()
            with torch.inference_mode():
                for _ in range(n_batches):
                    encoder.model.encode_batch(ids_d, mask_d, keep_d,
                                               dtype_name=cfg.activation_dtype)
            sync(device)
            return time.perf_counter() - t0

        run()
        best = min(run() for _ in range(2))
        tokens = n_batches * B * S
        flops = batch_flops(bert, encoder.dim, [(B, S)] * n_batches)
        m = mfu_fields(flops, best, dev)
        peak_mem = (torch.cuda.max_memory_allocated(device) / 2**30
                    if device.type == "cuda" else None)
        results[B] = None if m["mfu"] is None else round(m["mfu"] * 100, 2)
        mem = "n/a on the CPU" if peak_mem is None else f"{peak_mem:.2f} GiB"
        log(f"B={B:5d} S={S}: {tokens / best / 1e3:8.0f}k tokens/s, "
            f"{flops / tokens / 1e9:.4f} GFLOP per token: {mfu_text(m)}; "
            f"peak allocated {mem} ({n_batches} batches, best of 2)")
    print(json.dumps({"metric": "encode_mfu_sweep", "seqlen": S,
                      "unit": "% MFU by batch size", "value": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
