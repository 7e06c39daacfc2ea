"""Helpers of the attention readers (not a metric: the registry skips
files whose name starts with ``_``): the true lengths of the passages a
build encodes, and a kernel family's share of the roofline of the work
that the configuration's architecture counts for them."""

from __future__ import annotations

import numpy as np

from benchmark import harness, roofline
from benchmark.gen.queries import passage_pool
from benchmark.gen.vocab import filler_words, make_vocab
from benchmark.reference.codec import sample_pids
from benchmark.reference.tokenize import tensorize_docs


def encoded_lengths(r) -> np.ndarray:
    """True token counts of every passage one build of run ``r`` encodes:
    the codec's sample, then every passage again unless the sample is the
    whole collection (as the build driver counts the encoder's FLOPs)."""
    if not hasattr(r, "_attn_lengths"):
        c, cfg = r.cell, r.config
        n_vocab = r.arch.vocab_size(r.widths)
        passages = passage_pool(r.seed, cfg["collection_passages"], filler_words(n_vocab),
                                c["min_words"], c["max_words"])
        vocab = make_vocab(n_vocab)
        lens = np.concatenate([tensorize_docs(passages[s:s + 256], vocab, cfg["doc_maxlen"])[1]
                               .sum(axis=1) for s in range(0, len(passages), 256)])
        pids = sample_pids(len(passages), np.random.default_rng(0))
        r._attn_lengths = (lens[pids] if len(pids) == len(passages)
                           else np.concatenate([lens[pids], lens]))
    return r._attn_lengths


def is_window(name: str) -> bool:
    return "flash_mma_window_kernel" in name


def is_global(name: str) -> bool:
    return "flash_mma_kernel" in name


def share(r, name: str, kind: str, match) -> float | None:
    """Roofline share of the traced device operations ``match`` accepts,
    for the ``kind`` (``"local"`` or ``"global"``) attention work of every
    build of the window; notes under ``name`` what bound it. None where the
    architecture counts no attention work or no such operation ran."""
    t = r.device_trace
    work = getattr(r.arch, "attention_work", None)
    builds = r.counters.get("builds", 0)
    if t is None or work is None or not builds:
        return None
    seconds, launches = harness.kernel_seconds(t, match)
    if not launches:
        return None
    flops, nbytes = work(r.widths, encoded_lengths(r))[kind]
    got = roofline.share(flops * builds, nbytes * builds, seconds, r.card["name"])
    if got is None:
        return None
    r.notes[name] = f"bound by {got[1]}; {launches} launches, {seconds:.4f} s"
    return got[0]
