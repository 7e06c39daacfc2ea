"""Query and passage text: queries of 4 to 19 filler words each, drawn
uniformly from the vocabulary's fillers (a frozen copy of
``chip_smoke.synthetic_queries``), and passages of filler words at a
length range of the cell's."""

from __future__ import annotations

import numpy as np


def synthetic_queries(rng: np.random.Generator, n: int, n_words: int) -> list[str]:
    lens = rng.integers(4, 20, n)
    return [" ".join(f"w{j}" for j in rng.integers(0, n_words, m)) for m in lens]


def query_pool(seed: int, n: int, n_words: int) -> list[str]:
    """``n`` queries drawn from ``seed`` (any integer, also past 32 bits)."""
    return synthetic_queries(np.random.default_rng([seed, 1]), n, n_words)


def passage_pool(seed: int, n: int, n_words: int, min_words: int, max_words: int) -> list[str]:
    """``n`` passages of ``min_words`` to ``max_words - 1`` filler words each
    (uniform), drawn from ``seed``."""
    rng = np.random.default_rng([seed, 5])
    lens = rng.integers(min_words, max_words, n)
    words = rng.integers(0, n_words, int(lens.sum()))
    cuts = np.concatenate([[0], np.cumsum(lens)])
    return [" ".join(f"w{j}" for j in words[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
