"""The synthetic WordPiece vocabulary (a frozen copy of
``colbert_torch.utils.testing.make_vocab``): the specials, a small word
list and fillers ``w0, w1, ...`` up to the published 30,522 entries."""

from __future__ import annotations

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[unused0]", "[unused1]"]
BASE_WORDS = [
    "the", "a", "of", "and", "to", "in", "is", "it", "dog", "cat", "bird",
    "fish", "runs", "jumps", "sleeps", "eats", "red", "blue", "green", "big",
    "small", "fast", "slow", "house", "tree", "river", "mountain", "city",
    "music", "science", "history", "cooking", "sports", "travel",
] + list("!,.?;:'\"()-")
N_FIXED = len(SPECIALS) + len(BASE_WORDS)


def make_vocab(vocab_size: int) -> dict[str, int]:
    """-> token -> id for a vocabulary of exactly ``vocab_size`` entries."""
    if vocab_size < N_FIXED:
        raise ValueError(f"a vocabulary needs at least {N_FIXED} entries")
    words = SPECIALS + BASE_WORDS + [f"w{i}" for i in range(vocab_size - N_FIXED)]
    return {w: i for i, w in enumerate(words)}


def filler_words(vocab_size: int) -> int:
    """How many ``w<i>`` fillers a vocabulary of ``vocab_size`` holds."""
    return vocab_size - N_FIXED
