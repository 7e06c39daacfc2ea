"""Deterministic test and smoke fixtures (port of ``colbert_tpu.utils.testing``).

A tiny vocab, synthetic passages, a random-weight encoder seeded from a
``torch.Generator``, and ``synthesize_index``, which writes a complete,
loadable index with random but mutually consistent codec, chunks, IVF and
plan, without any encoder (its random draws are numpy's, so the same seed
writes the same index as the JAX package's function), and the long-document
corpus of the build smoke run (``bench_vocab_tokenizer``,
``synthetic_passages``: copies of ``bench.py``'s helpers).
"""

from __future__ import annotations

import numpy as np
import torch

from colbert_torch.config import ColBERTConfig
from colbert_torch.models.bert import BertConfig
from colbert_torch.models.colbert import init_colbert
from colbert_torch.models.encoder import ColBERTEncoder
from colbert_torch.tokenization.wordpiece import WordPieceTokenizer

__all__ = ["make_vocab", "make_encoder", "synthetic_collection", "synthesize_index",
           "bench_vocab_tokenizer", "synthetic_passages"]

_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[unused0]", "[unused1]"]
_BASE_WORDS = [
    "the", "a", "of", "and", "to", "in", "is", "it", "dog", "cat", "bird",
    "fish", "runs", "jumps", "sleeps", "eats", "red", "blue", "green", "big",
    "small", "fast", "slow", "house", "tree", "river", "mountain", "city",
    "music", "science", "history", "cooking", "sports", "travel",
] + list("!,.?;:'\"()-")


def make_vocab(extra_words: int = 64) -> dict[str, int]:
    """Specials, a small word list and ``extra_words`` fillers ``w0, w1, ...``
    (``make_vocab(30522 - 52)`` gives a bert-base-sized vocab)."""
    words = _SPECIALS + _BASE_WORDS + [f"w{i}" for i in range(extra_words)]
    return {w: i for i, w in enumerate(words)}


def make_encoder(
    *,
    dim: int = 32,
    seed: int = 0,
    config: ColBERTConfig | None = None,
    bert_config: BertConfig | None = None,
    vocab: dict[str, int] | None = None,
    device: str | torch.device = "cuda",
) -> ColBERTEncoder:
    """A ColBERT encoder with random weights drawn from
    ``torch.Generator().manual_seed(seed)`` (the JAX package's init scheme,
    not its numbers)."""
    vocab = vocab or make_vocab()
    tokenizer = WordPieceTokenizer(vocab)
    bert_cfg = bert_config or BertConfig(
        vocab_size=len(vocab),
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        max_position_embeddings=512,
    )
    cfg = config or ColBERTConfig(dim=dim, doc_maxlen=64, query_maxlen=16,
                                  index_bsize=8, length_bucket=16)
    model = init_colbert(bert_cfg, dim, generator=torch.Generator().manual_seed(seed))
    return ColBERTEncoder(model, tokenizer, cfg, device=device)


def synthesize_index(
    path: str,
    n_passages: int,
    *,
    dim: int = 128,
    nbits: int = 2,
    avg_doclen: int = 110,
    chunksize: int = 25_000,
    num_partitions: int | None = None,
    seed: int = 0,
    code_locality: bool = True,
) -> dict:
    """Write a complete index to ``path`` and return its plan.

    ``code_locality`` draws each passage's codes near a per-passage base
    cell (real indexes cluster a passage's tokens into few cells); False
    gives uniform codes."""
    from colbert_torch.indexing.ivf import build_ivf
    from colbert_torch.indexing.planner import setup_plan
    from colbert_torch.storage import format as fmt

    rng = np.random.default_rng(seed)
    plan = setup_plan(n_passages, float(avg_doclen), 10**9, chunksize, 1)
    if num_partitions is not None:
        plan["num_partitions"] = int(num_partitions)
    k = plan["num_partitions"]
    nbytes = dim // 8 * nbits

    ColBERTConfig(dim=dim, nbits=nbits).save(f"{path}/config.json")
    centroids = rng.normal(size=(k, dim)).astype(np.float32)
    centroids /= np.linalg.norm(centroids, axis=1, keepdims=True)
    q = 2**nbits
    cutoffs = np.linspace(-0.02, 0.02, q - 1).astype(np.float32)
    weights = np.linspace(-0.025, 0.025, q).astype(np.float32)
    fmt.save_codec(path, centroids, cutoffs, weights, 0.02)

    all_codes = []
    offsets = []
    total = 0
    for ci in range(plan["num_chunks"]):
        lo = ci * chunksize
        n_chunk = min(chunksize, n_passages - lo)
        doclens = rng.integers(
            max(8, avg_doclen - 30), avg_doclen + 30, size=n_chunk
        ).astype(np.int32)
        rows = int(doclens.sum())
        if code_locality:
            base = rng.integers(0, k, size=n_chunk)
            codes = (np.repeat(base, doclens) + rng.integers(0, 32, size=rows)) % k
        else:
            codes = rng.integers(0, k, size=rows)
        codes = codes.astype(np.uint32)
        residuals = rng.integers(0, 256, size=(rows, nbytes), dtype=np.uint8)
        fmt.save_chunk(path, ci, codes=codes, residuals=residuals,
                       doclens=doclens, passage_offset=lo)
        all_codes.append(codes)
        offsets.append(total)
        total += rows
    plan["num_embeddings"] = total
    plan["embedding_offsets"] = offsets
    fmt.save_plan(path, plan)

    ivf, ivf_lengths = build_ivf(np.concatenate(all_codes), k)
    fmt.save_ivf(path, ivf, ivf_lengths)
    return plan


def synthetic_collection(n: int, seed: int = 0, words_per_doc: int = 12) -> list[str]:
    """Deterministic pseudo-text passages over the tiny vocab's word list."""
    rng = np.random.default_rng(seed)
    words = _BASE_WORDS[: len(_BASE_WORDS) - 11]  # drop punctuation-only tail
    docs = []
    for _ in range(n):
        k = rng.integers(max(3, words_per_doc // 2), words_per_doc + 1)
        docs.append(" ".join(rng.choice(words, size=k)))
    return docs


# -- the long-document corpus of the build smoke run (copies of bench.py's
# corpus helpers; the strings they produce are identical) --

N_TOPICS = 64
TOPIC_VOCAB = 60  # words per topic (overlapping windows over the word list)


def bench_vocab_tokenizer(n_words: int = 2000) -> WordPieceTokenizer:
    """Specials, ``n_words`` words ``word00000, word00001, ...`` and the
    punctuation: every corpus word is one token."""
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[unused0]", "[unused1]"]
    words = [f"word{i:05d}" for i in range(n_words)]
    vocab = {t: i for i, t in enumerate(specials + words + list("!,.?;:'\"()-"))}
    return WordPieceTokenizer(vocab)


def _topic_words(topic: int, n_words: int, n_topics: int = N_TOPICS) -> np.ndarray:
    if n_topics <= N_TOPICS:
        # overlapping sliding windows: adjacent topics share most words
        start = (topic * (n_words - TOPIC_VOCAB)) // max(1, n_topics - 1)
        return np.arange(start, start + TOPIC_VOCAB)
    # many topics: random per-topic word sets keep topics distinct
    return np.random.default_rng(100_000 + topic).choice(
        n_words, size=TOPIC_VOCAB, replace=False
    )


def synthetic_passages(n: int, mean_words: int = 110, n_words: int = 2000,
                       n_topics: int = N_TOPICS, seed: int = 7) -> list[str]:
    """Topical corpus: each passage draws ~60% of its words from one of
    ``n_topics`` vocabulary subsets and the rest from the whole vocabulary,
    ``mean_words`` +- 30 words per passage, drawn from ``seed`` (bench.py's
    corpus at the default)."""
    rng = np.random.default_rng(seed)
    topics = [_topic_words(t, n_words, n_topics) for t in range(n_topics)]
    names = [f"word{i:05d}" for i in range(n_words)]
    out = []
    for i in range(n):
        words = topics[i % n_topics]
        k = int(rng.integers(mean_words - 30, mean_words + 30))
        k_topic = int(k * 0.6)
        ids = np.concatenate([
            rng.choice(words, size=k_topic),
            rng.integers(0, n_words, k - k_topic),
        ])
        rng.shuffle(ids)
        out.append(" ".join([names[j] for j in ids.tolist()]))
    return out
