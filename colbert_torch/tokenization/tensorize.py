"""Doc/query tensorization: marker insertion, padding, [MASK] augmentation.

Reference semantics (SURVEY §2, L3):
  - docs (reference: src/modelling/tokenization/doc_tokenization.jl:143-156):
    ``[CLS] [D] t1 ... [SEP] [PAD]...`` — content truncated so the total
    length (incl. the ``[D]`` marker inserted at position 1) is at most
    ``doc_maxlen``; attention mask covers non-pad positions.
  - queries (reference: query_tokenization.jl:174-197): fixed length
    ``query_maxlen``, ``[CLS] [Q] t1 ... [SEP]`` then every ``[PAD]``
    replaced by ``[MASK]`` (query augmentation); the attention mask still
    covers only the pre-augmentation positions unless
    ``attend_to_mask_tokens``.

TPU-first deviation: instead of padding docs to the batch max (dynamic
shapes => one XLA recompile per distinct length), doc batches are padded up
to a *length bucket* (multiple of ``length_bucket``, capped at
``doc_maxlen``) so the jitted encoder sees a small closed set of shapes.
"""

from __future__ import annotations

import string
from typing import Sequence, Tuple

import numpy as np

from colbert_torch.tokenization.wordpiece import WordPieceTokenizer

__all__ = [
    "build_skiplist",
    "tensorize_docs",
    "tensorize_queries",
]


def build_skiplist(tokenizer: WordPieceTokenizer, mask_punctuation: bool = True) -> list[int]:
    """Punctuation + pad token ids to exclude from doc embeddings.

    Reference: src/indexing.jl:30-34 — ids of the 32 ASCII punctuation chars
    plus the pad symbol.
    """
    ids = {tokenizer.pad_id}
    if mask_punctuation:
        for ch in string.punctuation:
            tid = tokenizer.vocab.get(ch)
            if tid is not None:
                ids.add(tid)
    return sorted(ids)


def _bucket_len(max_len: int, bucket: int, cap: int, strict_multiple: bool = False) -> int:
    if strict_multiple:
        # every padded length is an exact multiple of ``bucket`` (pallas flash
        # attention requires seqlen % 128 == 0); the cap rounds UP so content
        # is still truncated at ``cap`` tokens, only padding extends past it.
        cap_b = -(-cap // bucket) * bucket
        return min(cap_b, -(-max_len // bucket) * bucket)
    b = min(cap, -(-max_len // bucket) * bucket)
    return max(b, bucket if cap >= bucket else cap)


def tensorize_docs(
    texts: Sequence[str],
    tokenizer: WordPieceTokenizer,
    *,
    doc_token_id: int,
    doc_maxlen: int,
    length_bucket: int = 64,
    encoded: Sequence[Sequence[int]] | None = None,
    strict_multiple: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize passages -> (ids (N, L), mask (N, L)) int32/bool, L bucketed.

    ``ids[:, 0] == [CLS]``, ``ids[:, 1] == [D]`` (marker inserted after CLS,
    reference: tokenizer_utils.jl:140-143 ``_add_marker_row``). Pass
    ``encoded`` (pre-tokenized content ids) to skip re-tokenization.
    """
    if encoded is None:
        encoded = tokenizer.encode_batch(texts)
    content_budget = doc_maxlen - 3  # [CLS] [D] ... [SEP]
    rows = []
    for toks in encoded:
        toks = toks[:content_budget]
        rows.append([tokenizer.cls_id, doc_token_id] + toks + [tokenizer.sep_id])
    max_len = max(len(r) for r in rows) if rows else 3
    L = _bucket_len(max_len, length_bucket, doc_maxlen, strict_multiple)
    ids = np.full((len(rows), L), tokenizer.pad_id, dtype=np.int32)
    mask = np.zeros((len(rows), L), dtype=bool)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = True
    return ids, mask


def tensorize_queries(
    texts: Sequence[str],
    tokenizer: WordPieceTokenizer,
    *,
    query_token_id: int,
    query_maxlen: int,
    attend_to_mask_tokens: bool = False,
    encoded: Tuple[np.ndarray, np.ndarray] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize queries -> (ids (N, query_maxlen), mask) with [MASK] padding.

    Reference: query_tokenization.jl:174-197 — fixed length, ``[Q]`` marker at
    position 1, every pad replaced by ``[MASK]``. ``encoded`` = (token ids
    (N, W >= query_maxlen - 3), token counts (N,)), as
    :meth:`NativeWordPiece.encode_array` gives them (row i starts with text
    i's first tokens), skips the Python tokenizer; either way the rows are
    filled without a loop over tokens.
    """
    budget = query_maxlen - 3
    if encoded is None:
        toks = tokenizer.encode_batch(texts)
        lens = np.array([len(t) for t in toks], dtype=np.int64)
        tok_ids = np.zeros((len(toks), budget), dtype=np.int32)
        for i, t in enumerate(toks):
            tok_ids[i, : min(len(t), budget)] = t[:budget]
    else:
        tok_ids, lens = encoded
    n = len(lens)
    kept = np.minimum(lens, budget)
    ids = np.full((n, query_maxlen), tokenizer.mask_id, dtype=np.int32)
    ids[:, 0] = tokenizer.cls_id
    ids[:, 1] = query_token_id
    np.copyto(ids[:, 2:-1], tok_ids[:, :budget], where=np.arange(budget) < kept[:, None])
    ids[np.arange(n), kept + 2] = tokenizer.sep_id
    if attend_to_mask_tokens:
        return ids, np.ones((n, query_maxlen), dtype=bool)
    return ids, np.arange(query_maxlen) < (kept + 3)[:, None]
