"""Plain BERT tokenization of query text (lower-cased, split on whitespace
and punctuation, greedy longest-match WordPiece with ``##`` continuations)
and ColBERT's query tensorization: ``[CLS] [Q] tokens [SEP]``, content cut
at ``query_maxlen - 3``, the rest ``[MASK]``; the attention mask covers the
positions before the augmentation."""

from __future__ import annotations

import string

import numpy as np


def basic_split(text: str) -> list[str]:
    out, word = [], []
    for ch in text.lower():
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif ch in string.punctuation:
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


def wordpiece(word: str, vocab: dict[str, int]) -> list[int]:
    ids, start = [], 0
    while start < len(word):
        end = len(word)
        while end > start:
            piece = word[start:end] if start == 0 else "##" + word[start:end]
            if piece in vocab:
                ids.append(vocab[piece])
                break
            end -= 1
        if end == start:
            return [vocab["[UNK]"]]
        start = end
    return ids


def tensorize_queries(texts: list[str], vocab: dict[str, int], query_maxlen: int,
                      query_marker: str = "[unused0]") -> tuple[np.ndarray, np.ndarray]:
    """-> (ids (N, query_maxlen) int64, attention mask (N, query_maxlen) bool)."""
    ids = np.full((len(texts), query_maxlen), vocab["[MASK]"], np.int64)
    mask = np.zeros((len(texts), query_maxlen), bool)
    for i, text in enumerate(texts):
        toks = [t for w in basic_split(text) for t in wordpiece(w, vocab)]
        row = [vocab["[CLS]"], vocab[query_marker]] + toks[:query_maxlen - 3] + [vocab["[SEP]"]]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = True
    return ids, mask


def tensorize_docs(texts: list[str], vocab: dict[str, int], doc_maxlen: int,
                   doc_marker: str = "[unused1]") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``[CLS] [D] tokens [SEP]``, content cut at ``doc_maxlen - 3``, padded
    with ``[PAD]`` -> (ids, attention mask, keep mask) (N, L); the keep mask
    leaves out padding and ASCII punctuation (ColBERT's doc skiplist)."""
    rows = []
    for text in texts:
        toks = [t for w in basic_split(text) for t in wordpiece(w, vocab)]
        rows.append([vocab["[CLS]"], vocab[doc_marker]] + toks[:doc_maxlen - 3] + [vocab["[SEP]"]])
    L = max(len(r) for r in rows)
    ids = np.full((len(rows), L), vocab["[PAD]"], np.int64)
    mask = np.zeros((len(rows), L), bool)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = True
    skip = [vocab[c] for c in string.punctuation if c in vocab] + [vocab["[PAD]"]]
    return ids, mask, mask & ~np.isin(ids, skip)
