"""ctypes bridge to the native WordPiece tokenizer (native/wordpiece.cpp).

Builds the shared library on first use with g++ (cached under the port's
``colbert_torch/build/``); everything degrades gracefully to the pure-Python
tokenizer if the toolchain or the .so is unavailable. Texts containing
non-ASCII bytes are delegated back to the Python path per-text, so outputs
are always identical to :class:`WordPieceTokenizer`.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

from colbert_torch.utils.build import REPO_ROOT, compile_shared

logger = logging.getLogger(__name__)

__all__ = ["NativeWordPiece", "load_library"]

_SRC = os.path.join(REPO_ROOT, "native", "wordpiece.cpp")

_lib = None
_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL | None:
    """Compile (once) and load the shared library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SRC):
            return None
        try:
            so, _ = compile_shared(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"],
                _SRC, "libwordpiece.so",
            )
            lib = ctypes.CDLL(so)
        except (OSError, RuntimeError) as e:
            logger.warning("native wordpiece unavailable: %s", e)
            return None
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_int32]
        lib.wp_encode_batch.restype = None
        lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.wp_destroy.restype = None
        lib.wp_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeWordPiece:
    """Batch encoder backed by the C++ library, with Python-parity fallback."""

    def __init__(self, tokenizer, *, n_threads: int | None = None,
                 max_tokens_per_text: int = 512) -> None:
        self.tokenizer = tokenizer
        self.lib = load_library()
        self.max_tokens = max_tokens_per_text
        self.n_threads = n_threads or min(16, os.cpu_count() or 1)
        self.handle = None
        if self.lib is not None:
            # id = line number: rebuild the ordered token list
            items = sorted(tokenizer.vocab.items(), key=lambda kv: kv[1])
            blob = "\n".join(t for t, _ in items).encode("utf-8")
            self.handle = ctypes.c_void_p(self.lib.wp_create(
                blob, len(items), tokenizer.unk_id, tokenizer.max_chars_per_word
            ))

    @property
    def available(self) -> bool:
        return self.handle is not None

    def _native(self, texts, width: int):
        """One pass of the library over ``texts`` (a list[str] or a
        byte-backed ``Collection``) -> (ids (N, width) int32, lens (N,)
        int32): text i's tokens are ``ids[i, :lens[i]]``, and ``lens[i] < 0``
        leaves text i to the Python tokenizer (-1 non-ASCII, -2 more than
        ``width`` tokens: the native path never silently truncates). None
        where the library is not loaded, the batch is empty or a text has
        no UTF-8 form (a lone surrogate)."""
        from colbert_torch.storage.collection import Collection

        if not self.available or not len(texts):
            return None
        if isinstance(texts, Collection):
            blob, offsets = texts.batch_blob()
        else:
            try:
                blob = "".join(texts).encode("utf-8")
            except UnicodeEncodeError:
                return None
            lens = [len(t) for t in texts]
            if len(blob) != sum(lens):  # a non-ASCII text: offsets count bytes
                lens = [len(t.encode("utf-8")) for t in texts]
            offsets = np.zeros(len(texts) + 1, np.int64)
            np.cumsum(lens, out=offsets[1:])
        ids = np.empty((len(texts), width), np.int32)
        lens = np.empty(len(texts), np.int32)
        self.lib.wp_encode_batch(
            self.handle, blob, offsets, len(texts),
            1 if self.tokenizer.do_lower_case else 0,
            ids.reshape(-1), lens, width, self.n_threads,
        )
        return ids, lens

    def encode_batch(self, texts, width: int = 0) -> list[list[int]]:
        """Tokenize a list[str] OR a byte-backed ``Collection`` (the latter
        skips the per-text str decode/encode round-trip entirely — bytes go
        from the mmap'd file straight into the C++ tokenizer). Texts of up
        to ``max(width, max_tokens)`` tokens stay in the library."""
        from colbert_torch.storage.collection import Collection

        run = self._native(texts, max(width, self.max_tokens))
        if run is None:
            return self.tokenizer.encode_batch(
                list(texts) if isinstance(texts, Collection) else texts
            )
        ids, lens = run
        return [self.tokenizer.encode(texts[i]) if n < 0 else ids[i, :n].tolist()
                for i, n in enumerate(lens.tolist())]

    def encode_array(self, texts, width: int) -> tuple[np.ndarray, np.ndarray, int]:
        """Tokenize ``texts`` into one array -> (ids (N, width) int32, lens
        (N,) int64, n_fallback): row i starts with text i's first
        ``min(lens[i], width)`` token ids (the rest of the row is undefined)
        and ``lens[i]`` is its full token count, as :meth:`encode_batch`
        gives them. ``n_fallback`` texts went to the Python tokenizer:
        non-ASCII ones, those over ``max(width, max_tokens)`` tokens, and
        every text of a batch the library cannot take."""
        run = self._native(texts, max(width, self.max_tokens))
        if run is None:
            ids = np.empty((len(texts), width), np.int32)
            lens = np.zeros(len(texts), np.int64)
            fallback = range(len(texts))
        else:
            ids, lens = run[0][:, :width], run[1].astype(np.int64)
            fallback = np.flatnonzero(lens < 0).tolist()
        for i in fallback:
            toks = self.tokenizer.encode(texts[i])
            lens[i] = len(toks)
            ids[i, :min(len(toks), width)] = toks[:width]
        return ids, lens, len(fallback)

    def __del__(self):
        if getattr(self, "handle", None) and self.lib is not None:
            try:
                self.lib.wp_destroy(self.handle)
            except Exception:
                pass
