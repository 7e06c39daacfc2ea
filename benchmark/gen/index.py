"""The synthetic served index (a frozen copy of
``colbert_torch.utils.testing.synthesize_index``, numpy only): random unit
centroids, fixed bucket cutoffs and weights, doclens uniform in
``[max(8, avg - 30), avg + 30)``, each passage's codes near a base cell of
its own (``code_locality``), uniform random residual bytes, and the IVF
(embedding ids grouped by code, stable). :func:`write_index` stores it in
the on-disk layout that both ColBERT packages read (``.npy`` arrays and
JSON files)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticIndex:
    centroids: np.ndarray       # (K, dim) f32, unit rows
    bucket_cutoffs: np.ndarray  # (2^nbits - 1,) f32
    bucket_weights: np.ndarray  # (2^nbits,) f32
    codes: np.ndarray           # (N,) uint32
    residuals: np.ndarray       # (N, dim * nbits / 8) uint8, packed LSB-first
    doclens: np.ndarray         # (P,) int32
    chunk_passages: list        # passages per chunk
    dim: int
    nbits: int

    @property
    def num_partitions(self) -> int:
        return self.centroids.shape[0]


def synthesize(seed: int, n_passages: int, *, dim: int, nbits: int, avg_doclen: int,
               num_partitions: int, chunksize: int, code_locality: bool = True
               ) -> SyntheticIndex:
    rng = np.random.default_rng([seed, 2])
    k = num_partitions
    nbytes = dim // 8 * nbits
    centroids = rng.normal(size=(k, dim)).astype(np.float32)
    centroids /= np.linalg.norm(centroids, axis=1, keepdims=True)
    q = 2 ** nbits
    cutoffs = np.linspace(-0.02, 0.02, q - 1).astype(np.float32)
    weights = np.linspace(-0.025, 0.025, q).astype(np.float32)
    codes, residuals, doclens, per_chunk = [], [], [], []
    for lo in range(0, n_passages, chunksize):
        n_chunk = min(chunksize, n_passages - lo)
        dl = rng.integers(max(8, avg_doclen - 30), avg_doclen + 30, size=n_chunk).astype(np.int32)
        rows = int(dl.sum())
        if code_locality:
            base = rng.integers(0, k, size=n_chunk)
            c = (np.repeat(base, dl) + rng.integers(0, 32, size=rows)) % k
        else:
            c = rng.integers(0, k, size=rows)
        codes.append(c.astype(np.uint32))
        residuals.append(rng.integers(0, 256, size=(rows, nbytes), dtype=np.uint8))
        doclens.append(dl)
        per_chunk.append(n_chunk)
    return SyntheticIndex(centroids=centroids, bucket_cutoffs=cutoffs, bucket_weights=weights,
                          codes=np.concatenate(codes), residuals=np.concatenate(residuals),
                          doclens=np.concatenate(doclens), chunk_passages=per_chunk,
                          dim=dim, nbits=nbits)


def build_ivf(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (embedding ids sorted stably by code int32, per-code counts int32)."""
    ivf = np.argsort(codes, kind="stable").astype(np.int32)
    return ivf, np.bincount(codes, minlength=k).astype(np.int32)


def write_index(path: str, ix: SyntheticIndex, config: dict) -> None:
    """Write ``ix`` under ``path`` with ``config`` as its ``config.json``."""
    os.makedirs(path, exist_ok=True)

    def save(name, arr):
        np.save(os.path.join(path, name), arr)

    def dump(name, obj):
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)

    dump("config.json", config)
    save("centroids.npy", ix.centroids)
    save("bucket_cutoffs.npy", ix.bucket_cutoffs)
    save("bucket_weights.npy", ix.bucket_weights)
    dump("avg_residual.json", {"avg_residual": 0.02})
    offsets, emb, pid = [], 0, 0
    for ci, n_chunk in enumerate(ix.chunk_passages):
        dl = ix.doclens[pid:pid + n_chunk]
        rows = int(dl.sum())
        save(f"{ci}.codes.npy", ix.codes[emb:emb + rows])
        save(f"{ci}.residuals.npy", ix.residuals[emb:emb + rows])
        save(f"doclens.{ci}.npy", dl)
        dump(f"{ci}.metadata.json", {"passage_offset": pid, "num_passages": n_chunk,
                                     "num_embeddings": rows})
        offsets.append(emb)
        emb += rows
        pid += n_chunk
    P = len(ix.doclens)
    chunksize = ix.chunk_passages[0]
    dump("plan.json", {"chunksize": chunksize, "num_chunks": len(ix.chunk_passages),
                       "num_partitions": ix.num_partitions, "num_documents": P,
                       "num_embeddings_est": float(emb), "avg_doclen_est": emb / max(1, P),
                       "num_embeddings": emb, "embedding_offsets": offsets})
    ivf, lengths = build_ivf(ix.codes, ix.num_partitions)
    save("ivf.npy", ivf)
    save("ivf_lengths.npy", lengths)
