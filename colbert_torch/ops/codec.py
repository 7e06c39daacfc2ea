"""Residual codec (port of ``colbert_tpu.ops.codec``).

Layout (identical to the JAX package and the reference, residual.jl:197-208
and :400-407): per embedding, the bitstring is dim-major / bit-minor (bit b
of dim d's bucket index sits at position ``d * nbits + b``), packed
LSB-first into bytes. The device index stores the packed rows either as
uint8 bytes or, when a row is a whole number of 4-byte words, as
little-endian 32-bit words; PyTorch has no full uint32 arithmetic, so the
port keeps those words in ``torch.int32`` tensors with the same bits.

Compress side: codes are nearest centroids by inner product, taken in fp32
over row chunks (``torch.argmax`` takes the first maximal index, as
``jnp.argmax`` does) and returned as int32 (the JAX package's uint32 with
the same values); residuals are bucketed against the quantile cutoffs of
:func:`bucket_cutoffs_and_weights` and packed as above.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["word_bits", "unpack_bits", "bucket_indices_packed",
           "decompress_residuals", "decompress", "bucket_indices", "binarize",
           "unbinarize", "pack_bits", "compress_into_codes", "compress_residuals", "compress",
           "bucket_cutoffs_and_weights"]

_BYTE_WEIGHTS = tuple(1 << k for k in range(8))  # LSB-first
_QUANTILE_MAX_ELEMENTS = 1 << 24  # torch.quantile refuses larger inputs


def word_bits(packed: torch.Tensor) -> int:
    """Bits per packed word: 8 for uint8 bytes, 32 for int32 LE words."""
    if packed.dtype == torch.uint8:
        return 8
    if packed.dtype == torch.int32:
        return 32
    raise TypeError(f"packed residual words must be uint8 or int32, got {packed.dtype}")


def unpack_bits(packed: torch.Tensor, nbits: int) -> torch.Tensor:
    """``(n, nwords)`` packed words -> ``(n, dim, nbits)`` int32 bits.

    Word w's bit b is bitstring position ``wbits * w + b`` (LSB-first), so
    uint8 rows and their little-endian int32 regrouping unpack identically.
    """
    n, nwords = packed.shape
    wbits = word_bits(packed)
    dim = nwords * wbits // nbits
    shifts = torch.arange(wbits, device=packed.device, dtype=torch.int64)
    # widen to int64 first: int32 words carry bit 31 in the sign
    words = packed.to(torch.int64) & ((1 << wbits) - 1)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(n, dim, nbits).to(torch.int32)


def bucket_indices_packed(packed: torch.Tensor, nbits: int) -> torch.Tensor:
    """``(..., nwords)`` packed words -> ``(..., dim)`` int64 bucket indices.

    For nbits in {1, 2, 4, 8} a dim never straddles a word: dim
    ``w * per_word + j`` is ``(word_w >> (j * nbits)) & (2^nbits - 1)``.
    Equal to ``unbinarize(unpack_bits(...))``, one shift per slot."""
    wbits = word_bits(packed)
    per_word = wbits // nbits
    shifts = torch.arange(per_word, device=packed.device, dtype=torch.int64) * nbits
    words = packed.to(torch.int64) & ((1 << wbits) - 1)
    idx = (words[..., None] >> shifts) & ((1 << nbits) - 1)
    return idx.reshape(*packed.shape[:-1], packed.shape[-1] * per_word)


def decompress_residuals(
    packed: torch.Tensor, bucket_weights: torch.Tensor, *, nbits: int
) -> torch.Tensor:
    """Packed residual rows -> float32 ``(..., dim)`` bucket-weight values
    (reference residual.jl:698-721)."""
    idx = bucket_indices_packed(packed, nbits)
    return bucket_weights.to(torch.float32)[idx]


def decompress(
    codes: torch.Tensor,
    packed: torch.Tensor,
    centroids: torch.Tensor,
    bucket_weights: torch.Tensor,
    *,
    nbits: int,
) -> torch.Tensor:
    """L2-normalized embeddings from (codes, packed residuals): centroid
    row plus residual, renormalized (reference residual.jl:759-784)."""
    res = decompress_residuals(packed, bucket_weights, nbits=nbits)
    emb = centroids[codes.to(torch.int64)].to(torch.float32) + res
    norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb / torch.clamp(norm, min=1e-12)


# ---------------------------------------------------------------------------
# compress side
# ---------------------------------------------------------------------------


def bucket_indices(residuals: torch.Tensor, bucket_cutoffs: torch.Tensor) -> torch.Tensor:
    """Bucket ids in ``[0, 2^nbits)``: the count of cutoffs strictly below
    each value (reference residual.jl:348-351, ``searchsortedfirst - 1``)."""
    cut = bucket_cutoffs.to(residuals.dtype)
    return (residuals[..., None] > cut).sum(dim=-1, dtype=torch.int32)


def binarize(indices: torch.Tensor, nbits: int) -> torch.Tensor:
    """Bucket ids ``(n, dim)`` -> bits ``(n, dim, nbits)``, LSB first
    (reference residual.jl:197-208)."""
    shifts = torch.arange(nbits, dtype=torch.int32, device=indices.device)
    return (indices.to(torch.int32)[..., None] >> shifts) & 1


def unbinarize(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`binarize`: bits ``(n, dim, nbits)`` -> bucket ids
    ``(n, dim)`` int32 (reference residual.jl ``_unbinarize``)."""
    nbits = bits.shape[-1]
    weights = 1 << torch.arange(nbits, dtype=torch.int32, device=bits.device)
    return (bits.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``(n, dim, nbits)`` bits -> ``(n, dim // 8 * nbits)`` uint8, the
    bitstring dim-major / bit-minor, bytes filled LSB-first
    (reference residual.jl:400-407)."""
    n, dim, nbits = bits.shape
    if (dim * nbits) % 8 != 0:
        raise ValueError("dim * nbits must be a multiple of 8")
    flat = bits.reshape(n, dim * nbits // 8, 8).to(torch.int32)
    weights = torch.tensor(_BYTE_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (flat * weights).sum(dim=-1).to(torch.uint8)


def compress_into_codes(embs: torch.Tensor, centroids: torch.Tensor, *,
                        bsize: int = 4096) -> torch.Tensor:
    """Nearest centroid id (max inner product, fp32) per row -> int32
    ``(n,)`` (reference residual.jl:67-81), ``bsize`` rows at a time."""
    ct = centroids.float().t()
    codes = torch.empty(embs.shape[0], dtype=torch.int32, device=embs.device)
    for s in range(0, embs.shape[0], bsize):
        scores = torch.matmul(embs[s:s + bsize].float(), ct)
        codes[s:s + bsize] = torch.argmax(scores, dim=-1).to(torch.int32)
    return codes


def compress_residuals(embs: torch.Tensor, centroid_of_emb: torch.Tensor,
                       bucket_cutoffs: torch.Tensor, *, nbits: int) -> torch.Tensor:
    """Quantize ``embs - centroid_of_emb`` into packed uint8 residuals."""
    res = embs.float() - centroid_of_emb.float()
    return pack_bits(binarize(bucket_indices(res, bucket_cutoffs), nbits))


def compress(embs: torch.Tensor, centroids: torch.Tensor, bucket_cutoffs: torch.Tensor,
             *, nbits: int, bsize: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (codes int32 ``(n,)``, packed residuals uint8 ``(n, dim // 8 *
    nbits)``) (reference residual.jl:586-604), ``bsize`` rows at a time so
    the fp32 and bit temporaries stay the size of one chunk."""
    codes = compress_into_codes(embs, centroids, bsize=bsize)
    residuals = torch.empty((embs.shape[0], embs.shape[1] // 8 * nbits),
                            dtype=torch.uint8, device=embs.device)
    for s in range(0, embs.shape[0], bsize):
        residuals[s:s + bsize] = compress_residuals(
            embs[s:s + bsize], centroids[codes[s:s + bsize].long()], bucket_cutoffs,
            nbits=nbits)
    return codes, residuals


def bucket_cutoffs_and_weights(
    nbits: int, heldout_residuals: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantile cutoffs ``(2^nbits - 1,)`` and weights ``(2^nbits,)`` (linear
    interpolation) and the mean of |residual| over the heldout residuals,
    all fp32 (reference collection_indexer.jl:141-152, :177-195). The
    heldout split holds at most 50,000 rows, inside ``torch.quantile``'s
    2^24-element limit; larger inputs raise."""
    flat = heldout_residuals.float().reshape(-1)
    if flat.numel() > _QUANTILE_MAX_ELEMENTS:
        raise ValueError(f"{flat.numel()} heldout values exceed torch.quantile's "
                         f"{_QUANTILE_MAX_ELEMENTS}-element limit")
    num_options = 1 << nbits
    base = np.arange(num_options, dtype=np.float64) / num_options
    cutoff_q = torch.tensor(base[1:], dtype=torch.float32, device=flat.device)
    weight_q = torch.tensor(base + 0.5 / num_options, dtype=torch.float32,
                            device=flat.device)
    cutoffs = torch.quantile(flat, cutoff_q, interpolation="linear")
    weights = torch.quantile(flat, weight_q, interpolation="linear")
    return cutoffs, weights, flat.abs().mean()
