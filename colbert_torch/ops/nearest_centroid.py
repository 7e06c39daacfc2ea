"""k-means' assignment step on the card: the nearest centroid of every row
in one kernel launch, and the split of fp32 operands into bf16 terms that
the kernel multiplies.

Replaces no Pallas kernel: ``colbert_tpu/ops/kmeans.py:_assign_chunk``
leaves ``jnp.dot`` + ``jnp.argmax`` to XLA. This is the port's own kernel
for that op, written once an H100 profile of the index build named the
fp32 GEMM behind it and the argmax over its score tile.

:func:`nearest_centroid` returns, for every row x of ``data``,
``argmax_j (2 x·c_j − ‖c_j‖²)``, the lowest ``j`` among exact ties (as
``torch.argmax`` takes it), without writing the (n, K) scores: the scores
of :func:`colbert_torch.ops.kmeans._assign_chunk` in the same fp32 class.
The centroids are split by :func:`split_bf16` into three bf16 terms, each
the bf16 rounding of what the earlier ones leave (the sum is within
~2^-27 of the fp32 value); a bf16 row is exact in bf16, so each row meets
three exact bf16 products accumulated in fp32. Other rows (fp32, and any
other float type by way of fp32) are split the same way and passed as
``[x1 | x2 | x3]`` against centroid terms that pair ``x_i`` with ``c_t``
only where ``i + t <= 2``: six products, each of the dropped three below
2^-27 of the whole. The input's dtype alone picks the split; there is no
single-term route.

:func:`centroid_stream` lays the terms out as the kernel reads them (one
6 KB stage per tile of ``TILE`` centroids and 16-dim slab, see
``csrc/nearest_centroid.cu``) with the biases ``−‖c‖²`` (−inf past K), once
per call. The kernel is built with ``nvcc`` into ``colbert_torch/build/``
at first use, loaded with ctypes and launched on the current stream; its
output is allocated here. A launch that fails raises; nothing retries on
the plain version, which :mod:`colbert_torch.ops.kmeans` keeps for CPU
tensors.

While tracing records, each launch counts ``kmeans_assign_launches``,
``kmeans_assign_rows`` (rows assigned) and ``kmeans_assign_pairs`` (rows
x K, the (row, centroid) pairs scored).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from colbert_torch.utils import tracing
from colbert_torch.utils.build import CSRC_DIR, compile_cuda

__all__ = ["nearest_centroid", "split_bf16", "row_operand", "centroid_stream", "build_kernel",
           "KERNEL_SOURCE", "TILE", "TERMS", "MAX_DIM"]

KERNEL_SOURCE = os.path.join(CSRC_DIR, "nearest_centroid.cu")
TILE = 64      # centroids per tile (the kernel's kBN)
TERMS = 3      # bf16 terms of an fp32 operand
MAX_DIM = 256  # the widest rows the kernel's shared memory takes split three ways
_ENTRY = "colbert_nearest_centroid"

_lib = None
_lib_lock = threading.Lock()


def load_library(so: str) -> ctypes.CDLL:
    """Load a built kernel library and declare its entry point's C signature."""
    lib = ctypes.CDLL(so)
    fn = getattr(lib, _ENTRY)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def build_kernel() -> str:
    """Build (once per source change) and load the kernel library -> the
    compiler's output ("" when the library was already up to date)."""
    global _lib
    with _lib_lock:
        so, log = compile_cuda(KERNEL_SOURCE, "libnearest_centroid.so")
        if _lib is None:
            _lib = load_library(so)
        return log


def split_bf16(x: torch.Tensor, terms: int = TERMS) -> list[torch.Tensor]:
    """``x`` (any float type, taken as fp32) as ``terms`` bf16 tensors whose
    fp32 sum is ``x`` to ~2^-(9 terms) relative: each term is the bf16
    rounding (to nearest even) of what the earlier ones leave, and each
    remainder is exact in fp32."""
    rest = x.to(torch.float32, copy=True)
    parts = []
    for _ in range(terms):
        part = rest.to(torch.bfloat16)
        parts.append(part)
        rest.sub_(part)
    return parts


def row_operand(data: torch.Tensor) -> tuple[torch.Tensor, int]:
    """-> (the kernel's bf16 rows, the number of row terms): bf16 rows as
    they are (one term), any other rows split by :func:`split_bf16` into
    ``[x1 | x2 | x3]`` (three terms, ``3 dim`` columns)."""
    if data.dtype == torch.bfloat16:
        return data.contiguous(), 1
    return torch.cat(split_bf16(data), dim=1), TERMS


def centroid_stream(centroids: torch.Tensor, row_terms: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (the centroid terms in the kernel's order, the biases). The terms
    are (tiles, row_terms * dim / 16, TERMS, TILE, 16) bf16: K padded with
    zero centroids to whole tiles of ``TILE``; for tile j and slab s (dims
    16 s .. 16 s + 15 of the row operand, whose block i of ``dim`` dims is
    row term i) the three centroid terms' 16 values of each centroid, the
    two 8-value halves swapped on centroids whose index has bit 2 set (the
    kernel's bank-conflict swizzle), and zeros in block i of term t where
    i + t > 2. The biases are (tiles x TILE,) fp32: ``−‖c‖²`` from the fp32
    centroids, as the plain version forms it, and −inf on the padding."""
    k, dim = centroids.shape
    c = centroids.float()
    tiles = -(-k // TILE)
    pad = tiles * TILE - k
    bias = torch.full((tiles * TILE,), float("-inf"), dtype=torch.float32,
                      device=centroids.device)
    bias[:k] = -(c * c).sum(dim=-1)
    stream = torch.zeros((tiles, row_terms * dim // 16, TERMS, TILE, 16), dtype=torch.bfloat16,
                         device=centroids.device)
    # centroid n of a tile is (8 a + 4 b + c): b is the swizzle bit
    dst = stream.view(tiles, row_terms, dim // 16, TERMS, TILE // 8, 2, 4, 2, 8)
    for t, part in enumerate(split_bf16(c)):
        src = torch.nn.functional.pad(part, (0, 0, 0, pad)).view(
            tiles, TILE // 8, 2, 4, dim // 16, 2, 8).permute(0, 4, 1, 2, 3, 5, 6)
        for i in range(min(row_terms, TERMS - t)):
            block = dst[:, i, :, t]
            block[:, :, :, 0].copy_(src[:, :, :, 0])
            block[:, :, :, 1].copy_(src[:, :, :, 1].flip(-2))
    return stream, bias


def _check(data: torch.Tensor, centroids: torch.Tensor) -> None:
    if data.device.type != "cuda":
        raise ValueError(f"nearest_centroid runs on cuda, not {data.device}")
    if centroids.device != data.device:
        raise ValueError(f"centroids are on {centroids.device}, data on {data.device}")
    if data.dim() != 2 or centroids.dim() != 2 or data.shape[1] != centroids.shape[1]:
        raise ValueError("data must be (n, dim) and centroids (K, dim)")
    if not (data.is_floating_point() and centroids.is_floating_point()):
        raise TypeError("data and centroids must be floating point")
    dim = data.shape[1]
    if dim % 16 or not 0 < dim <= MAX_DIM:
        raise ValueError(f"dim {dim}: the kernel takes multiples of 16 up to {MAX_DIM}")
    if centroids.shape[0] < 1:
        raise ValueError("at least one centroid is needed")


def nearest_centroid(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid (squared distance) of every row of ``data (n,
    dim)`` among ``centroids (K, dim)``, both on one card -> int64 ``(n,)``,
    in one kernel launch (built from ``KERNEL_SOURCE`` at first use)."""
    _check(data, centroids)
    if _lib is None:
        build_kernel()
    rows, row_terms = row_operand(data)
    stream, bias = centroid_stream(centroids, row_terms)
    n, k = data.shape[0], centroids.shape[0]
    out = torch.empty((n,), dtype=torch.int64, device=data.device)
    with torch.cuda.device(data.device):
        cuda_stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = getattr(_lib, _ENTRY)(rows.data_ptr(), stream.data_ptr(), bias.data_ptr(),
                                   out.data_ptr(), n, rows.shape[1], bias.shape[0], TILE,
                                   cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nearest_centroid kernel launch failed (code {rc})")
    tracing.count("kmeans_assign_launches")
    tracing.count("kmeans_assign_rows", n)
    tracing.count("kmeans_assign_pairs", n * k)
    return out

