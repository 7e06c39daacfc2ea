"""Flash attention for the doc encoder (BERT, ModernBERT): the CUDA kernels and their plain version.

Replaces the TPU kernel ``colbert_tpu/ops/flash_attention.py::_flash_kernel``
(wrapped by ``flash_attention``): non-causal multi-head attention with an
online softmax,

    out[b*H + h] = softmax(q k^T / sqrt(hd) + bias[b]) v,

over ``q, k, v (B*H, S, hd)`` with an additive per-batch key bias ``(B, S)``
f32 (0 for real tokens; BERT passes ``finfo(float32).min`` for pads). It
accumulates in fp32 and casts the output to q's dtype.

The kernels (``csrc/flash_attention.cu``) are CUDA C++ for ``sm_90a``,
built with ``nvcc`` into ``colbert_torch/build/`` at first use and loaded
with ctypes. :func:`_variant` picks one from the dtype and head dim alone:
``"mma"``, ``flash_mma_kernel``, runs both products on the tensor cores
(``mma.sync`` on bf16/fp16, a ``cp.async`` K/V ring) for bf16 and fp16 at
head dim 32, 64 or 128, and needs every pointer 16-byte aligned and every
stride a multiple of 8 elements (it raises ``ValueError`` otherwise);
``"simt"``, ``flash_kernel``, runs fp32 FMAs for fp32 inputs and any other
head dim. This is a routing by type, not a fallback: a launch that fails
raises and nothing retries on the other kernel. At the build path's shape
(S=512, hd=64, bf16) the work is 256 FLOPs per byte of q, k, v and out,
just under the H100's 295, so its least time is set by the bytes (the
source note says how each kernel meets that).
It keeps the reference's ``S % 128 == 0`` check and raises otherwise: the
encoder's strict length buckets guarantee it wherever attention is routed
here. ``hd`` is a multiple of 8 up to 128; inputs are fp32, bf16 or fp16.

:func:`flash_attention` takes the JAX layout. :func:`flash_attention_bsh`
takes BertLayer's ``(B, S, H*hd)`` projections and returns that layout;
the kernels read them through strides, so no head transpose runs. Both
count every launch in ``flash_attention.launches`` and, by variant, in
``flash_attention.variant_launches`` (a captured program's replays count
the launches its capture recorded, :mod:`colbert_torch.retrieval.program`).
CUDA tensors go through a kernel (or
raise); CPU tensors through :func:`flash_attention_plain`, the
materialized fp32 softmax of the same function. The two differ only on a
batch row whose every key is a pad (the kernels write 0 there, as the
Pallas kernel does; the materialized softmax averages v), which BERT never
produces: [CLS] is always a real token.

Every function takes a ``window``: ``None`` is the attention above; a half
width ``w >= 0`` leaves out every key ``j`` farther than ``w`` from query
``i`` (``|i - j| > w`` scores ``-inf``), ModernBERT's local layers (``w =
64``). On the card a windowed launch goes through
``flash_mma_window_kernel`` (or ``flash_kernel`` with the window, for the
``"simt"`` variant): 64-row q tiles, each visiting only the 64-key tiles
that meet ``[q0 - w, q0 + 63 + w]``, and counts in
``flash_attention.window_launches`` too; while recording
(:mod:`colbert_torch.utils.tracing`) it adds the (query, key) pairs inside
those tiles (:func:`window_tile_pairs` per row and head) to the counter
``attn_window_tile_pairs``.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading

import torch

from colbert_torch.utils import tracing
from colbert_torch.utils.build import CSRC_DIR, compile_cuda

__all__ = ["flash_attention", "flash_attention_bsh", "flash_attention_plain",
           "build_kernel", "window_tile_pairs", "KERNEL_SOURCE"]

KERNEL_SOURCE = os.path.join(CSRC_DIR, "flash_attention.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MMA_DTYPES = (torch.bfloat16, torch.float16)
_MMA_HEAD_DIMS = (32, 64, 128)
_ENTRY = {"mma": "colbert_flash_attention_mma", "simt": "colbert_flash_attention"}
# a windowed launch's q tile and every launch's key tile (csrc: kBlockQ of
# MmaShape<HD, true> and flash_kernel, kMmaBlockK and kBlockK)
WINDOW_BLOCK_Q = 64
BLOCK_K = 64

_lib = None
_lib_lock = threading.Lock()


def build_kernel() -> str:
    """Build (once per source change) and load the kernel library -> the
    compiler's output ("" when the library was already up to date)."""
    global _lib
    with _lib_lock:
        so, log = compile_cuda(KERNEL_SOURCE, "libflash_attention.so")
        if _lib is None:
            lib = ctypes.CDLL(so)
            for name in _ENTRY.values():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = (
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
                    + [ctypes.c_int] + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
                )
            _lib = lib
        return log


def window_tile_pairs(S: int, window: int) -> int:
    """(query, key) pairs a windowed launch computes per (batch row, head)
    at padded length ``S``: every 64-row q tile times the keys of the 64-key
    tiles it visits."""
    total = 0
    for q0 in range(0, S, WINDOW_BLOCK_Q):
        j0 = max(q0 - window, 0) // BLOCK_K
        j1 = min(S // BLOCK_K, (q0 + WINDOW_BLOCK_Q - 1 + window) // BLOCK_K + 1)
        total += WINDOW_BLOCK_Q * BLOCK_K * (j1 - j0)
    return total


def band_mask(S: int, window: int, device) -> torch.Tensor:
    """``(S, S)`` bool, True where ``|i - j| > window``: the keys a window
    leaves out."""
    i = torch.arange(S, device=device)
    return (i[:, None] - i[None, :]).abs() > window


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, *, num_heads: int,
                          window: int | None = None) -> torch.Tensor:
    """The same function with the ``(B*H, S, S)`` scores materialized in
    fp32 -> ``(B*H, S, hd)`` in q's dtype."""
    BH, S, hd = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    scores = scores + bias.float().repeat_interleave(num_heads, dim=0)[:, None, :]
    if window is not None:
        scores = scores.masked_fill(band_mask(S, window, q.device), float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def _check(q, k, v, bias, B, S, hd, window=None):
    if window is not None and window < 0:
        raise ValueError(f"window {window} must be >= 0 (or None)")
    for name, t in (("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one shape and dtype")
    if bias.shape != (B, S) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be ({B}, {S}) float32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if S % 128:
        raise ValueError(f"S={S} must be a multiple of 128")
    if hd % 8 or not 0 < hd <= 128:
        raise ValueError(f"head dim {hd} must be a multiple of 8 up to 128")


def _variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel for inputs of this dtype and head dim: ``"mma"`` (tensor
    cores) for bf16/fp16 at hd 32, 64 or 128, else ``"simt"``."""
    return "mma" if dtype in _MMA_DTYPES and hd in _MMA_HEAD_DIMS else "simt"


def _check_aligned(tensors, strides):
    """The mma kernel's 16-byte ``cp.async`` copies: every pointer 16-byte
    aligned, every stride a multiple of 8 elements."""
    for name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (data_ptr {t.data_ptr():#x})")
    if any(st % 8 for st in strides):
        raise ValueError(f"strides {tuple(strides)} are not multiples of 8 elements")


def _launch(q, k, v, bias, out, B, H, S, hd, in_strides, out_strides, window=None):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes fp32, bf16 or fp16, not {q.dtype}")
    variant = _variant(q.dtype, hd)
    if variant == "mma":
        _check_aligned((("q", q), ("k", k), ("v", v), ("out", out)),
                       (*in_strides, *out_strides))
    if _lib is None:
        build_kernel()
    bias = bias.contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(_lib, _ENTRY[variant])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype], B, H, S, hd, 1.0 / math.sqrt(hd),
            -1 if window is None else min(int(window), S), *in_strides, *out_strides, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch failed (code {rc})")
    flash_attention.launches += 1
    flash_attention.variant_launches[variant] += 1
    if window is not None:
        flash_attention.window_launches += 1
        tracing.count("attn_window_tile_pairs", B * H * window_tile_pairs(S, int(window)))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, *, num_heads: int,
                    window: int | None = None) -> torch.Tensor:
    """Attention over ``q, k, v (B*H, S, hd)`` with ``bias (B, S)`` f32 ->
    ``(B*H, S, hd)`` in q's dtype. CUDA tensors go through the kernel; CPU
    tensors through the plain version."""
    BH, S, hd = q.shape
    if BH % num_heads:
        raise ValueError(f"B*H={BH} is not a multiple of num_heads={num_heads}")
    B = BH // num_heads
    _check(q, k, v, bias, B, S, hd, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, num_heads=num_heads, window=window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    strides = (num_heads * S * hd, S * hd, hd)
    return _launch(q, k, v, bias, out, B, num_heads, S, hd, strides, strides, window)


def flash_attention_bsh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, *, num_heads: int,
                        window: int | None = None) -> torch.Tensor:
    """The same attention over BertLayer's projections ``(B, S, H*hd)``
    -> ``(B, S, H*hd)``: the kernel reads head ``h`` of row ``s`` at
    ``[b, s, h*hd:(h+1)*hd]`` through strides."""
    B, S, Hd = q.shape
    if Hd % num_heads:
        raise ValueError(f"width {Hd} is not a multiple of num_heads={num_heads}")
    hd = Hd // num_heads
    _check(q, k, v, bias, B, S, hd, window)
    if q.device.type == "cpu":
        def split(x):  # (B, S, H*hd) -> (B*H, S, hd)
            return x.reshape(B, S, num_heads, hd).transpose(1, 2).reshape(B * num_heads, S, hd)

        out = flash_attention_plain(split(q), split(k), split(v), bias, num_heads=num_heads,
                                    window=window)
        return out.reshape(B, num_heads, S, hd).transpose(1, 2).reshape(B, S, Hd)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    strides = (S * Hd, hd, Hd)
    return _launch(q, k, v, bias, out, B, num_heads, S, hd, strides, strides, window)


flash_attention.launches = 0
flash_attention.variant_launches = {"mma": 0, "simt": 0}
flash_attention.window_launches = 0
