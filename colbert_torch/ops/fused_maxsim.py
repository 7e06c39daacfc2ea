"""Stage-2 fused decompress + MaxSim: the CUDA kernels and their plain version.

Replaces the TPU kernel ``colbert_tpu/ops/fused_maxsim.py::_kernel``
(wrapped by ``stage2_maxsim_pallas``) and the XLA code of
``colbert_tpu/retrieval/device_index.py::_stage2_scores`` around it. One
call scores a whole query batch:

    scores[b, c] = sum_q max_{t < dls[b, c]}
                   <Q[b, q], normalize(centroids[codes[o+t]] + res(o+t))>,
    o = offs[b, c]; 0 for a candidate whose doclen is 0.

The kernels (``csrc/stage2_maxsim.cu``) are CUDA C++ for ``sm_90a``, built
with ``nvcc`` into ``colbert_torch/build/`` at first use and loaded with
ctypes. :func:`_variant` picks one from the shapes alone: ``"mma"``,
``stage2_mma_kernel``, runs the dots on the tensor cores (``mma.sync`` in
3xTF32, which keeps fp32 accuracy) for dim 128 and Lq up to 32 (the
serving path's shapes) at any nbits and word width, and needs the
residuals 4-byte aligned (it raises ``ValueError`` otherwise);
``"simt"``, ``stage2_kernel``, runs fp32 FMAs for every other shape. This
is a routing by shape, not a fallback: a launch that fails raises and
nothing retries on the other kernel. Both are bound by operations (2*Lq*dim
FLOPs per 36-byte token at the default geometry); the source note says how
each design deals with that. The Mosaic workarounds of the TPU kernel (the
token-major transpose, the ``Lq % 8`` padding and the centroid gather left
outside the kernel) have no counterpart here; the dim permutation has one
in the ``mma`` kernel, chosen for its fragment layout.

``stage2_maxsim`` launches a kernel for CUDA tensors and uses
:func:`stage2_maxsim_plain` only for CPU tensors. ``stage2_maxsim.launches``
counts kernel launches, ``stage2_maxsim.variant_launches`` counts them by
kernel. A captured serving program (:mod:`colbert_torch.retrieval.program`)
replays its kernels without entering this wrapper: the launches its capture
recorded are taken back out of the counts and added again at each replay.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from colbert_torch.ops import codec
from colbert_torch.utils.build import CSRC_DIR, compile_cuda

__all__ = ["stage2_maxsim", "stage2_maxsim_plain", "build_kernel", "KERNEL_SOURCE"]

NEG = -1e30
KERNEL_SOURCE = os.path.join(CSRC_DIR, "stage2_maxsim.cu")
MMA_DIM = 128      # the only dim the mma kernel takes
MMA_MAX_LQ = 32    # the most query tokens it takes (four n8 tiles)
_ENTRY = {"mma": "colbert_stage2_maxsim_mma", "simt": "colbert_stage2_maxsim"}

_lib = None
_lib_lock = threading.Lock()


def load_library(so: str) -> ctypes.CDLL:
    """Load a built kernel library and declare its entry points' C
    signature (both kernels take the same arguments)."""
    lib = ctypes.CDLL(so)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
    return lib


def build_kernel() -> str:
    """Build (once per source change) and load the kernel library -> the
    compiler's output ("" when the library was already up to date)."""
    global _lib
    with _lib_lock:
        so, log = compile_cuda(KERNEL_SOURCE, "libstage2_maxsim.so")
        if _lib is None:
            _lib = load_library(so)
        return log


def stage2_maxsim_plain(
    Q: torch.Tensor, offs: torch.Tensor, dls: torch.Tensor, codes: torch.Tensor,
    residuals: torch.Tensor, centroids: torch.Tensor, bucket_weights: torch.Tensor,
    *, nbits: int, max_doclen: int, chunk: int = 1024,
) -> torch.Tensor:
    """The same function in plain PyTorch ops, chunked over candidates so
    only ``chunk`` candidates' fp32 embeddings are live at once. Reads a
    fixed ``max_doclen`` window per candidate (the device index pads codes
    and residuals with that many zero rows) and masks past the doclen."""
    B, Lq, dim = Q.shape
    NC = offs.shape[1]
    nwords = dim * nbits // codec.word_bits(residuals)
    words = residuals.view(-1, nwords)
    ar = torch.arange(max_doclen, device=Q.device)
    flat_off = offs.reshape(-1).to(torch.int64)
    flat_dl = dls.reshape(-1).to(torch.int64)
    q_of = torch.arange(B, device=Q.device).repeat_interleave(NC)
    out = torch.empty(B * NC, dtype=torch.float32, device=Q.device)
    for s in range(0, B * NC, chunk):
        off, dl = flat_off[s:s + chunk], flat_dl[s:s + chunk]
        tok = off[:, None] + ar                                   # (c, Ld)
        embs = codec.decompress(codes[tok], words[tok], centroids,
                                bucket_weights, nbits=nbits)      # (c, Ld, dim)
        sc = torch.bmm(embs, Q[q_of[s:s + chunk]].transpose(1, 2))  # (c, Ld, Lq)
        valid = ar[None, :] < dl[:, None]
        sc = sc.masked_fill(~valid[:, :, None], NEG)
        per_q = sc.amax(dim=1)                                    # (c, Lq)
        per_q = torch.where((dl > 0)[:, None], per_q, 0.0)
        out[s:s + chunk] = per_q.sum(dim=-1)
    return out.view(B, NC)


def _check(Q, offs, dls, codes, residuals, centroids, bucket_weights, nbits):
    dev = Q.device
    tensors = dict(Q=Q, offs=offs, dls=dls, codes=codes, residuals=residuals,
                   centroids=centroids, bucket_weights=bucket_weights)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    want = dict(Q=torch.float32, offs=torch.int64, dls=torch.int32,
                codes=torch.int32, centroids=torch.float32,
                bucket_weights=torch.float32)
    for name, dt in want.items():
        if tensors[name].dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {tensors[name].dtype}")
    if Q.dim() != 3 or offs.dim() != 2 or offs.shape != dls.shape:
        raise ValueError("Q must be (B, Lq, dim) and offs/dls (B, NC)")
    B, Lq, dim = Q.shape
    if offs.shape[0] != B or centroids.dim() != 2 or centroids.shape[1] != dim:
        raise ValueError("offs rows must equal B and centroids be (K, dim)")
    if nbits not in (1, 2, 4, 8) or bucket_weights.shape != (1 << nbits,):
        raise ValueError(f"nbits={nbits} with {tuple(bucket_weights.shape)} weights")
    wbits = codec.word_bits(residuals)
    if codes.dim() != 1 or residuals.dim() != 1 or dim % (wbits // nbits):
        raise ValueError("codes/residuals must be flat and words must tile dim")
    if residuals.numel() != codes.numel() * (dim * nbits // wbits):
        raise ValueError("residuals must hold dim*nbits/8 bytes per code row")


def _variant(Lq: int, dim: int) -> str:
    """The kernel for inputs that passed :func:`_check`: ``"mma"`` (tensor
    cores, 3xTF32) for dim 128 and 1 <= Lq <= 32, at every nbits and word
    width ``_check`` lets through, else ``"simt"`` (fp32 FMAs)."""
    return "mma" if dim == MMA_DIM and 0 < Lq <= MMA_MAX_LQ else "simt"


def _launch(variant: str, Q, offs, dls, codes, residuals, centroids, bucket_weights,
            *, nbits: int, max_doclen: int, lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """One launch of the named kernel on checked CUDA tensors -> ``(B, NC)``
    scores; counts it. ``lib`` is a library from :func:`load_library`
    (default: the one :func:`build_kernel` builds from ``KERNEL_SOURCE``).
    The wrapper's route is :func:`_variant`'s."""
    if variant == "mma" and residuals.data_ptr() % 4:
        raise ValueError(f"residuals are not 4-byte aligned (data_ptr "
                         f"{residuals.data_ptr():#x}); the mma kernel reads up to 4 bytes at once")
    if lib is None:
        if _lib is None:
            build_kernel()
        lib = _lib
    B, Lq, dim = Q.shape
    NC = offs.shape[1]
    out = torch.empty((B, NC), dtype=torch.float32, device=Q.device)
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        rc = getattr(lib, _ENTRY[variant])(
            Q.data_ptr(), offs.data_ptr(), dls.data_ptr(), codes.data_ptr(),
            residuals.data_ptr(), residuals.element_size(),
            centroids.data_ptr(), bucket_weights.data_ptr(), out.data_ptr(),
            B, NC, Lq, dim, nbits, max_doclen, stream,
        )
    if rc != 0:
        raise RuntimeError(f"stage2_maxsim {variant} kernel launch failed (code {rc})")
    stage2_maxsim.launches += 1
    stage2_maxsim.variant_launches[variant] += 1
    return out


def stage2_maxsim(
    Q: torch.Tensor, offs: torch.Tensor, dls: torch.Tensor, codes: torch.Tensor,
    residuals: torch.Tensor, centroids: torch.Tensor, bucket_weights: torch.Tensor,
    *, nbits: int, max_doclen: int,
) -> torch.Tensor:
    """Stage-2 scores ``(B, NC)`` f32 for ``Q (B, Lq, dim)`` f32, candidate
    token offsets ``offs (B, NC)`` int64 and doclens ``dls (B, NC)`` int32
    over the flat ``codes`` (int32) and packed ``residuals`` (uint8 bytes or
    int32 LE words), ``centroids (K, dim)`` f32 and ``bucket_weights``.
    CUDA tensors go through the kernel :func:`_variant` picks; CPU tensors
    through the plain version."""
    _check(Q, offs, dls, codes, residuals, centroids, bucket_weights, nbits)
    if Q.device.type == "cpu":
        return stage2_maxsim_plain(Q, offs, dls, codes, residuals, centroids,
                                   bucket_weights, nbits=nbits,
                                   max_doclen=max_doclen)
    if Q.device.type != "cuda":
        raise ValueError(f"stage2_maxsim runs on cuda or cpu, not {Q.device}")
    B, Lq, dim = Q.shape
    return _launch(_variant(Lq, dim), Q, offs, dls, codes, residuals, centroids,
                   bucket_weights, nbits=nbits, max_doclen=max_doclen)


stage2_maxsim.launches = 0
stage2_maxsim.variant_launches = {"mma": 0, "simt": 0}
