"""The refine's centroid-interaction approximation: the CUDA kernel and its
plain version.

Replaces ``colbert_tpu/retrieval/device_index.py::_approx_maxsim``, which
the JAX package leaves to XLA: a fused chain (a slice of token codes, a
gather of bf16 centroid rows, a bf16 product into fp32 against Q, a masked
max over the doclen, a sum over the query tokens), not a Pallas kernel.
This is the port's own kernel for that op, written once an H100 profile of
a served batch named it. One call scores a whole query batch:

    approx[b, c] = sum_{q < Lq} max_{t < dls[b, c]}
                   <bf16(Q[b, q]), bf16(centroids[codes[offs[b, c] + t]])>,

products exact in fp32 and summed in fp32; 0 for a candidate whose doclen
is 0 (the sentinel pid's too).

On a card, :func:`approx_maxsim` takes the per-batch score table (B, K, Lq)
fp32, query-major, as one batched product of the bf16 operands into fp32 on
the tensor cores (``aten::bmm.dtype``, the JAX package's
``preferred_element_type`` form; a plain large product outside the kernel),
then launches the kernel (``csrc/approx_maxsim.cu``: one warp per query and
candidate, the max over the candidate's tokens and the sum over the query's
tokens), built with ``nvcc`` into ``colbert_torch/build/`` at first use and
loaded with ctypes. A launch that fails raises; nothing retries on the
plain version.

:func:`approx_maxsim_plain` is the route for CPU tensors: one
``embedding_bag(mode="max")`` pass per chunk of candidate columns over a
code-major (K*B + 1, Lq) table of the fp32 products of bf16-rounded values
(the same math), each chunk's working set (:func:`refine_column_bytes` per
column) under ``chunk_bytes``. ``chunk_bytes`` is read by the plain version
only.

``approx_maxsim.launches`` counts kernel launches and
``approx_maxsim.variant_launches`` counts them by kernel (one, ``"table"``).
A captured serving program (:mod:`colbert_torch.retrieval.program`) replays
the kernel without entering this wrapper: the launches its capture recorded
are taken back out of the counts and added again at each replay.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from colbert_torch.utils.build import CSRC_DIR, compile_cuda

__all__ = ["approx_maxsim", "approx_maxsim_plain", "score_table", "build_kernel",
           "refine_column_bytes", "REFINE_CHUNK_BYTES", "KERNEL_SOURCE"]

KERNEL_SOURCE = os.path.join(CSRC_DIR, "approx_maxsim.cu")
# the plain version's cap on one chunk's working set
REFINE_CHUNK_BYTES = 256 << 20
_ENTRY = "colbert_approx_maxsim"

_lib = None
_lib_lock = threading.Lock()


def load_library(so: str) -> ctypes.CDLL:
    """Load a built kernel library and declare its entry point's C signature."""
    lib = ctypes.CDLL(so)
    fn = getattr(lib, _ENTRY)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def build_kernel() -> str:
    """Build (once per source change) and load the kernel library -> the
    compiler's output ("" when the library was already up to date)."""
    global _lib
    with _lib_lock:
        so, log = compile_cuda(KERNEL_SOURCE, "libapprox_maxsim.so")
        if _lib is None:
            _lib = load_library(so)
        return log


def refine_column_bytes(B: int, max_doclen: int, Lq: int) -> int:
    """Device bytes that one candidate column of :func:`approx_maxsim_plain`
    holds at its peak, for B queries: two int64 (B, Ld) tiles (the table-row
    indices and ``embedding_bag``'s own bag index per row) and, per (query,
    candidate) bag, an fp32 max and an int64 argmax per query token."""
    return B * (16 * max_doclen + 12 * Lq)


def approx_maxsim_plain(Q: torch.Tensor, offs: torch.Tensor, dls: torch.Tensor,
                        codes: torch.Tensor, centroids: torch.Tensor, *, max_doclen: int,
                        chunk_bytes: int = REFINE_CHUNK_BYTES) -> torch.Tensor:
    """The same function in plain PyTorch ops, from one centroid-score table
    per batch: row ``code * B + b`` holds query ``b``'s Lq scores of centroid
    ``code`` (one (K, B*Lq) product), and a last row is the padding index
    that tokens past their doclen point at. The W candidate columns are
    walked in chunks shared by the whole batch: one gather of token codes
    into an int64 (B, c, Ld) tile, turned into table rows in place, then one
    ``embedding_bag(mode="max")`` over the table, each (query, candidate) a
    bag of Ld rows (the max over the bag's rows per column, padding left
    out; a bag of padding only, a zero doclen, gives 0), then the sum over
    Lq. ``c`` keeps a chunk's working set (:func:`refine_column_bytes` per
    column) under ``chunk_bytes``, so the loop runs about W/c times; the
    (K*B + 1, Lq) table is outside that cap. The JAX package gathers bf16
    centroid rows and multiplies them by Q per chunk instead; at dim 128
    and Lq 32 that moves twice the bytes per token (256 B of centroid row
    against 128 B of table row), and it writes the (c, Ld, Lq) scores that
    the bag's max never materializes."""
    B, W = offs.shape
    Lq = Q.shape[1]
    Ld = max_doclen
    K = centroids.shape[0]
    dev = Q.device
    q16 = Q.to(torch.bfloat16).float().reshape(B * Lq, -1)
    c16 = centroids.to(torch.bfloat16).float()
    table = torch.empty((K * B + 1, Lq), dtype=torch.float32, device=dev)
    torch.mm(c16, q16.T, out=table[:K * B].view(K, B * Lq))
    table[K * B] = 0.0
    ar = torch.arange(Ld, device=dev)
    qrow = torch.arange(B, device=dev)[:, None, None]
    chunk = max(1, chunk_bytes // refine_column_bytes(B, Ld, Lq))
    out = torch.empty((B, W), dtype=torch.float32, device=dev)
    for s in range(0, W, chunk):
        off, dl = offs[:, s:s + chunk], dls[:, s:s + chunk]            # (B, c)
        rows = off[..., None] + ar                                     # (B, c, Ld)
        rows.copy_(codes[rows])                                        # token codes
        rows.mul_(B).add_(qrow).masked_fill_(ar >= dl[..., None], K * B)
        per_q = torch.nn.functional.embedding_bag(
            rows.view(-1, Ld), table, mode="max", padding_idx=K * B)     # (B*c, Lq)
        out[:, s:s + chunk] = per_q.sum(dim=-1).view(B, -1)
    return out


def score_table(Q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """The kernel's table: (B, K, Lq) fp32, query-major, ``table[b, k, q] =
    <bf16(Q[b, q]), bf16(centroids[k])>`` from one batched product of the
    bf16 operands into fp32 (``aten::bmm.dtype``; the centroids broadcast
    over the batch with a zero stride, never copied)."""
    B, Lq, dim = Q.shape
    K = centroids.shape[0]
    c16 = centroids.to(torch.bfloat16).expand(B, K, dim)
    return torch.bmm(c16, Q.to(torch.bfloat16).mT, out_dtype=torch.float32)


def _check(Q, offs, dls, codes, centroids):
    dev = Q.device
    tensors = dict(Q=Q, offs=offs, dls=dls, codes=codes, centroids=centroids)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    want = dict(Q=torch.float32, offs=torch.int64, dls=torch.int32, codes=torch.int32,
                centroids=torch.float32)
    for name, dt in want.items():
        if tensors[name].dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {tensors[name].dtype}")
    if Q.dim() != 3 or offs.dim() != 2 or offs.shape != dls.shape:
        raise ValueError("Q must be (B, Lq, dim) and offs/dls (B, W)")
    if offs.shape[0] != Q.shape[0] or centroids.dim() != 2 or centroids.shape[1] != Q.shape[2]:
        raise ValueError("offs rows must equal B and centroids be (K, dim)")
    if codes.dim() != 1:
        raise ValueError("codes must be flat")


def _launch(table: torch.Tensor, offs: torch.Tensor, dls: torch.Tensor,
            codes: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel (built from ``KERNEL_SOURCE`` at first use)
    over a :func:`score_table` and checked CUDA tensors -> ``(B, W)``
    scores; counts it."""
    if _lib is None:
        build_kernel()
    B, K, Lq = table.shape
    W = offs.shape[1]
    out = torch.empty((B, W), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = getattr(_lib, _ENTRY)(table.data_ptr(), offs.data_ptr(), dls.data_ptr(),
                                   codes.data_ptr(), out.data_ptr(), B, W, K, Lq, stream)
    if rc != 0:
        raise RuntimeError(f"approx_maxsim kernel launch failed (code {rc})")
    approx_maxsim.launches += 1
    approx_maxsim.variant_launches["table"] += 1
    return out


def approx_maxsim(Q: torch.Tensor, offs: torch.Tensor, dls: torch.Tensor,
                  codes: torch.Tensor, centroids: torch.Tensor, *, max_doclen: int,
                  chunk_bytes: int = REFINE_CHUNK_BYTES) -> torch.Tensor:
    """Refine scores ``(B, W)`` f32 for ``Q (B, Lq, dim)`` f32, candidate
    token offsets ``offs (B, W)`` int64 and doclens ``dls (B, W)`` int32 over
    the flat ``codes`` (int32) and ``centroids (K, dim)`` f32. CUDA tensors
    go through the table product and the kernel; CPU tensors through
    :func:`approx_maxsim_plain` (which alone reads ``max_doclen`` and
    ``chunk_bytes``)."""
    _check(Q, offs, dls, codes, centroids)
    if Q.device.type == "cpu":
        return approx_maxsim_plain(Q, offs, dls, codes, centroids, max_doclen=max_doclen,
                                   chunk_bytes=chunk_bytes)
    if Q.device.type != "cuda":
        raise ValueError(f"approx_maxsim runs on cuda or cpu, not {Q.device}")
    return _launch(score_table(Q, centroids), offs, dls, codes)


approx_maxsim.launches = 0
approx_maxsim.variant_launches = {"table": 0}
