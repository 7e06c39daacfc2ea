"""Encode pipeline: texts -> token embeddings (port of ``colbert_tpu.models.encoder``).

``ColBERTEncoder`` bundles the model, the tokenizer and the config: the
query/doc marker ids, the skiplist, ``encode_queries`` and the doc side of
the build path:

  - doc batches are sorted by token length within groups of
    ``passages_batch_size`` and padded to length buckets,
  - every batch is launched on the device at once and its result copied
    back asynchronously into pinned host memory, with at most
    ``MAX_INFLIGHT`` batches outstanding; a CUDA event per batch is
    synchronized before its host copy is read,
  - only kept rows (or only codes and packed residuals) leave the device,
    and one vectorized scatter per batch restores passage order,
  - attention routes through the flash-attention kernel where
    ``_flash_for`` allows: on CUDA with ``config.use_pallas``, at padded
    lengths >= ``config.flash_min_seqlen`` that are multiples of 128
    (length buckets are then forced to 128, ``strict_multiple``). On the
    CPU nothing routes there and buckets stay as configured, as in the JAX
    package on its CPU backend,
  - with a mesh attached (:meth:`ColBERTEncoder.attach_mesh`) every batch
    pads to a multiple of the data axis and each data shard encodes its
    rows on its own device (and, with a model axis above 1, through a
    tensor-parallel model); doc outputs then leave the device as padded
    blocks, not compacted rows, and the pad rows are dropped at drain.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Sequence

import numpy as np
import torch

from colbert_torch.config import ColBERTConfig
from colbert_torch.models.colbert import ColBERT, skiplist_keep_mask
from colbert_torch.ops import codec as codec_ops
from colbert_torch.tokenization.native import NativeWordPiece
from colbert_torch.tokenization.tensorize import (
    build_skiplist,
    tensorize_docs,
    tensorize_queries,
)
from colbert_torch.tokenization.wordpiece import WordPieceTokenizer
from colbert_torch.utils.build import resolve_device

__all__ = ["ColBERTEncoder", "MAX_INFLIGHT"]

# batches allowed in flight (launched, host copy not yet read) before the
# pipeline drains the oldest; bounds the device memory held by outputs
MAX_INFLIGHT = 8


def _take_rows(keep: np.ndarray) -> tuple[np.ndarray, int]:
    """keep mask (B, L) -> (take (M,) int32 flat kept-row indices padded to a
    2048-row bucket with copies of row 0, real count)."""
    flat = np.flatnonzero(keep.reshape(-1)).astype(np.int32)
    v = flat.shape[0]
    m = max(2048, -(-v // 2048) * 2048)
    take = np.zeros((m,), np.int32)
    take[:v] = flat
    return take, v


def _scatter_compact_rows(out: np.ndarray, dest_offsets: np.ndarray, idx: np.ndarray,
                          counts: np.ndarray, values: np.ndarray) -> None:
    """Scatter one batch's already-compacted kept rows ``values (M, ...)``
    (passage ``idx[r]``'s ``counts[r]`` rows contiguous, in batch order)
    into the global flat array at ``dest_offsets[idx[r]]``."""
    total = int(counts.sum())
    if total == 0:
        return
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    dest = np.repeat(dest_offsets[idx], counts) + within
    vals = values[:total]
    out[dest] = vals if vals.dtype == out.dtype else vals.astype(out.dtype)


def _scatter_compact(out: np.ndarray, dest_offsets: np.ndarray, idx: np.ndarray,
                     keep: np.ndarray, values: np.ndarray) -> None:
    """Scatter one batch's kept token rows of ``values (B, L, ...)`` into the
    global flat array: row ``r`` holds passage ``idx[r]``, whose kept
    tokens land at ``dest_offsets[idx[r]] + [0..)`` (reference
    embedding_utils.jl:195-205, with original-order restore)."""
    counts = keep.sum(axis=1).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    dest = np.repeat(dest_offsets[idx], counts) + within
    vals = values[keep]
    out[dest] = vals if vals.dtype == out.dtype else vals.astype(out.dtype)


def _start_host_copy(t: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """Start a device->host copy of ``t`` -> (host tensor, event to
    synchronize before reading it). A CUDA tensor is copied into pinned
    memory without blocking; a CPU tensor is its own host copy."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _host_numpy(host: torch.Tensor, nrows: int) -> np.ndarray:
    """A drained host copy -> numpy: the first ``nrows`` rows; bf16/fp16
    upcast to fp32, int8 dequantized (``x / 127``), int32 codes as uint32."""
    h = host[:nrows]
    if h.dtype in (torch.bfloat16, torch.float16):
        return h.float().numpy()
    if h.dtype == torch.int8:
        return h.numpy().astype(np.float32) / 127.0
    if h.dtype == torch.int32:
        return h.numpy().view(np.uint32)
    return h.numpy()


@dataclass
class ColBERTEncoder:
    """Model + tokenizer + config; the model is moved to ``device``."""

    model: ColBERT
    tokenizer: WordPieceTokenizer
    config: ColBERTConfig
    device: str | torch.device = "cuda"
    skiplist: list[int] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device).eval()
        if not self.skiplist:
            self.skiplist = build_skiplist(self.tokenizer, self.config.mask_punctuation)
        self.doc_token_id = self.tokenizer.token_to_id(self.config.doc_token_id)
        self.query_token_id = self.tokenizer.token_to_id(self.config.query_token_id)
        self._native_tok = NativeWordPiece(self.tokenizer)
        # flash attention: on the card only, and only at padded lengths >=
        # config.flash_min_seqlen; the kernel needs S % 128 == 0, so where
        # flash can trigger the length buckets become 128 wide
        self._flash_capable = bool(self.config.use_pallas) and self.device.type == "cuda"
        self.length_bucket = self.config.length_bucket
        self._strict_buckets = (
            self._flash_capable
            and self.config.doc_maxlen >= self.config.flash_min_seqlen
        )
        if self._strict_buckets and self.length_bucket % 128 != 0:
            self.length_bucket = 128
        self.mesh = None
        self._replicas: dict[int, ColBERT] = {}

    def attach_mesh(self, mesh) -> None:
        """Encode and train data-parallel over ``mesh``: batches split over
        its data axis, each shard through its own model
        (:func:`colbert_torch.parallel.tp.shard_params`: the model
        replicated on the shard's device, or with a model axis above 1 split
        Megatron-style over the shard's model group), built for the data
        shards this process owns. Encode outputs gather on this encoder's
        device, so an encode needs every data shard in this process; a mesh
        that spans processes trains (:class:`colbert_torch.training.ColBERTTrainer`)
        but does not encode."""
        from colbert_torch.parallel import launch
        from colbert_torch.parallel.tp import shard_params

        self._replicas = shard_params(self.model, mesh, launch.owned_data_shards(mesh))
        self.mesh = mesh

    def refresh_replicas(self) -> None:
        """Copy ``self.model``'s weights into the mesh's replicas and shards
        (after an optimizer step on the model), so that every later mesh
        encode is the current model's."""
        from colbert_torch.parallel.tp import refresh_replicas

        refresh_replicas(self.model, self._replicas)

    @property
    def bert_config(self):
        return self.model.bert_config

    @property
    def dim(self) -> int:
        return self.model.dim

    def _put_batch(self, *arrays: np.ndarray, device: torch.device | None = None
                   ) -> list[torch.Tensor]:
        """Host arrays -> tensors on ``device`` (default: the encoder's),
        int32 token ids widened to int64."""
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if t.dtype == torch.int32:
                t = t.long()
            out.append(t.to(device or self.device, non_blocking=True))
        return out

    def _forward(self, method: str, ids: np.ndarray, mask: np.ndarray, keep: np.ndarray,
                 *extra: torch.Tensor, **kw):
        """``self.model.<method>(ids, mask, keep, *extra, **kw)`` on one host
        batch. Under a mesh the rows pad to a multiple of the data axis
        (pad rows have empty masks), each data shard runs its rows through
        its own model on its device, and the outputs (a tensor or a tuple)
        gather on the encoder's device in shard order, pad rows included:
        callers keep the leading ``ids.shape[0]`` rows."""
        if self.mesh is None:
            return getattr(self.model, method)(*self._put_batch(ids, mask, keep), *extra, **kw)
        ndev = self.mesh.shape["data"]
        if sorted(self._replicas) != list(range(ndev)):
            raise ValueError("a mesh encode needs every data shard in this process")
        n = ids.shape[0]
        pad = -(-n // ndev) * ndev - n
        if pad:
            ids, mask, keep = (np.pad(a, ((0, pad), (0, 0))) for a in (ids, mask, keep))
        rows = ids.shape[0] // ndev
        outs = []
        for s, model in self._replicas.items():
            dev = self.mesh.data_device(s)
            part = [a[s * rows:(s + 1) * rows] for a in (ids, mask, keep)]
            outs.append(getattr(model, method)(*self._put_batch(*part, device=dev),
                                               *(e.to(dev) for e in extra), **kw))
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[i].to(self.device) for o in outs])
                         for i in range(len(outs[0])))
        return torch.cat([o.to(self.device) for o in outs])

    def tokenize_batch(self, texts) -> list[list[int]]:
        """Lists and byte-backed Collections both go to the native tokenizer."""
        return self._native_tok.encode_batch(texts)

    def _flash_for(self, padded_len: int) -> bool:
        """Per-batch routing of attention to the flash kernel."""
        return (
            self._flash_capable
            and padded_len >= self.config.flash_min_seqlen
            and padded_len % 128 == 0
        )

    # -- passages ------------------------------------------------------------

    def _doc_batches(
        self, passages: Sequence[str]
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Length-sorted batches -> (orig_indices, ids, attn_mask, keep_mask).

        Passages are tokenized in groups of ``config.passages_batch_size``;
        within a group, batches of ``index_bsize`` are taken in token-length
        order (a stable sort) and padded to their own length bucket."""
        cfg = self.config
        bsize = cfg.index_bsize
        group = max(cfg.passages_batch_size, bsize)
        for glo in range(0, len(passages), group):
            ghi = min(len(passages), glo + group)
            token_ids = self.tokenize_batch(passages[glo:ghi])
            order = glo + np.argsort([len(t) for t in token_ids], kind="stable")
            for start in range(0, ghi - glo, bsize):
                idx = order[start:start + bsize]
                ids, mask = tensorize_docs(
                    (), self.tokenizer,
                    doc_token_id=self.doc_token_id,
                    doc_maxlen=cfg.doc_maxlen,
                    length_bucket=self.length_bucket,
                    encoded=[token_ids[i - glo] for i in idx],
                    strict_multiple=self._strict_buckets,
                )
                keep = skiplist_keep_mask(ids, mask, self.skiplist)
                yield idx, ids, mask, keep

    def _pipeline_batches(self, passages, dispatch):
        """Launch every doc batch with at most ``MAX_INFLIGHT`` host copies
        outstanding. ``dispatch(idx, ids, mask, keep) -> (tuple of device
        tensors, nrows)``, ``nrows`` being how many leading rows of each
        output are real. -> (drained [(idx, keep, host arrays...)], doclens)."""
        doclens = np.zeros((len(passages),), np.int64)

        def drain(item):
            idx, keep, copies, nrows = item
            host = []
            for h, event in copies:
                if event is not None:
                    event.synchronize()
                host.append(_host_numpy(h, nrows))
            return (idx, keep, *host)

        drained, pending = [], []
        with torch.no_grad():
            for idx, ids, mask, keep in self._doc_batches(passages):
                outs, nrows = dispatch(idx, ids, mask, keep)
                doclens[idx] = keep.sum(axis=1)
                pending.append((idx, keep, [_start_host_copy(o) for o in outs], nrows))
                if len(pending) > MAX_INFLIGHT:
                    drained.append(drain(pending.pop(0)))
        drained.extend(drain(p) for p in pending)
        return drained, doclens

    def encode_passages(self, passages: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """-> (flat embeddings (sum doclens, dim) fp32, doclens (N,) int64) in
        passage order. Only kept rows leave the device, in
        ``config.transfer_dtype``; the result is always fp32."""
        cfg = self.config
        n = len(passages)
        if n == 0:
            return np.zeros((0, self.dim), np.float32), np.zeros((0,), np.int64)

        compact = self.mesh is None  # a mesh ships padded blocks

        def dispatch(idx, ids, mask, keep):
            kw = dict(dtype_name=cfg.activation_dtype, out_dtype_name=cfg.transfer_dtype,
                      use_flash=self._flash_for(ids.shape[1]))
            if not compact:
                return (self._forward("encode_batch", ids, mask, keep, **kw),), len(idx)
            take, v = _take_rows(keep)
            ids_d, mask_d, keep_d, take_d = self._put_batch(ids, mask, keep, take)
            return (self.model.encode_compact_batch(ids_d, mask_d, keep_d, take_d, **kw),), v

        drained, doclens = self._pipeline_batches(passages, dispatch)
        dest_offsets = np.concatenate([[0], np.cumsum(doclens[:-1])])
        flat = np.empty((int(doclens.sum()), self.dim), np.float32)
        for idx, keep, emb in drained:
            if compact:
                counts = keep.sum(axis=1).astype(np.int64)
                _scatter_compact_rows(flat, dest_offsets, idx, counts, emb)
            else:
                _scatter_compact(flat, dest_offsets, idx, keep, emb)
        return flat, doclens

    @torch.no_grad()
    def encode_passages_to_device(self, passages: Sequence[str], *,
                                  return_layout: bool = False):
        """-> (padded flat embeddings on the device (M, dim) bf16, valid (M,)
        host bool, doclens (N,) host); with ``return_layout`` a fourth element
        lists each batch block's (orig_indices, keep, row_offset, B, L) so
        that :meth:`compress_sample_to_host` can map rows back to passages.

        The codec-training sample never leaves the device: the padded batch
        blocks are written one after another into one preallocated buffer
        (rows padded up to the codec trainer's bucket), and the host-side
        ``valid`` mask marks the real token rows. Row order is encode order.
        The buffer is bf16 (k-means and the quantiles accumulate in fp32)
        and starts as zeros, not uninitialized memory: its padding rows carry
        weight 0 in k-means, and 0 * NaN would poison the sums."""
        from colbert_torch.indexing.codec_trainer import sample_bucket_step

        cfg = self.config
        n = len(passages)
        if n == 0:
            empty = (torch.zeros((0, self.dim), dtype=torch.bfloat16, device=self.device),
                     np.zeros((0,), bool), np.zeros((0,), np.int64))
            return empty + ([],) if return_layout else empty
        batches = list(self._doc_batches(passages))
        ndev = 1 if self.mesh is None else self.mesh.shape["data"]
        total = sum(-(-ids.shape[0] // ndev) * ndev * ids.shape[1]
                    for _, ids, _, _ in batches)
        step = sample_bucket_step(total)
        padded = -(-total // step) * step

        doclens = np.zeros((n,), np.int64)
        valid = np.zeros((padded,), bool)
        layout: list[tuple] = []
        buf = torch.zeros((padded, self.dim), dtype=torch.bfloat16, device=self.device)
        offset = 0
        for idx, ids, mask, keep in batches:
            emb = self._forward("encode_batch", ids, mask, keep,
                                dtype_name=cfg.activation_dtype,
                                use_flash=self._flash_for(ids.shape[1]))
            B, L, dim = emb.shape  # B counts a mesh's pad rows (valid=False)
            buf[offset:offset + B * L] = emb.reshape(B * L, dim)
            valid[offset:offset + len(idx) * L] = keep.reshape(-1)
            doclens[idx] = keep.sum(axis=1)
            layout.append((idx, keep, offset, B, L))
            offset += B * L
        if return_layout:
            return buf, valid, doclens, layout
        return buf, valid, doclens

    @torch.no_grad()
    def compress_sample_to_host(
        self, buf: torch.Tensor, layout: list[tuple], doclens: np.ndarray,
        centroids: torch.Tensor, bucket_cutoffs: torch.Tensor, *, nbits: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Compress an encoded device-resident sample -> host (codes (M,)
        uint32, packed residuals (M, nbytes) uint8) in passage order: the
        small-corpus fast path, where the sample is the whole collection and
        a second encode is not needed. The sample is bf16, so codes and
        bucket indices can differ from the fp32 fused path at near-ties."""
        codes_d, res_d = codec_ops.compress(buf, centroids, bucket_cutoffs, nbits=nbits)
        codes_h = codes_d.cpu().numpy().view(np.uint32)
        res_h = res_d.cpu().numpy()
        nbytes = self.dim // 8 * nbits
        dest_offsets = np.concatenate([[0], np.cumsum(doclens[:-1])])
        total = int(doclens.sum())
        flat_codes = np.empty((total,), np.uint32)
        flat_res = np.empty((total, nbytes), np.uint8)
        for idx, keep, offset, B, L in layout:
            blk_codes = codes_h[offset:offset + B * L].reshape(B, L)[:len(idx)]
            blk_res = res_h[offset:offset + B * L].reshape(B, L, nbytes)[:len(idx)]
            _scatter_compact(flat_codes, dest_offsets, idx, keep, blk_codes)
            _scatter_compact(flat_res, dest_offsets, idx, keep, blk_res)
        return flat_codes, flat_res

    def encode_passages_compressed(
        self, passages: Sequence[str], centroids: torch.Tensor,
        bucket_cutoffs: torch.Tensor, *, nbits: int,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fused encode+compress -> (codes (M,) uint32, packed residuals
        (M, nbytes) uint8, doclens (N,)) in passage order, on the host. Only
        the kept rows' codes and residuals leave the device."""
        cfg = self.config
        n = len(passages)
        nbytes = self.dim // 8 * nbits
        if n == 0:
            return (np.zeros((0,), np.uint32), np.zeros((0, nbytes), np.uint8),
                    np.zeros((0,), np.int64))

        compact = self.mesh is None  # a mesh ships padded blocks

        def dispatch(idx, ids, mask, keep):
            kw = dict(dtype_name=cfg.activation_dtype, nbits=nbits,
                      use_flash=self._flash_for(ids.shape[1]))
            if not compact:
                return self._forward("encode_compress_batch", ids, mask, keep, centroids,
                                     bucket_cutoffs, **kw), len(idx)
            take, v = _take_rows(keep)
            ids_d, mask_d, keep_d, take_d = self._put_batch(ids, mask, keep, take)
            return self.model.encode_compress_compact_batch(
                ids_d, mask_d, keep_d, centroids, bucket_cutoffs, take_d, **kw), v

        drained, doclens = self._pipeline_batches(passages, dispatch)
        dest_offsets = np.concatenate([[0], np.cumsum(doclens[:-1])])
        total = int(doclens.sum())
        flat_codes = np.empty((total,), np.uint32)
        flat_res = np.empty((total, nbytes), np.uint8)
        for idx, keep, codes, res in drained:
            if compact:
                counts = keep.sum(axis=1).astype(np.int64)
                _scatter_compact_rows(flat_codes, dest_offsets, idx, counts, codes)
                _scatter_compact_rows(flat_res, dest_offsets, idx, counts, res)
            else:
                _scatter_compact(flat_codes, dest_offsets, idx, keep, codes)
                _scatter_compact(flat_res, dest_offsets, idx, keep, res)
        return flat_codes, flat_res, doclens

    # -- queries -------------------------------------------------------------

    def tensorize_queries(self, queries: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """-> (ids (N, query_maxlen) int32, attention mask bool) on the host."""
        cfg = self.config
        return tensorize_queries(
            queries, self.tokenizer,
            query_token_id=self.query_token_id,
            query_maxlen=cfg.query_maxlen,
            attend_to_mask_tokens=cfg.attend_to_mask_tokens,
        )

    @torch.no_grad()
    def encode_query_tokens(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Token ids -> ``(N, query_maxlen, dim)`` fp32 embeddings on the
        device. The query skiplist is pad-only and pads became [MASK], so
        every position is kept (reference searching.jl:62). Under a mesh the
        batch splits over the data shards and the pad rows are dropped."""
        ids = np.asarray(ids, np.int64)
        mask = np.asarray(mask)
        Q = self._forward("forward_normalized", ids, mask, np.ones_like(mask),
                          dtype_name=self.config.activation_dtype)
        return Q[:ids.shape[0]]

    def encode_queries_device(self, queries: Sequence[str]) -> torch.Tensor:
        """-> ``(N, query_maxlen, dim)`` fp32 query embeddings on the device."""
        return self.encode_query_tokens(*self.tensorize_queries(list(queries)))

    def encode_queries(self, queries: Sequence[str]) -> np.ndarray:
        """-> ``(N, query_maxlen, dim)`` fp32 normalized query embeddings,
        encoded in ``index_bsize`` batches."""
        cfg = self.config
        out = np.zeros((len(queries), cfg.query_maxlen, self.dim), np.float32)
        bsize = cfg.index_bsize
        for start in range(0, len(queries), bsize):
            batch = list(queries[start:start + bsize])
            out[start:start + len(batch)] = (
                self.encode_queries_device(batch).cpu().numpy())
        return out
