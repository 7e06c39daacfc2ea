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
    package on its CPU backend. A ModernBERT model sends both its layer
    kinds there, local layers windowed; a DeepSeek-V3 model refuses it
    (its configuration keeps ``flash_min_seqlen`` above ``doc_maxlen``),
  - one step (``_doc_step``) picks each doc batch's route and gives its
    embeddings on the encoder's device: with no mesh, a full batch
    (``index_bsize`` rows) of at most ``MAX_GRAPH_TOKENS`` padded tokens
    replays one captured program per static key
    (:mod:`colbert_torch.retrieval.program`: the forward, the compaction
    and the cast, one CUDA graph on a card, the same code run eagerly on
    its static buffers on the CPU), the encoder's own ``programs``; with a
    mesh attached (:meth:`ColBERTEncoder.attach_mesh`) the batch pads to a
    multiple of the data axis, each data shard encodes its rows on its own
    device (and, with a model axis above 1, through a tensor-parallel
    model) and the rows gather on the encoder's device; every other batch
    (a group's last, a long one) runs op by op. The three doc encodes
    consume it: the host copy, the codec after it, the sample buffer.
    Counters: ``doc_replays``, ``doc_captures`` (a key's first batch: its
    warm-up, then on a card its capture, counted with
    ``doc_eager_batches``) and ``doc_eager_batches``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Sequence

import numpy as np
import torch

from colbert_torch.config import ColBERTConfig
from colbert_torch.models.colbert import (
    ColBERT,
    _to_out_dtype,
    compress_rows,
    skiplist_keep_mask,
)
from colbert_torch.models.deepseek_v3 import DeepseekV3Config
from colbert_torch.models.modernbert import ModernBertConfig
from colbert_torch.ops import codec as codec_ops
from colbert_torch.retrieval.program import Program, ProgramCache, input_dtype, tensor_signature
from colbert_torch.tokenization.native import NativeWordPiece
from colbert_torch.tokenization.tensorize import (
    build_skiplist,
    tensorize_docs,
    tensorize_queries,
)
from colbert_torch.tokenization.wordpiece import WordPieceTokenizer
from colbert_torch.utils import tracing
from colbert_torch.utils.build import resolve_device

__all__ = ["ColBERTEncoder", "DOC_PROGRAMS", "MAX_GRAPH_TOKENS", "MAX_INFLIGHT"]

# batches allowed in flight (launched, host copy not yet read) before the
# pipeline drains the oldest; bounds the device memory held by outputs
MAX_INFLIGHT = 8
# padded tokens (B x L) up to which a full doc batch replays a captured
# program: index_bsize 64 x BERT's 512 positions. Past it a batch keeps the
# card busy for hundreds of ms against tens of ms of launches (ModernBERT's
# long documents), so a graph would add only its pool and its capture
MAX_GRAPH_TOKENS = 32_768
# doc programs an encoder keeps: every (route, L, M) key of a build, with
# room for the other length buckets up to doc_maxlen, so a build never
# evicts and captures again
DOC_PROGRAMS = 32


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
    _scatter_compact_rows(out, dest_offsets, idx, keep.sum(axis=1).astype(np.int64),
                          values[keep])


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
        arch = self.model.bert_config
        positions = arch.max_position_embeddings
        if isinstance(arch, (ModernBertConfig, DeepseekV3Config)) and \
                self.config.doc_maxlen > positions:
            raise ValueError(f"doc_maxlen {self.config.doc_maxlen} is above the "
                             f"{positions} positions {type(arch).__name__} declares")
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
        self.programs = ProgramCache(DOC_PROGRAMS)

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
        int32 token ids widened to int64 (the span ``h2d``)."""
        out = []
        with tracing.span("h2d"):
            for a in arrays:
                t = torch.from_numpy(np.ascontiguousarray(a))
                if t.dtype == torch.int32:
                    t = t.long()
                out.append(t.to(device or self.device, non_blocking=True))
        return out

    def _shard_forward(self, ids: np.ndarray, mask: np.ndarray, keep: np.ndarray,
                       **kw) -> torch.Tensor:
        """``forward_normalized`` of one host batch over the mesh: the rows pad
        to a multiple of the data axis (pad rows have empty masks), each data
        shard runs its rows through its own model on its device, and the
        outputs gather on the encoder's device in shard order, pad rows
        included: callers keep the leading ``ids.shape[0]`` rows."""
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
            part = [a[s * rows:(s + 1) * rows] for a in (ids, mask, keep)]
            outs.append(model.forward_normalized(
                *self._put_batch(*part, device=self.mesh.data_device(s)), **kw))
        return torch.cat([o.to(self.device) for o in outs])

    def _doc_step(self, *, compact: bool, out_dtype_name: str | None = None):
        """-> ``step(ids, mask, keep) -> (embeddings on the encoder's device,
        real rows)`` for one doc encode: the one place a doc batch's route is
        chosen. With ``compact`` a batch gives its kept rows ``(M, dim)``
        (:func:`_take_rows`: the real ones lead), else its padded block
        ``(B, L, dim)`` (a mesh's pad rows after the ``B`` real ones); fp32,
        or cast to ``out_dtype_name``.

        A full batch (``index_bsize`` rows) of at most ``MAX_GRAPH_TOKENS``
        padded tokens with no mesh replays the program of its key (the route,
        the arrays' shapes, the dtype, the flash route and the parameters'
        addresses, shapes and dtypes, taken once per encode: a reload or a
        re-bound parameter gives new keys, an in-place update is read by the
        next replay); its outputs stay on the device, read on the caller's
        stream before the next batch. Under a mesh the data shards run the
        forward and the encoder's device compacts and casts. Any other batch
        runs op by op on the encoder's device."""
        cfg, model = self.config, self.model
        signature = tensor_signature(list(model.parameters()))

        def finish(emb, *take):
            if take:
                emb = emb.reshape(-1, emb.shape[-1])[take[0]]
            return emb if out_dtype_name is None else _to_out_dtype(emb, out_dtype_name)

        def step(ids: np.ndarray, mask: np.ndarray, keep: np.ndarray
                 ) -> tuple[torch.Tensor, int]:
            B, L = ids.shape
            kw = dict(dtype_name=cfg.activation_dtype, use_flash=self._flash_for(L))
            arrays, nrows = [ids, mask, keep], B
            if compact:
                take, nrows = _take_rows(keep)
                arrays.append(take)
            prog = None
            if self.mesh is None and B == cfg.index_bsize and B * L <= MAX_GRAPH_TOKENS:
                key = (compact, out_dtype_name, tuple(a.shape for a in arrays),
                       tuple(sorted(kw.items())), signature)
                prog = self.programs.get(key, lambda: Program(
                    lambda i, m, k, *t: (finish(model.forward_normalized(i, m, k, **kw), *t),),
                    [a.shape for a in arrays], [input_dtype(a) for a in arrays], self.device))
                tracing.count("doc_replays" if prog.launches else "doc_captures")
            if prog is None or not prog.launches:  # a key's first batch runs eagerly
                tracing.count("doc_eager_batches")
            if prog is None and self.mesh is None:
                tensors = self._put_batch(*arrays)
            with tracing.span("forward"):
                if prog is not None:
                    (out,), _, _ = prog.launch(*arrays, to_host=False)
                elif self.mesh is None:
                    out = finish(model.forward_normalized(*tensors[:3], **kw), *tensors[3:])
                else:
                    out = finish(self._shard_forward(ids, mask, keep, **kw),
                                 *self._put_batch(*arrays[3:]))
            return out, nrows

        return step

    def tokenize_batch(self, texts) -> list[list[int]]:
        """Lists and byte-backed Collections both go to the native tokenizer,
        which keeps passages of up to ``doc_maxlen`` tokens (at least 512):
        a longer one goes to the Python tokenizer."""
        return self._native_tok.encode_batch(texts, self.config.doc_maxlen)

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
            with tracing.span("doc_tokenize"):
                token_ids = self.tokenize_batch(passages[glo:ghi])
                order = glo + np.argsort([len(t) for t in token_ids], kind="stable")
            for start in range(0, ghi - glo, bsize):
                with tracing.span("doc_tensorize"):
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
                if tracing.active():
                    tracing.count("doc_batches")
                    tracing.count("doc_tokens", int(mask.sum()))
                    tracing.count("doc_slots", mask.size)
                yield idx, ids, mask, keep

    def _pipeline_batches(self, passages, dispatch):
        """Launch every doc batch with at most ``MAX_INFLIGHT`` host copies
        outstanding. ``dispatch(idx, ids, mask, keep) -> (list of (host
        tensor, event or None) copies, nrows)``, ``nrows`` being how many
        leading rows of each output are real. -> (drained [(idx, keep, host
        arrays...)], doclens)."""
        doclens = np.zeros((len(passages),), np.int64)

        def drain(item):
            idx, keep, copies, nrows = item
            host = []
            with tracing.span("doc_drain"):
                for h, event in copies:
                    if event is not None:
                        with tracing.span("doc_wait"):
                            event.synchronize()
                    host.append(_host_numpy(h, nrows))
            return (idx, keep, *host)

        drained, pending = [], []
        with torch.no_grad():
            for idx, ids, mask, keep in self._doc_batches(passages):
                with tracing.span("doc_dispatch"):
                    copies, nrows = dispatch(idx, ids, mask, keep)
                    doclens[idx] = keep.sum(axis=1)
                    pending.append((idx, keep, copies, nrows))
                if len(pending) > MAX_INFLIGHT:
                    drained.append(drain(pending.pop(0)))
        drained.extend(drain(p) for p in pending)
        return drained, doclens

    def _encode_to_host(self, passages: Sequence[str], outputs, out_dtype_name=None
                        ) -> tuple[list[np.ndarray], np.ndarray]:
        """Every doc batch's kept rows (:meth:`_doc_step`), through
        ``outputs(rows) -> device tensors``, copied to the host and scattered
        into passage order -> (one flat host array per output, doclens)."""
        embed = self._doc_step(compact=True, out_dtype_name=out_dtype_name)

        def dispatch(idx, ids, mask, keep):
            rows, nrows = embed(ids, mask, keep)
            return [_start_host_copy(o) for o in outputs(rows)], nrows

        drained, doclens = self._pipeline_batches(passages, dispatch)
        with tracing.span("doc_scatter"):
            dest_offsets = np.concatenate([[0], np.cumsum(doclens[:-1])])
            total = int(doclens.sum())
            flats = [np.empty((total, *h.shape[1:]), h.dtype) for h in drained[0][2:]]
            for idx, keep, *host in drained:
                counts = keep.sum(axis=1).astype(np.int64)
                for flat, h in zip(flats, host):
                    _scatter_compact_rows(flat, dest_offsets, idx, counts, h)
        return flats, doclens

    def encode_passages(self, passages: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """-> (flat embeddings (sum doclens, dim) fp32, doclens (N,) int64) in
        passage order. Only kept rows leave the device, in
        ``config.transfer_dtype``; the result is always fp32."""
        if len(passages) == 0:
            return np.zeros((0, self.dim), np.float32), np.zeros((0,), np.int64)
        (flat,), doclens = self._encode_to_host(passages, lambda rows: (rows,),
                                                self.config.transfer_dtype)
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

        n = len(passages)
        if n == 0:
            empty = (torch.zeros((0, self.dim), dtype=torch.bfloat16, device=self.device),
                     np.zeros((0,), bool), np.zeros((0,), np.int64))
            return empty + ([],) if return_layout else empty
        batches = list(self._doc_batches(passages))
        ndev = 1 if self.mesh is None else self.mesh.shape["data"]
        total = sum(-(-ids.shape[0] // ndev) * ndev * ids.shape[1]
                    for _, ids, _, _ in batches)
        bucket = sample_bucket_step(total)
        padded = -(-total // bucket) * bucket

        doclens = np.zeros((n,), np.int64)
        valid = np.zeros((padded,), bool)
        layout: list[tuple] = []
        buf = torch.zeros((padded, self.dim), dtype=torch.bfloat16, device=self.device)
        offset = 0
        embed = self._doc_step(compact=False)
        for idx, ids, mask, keep in batches:
            with tracing.span("doc_dispatch"):
                emb, _ = embed(ids, mask, keep)
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
        """Encode+compress -> (codes (M,) uint32, packed residuals
        (M, nbytes) uint8, doclens (N,)) in passage order, on the host. Only
        the kept rows' codes and residuals leave the device."""
        if len(passages) == 0:
            return (np.zeros((0,), np.uint32), np.zeros((0, self.dim // 8 * nbits), np.uint8),
                    np.zeros((0,), np.int64))
        # the codec runs after the step, so the codebook's size is no part of
        # a program's key
        (codes, residuals), doclens = self._encode_to_host(
            passages, lambda rows: compress_rows(rows, centroids, bucket_cutoffs, nbits))
        return codes, residuals, doclens

    # -- queries -------------------------------------------------------------

    def tensorize_queries(self, queries: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """-> (ids (N, query_maxlen) int32, attention mask bool) on the host,
        tokenized by the native WordPiece (texts it took counted as
        ``query_tokenize_native``; those sent to the Python tokenizer, every
        text where the library is not loaded, as ``query_tokenize_fallback``),
        byte-identical to the Python path."""
        cfg = self.config
        ids, lens, n_fallback = self._native_tok.encode_array(queries, cfg.query_maxlen - 3)
        tracing.count("query_tokenize_native", len(queries) - n_fallback)
        tracing.count("query_tokenize_fallback", n_fallback)
        return tensorize_queries(
            queries, self.tokenizer, encoded=(ids, lens),
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
        keep = np.ones_like(mask)
        kw = dict(dtype_name=self.config.activation_dtype)
        if self.mesh is not None:
            return self._shard_forward(ids, mask, keep, **kw)[:ids.shape[0]]
        tensors = self._put_batch(ids, mask, keep)
        with tracing.span("forward"):
            return self.model.forward_normalized(*tensors, **kw)

    def encode_query_device(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Token ids and mask already on the encoder's device -> ``(N, L,
        dim)`` fp32 embeddings, with no host work: the query encode of a
        captured serving program, which reads its static id and mask
        buffers (:mod:`colbert_torch.retrieval.program` fills them from
        pinned staging before each replay)."""
        return self.model.forward_normalized(ids, mask, torch.ones_like(mask),
                                             dtype_name=self.config.activation_dtype)

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
