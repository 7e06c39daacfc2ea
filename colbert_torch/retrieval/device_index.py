"""Device-resident index and batched search (port of ``colbert_tpu.retrieval.device_index``).

The whole index lives on the device and a query batch runs as one program
with no host round trip until the results are read:

    query BERT encode -> probe matmul + top-nprobe -> IVF cell slices ->
    pid dedup sort and per-pid stage-1 bound -> optional full-centroid
    refine (the CUDA kernel of :mod:`colbert_torch.ops.approx_maxsim`) ->
    top ncandidates -> stage-2 fused decompress + MaxSim (the CUDA kernel of
    :mod:`colbert_torch.ops.fused_maxsim`) -> final top-k

On a card the program is a captured CUDA graph per static key
(:mod:`colbert_torch.retrieval.program`), the counterpart of the JAX
package's jitted ``_search_tokens`` / ``_search_batch``: a launch copies
the inputs in, replays the graph and copies the results out without
waiting on the device. Three cases run the same funnel eagerly, op by op,
instead: CPU tensors (the tests), a ``tracer`` (the eager stage timing,
for debugging: its per-stage times need a synchronize at each stage end;
the JAX program has no per-stage times either) and an encoder with a mesh attached (its shards run on several
devices). Nothing else runs eagerly, and a capture or replay that fails
raises.

Every shape in the funnel is static, as in the JAX program: stage 1 keeps
all ``E = Lq*nprobe*cell_cap`` entries per query and sorts them by (pid, q,
score descending), the per-pid sums are cumsum differences between run
heads. The funnel is written for the batch at once (a batch dimension
instead of ``vmap``). Differences from the JAX program, none of which
changes what is computed:

- the (pid, q) key and the score's order share one int64 sort key (two
  stable sorts past ``2^26`` pids at Lq 32) where JAX sorts two keys, or
  three past that size;
- probe scores are taken against the codec centroids and gathered to the
  balanced probe table, so duplicated sub-cells tie exactly, and ties at the
  top-nprobe cut go to the lowest probe-table index as in ``lax.top_k``;
- ties elsewhere (stage-1 cut, refine cut, final top-k) follow
  ``torch.topk``; tied candidates are interchangeable.
"""

from __future__ import annotations

import logging
import weakref
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from colbert_torch.ops.approx_maxsim import (REFINE_CHUNK_BYTES, approx_maxsim,  # noqa: F401
                                              refine_column_bytes)
from colbert_torch.ops.fused_maxsim import stage2_maxsim
from colbert_torch.retrieval.program import Program, ProgramCache, tensor_signature
from colbert_torch.utils import tracing
from colbert_torch.utils.build import resolve_device
from colbert_torch.utils.tracing import device_phase as _phase

logger = logging.getLogger(__name__)

__all__ = ["DeviceIndex", "PendingSearch", "balance_cells", "split_mass_fraction",
           "probe_compensation", "IVF_PAD", "MAX_CELL_DUP"]

NEG = -1e30
MAX_CELL_DUP = 4  # sub-cells per oversized cell (see balance_cells)
# tail padding (entries) of the device IVF, kept for layout parity with the
# JAX package; the port's cell reads clamp their indices instead
IVF_PAD = 4096


def balance_cells(
    ivf_lengths: np.ndarray, orig_offsets: np.ndarray, balance_cap: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Split cells larger than ``balance_cap`` into at most ``MAX_CELL_DUP``
    sub-cells -> (sub_lengths int32, sub_offsets int32, split_origin int32,
    dup_max). Sub-cell offsets derive from ORIGIN offsets so truncated tails
    never shift later cells' segments."""
    ivf_lengths = np.asarray(ivf_lengths, np.int64)
    nsub = np.clip(-(-ivf_lengths // balance_cap), 1, MAX_CELL_DUP)
    dropped = int(np.maximum(ivf_lengths - nsub * balance_cap, 0).sum())
    if dropped:
        logger.warning(
            "balanced IVF truncates %d entries beyond %d sub-cells of %d "
            "(raise ivf_balance_cap to keep them)",
            dropped, MAX_CELL_DUP, balance_cap,
        )
    split_origin = np.repeat(np.arange(len(ivf_lengths), dtype=np.int32), nsub)
    starts = np.concatenate([[0], np.cumsum(nsub)[:-1]])
    within = np.arange(int(nsub.sum())) - np.repeat(starts, nsub)
    sub_lengths = np.clip(
        np.repeat(ivf_lengths, nsub) - within * balance_cap, 0, balance_cap
    ).astype(np.int32)
    sub_offsets = (
        np.repeat(np.asarray(orig_offsets), nsub) + within * balance_cap
    ).astype(np.int32)
    return sub_lengths, sub_offsets, split_origin, int(nsub.max())


def split_mass_fraction(ivf_lengths: np.ndarray, balance_cap: int) -> float:
    """Fraction of probeable entries (post-truncation) in cells that
    :func:`balance_cells` splits."""
    ivf_lengths = np.asarray(ivf_lengths, np.int64)
    probeable = np.minimum(ivf_lengths, MAX_CELL_DUP * balance_cap)
    total = int(probeable.sum())
    if not total:
        return 0.0
    return float(probeable[ivf_lengths > balance_cap].sum() / total)


def probe_compensation(dup_max: int, split_mass: float,
                       *, saturate: float = 0.05) -> int:
    """Extra probe slots so balanced-IVF duplicates of split cells don't
    crowd distinct cells out of the top-``nprobe``: ``dup_max - 1`` scaled
    by the split mass, saturating at ``saturate`` (> 0, which the port's
    config enforces)."""
    if saturate <= 0:
        raise ValueError("saturate must be > 0")
    if dup_max <= 1 or split_mass <= 0.0:
        return 0
    return min(dup_max - 1,
               max(0, round((dup_max - 1) * min(1.0, split_mass / saturate))))


@dataclass
class PendingSearch:
    """A launched batch search: tensors not yet read back. A captured
    program's launch owns pinned host tensors that are readable once
    ``ready`` (a CUDA event) has completed; an eager launch holds the device
    tensors themselves (``ready`` None)."""

    pids: torch.Tensor
    scores: torch.Tensor
    overflow: torch.Tensor
    k: int
    ready: torch.cuda.Event | None = None
    # (start, end) CUDA events around a replay recorded while tracing was on
    timing: tuple | None = None


def _stream_chunks(index_path: str, N: int, nbytes: int, pad_rows: int,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk mmaps -> preallocated device buffers, one chunk at a time (the
    host never holds the packed index): codes ``(N + pad_rows,)`` int32 and
    FLAT residual words ``((N + pad_rows) * nwords,)``, zeroed tail rows."""
    from colbert_torch.storage import format as fmt

    wdtype, nwords = _word_layout(nbytes)
    codes = torch.zeros(N + pad_rows, dtype=torch.int32, device=device)
    res = torch.zeros((N + pad_rows) * nwords, dtype=wdtype, device=device)
    off = 0
    for i in range(fmt.num_chunks(index_path)):
        ch = fmt.load_chunk(index_path, i, mmap=True)
        n = ch["codes"].shape[0]
        if off + n > N:
            raise ValueError(f"chunks under {index_path} hold more than {N} embeddings")
        # a real staging copy out of the read-only mmap
        c_host = torch.from_numpy(np.array(ch["codes"], np.uint32).view(np.int32))
        r_host = torch.from_numpy(
            np.array(ch["residuals"], np.uint8).reshape(-1)
            .view(np.int32 if wdtype == torch.int32 else np.uint8))
        codes[off:off + n].copy_(c_host)
        res[off * nwords:(off + n) * nwords].copy_(r_host)
        off += n
    if off != N:
        raise ValueError(f"chunks under {index_path} hold {off} embeddings, doclens say {N}")
    return codes, res


def _word_layout(nbytes: int) -> tuple[torch.dtype, int]:
    """Residual row of ``nbytes`` -> (word dtype, words per row): 4-byte LE
    words in int32 when the row is a whole number of them, else bytes."""
    if nbytes % 4 == 0:
        return torch.int32, nbytes // 4
    return torch.uint8, nbytes


@dataclass
class DeviceIndex:
    """All index artifacts as device tensors, plus the batched search."""

    centroids: torch.Tensor      # (K, dim) f32 — codec table (codes index it)
    split_origin: torch.Tensor | None  # (K',) int64 probe row -> codec row, or None
    codes: torch.Tensor          # (N + max_doclen,) int32, zeroed tail rows
    residuals: torch.Tensor      # ((N + max_doclen) * nwords,) FLAT words (int32 LE or uint8)
    ivf: torch.Tensor            # (N + IVF_PAD,) int32 PIDS grouped by cell
    ivf_offsets: torch.Tensor    # (K',) int64 (probe-side cells)
    ivf_lengths: torch.Tensor    # (K',) int64
    doclens: torch.Tensor        # (P + 1,) int32 — sentinel pid has doclen 0
    emb_offsets: torch.Tensor    # (P + 1,) int64 — sentinel pid -> sentinel row N
    bucket_weights: torch.Tensor  # (2^nbits,) f32
    n_passages: int
    nbits: int
    max_doclen: int              # padded per-passage token capacity
    probe_dup_max: int = 1
    probe_split_mass: float = 0.0
    overflow_candidates: int = field(default=0, compare=False)
    # captured serving programs (see colbert_torch.retrieval.program)
    programs: ProgramCache = field(default_factory=ProgramCache, compare=False, repr=False)

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def probe_centroids(self) -> torch.Tensor:
        """(K', dim) probe table: codec centroids with split cells duplicated."""
        if self.split_origin is None:
            return self.centroids
        return self.centroids[self.split_origin]

    @classmethod
    def build(
        cls,
        *,
        centroids: np.ndarray,
        codes: np.ndarray | None = None,
        residuals: np.ndarray | None = None,
        ivf: np.ndarray,
        ivf_lengths: np.ndarray,
        doclens: np.ndarray,
        bucket_weights: np.ndarray,
        nbits: int,
        balance_cap: int | None = None,
        stream_from: str | None = None,
        device: str | torch.device = "cuda",
    ) -> "DeviceIndex":
        """Upload an index. Host ``codes``/``residuals`` may carry zeroed tail
        rows already (``len == doclens.sum() + max_doclen``); other lengths
        are re-padded. With ``stream_from`` (an index dir) the chunks stream
        from their mmaps into preallocated device buffers instead.
        ``balance_cap`` splits larger IVF cells (see :func:`balance_cells`)."""
        dev = resolve_device(device)
        doclens = np.asarray(doclens, np.int64)
        N = int(doclens.sum())
        P = len(doclens)
        max_doclen = int(doclens.max()) if P else 1
        max_doclen = max(32, -(-max_doclen // 32) * 32)
        if stream_from is None:
            if len(codes) < N or len(residuals) != len(codes):
                raise ValueError(
                    f"codes/residuals rows ({len(codes)}/{len(residuals)}) must "
                    f"be >= doclens.sum()={N} and equal"
                )
            nbytes = residuals.shape[1]
        else:
            nbytes = centroids.shape[1] // 8 * nbits
        wdtype, _ = _word_layout(nbytes)

        centroids = np.asarray(centroids, np.float32)
        ivf_lengths = np.asarray(ivf_lengths, np.int64)
        probe = _probe_tables(ivf_lengths, balance_cap)

        if stream_from is not None:
            codes_d, res_d = _stream_chunks(stream_from, N, nbytes, max_doclen, dev)
        else:
            codes_p = np.zeros(N + max_doclen, np.uint32)
            codes_p[:N] = codes[:N]
            res_p = np.zeros((N + max_doclen, nbytes), np.uint8)
            res_p[:N] = residuals[:N]
            codes_d = torch.from_numpy(codes_p.view(np.int32)).to(dev)
            res_d = torch.from_numpy(
                res_p.reshape(-1).view(np.int32 if wdtype == torch.int32 else np.uint8)
            ).to(dev)

        emb2pid = np.empty(N + 1, np.int32)
        emb2pid[:N] = np.repeat(np.arange(P, dtype=np.int32), doclens)
        emb2pid[N] = P
        offsets = np.zeros(P + 1, np.int64)
        if P:
            offsets[1:P] = np.cumsum(doclens[:-1])
        offsets[P] = N  # the sentinel pid reads the zeroed row N
        dl_p = np.concatenate([doclens.astype(np.int32), np.zeros(1, np.int32)])
        # the device IVF holds pids (mapped once here), padded at the tail
        ivf = np.asarray(ivf)
        ivf_pid = np.full(len(ivf) + IVF_PAD, P, np.int32)
        ivf_pid[:len(ivf)] = emb2pid[ivf]

        def up(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype).to(dev)

        return cls(
            centroids=up(centroids),
            split_origin=None if probe[2] is None else up(probe[2], torch.int64),
            codes=codes_d,
            residuals=res_d,
            ivf=up(ivf_pid),
            ivf_offsets=up(probe[1], torch.int64),
            ivf_lengths=up(probe[0], torch.int64),
            doclens=up(dl_p),
            emb_offsets=up(offsets),
            bucket_weights=up(np.asarray(bucket_weights, np.float32)),
            n_passages=P,
            nbits=nbits,
            max_doclen=max_doclen,
            probe_dup_max=probe[3],
            probe_split_mass=probe[4],
        )

    def rebalance(self, ivf_lengths: np.ndarray, balance_cap: int | None) -> None:
        """Recompute the probe-side tables for a new ``balance_cap`` in
        place; codes, residuals and IVF entries stay as they are.
        ``ivf_lengths`` are the ORIGINAL (on-disk) per-cell lengths."""
        lengths, offs, origin, self.probe_dup_max, self.probe_split_mass = (
            _probe_tables(np.asarray(ivf_lengths, np.int64), balance_cap))
        dev = self.device
        self.split_origin = None if origin is None else torch.as_tensor(
            origin, dtype=torch.int64).to(dev)
        self.ivf_lengths = torch.as_tensor(lengths, dtype=torch.int64).to(dev)
        self.ivf_offsets = torch.as_tensor(offs, dtype=torch.int64).to(dev)
        self.programs.clear()  # they read the replaced probe tables

    def compensated_nprobe(self, nprobe: int, *, saturate: float = 0.05) -> int:
        return nprobe + probe_compensation(
            self.probe_dup_max, self.probe_split_mass, saturate=saturate
        )

    @staticmethod
    def _clamp(Lq, nprobe, cell_cap, max_candidates, ncandidates, k):
        max_candidates = min(max_candidates, Lq * nprobe * cell_cap)
        ncand = min(ncandidates, max_candidates)
        return max_candidates, ncand, min(k, ncand)

    def search_Q_batch_async(
        self, Q, *, k: int, nprobe: int, ncandidates: int,
        cell_cap: int = 1024, max_candidates: int = 8192,
        centroid_threshold: float | None = None,
        stage1_refine: bool = True, refine_width: int = 4, tracer=None,
    ) -> PendingSearch:
        """Launch the search of pre-encoded queries ``Q (B, Lq, dim)``
        without reading results back: the captured program of this key on a
        card (the JAX package's ``_search_batch``); eagerly on the CPU or
        with a ``tracer`` (a :class:`~colbert_torch.utils.tracing.Tracer`,
        which times each stage, synchronizing the device at stage ends)."""
        kw = dict(nprobe=nprobe, ncandidates=ncandidates, cell_cap=cell_cap,
                  max_candidates=max_candidates, centroid_threshold=centroid_threshold,
                  stage1_refine=stage1_refine, refine_width=refine_width)
        if self.device.type == "cpu" or tracer is not None:
            return self._search_Q_eager(Q, k=k, tracer=tracer, **kw)
        return self._program_search_Q(Q, k=k, **kw)

    def search_Q_batch(self, Q, *, k: int, **kw) -> Tuple[np.ndarray, np.ndarray]:
        """Pre-encoded queries (B, Lq, dim) -> (pids (B, k), scores (B, k))."""
        return self.finalize(self.search_Q_batch_async(Q, k=k, **kw))

    def search_tokens_batch_async(
        self, encoder, input_ids: np.ndarray, attention_mask: np.ndarray,
        *, k: int, tracer=None, **kw,
    ) -> PendingSearch:
        """Query token ids -> launched search: the query BERT encode
        followed by the funnel, as one captured program per key on a card
        (the JAX package's ``_search_tokens``). Eager in three cases only:
        CPU tensors, a ``tracer``, and an encoder with a mesh attached."""
        if self.device.type == "cpu" or tracer is not None or encoder.mesh is not None:
            return self._search_tokens_eager(encoder, input_ids, attention_mask, k=k,
                                             tracer=tracer, **kw)
        return self._program_search_tokens(encoder, input_ids, attention_mask, k=k, **kw)

    def search_tokens_batch(self, encoder, input_ids, attention_mask, *, k: int,
                            **kw) -> Tuple[np.ndarray, np.ndarray]:
        return self.finalize(self.search_tokens_batch_async(
            encoder, input_ids, attention_mask, k=k, **kw))

    # --- the two routes ---------------------------------------------------

    def _search_Q_eager(self, Q, *, k: int, tracer=None, **kw) -> PendingSearch:
        """The funnel op by op (the eager route; also the yardstick the
        captured route is held against)."""
        Q = torch.as_tensor(Q, dtype=torch.float32).to(self.device).contiguous()
        static = self._static_kwargs(Q.shape[1], k, **kw)
        with torch.no_grad():
            pids, scores, overflow = _search(self, Q, tracer=tracer, **static)
        return PendingSearch(pids=pids, scores=scores, overflow=overflow, k=k)

    def _search_tokens_eager(self, encoder, input_ids, attention_mask, *, k: int,
                             tracer=None, **kw) -> PendingSearch:
        with _phase(tracer, "encode"):
            Q = encoder.encode_query_tokens(input_ids, attention_mask)
        return self._search_Q_eager(Q, k=k, tracer=tracer, **kw)

    def _static_kwargs(self, Lq: int, k: int, *, nprobe, ncandidates, cell_cap=1024,
                       max_candidates=8192, centroid_threshold=None, stage1_refine=True,
                       refine_width=4) -> dict:
        """The knobs as :func:`_search` takes them, budgets clamped (the
        JAX package's static arguments)."""
        mc, ncand, k_eff = self._clamp(Lq, nprobe, cell_cap, max_candidates, ncandidates, k)
        return dict(k=k_eff, nprobe=nprobe, ncandidates=ncand, cell_cap=cell_cap,
                    max_candidates=mc, centroid_threshold=centroid_threshold,
                    stage1_refine=stage1_refine, refine_width=refine_width)

    def _signature(self) -> tuple:
        """What a program bakes in about this index: every tensor it reads
        (address, shape, dtype) and the scalars it reads."""
        return tensor_signature([
            self.centroids, self.split_origin, self.codes, self.residuals, self.ivf,
            self.ivf_offsets, self.ivf_lengths, self.doclens, self.emb_offsets,
            self.bucket_weights,
        ]) + (self.n_passages, self.nbits, self.max_doclen, self.probe_dup_max)

    def _program(self, key, fn, shapes, dtypes) -> Program:
        """The program of ``key`` (made from ``fn(index, *inputs)`` on its
        first launch). A program holds its index weakly: the index owns its
        programs, and their device memory goes with the index."""
        index = weakref.ref(self)
        return self.programs.get(
            (key, self._signature()),
            lambda: Program(lambda *a: fn(index(), *a), shapes, dtypes, self.device))

    @staticmethod
    def _launch(prog: Program, inputs, k: int) -> PendingSearch:
        """Launch ``prog`` on ``inputs`` -> the launch's results."""
        (pids, scores, overflow), ready, timing = prog.launch(*inputs)
        return PendingSearch(pids=pids, scores=scores, overflow=overflow, k=k, ready=ready,
                             timing=timing)

    def _program_search_Q(self, Q, *, k: int, **kw) -> PendingSearch:
        """Launch the captured program of ``_search_batch``'s key for ``Q``."""
        if isinstance(Q, torch.Tensor) and Q.device.type == "cuda" and Q.device != self.device:
            raise ValueError(f"Q is on {Q.device}, the index on {self.device}")
        B, Lq, dim = Q.shape
        with tracing.span("program_key"):
            static = self._static_kwargs(Lq, k, **kw)

            def run(index, q):
                return _search(index, q, tracer=None, **static)

            prog = self._program(("Q", B, Lq, dim, tuple(sorted(static.items()))), run,
                                 [(B, Lq, dim)], [torch.float32])
        return self._launch(prog, [Q], k)

    def _program_search_tokens(self, encoder, input_ids, attention_mask, *, k: int,
                               **kw) -> PendingSearch:
        """Launch the captured program of ``_search_tokens``' key: the query
        encode reads the program's static id and mask buffers."""
        model_device = next(encoder.model.parameters()).device
        if model_device != self.device:
            raise ValueError(f"the encoder is on {model_device}, the index on {self.device}")
        B, Lq = input_ids.shape
        with tracing.span("program_key"):
            static = self._static_kwargs(Lq, k, **kw)

            def run(index, ids, mask):
                Q = encoder.encode_query_device(ids, mask)
                return _search(index, Q, tracer=None, **static)

            key = ("tokens", B, Lq, tuple(sorted(static.items())),
                   encoder.config.activation_dtype, id(encoder.model),
                   tensor_signature(list(encoder.model.parameters())))
            prog = self._program(key, run, [(B, Lq), (B, Lq)], [torch.int64, torch.bool])
        return self._launch(prog, (input_ids, attention_mask), k)

    def finalize(self, pending: PendingSearch) -> Tuple[np.ndarray, np.ndarray]:
        """Read a launched search back -> (pids, scores) numpy: the one
        place a search waits for the device. A timed replay's device time
        is counted here, once its events have completed."""
        with tracing.span("wait"):
            if pending.ready is not None:
                pending.ready.synchronize()
        if pending.timing is not None:
            start, end = pending.timing
            tracing.count("program_replay_device_ns", round(start.elapsed_time(end) * 1e6))
            tracing.count("program_replays_timed")
        with tracing.span("read_back"):
            return self._postprocess(
                pending.pids.cpu().numpy(), pending.scores.cpu().numpy(),
                pending.overflow.cpu().numpy(), pending.k,
            )

    def _postprocess(self, pids, scores, overflow, k):
        B = pids.shape[0]
        dropped = int(overflow.sum())
        if dropped > 0:
            first = self.overflow_candidates == 0
            self.overflow_candidates += dropped
            logger.log(
                logging.WARNING if first else logging.DEBUG,
                "stage-1 selection overflow: %d candidates dropped beyond "
                "the selection width (lowest stage-1 scores; widen "
                "plaid_stage2_docs/ncandidates and search_max_candidates "
                "to score them; total dropped: %d)",
                dropped, self.overflow_candidates,
            )
        out_p = np.full((B, k), -1, np.int64)
        out_s = np.full((B, k), -np.inf, np.float32)
        for b in range(B):
            valid = pids[b] != self.n_passages
            nv = int(valid.sum())
            out_p[b, :nv] = pids[b][valid]
            out_s[b, :nv] = scores[b][valid]
        return out_p, out_s


def _probe_tables(ivf_lengths: np.ndarray, balance_cap: int | None):
    """-> (probe lengths, probe offsets, split_origin or None, dup_max,
    split_mass) for the on-disk cell lengths and a balance cap."""
    orig_offsets = np.concatenate([[0], np.cumsum(ivf_lengths)])[:-1]
    if balance_cap is not None and len(ivf_lengths) and (
        int(ivf_lengths.max()) > balance_cap
    ):
        mass = split_mass_fraction(ivf_lengths, balance_cap)
        lengths, offs, origin, dup_max = balance_cells(
            ivf_lengths, orig_offsets, balance_cap)
        return lengths, offs, origin, dup_max, mass
    return ivf_lengths, orig_offsets, None, 1, 0.0


# ---------------------------------------------------------------------------
# the batched funnel
# ---------------------------------------------------------------------------


def _probe_topk(index: DeviceIndex, Q: torch.Tensor, nprobe: int):
    """Probe every query token against the probe table in one flat
    ``(B*Lq, K')`` matmul -> top-nprobe (scores, cells), each (B, Lq, nprobe).

    Scores are computed against the K codec centroids and gathered through
    ``split_origin``, so a split cell's sub-cells tie exactly. Ties at the
    cut go to the lowest probe-table index, as ``lax.top_k`` orders them:
    a tie group (one cell's sub-cells) has at most ``dup_max`` members, so
    the top ``nprobe + dup_max - 1`` holds every member of the group at the
    cut, and a stable re-sort by (score desc, index asc) picks among them."""
    B, Lq, dim = Q.shape
    cs = Q.reshape(B * Lq, dim) @ index.centroids.T            # (B*Lq, K)
    if index.split_origin is not None:
        cs = cs[:, index.split_origin]                          # (B*Lq, K')
    extra = min(index.probe_dup_max - 1, cs.shape[1] - nprobe)
    vals, cells = torch.topk(cs, nprobe + extra, dim=1)
    if extra > 0:
        by_idx = torch.argsort(cells, dim=1)
        vals, cells = vals.gather(1, by_idx), cells.gather(1, by_idx)
        order = torch.argsort(-vals, dim=1, stable=True)[:, :nprobe]
        vals, cells = vals.gather(1, order), cells.gather(1, order)
    return vals.reshape(B, Lq, nprobe), cells.reshape(B, Lq, nprobe)


# the (pid, q) key and the score's 32-bit order share one int64 sort key
# while ``(P + 1) << qbits`` stays below 2^PACKED_KEY_BITS; past that the
# two keys take two stable sorts
PACKED_KEY_BITS = 31


def _sort_pid_q_score(key: torch.Tensor, neg_adj: torch.Tensor, qbits: int,
                      sentinel: int) -> torch.Tensor:
    """Per row of ``key (B, E)`` (``(pid << qbits) | q``, non-negative) and
    ``neg_adj (B, E)`` f32: the permutation that sorts by key, then by
    ``neg_adj`` ascending (the score descending) -> (B, E) int64. Entries
    tied on both are interchangeable. One sort of the two keys packed into
    int64 (the float's bits mapped to an order-preserving unsigned int) when
    they fit, else a stable sort by score and a stable sort by key."""
    if (sentinel + 1) << qbits < (1 << PACKED_KEY_BITS):
        bits = neg_adj.view(torch.int32).to(torch.int64)
        # negative floats order reversed as ints: flip their magnitude bits,
        # then shift the signed order into [0, 2^32)
        ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) + (1 << 31)
        return torch.sort((key << 32) | ordered, dim=1).indices
    by_score = torch.sort(neg_adj, dim=1, stable=True).indices
    by_key = torch.sort(key.gather(1, by_score), dim=1, stable=True).indices
    return by_score.gather(1, by_key)


def _stage1(index: DeviceIndex, probe_scores, cells, *, cell_cap: int,
            centroid_threshold: float | None):
    """IVF cell reads + pid dedup + the per-pid stage-1 bound, in the JAX
    package's static form (``colbert_tpu/retrieval/device_index.py``
    ``_search_core``): every query keeps all E = Lq*nprobe*cell_cap entries.

    -> (stage1 (B, E) f32, pids (B, E) int64, n_unique (B,)): per query the
    entries sorted by (pid, q, score descending), sentinel pids last; the
    head of each pid run holds that pid's stage-1 score, every other
    position NEG. ``n_unique`` counts the real pid runs.

    Per candidate the bound is the sum over query tokens of the best probed
    entry score, unprobed tokens imputed at half their nprobe-th probe score
    (the midpoint of the WARP/XTR imputation bounds). After the sort each
    (pid, q) run's head carries the run max; the per-pid sums are
    differences of a per-query fp32 cumsum between pid-run heads, the run
    ends found by a reversed cummin. No output shape depends on the data."""
    B, Lq, nprobe = probe_scores.shape
    dev = probe_scores.device
    sentinel = index.n_passages
    if centroid_threshold is not None:
        keep_cell = probe_scores >= centroid_threshold
        keep_cell[:, :, 0] = True  # each token's best cell always stays
    else:
        keep_cell = torch.ones_like(probe_scores, dtype=torch.bool)
    ncells = Lq * nprobe
    cells = cells.reshape(B, ncells)
    base = index.ivf_offsets[cells]                                   # (B, ncells)
    lens = torch.where(keep_cell.reshape(B, ncells), index.ivf_lengths[cells], 0)
    ar = torch.arange(cell_cap, device=dev)
    valid = ar < lens[..., None]                                      # (B, ncells, cap)
    idx = base[..., None] + torch.minimum(ar, (lens - 1).clamp(min=0)[..., None])
    E = ncells * cell_cap
    pids = torch.where(valid, index.ivf[idx].to(torch.int64), sentinel).reshape(B, E)

    impute = probe_scores[:, :, nprobe - 1]                           # (B, Lq)
    adj = (probe_scores - impute[..., None]).reshape(B, ncells)       # >= 0
    neg_adj = torch.where(valid, -adj[..., None], -NEG).reshape(B, E)  # invalid last
    q_of = torch.arange(Lq, device=dev).repeat_interleave(nprobe * cell_cap)  # (E,)
    qbits = max(1, (Lq - 1).bit_length())
    perm = _sort_pid_q_score((pids << qbits) | q_of, neg_adj, qbits, sentinel)
    p2 = pids.gather(1, perm)
    q2 = q_of[perm]
    a2 = -neg_adj.gather(1, perm)

    head = torch.ones((B, E), dtype=torch.bool, device=dev)
    head_p = head.clone()
    head[:, 1:] = (p2[:, 1:] != p2[:, :-1]) | (q2[:, 1:] != q2[:, :-1])
    head_p[:, 1:] = p2[:, 1:] != p2[:, :-1]
    real = p2 != sentinel
    first_pq = head & real
    first = head_p & real
    n_unique = first.sum(dim=1)

    # unclamped imputation: (s - i_q) + i_q/2 = s - i_q/2, the midpoint
    contrib = torch.where(first_pq, a2.clamp(min=0.0) + impute.gather(1, q2) * 0.5, 0.0)
    csum = torch.cumsum(contrib, dim=1)
    csum_prev = torch.nn.functional.pad(csum[:, :-1], (1, 0))
    pos = torch.arange(E, device=dev).expand(B, E)
    # the next pid-run head at or after each position (E: none), then the
    # run end of a head i: (the next head after i) - 1
    nxt = torch.where(head_p, pos, E).flip(1).cummin(dim=1).values.flip(1)
    run_end = torch.nn.functional.pad(nxt[:, 1:], (0, 1), value=E) - 1
    stage1 = torch.where(first, csum.gather(1, run_end) - csum_prev, NEG)
    return stage1, p2, n_unique


def _approx_maxsim(index: DeviceIndex, Q, pids, *, chunk_bytes: int = REFINE_CHUNK_BYTES):
    """Full centroid-interaction approximation for candidates ``pids (B, W)``:
    sum_q max_t <q, cent[code(t)]> over each candidate's tokens, with Q and
    the centroids rounded to bf16 and the products summed in fp32 (the JAX
    package's bf16 operands with fp32 accumulation). On a card one table
    product and one launch of the kernel of
    :mod:`colbert_torch.ops.approx_maxsim`; on the CPU its plain version's
    chunk passes (which alone read ``chunk_bytes``)."""
    return approx_maxsim(Q, index.emb_offsets[pids], index.doclens[pids], index.codes,
                         index.centroids, max_doclen=index.max_doclen,
                         chunk_bytes=chunk_bytes)


def _search(index: DeviceIndex, Q, *, k, nprobe, ncandidates, cell_cap,
            max_candidates, centroid_threshold, stage1_refine, refine_width,
            tracer):
    sentinel = index.n_passages
    with _phase(tracer, "probe"):
        probe_scores, cells = _probe_topk(index, Q, nprobe)
    with _phase(tracer, "stage1"):
        stage1, p2, n_unique = _stage1(
            index, probe_scores, cells, cell_cap=cell_cap,
            centroid_threshold=centroid_threshold)
        refine = stage1_refine and ncandidates < max_candidates
        sel_width = min(refine_width * ncandidates, max_candidates) if refine else ncandidates
        overflow = (n_unique - sel_width).clamp(min=0)
        if stage1.shape[1] < sel_width:
            # a shard of a sharded index probing all of its few cells
            # (sharded_index) has fewer slots than the common budget
            pad = sel_width - stage1.shape[1]
            stage1 = torch.nn.functional.pad(stage1, (0, pad), value=NEG)
            p2 = torch.nn.functional.pad(p2, (0, pad), value=sentinel)
        w_vals, w_idx = torch.topk(stage1, sel_width, dim=1)
        sel = torch.where(w_vals > NEG / 2, p2.gather(1, w_idx), sentinel)
    if refine:
        with _phase(tracer, "refine"):
            approx = _approx_maxsim(index, Q, sel)
            approx = torch.where(sel == sentinel, NEG, approx)
            keep_rows = torch.topk(approx, ncandidates, dim=1).indices
            sel = sel.gather(1, keep_rows)
    with _phase(tracer, "stage2"):
        scores = stage2_maxsim(
            Q, index.emb_offsets[sel], index.doclens[sel], index.codes,
            index.residuals, index.centroids, index.bucket_weights,
            nbits=index.nbits, max_doclen=index.max_doclen,
        )
        scores = torch.where(sel == sentinel, NEG, scores)
    with _phase(tracer, "topk"):
        top_scores, top_rows = torch.topk(scores, k, dim=1)
        top_pids = sel.gather(1, top_rows)
    return top_pids, top_scores, overflow
