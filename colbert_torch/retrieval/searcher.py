"""Searcher: load an index, answer queries (port of ``colbert_tpu.retrieval.searcher``).

Two backends:

- ``"device"`` (default): the index is streamed from its chunk files onto
  the device (:class:`~colbert_torch.retrieval.device_index.DeviceIndex`)
  and a query batch runs tokenize (host) -> query BERT encode -> the search
  funnel on the device;
- ``"host"``: the reference-shaped staged pipeline of
  :mod:`~colbert_torch.retrieval.ranking`: codes and residuals stay on the
  host, candidates are gathered there per query, and the probe and the
  scoring run on ``device``. Useful for debugging and parity.

The JAX package's ``"sharded"`` backend waits for the multi-device layer
and raises (see ROADMAP.md).
"""

from __future__ import annotations

import logging
import os
from collections import deque
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from colbert_torch.config import ColBERTConfig
from colbert_torch.models.encoder import ColBERTEncoder
from colbert_torch.retrieval import ranking
from colbert_torch.retrieval.device_index import DeviceIndex
from colbert_torch.storage import format as fmt
from colbert_torch.utils.build import resolve_device
from colbert_torch.utils.tracing import Tracer, device_phase

__all__ = ["Searcher", "search"]

logger = logging.getLogger(__name__)


@dataclass
class Searcher:
    index_path: str
    encoder: ColBERTEncoder | None = None
    config: ColBERTConfig = None  # loaded from the index unless given
    backend: str = "device"
    device: str | torch.device = "cuda"
    # optional stage timing: with a Tracer every stage synchronizes the
    # device at its end and adds its wall time under its name
    tracer: Tracer | None = None

    # auto-capacity ceilings (as in the JAX package)
    AUTO_CELL_CAP_MAX = 4096
    AUTO_MAX_CANDIDATES_MAX = 8192
    # a query batch pads up to the next of these sizes; wider batches run in
    # chunks of the largest (the same batch shapes as the JAX package)
    QUERY_BATCH_BUCKETS = (1, 4, 8, 16, 32, 64, 128)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.backend not in ("device", "host"):
            raise NotImplementedError(
                f"backend={self.backend!r} is not ported yet; 'device' and 'host' "
                "are (see ROADMAP.md, queue A)"
            )
        if self.config is None:
            self.config = ColBERTConfig.load(os.path.join(self.index_path, "config.json"))
        missing = fmt.check_all_files_saved(self.index_path)
        if missing:
            raise FileNotFoundError(f"incomplete index at {self.index_path}: {missing}")
        if os.path.exists(os.path.join(self.index_path, "compact_commit.json")):
            raise RuntimeError(
                "a compact() publish was interrupted mid-commit: run "
                "IndexUpdater(index_path, encoder).finish_pending_compact() "
                "to complete it before opening a Searcher"
            )
        if self.encoder is None:
            from colbert_torch.models.hf_loader import load_checkpoint

            _, model, tokenizer = load_checkpoint(self.config.checkpoint, device=self.device)
            self.encoder = ColBERTEncoder(model, tokenizer, self.config, device=self.device)

        codec = fmt.load_codec(self.index_path)
        self.avg_residual = codec["avg_residual"]
        self.plan = fmt.load_plan(self.index_path)
        self.ivf, self.ivf_lengths = fmt.load_ivf(self.index_path)
        self.doclens = fmt.load_all_doclens(self.index_path)
        self.deleted_pids = fmt.load_deleted(self.index_path)
        dl64 = np.asarray(self.doclens, np.int64)
        expected = int(dl64.sum())
        if len(self.deleted_pids):
            expected -= int(dl64[self.deleted_pids].sum())
        if int(np.asarray(self.ivf_lengths, np.int64).sum()) != expected:
            logger.warning(
                "IVF covers %d embeddings but chunks hold %d (minus "
                "tombstones): the index looks torn mid-update",
                int(np.asarray(self.ivf_lengths, np.int64).sum()), expected,
            )
        if self.backend == "host":
            self.centroids = torch.as_tensor(codec["centroids"], dtype=torch.float32).to(self.device)
            self.bucket_weights = torch.as_tensor(
                codec["bucket_weights"], dtype=torch.float32).to(self.device)
            self.codes = fmt.load_all_codes(self.index_path)
            self.residuals = fmt.load_all_residuals(self.index_path)
            self.emb2pid = ranking.build_emb2pid(self.doclens)
            self.emb_offsets = np.concatenate([[0], np.cumsum(dl64[:-1])]).astype(np.int64)
        else:
            self.device_index = DeviceIndex.build(
                centroids=codec["centroids"],
                stream_from=self.index_path,
                ivf=self.ivf,
                ivf_lengths=self.ivf_lengths,
                doclens=dl64,
                bucket_weights=codec["bucket_weights"],
                nbits=self.config.nbits,
                balance_cap=self._balance_cap(self.config.ivf_balance_cap),
                device=self.device,
            )
            # the codec tables the oracle and the tuner read, shared with the index
            self.centroids = self.device_index.centroids
            self.bucket_weights = self.device_index.bucket_weights
            self.codes = self.residuals = None  # device-resident only
            self.emb2pid = self.emb_offsets = None
            self._init_capacities()

    @staticmethod
    def _balance_cap(cap: int | None) -> int | None:
        """``config.ivf_balance_cap`` semantics: None = 1024, <= 0 = no split."""
        return 1024 if cap is None else (cap if cap > 0 else None)

    def _init_capacities(self) -> None:
        """Capacities of the search: exact up to a ceiling unless the config
        sets them; any truncation is warned about and overflow counted."""
        cfg = self.config
        probe_lengths = self.device_index.ivf_lengths
        max_ivf = int(probe_lengths.max()) if probe_lengths.numel() else 1
        if cfg.search_cell_cap is not None:
            self.cell_cap = int(cfg.search_cell_cap)
        else:
            self.cell_cap = min(self.AUTO_CELL_CAP_MAX, max(32, -(-max_ivf // 32) * 32))
        if max_ivf > self.cell_cap:
            logger.warning(
                "cell_cap=%d truncates IVF cells (largest has %d embeddings); "
                "raise config.search_cell_cap to widen", self.cell_cap, max_ivf,
            )
        if cfg.search_max_candidates is not None:
            self.max_candidates = int(cfg.search_max_candidates)
        else:
            exact = max(128, -(-(len(self.doclens) + 1) // 128) * 128)
            self.max_candidates = min(self.AUTO_MAX_CANDIDATES_MAX, exact)

    def reload(self) -> "Searcher":
        """Fresh Searcher over the current on-disk artifacts (shares the encoder)."""
        return Searcher(self.index_path, encoder=self.encoder, backend=self.backend,
                        device=self.device, tracer=self.tracer)

    def set_balance_cap(self, cap: int | None) -> None:
        """Re-balance the probe-side IVF for a new ``ivf_balance_cap``
        without reloading the index, and re-size the auto capacities
        (device backend only)."""
        if self.backend != "device":
            raise NotImplementedError(
                "set_balance_cap: device backend only (rebuild the Searcher for host)")
        self.config.ivf_balance_cap = cap
        self.device_index.rebalance(self.ivf_lengths, self._balance_cap(cap))
        self._init_capacities()

    def _stage_params(self, k: int) -> Tuple[int, float | None]:
        """(stage-2 doc budget, stage-1 cell threshold) for a top-k search."""
        cfg = self.config
        if not cfg.use_plaid_pruning:
            return self.max_candidates, None
        ndocs = cfg.plaid_stage2_docs or max(16 * k, 1024)
        return min(cfg.ncandidates, ndocs), cfg.centroid_score_threshold

    def _search_kwargs(self, k: int) -> dict:
        cfg = self.config
        ncand, threshold = self._stage_params(k)
        nprobe = cfg.nprobe
        if cfg.probe_dup_compensation:
            nprobe = self.device_index.compensated_nprobe(
                nprobe, saturate=cfg.probe_comp_saturation)
        return dict(
            k=k, nprobe=nprobe, ncandidates=ncand,
            cell_cap=self.cell_cap, max_candidates=self.max_candidates,
            centroid_threshold=threshold,
            stage1_refine=cfg.plaid_stage1_refine,
            refine_width=cfg.refine_width_factor,
        )

    def search(self, query: str, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """-> (pids (k,), scores (k,)) for one query."""
        pids, scores = self.search_batch([query], k)
        return pids[0], scores[0]

    def search_batch(self, queries: Sequence[str], k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Batched retrieval -> (pids (B, k) int64, scores (B, k) f32)."""
        if self.backend == "host":
            return self._search_batch_impl(queries, k)
        return self.finish_search(self.launch_search(queries, k), k)

    def launch_search(self, queries: Sequence[str], k: int = 10) -> list:
        """Tokenize and launch the search of ``queries`` -> a handle for
        :meth:`finish_search`. Batches pad up to a query-batch bucket;
        wider ones split into bucket-sized launches. Device backend only."""
        if self.backend != "device":
            raise NotImplementedError("launch_search: device backend only")
        kw = self._search_kwargs(k)
        cap = self.QUERY_BATCH_BUCKETS[-1]
        parts = []
        for i in range(0, len(queries), cap):
            piece = list(queries[i:i + cap])
            B = len(piece)
            padded = next(b for b in self.QUERY_BATCH_BUCKETS if b >= B)
            piece = piece + [""] * (padded - B)
            with self._phase("tokenize"):
                ids, mask = self.encoder.tensorize_queries(piece)
            parts.append((B, self.device_index.search_tokens_batch_async(
                self.encoder, ids, mask, tracer=self.tracer, **kw)))
        return parts

    def finish_search(self, parts: list, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Read back a :meth:`launch_search` handle -> (pids (B, k), scores)."""
        if not parts:
            return np.empty((0, k), np.int64), np.empty((0, k), np.float32)
        with self._phase("finish"):
            outs = [(B, self.device_index.finalize(p)) for B, p in parts]
        pids = np.concatenate([pi[:B] for B, (pi, _) in outs])
        scores = np.concatenate([sc[:B] for B, (_, sc) in outs])
        if pids.shape[1] < k:  # tiny index: fewer than k hits exist
            pad = k - pids.shape[1]
            pids = np.pad(pids, ((0, 0), (0, pad)), constant_values=-1)
            scores = np.pad(scores.astype(np.float32), ((0, 0), (0, pad)),
                            constant_values=-np.inf)
        return pids.astype(np.int64), scores.astype(np.float32)

    def search_stream(self, query_batches, k: int = 10, max_inflight: int = 2):
        """Pipelined batched search: yields one (pids, scores) per input
        batch, in order, with up to ``max_inflight`` batches launched ahead
        of the one being read back. The host backend runs the batches one
        after another through :meth:`search_batch` (same results, no
        overlap)."""
        if self.backend != "device":
            for qb in query_batches:
                yield self.search_batch(list(qb), k)
            return
        pending = deque()
        for qb in query_batches:
            if len(pending) >= max(1, max_inflight):
                yield self.finish_search(pending.popleft(), k)
            pending.append(self.launch_search(list(qb), k))
        while pending:
            yield self.finish_search(pending.popleft(), k)

    def _phase(self, name: str):
        return device_phase(self.tracer, name)

    # --- host backend ---------------------------------------------------

    @torch.no_grad()
    def _search_batch_impl(self, queries: Sequence[str], k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host-backend search: probe on the device, candidates per query
        from the host IVF, optional centroid-only pruning, then full scoring
        on the device. Holds its own ``no_grad``: serving threads do not
        inherit the caller's grad mode."""
        B = len(queries)
        out_pids = np.full((B, k), -1, np.int64)
        out_scores = np.full((B, k), -np.inf, np.float32)
        if B == 0:
            return out_pids, out_scores
        Q = torch.from_numpy(self.encoder.encode_queries(list(queries))).to(self.device)
        cells = ranking.probe_centroids(Q, self.centroids,
                                        nprobe=self.config.nprobe).cpu().numpy()
        for b in range(B):
            pids = ranking.candidate_pids(cells[b], self.ivf, self.ivf_lengths, self.emb2pid)
            if len(pids) == 0:
                continue
            pids, scores = self._score_pids(Q[b:b + 1], pids, k)
            order = np.argsort(-scores, kind="stable")[:k]
            out_pids[b, :len(order)] = pids[order]
            out_scores[b, :len(order)] = scores[order]
        return out_pids, out_scores

    def _gathered(self, arr: np.ndarray, idx: np.ndarray) -> torch.Tensor:
        """Rows ``arr[idx]`` of a host array -> a tensor on the device
        (uint32 codes as int32: they index centroids, far below 2^31)."""
        g = arr[idx]
        if g.dtype == np.uint32:
            g = g.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(g)).to(self.device)

    def _score_pids(self, Qb: torch.Tensor, pids: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.config
        ndocs = self._stage_params(k)[0] if cfg.use_plaid_pruning else len(pids)
        if len(pids) > ndocs:
            # PLAID stage 1: centroid-only scores keep the stage-2 doc budget
            idx, mask = ranking.gather_padded(pids, self.doclens, self.emb_offsets)
            approx = ranking.score_approx(
                Qb, self._gathered(self.codes, idx),
                torch.from_numpy(mask).to(self.device), self.centroids,
            )[0, :len(pids)].cpu().numpy()
            keep = np.argsort(-approx, kind="stable")[:ndocs]
            pids = pids[np.sort(keep)]
        idx, mask = ranking.gather_padded(pids, self.doclens, self.emb_offsets)
        scores = ranking.score_full(
            Qb, self._gathered(self.codes, idx), self._gathered(self.residuals, idx),
            torch.from_numpy(mask).to(self.device), self.centroids, self.bucket_weights,
            nbits=cfg.nbits,
        )[0, :len(pids)].cpu().numpy()
        return pids, scores


def search(searcher: Searcher, query: str, k: int = 10):
    """Functional alias mirroring the reference's ``search`` export."""
    return searcher.search(query, k)
