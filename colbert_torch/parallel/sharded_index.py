"""An index sharded over the data axis of a mesh (port of
``colbert_tpu.parallel.sharded_index``).

The passages split into contiguous ranges with about equal embedding
counts, one per data shard. Each shard is a self-contained
:class:`~colbert_torch.retrieval.device_index.DeviceIndex` on its shard's
device: its codes and residuals, its own IVF over its own embeddings
(tombstoned pids left out), its own balanced probe table. A query batch
runs the port's batched funnel on every shard (stage 2 through the CUDA
kernel on a card) and each shard keeps its top-k; the merge is a host sort
of ``n_shards * k`` (pid, score) pairs per query. Scores are exact MaxSim
over what each shard holds.

The JAX package stacks every shard's arrays into padded ``(D, ...)``
arrays because one ``shard_map`` program needs equal shapes, and masks the
probe table's pad rows; here each shard keeps its own shapes and probes at
most as many cells as it has. The budgets that decide which candidates a
shard keeps (``max_candidates``, ``ncandidates``, the local ``k``) are
clamped once for every shard, as the JAX package clamps them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from colbert_torch.retrieval.device_index import DeviceIndex, _search, probe_compensation
from colbert_torch.utils.tracing import Tracer

__all__ = ["ShardedDeviceIndex", "PendingShardSearch", "merge_shard_topk",
           "shard_bounds"]


@dataclass
class PendingShardSearch:
    """A launched sharded search: each owned shard's (pids, scores) device
    tensors, not yet read back."""

    parts: dict[int, tuple[torch.Tensor, torch.Tensor]]
    k: int


def shard_bounds(doclens: np.ndarray, ndev: int) -> list[int]:
    """Passage bounds of ``ndev`` contiguous shards with about equal
    embedding counts -> ``ndev + 1`` pids."""
    doclens = np.asarray(doclens, np.int64)
    emb_offsets = np.concatenate([[0], np.cumsum(doclens)]).astype(np.int64)
    total = int(doclens.sum())
    bounds = [0]
    for s in range(ndev - 1):
        bounds.append(int(np.searchsorted(emb_offsets, (s + 1) * total / ndev)))
    bounds.append(len(doclens))
    return bounds


@dataclass
class ShardedDeviceIndex:
    mesh: object
    shards: dict[int, DeviceIndex]   # this process's data shards
    pid_base: np.ndarray             # (D,) global pid of each shard's first passage
    shard_passages: int              # the largest shard's passage count: the merge's sentinel
    n_passages: int
    nbits: int
    max_cell_length: int = 1         # longest probe-table cell over every shard
    probe_dup_max: int = 1           # worst shard's, see DeviceIndex.probe_dup_max
    probe_split_mass: float = 0.0    # worst shard's split-cell mass fraction

    @classmethod
    def build(
        cls,
        mesh,
        *,
        centroids: np.ndarray,
        doclens: np.ndarray,
        bucket_weights: np.ndarray,
        nbits: int,
        codes: np.ndarray | None = None,
        residuals: np.ndarray | None = None,
        stream_from: str | None = None,
        balance_cap: int | None = None,
        deleted_pids: np.ndarray | None = None,
    ) -> "ShardedDeviceIndex":
        """Split the passages into ``mesh.shape["data"]`` shards and build
        each owned shard on its device from its rows: in-memory
        ``codes``/``residuals``, or the rows of an index directory
        ``stream_from`` (only this process's shards are read).
        ``balance_cap`` splits oversized cells of each shard's IVF;
        ``deleted_pids`` (tombstones) are left out of every shard's IVF, so
        they can never become candidates. The widths that every process must
        agree on are gathered across processes."""
        from colbert_torch.indexing.updater import build_ivf_excluding
        from colbert_torch.parallel import launch
        from colbert_torch.storage import format as fmt

        if (codes is None) != (residuals is None):
            raise ValueError("codes and residuals must be passed together")
        if (codes is None) == (stream_from is None):
            raise ValueError("pass exactly one of codes/residuals or stream_from")
        ndev = mesh.shape["data"]
        doclens = np.asarray(doclens, np.int64)
        emb_offsets = np.concatenate([[0], np.cumsum(doclens)]).astype(np.int64)
        bounds = shard_bounds(doclens, ndev)
        pid_base = np.asarray(bounds[:-1], np.int64)
        deleted = (np.asarray(deleted_pids, np.int64) if deleted_pids is not None
                   else np.zeros((0,), np.int64))
        centroids = np.asarray(centroids, np.float32)
        k = centroids.shape[0]

        shards = {}
        # per shard: longest probe cell, dup bound, split mass (0 where
        # another process owns the shard, so the max over processes is exact)
        widths = np.zeros((3, ndev), np.float64)
        for s in launch.owned_data_shards(mesh):
            p0, p1 = bounds[s], bounds[s + 1]
            e0, e1 = int(emb_offsets[p0]), int(emb_offsets[p1])
            if stream_from is not None:
                local_codes, local_res = fmt.read_embedding_rows(stream_from, e0, e1)
            else:
                local_codes = np.asarray(codes[e0:e1], np.uint32)
                local_res = residuals[e0:e1]
            local_del = deleted[(deleted >= p0) & (deleted < p1)]
            del_eids = np.concatenate(
                [np.arange(emb_offsets[p] - e0, emb_offsets[p + 1] - e0) for p in local_del]
                or [np.zeros(0, np.int64)]).astype(np.int64)
            ivf, ivf_lengths = build_ivf_excluding(local_codes, k, del_eids)
            shard = DeviceIndex.build(
                centroids=centroids, codes=local_codes, residuals=local_res, ivf=ivf,
                ivf_lengths=ivf_lengths, doclens=doclens[p0:p1],
                bucket_weights=bucket_weights, nbits=nbits, balance_cap=balance_cap,
                device=mesh.data_device(s))
            shards[s] = shard
            lengths = shard.ivf_lengths
            widths[:, s] = (int(lengths.max()) if lengths.numel() else 0,
                            shard.probe_dup_max, shard.probe_split_mass)
        widths = launch.allgather_host(widths).max(axis=(0, 2))
        Ps_max = max(1, max(bounds[s + 1] - bounds[s] for s in range(ndev)))
        return cls(
            mesh=mesh, shards=shards, pid_base=pid_base, shard_passages=Ps_max,
            n_passages=len(doclens), nbits=nbits,
            max_cell_length=max(1, int(widths[0])), probe_dup_max=int(widths[1]),
            probe_split_mass=float(widths[2]),
        )

    def compensated_nprobe(self, nprobe: int, *, saturate: float = 0.05) -> int:
        """See :meth:`DeviceIndex.compensated_nprobe`; the worst shard's
        duplication and split mass decide."""
        return nprobe + probe_compensation(self.probe_dup_max, self.probe_split_mass,
                                           saturate=saturate)

    def search_Q_batch(self, Q, *, k: int, **kw) -> tuple[np.ndarray, np.ndarray]:
        """Queries (B, Lq, dim) -> (pids (B, k), scores (B, k)): the exact
        merge of every shard's top-k."""
        return self.finalize(self.search_Q_batch_async(Q, k=k, **kw))

    def search_Q_batch_async(
        self, Q, *, k: int, nprobe: int, ncandidates: int, cell_cap: int = 1024,
        max_candidates: int = 8192, centroid_threshold: float | None = None,
        stage1_refine: bool = True, refine_width: int = 4, tracer: Tracer | None = None,
    ) -> PendingShardSearch:
        """Launch every owned shard's search without reading results back.
        The budgets are clamped once for every shard; a shard with fewer
        probe-table rows than ``nprobe`` probes all of its cells."""
        Q = torch.as_tensor(Q, dtype=torch.float32)
        B, Lq, _ = Q.shape
        max_candidates = min(max_candidates, Lq * nprobe * cell_cap)
        ncand = min(ncandidates, max_candidates)
        k_local = min(k, ncand)
        parts = {}
        with torch.no_grad():
            for s, shard in self.shards.items():
                Qs = Q.to(shard.device).contiguous()
                pids, scores, _overflow = _search(
                    shard, Qs, k=k_local, nprobe=min(nprobe, shard.ivf_lengths.numel()),
                    ncandidates=ncand, cell_cap=cell_cap, max_candidates=max_candidates,
                    centroid_threshold=centroid_threshold, stage1_refine=stage1_refine,
                    refine_width=refine_width, tracer=tracer)
                parts[s] = (pids, scores)
        return PendingShardSearch(parts, k)

    def finalize(self, pending: PendingShardSearch) -> tuple[np.ndarray, np.ndarray]:
        """Read a launched search back -> (pids, scores): each shard's
        sentinel becomes the common one, every shard's table is gathered
        (across processes too) and merged on the host."""
        from colbert_torch.parallel import launch

        tables = {}
        for s, (pids, scores) in pending.parts.items():
            p = pids.to(torch.int64)
            p = torch.where(p == self.shards[s].n_passages, self.shard_passages, p)
            tables[s] = torch.stack([p.to(torch.float64), scores.to(torch.float64)])
        gathered, _ = launch.gather_shards(tables, self.mesh)
        t = torch.stack(gathered).cpu().numpy()  # (D, 2, B, k_local)
        return merge_shard_topk(t[:, 0].astype(np.int64), t[:, 1].astype(np.float32),
                                self.pid_base, self.shard_passages, pending.k)


def merge_shard_topk(lp: np.ndarray, ls: np.ndarray, pid_base: np.ndarray,
                     sentinel_pid: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-shard (D, B, k_local) top-k tables into global (B, k):
    shard-local pids -> global via ``pid_base``, sentinel rows masked,
    numpy sort of the D*k_local pairs per query."""
    D, B2, kl = lp.shape
    valid = lp != sentinel_pid
    gp = lp.astype(np.int64) + np.asarray(pid_base)[:, None, None]
    gp = np.where(valid, gp, -1)
    ls = np.where(valid, ls, -np.inf)
    flat_p = gp.transpose(1, 0, 2).reshape(B2, D * kl)
    flat_s = ls.transpose(1, 0, 2).reshape(B2, D * kl)
    order = np.argsort(-flat_s, axis=1)[:, :k]
    out_p = np.take_along_axis(flat_p, order, 1)
    out_s = np.take_along_axis(flat_s, order, 1).astype(np.float32)
    out_p[~np.isfinite(out_s)] = -1
    return out_p, out_s
