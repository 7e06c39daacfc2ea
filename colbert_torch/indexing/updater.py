"""Incremental index updates: add / remove passages without a rebuild
(port of ``colbert_tpu.indexing.updater``).

  - :meth:`IndexUpdater.add` encodes and compresses new passages against the
    EXISTING codec (centroids and cutoffs frozen: retraining the codec would
    invalidate every stored residual), appends them as new chunks split at
    the plan's ``chunksize``, and rebuilds the IVF. New passages get pids
    following the current collection; existing pids and their compressed
    embeddings are untouched.
  - :meth:`IndexUpdater.remove` tombstones pids in ``deleted.npy`` and
    rebuilds the IVF *excluding* their embeddings, so no backend surfaces
    them as candidates. Their rows stay on disk until :meth:`compact`.
  - :meth:`IndexUpdater.compact` rewrites the chunks without the tombstoned
    passages and renumbers pids densely, publishing through a commit
    journal (``compact_commit.json``) so a crash at any point is repaired
    by :meth:`finish_pending_compact`.

The files written are those of the JAX updater: plan, chunk files,
``deleted.npy`` (int64) and IVF. The encode runs where the encoder runs
(``encoder.device``). Open searchers keep serving their loaded snapshot;
``Searcher.reload()`` sees the update.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from colbert_torch.config import ColBERTConfig
from colbert_torch.indexing.ivf import build_ivf_native
from colbert_torch.models.encoder import ColBERTEncoder
from colbert_torch.storage import format as fmt

logger = logging.getLogger(__name__)

__all__ = ["IndexUpdater", "build_ivf_excluding", "deleted_eids_from_pids"]


def build_ivf_excluding(
    codes: np.ndarray, num_partitions: int, deleted_eids: np.ndarray | None
) -> tuple[np.ndarray, np.ndarray]:
    """IVF over ``codes`` with the ``deleted_eids`` rows excluded from every
    cell -> (ivf int32, lengths int32). Excluded rows take the virtual cell
    ``num_partitions``: they sort to the tail of the eid array and never
    count in ``lengths``, so no probe reaches them. The C++ counting sort,
    with a bit-identical numpy path."""
    codes_u = np.ascontiguousarray(codes, np.uint32)
    if deleted_eids is not None and len(deleted_eids):
        codes_u = codes_u.copy()
        codes_u[deleted_eids] = num_partitions
    native = build_ivf_native(codes_u, num_partitions)
    if native is not None:
        return native
    codes64 = codes_u.astype(np.int64)
    ivf = np.argsort(codes64, kind="stable").astype(np.int32)
    lengths = np.bincount(codes64, minlength=num_partitions + 1)[:num_partitions]
    return ivf, lengths.astype(np.int32)


def deleted_eids_from_pids(deleted_pids: np.ndarray, doclens: np.ndarray) -> np.ndarray:
    """Tombstoned pids -> their embedding row ids (contiguous per pid), int64."""
    doclens = np.asarray(doclens, np.int64)
    offsets = np.concatenate([[0], np.cumsum(doclens)])
    return np.concatenate(
        [np.arange(offsets[p], offsets[p + 1]) for p in np.asarray(deleted_pids)]
        or [np.zeros(0, np.int64)]
    ).astype(np.int64)


@dataclass
class IndexUpdater:
    """Add/remove passages on an existing on-disk index."""

    index_path: str
    encoder: ColBERTEncoder

    COMPACT_JOURNAL = "compact_commit.json"

    def __post_init__(self) -> None:
        missing = fmt.check_all_files_saved(self.index_path)
        if missing:
            raise FileNotFoundError(f"incomplete index at {self.index_path}: {missing}")
        self.config = ColBERTConfig.load(os.path.join(self.index_path, "config.json"))

    # ------------------------------------------------------------------

    def add(self, passages: Sequence[str]) -> np.ndarray:
        """Append ``passages`` as new chunks -> their assigned pids (int64).

        Compression uses the index's saved codec on ``encoder.device``; the
        IVF is rebuilt over all non-deleted embeddings, so the new passages
        are probeable by a fresh Searcher.
        """
        if not len(passages):
            return np.zeros((0,), np.int64)
        passages = list(passages)
        plan = fmt.load_plan(self.index_path)
        codec = fmt.load_codec(self.index_path)
        dev = self.encoder.device
        centroids = torch.from_numpy(codec["centroids"]).to(dev)
        cutoffs = torch.from_numpy(codec["bucket_cutoffs"]).to(dev)

        passage_offset = int(plan["num_documents"])
        chunksize = int(plan.get("chunksize") or len(passages))
        offsets = list(plan.get("embedding_offsets") or [])
        n_embs = int(plan.get("num_embeddings", 0))
        n_new_embs = 0
        first_chunk = int(plan["num_chunks"])
        # large additions split at the plan's chunksize, as the builder does
        for lo in range(0, len(passages), chunksize):
            codes, residuals, doclens = self.encoder.encode_passages_compressed(
                passages[lo:lo + chunksize], centroids, cutoffs, nbits=self.config.nbits)
            fmt.save_chunk(self.index_path, int(plan["num_chunks"]), codes=codes,
                           residuals=residuals, doclens=doclens,
                           passage_offset=passage_offset + lo)
            plan["num_chunks"] = int(plan["num_chunks"]) + 1
            offsets.append(n_embs + n_new_embs)
            n_new_embs += int(codes.shape[0])
        plan["num_documents"] = passage_offset + len(passages)
        plan["embedding_offsets"] = offsets
        plan["num_embeddings"] = n_embs + n_new_embs
        fmt.save_plan(self.index_path, plan)
        self._rebuild_ivf(plan)
        new_pids = np.arange(passage_offset, passage_offset + len(passages), dtype=np.int64)
        logger.info("added %d passages (%d embeddings) as chunks %d..%d; pids %d..%d",
                    len(passages), n_new_embs, first_chunk, int(plan["num_chunks"]) - 1,
                    new_pids[0], new_pids[-1])
        return new_pids

    def remove(self, pids: Sequence[int]) -> None:
        """Tombstone ``pids`` and rebuild the IVF without their embeddings.

        Idempotent; pids outside the collection raise ``ValueError``. Rows
        stay on disk until :meth:`compact`.
        """
        pids = np.unique(np.asarray(list(pids), np.int64))
        if not len(pids):
            return
        plan = fmt.load_plan(self.index_path)
        n_docs = int(plan["num_documents"])
        if pids.min() < 0 or pids.max() >= n_docs:
            raise ValueError(
                f"pids out of range [0, {n_docs}): {pids[(pids < 0) | (pids >= n_docs)]}")
        merged = np.union1d(fmt.load_deleted(self.index_path), pids)
        fmt.save_deleted(self.index_path, merged)
        self._rebuild_ivf(plan)
        logger.info("removed %d pids (%d tombstoned total)", len(pids), len(merged))

    def compact(self) -> np.ndarray:
        """Physically drop tombstoned rows -> old->new pid map (int64, -1
        for removed pids).

        Every chunk is rewritten without the deleted passages into a staging
        directory (one chunk in host memory at a time), pids are renumbered
        densely in chunk order, and the result is published only after the
        full pass: the commit journal is written durably first, then
        replayed (renames, plan, empty tombstones, IVF). A crash before the
        journal leaves the live index untouched; a crash after it is
        repaired by :meth:`finish_pending_compact`.
        """
        self.finish_pending_compact()
        plan = fmt.load_plan(self.index_path)
        deleted = fmt.load_deleted(self.index_path)
        n_docs = int(plan["num_documents"])
        pid_map = np.full(n_docs, -1, np.int64)
        keep_mask = np.ones(n_docs, bool)
        keep_mask[deleted] = False
        pid_map[keep_mask] = np.arange(int(keep_mask.sum()))
        if not len(deleted):
            return pid_map

        n_chunks = int(plan["num_chunks"])
        tmp_dir = os.path.join(self.index_path, "compact_tmp")
        os.makedirs(tmp_dir, exist_ok=True)
        passage_offset = total_embs = pid = 0
        offsets = []
        for ci in range(n_chunks):
            chunk = fmt.load_chunk(self.index_path, ci, mmap=True)
            dl = chunk["doclens"].astype(np.int64)
            keep = keep_mask[pid:pid + len(dl)]
            row_keep = np.repeat(keep, dl)
            fmt.save_chunk(tmp_dir, ci, codes=chunk["codes"][row_keep],
                           residuals=chunk["residuals"][row_keep],
                           doclens=dl[keep], passage_offset=passage_offset)
            offsets.append(total_embs)
            passage_offset += int(keep.sum())
            total_embs += int(row_keep.sum())
            pid += len(dl)
        self._write_compact_journal(
            num_chunks=n_chunks,
            plan_updates={"num_documents": passage_offset, "num_embeddings": total_embs,
                          "embedding_offsets": offsets},
        )
        self._replay_compact_journal()
        logger.info("compacted: %d pids removed, %d remain (%d embeddings)",
                    len(deleted), passage_offset, total_embs)
        return pid_map

    def finish_pending_compact(self) -> bool:
        """Complete a :meth:`compact` publish interrupted by a crash -> True
        if there was one.

        The replay is idempotent (renames that already happened find no
        staging file and are skipped), so rerunning it repairs a crash at
        any point. Called at the start of every ``compact()``; the
        interrupted call's pid map is lost (recompute it from the
        pre-compact tombstones if needed).
        """
        if not os.path.exists(os.path.join(self.index_path, self.COMPACT_JOURNAL)):
            return False
        logger.warning("found an interrupted compact() publish — completing it")
        self._replay_compact_journal()
        return True

    def _write_compact_journal(self, **journal) -> None:
        path = os.path.join(self.index_path, self.COMPACT_JOURNAL)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(journal, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _replay_compact_journal(self) -> None:
        journal_path = os.path.join(self.index_path, self.COMPACT_JOURNAL)
        with open(journal_path) as f:
            journal = json.load(f)
        tmp_dir = os.path.join(self.index_path, "compact_tmp")
        for ci in range(int(journal["num_chunks"])):
            for name in fmt.chunk_file_names(ci):
                src = os.path.join(tmp_dir, name)
                if os.path.exists(src):  # skip: the rename already happened
                    os.replace(src, os.path.join(self.index_path, name))
        if os.path.isdir(tmp_dir):
            os.rmdir(tmp_dir)
        plan = fmt.load_plan(self.index_path)
        plan.update(journal["plan_updates"])
        fmt.save_plan(self.index_path, plan)
        fmt.save_deleted(self.index_path, np.zeros((0,), np.int64))
        self._rebuild_ivf(plan)
        os.remove(journal_path)

    # ------------------------------------------------------------------

    def _rebuild_ivf(self, plan: dict) -> None:
        codes = fmt.load_all_codes(self.index_path, mmap=True)
        doclens = fmt.load_all_doclens(self.index_path)
        deleted = fmt.load_deleted(self.index_path)
        eids = deleted_eids_from_pids(deleted, doclens) if len(deleted) else None
        ivf, lengths = build_ivf_excluding(codes, int(plan["num_partitions"]), eids)
        fmt.save_ivf(self.index_path, ivf, lengths)
