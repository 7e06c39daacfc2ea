"""Index builder: the offline indexing pipeline (port of ``colbert_tpu.indexing.builder``).

Reference src/indexing.jl:24-147 (``Indexer`` + ``index``) and
src/indexing/collection_indexer.jl (sampling, plan, codec training, chunked
build, IVF). The same phases and the same artifacts as the JAX package, so
either package's ``Searcher`` opens an index built by the other:

  1. sample + encode: the sampled passages' embeddings stay on the device
     (a padded bf16 buffer plus host validity mask),
  2. plan (planner formulas), ``plan.json`` and ``config.json``,
  3. codec training: k-means over the sample's training rows, quantile
     cutoffs and weights over the heldout rows,
  4. fused encode+compress per chunk (resumable: a chunk whose four
     artifacts exist is skipped), or, when the sample is the whole
     collection and small, one compress pass over the sample,
  5. IVF from the in-memory codes.

``plan.json``'s ``timings`` hold each phase's seconds: a device phase's
from two CUDA events read when the build is done (no phase synchronizes
the device), a host phase's on the host clock. Each phase, and each file
write, is also a span of :mod:`colbert_torch.utils.tracing` under the
build's ``index`` span.

``np.random.default_rng(0)`` draws the sample, the heldout split and the
initial centroids, as in the JAX package, so both packages draw the same
ones. Multi-rank striding (``config.nranks``/``rank``: each rank builds
every ``nranks``-th chunk of a shared index directory, the last to finish
builds the IVF) is host and file logic and works as in the JAX package.

On a mesh (``config.mesh_data_axis`` or ``mesh_model_axis`` above 1; -1
takes every device of the ``device`` list) the encoder runs data-parallel,
and tensor-parallel over a model axis, and the codec trains sharded
(sharded Lloyd, histogram quantiles), as the JAX package's mesh build does.
``device`` may list the mesh's devices: ``["cuda:0"] * 2`` puts two data
shards on one card.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from colbert_torch.config import ColBERTConfig
from colbert_torch.indexing.codec_trainer import train_codec
from colbert_torch.indexing.ivf import build_ivf
from colbert_torch.indexing.planner import heldout_split_indices, sample_pids, setup_plan
from colbert_torch.models.encoder import ColBERTEncoder
from colbert_torch.storage import format as fmt
from colbert_torch.storage.collection import Collection
from colbert_torch.utils import tracing
from colbert_torch.utils.tracing import Tracer

logger = logging.getLogger(__name__)

__all__ = ["Indexer", "index", "load_collection", "build_ivf"]

# the small-corpus fast path compresses the device-resident sample when it
# holds at most this many (padded) rows
FAST_PATH_MAX_ROWS = 8_000_000


def load_collection(path_or_list):
    """A list of passages, a :class:`Collection`, or a file path (``.tsv``:
    ``pid\\ttext[\\t...]``; otherwise one passage per line, returned as a
    byte-backed :class:`Collection`)."""
    if isinstance(path_or_list, (list, tuple)):
        return list(path_or_list)
    if isinstance(path_or_list, Collection):
        return path_or_list
    return Collection.from_file(str(path_or_list))


@dataclass
class Indexer:
    """Loads the model and the collection; ``indexer.index(path)`` builds.

    Construct from ``config.checkpoint`` (a HF ColBERT checkpoint directory)
    or with a ready :class:`ColBERTEncoder`, which must live on ``device``
    (the first device of a list).
    """

    config: ColBERTConfig
    encoder: ColBERTEncoder | None = None
    collection: Sequence[str] | str | None = None
    device: str | torch.device | list = "cuda"

    def __post_init__(self) -> None:
        from colbert_torch.parallel.mesh import canonical, make_mesh, resolve_devices

        self.device, devices = resolve_devices(self.device)
        if self.encoder is None:
            from colbert_torch.models.hf_loader import load_checkpoint

            _, model, tokenizer = load_checkpoint(self.config.checkpoint, device=self.device)
            self.encoder = ColBERTEncoder(model, tokenizer, self.config, device=self.device)
        elif canonical(self.encoder.device) != canonical(self.device):
            raise ValueError(f"the encoder is on {self.encoder.device}, the Indexer "
                             f"on {self.device}")
        self.passages = load_collection(
            self.collection if self.collection is not None else self.config.collection
        )
        n_model = max(1, self.config.mesh_model_axis)
        n_data = self.config.mesh_data_axis
        if n_data == -1:
            n_data = (len(devices) if devices else
                      torch.cuda.device_count() if self.device.type == "cuda" else 1) // n_model
        self.mesh = None
        if n_data > 1 or n_model > 1:
            self.mesh = make_mesh(n_data, n_model, devices=devices, device=self.device)
            if self.encoder.mesh is None:
                self.encoder.attach_mesh(self.mesh)

    def index(self, index_path: str | None = None, *, overwrite: bool = False) -> str:
        index_path = index_path or self.config.index_path
        if not index_path:
            raise ValueError("no index_path given (argument or config.index_path)")
        with tracing.span("index", request=tracing.NEW):
            if os.path.exists(os.path.join(index_path, "plan.json")) and not overwrite:
                if not fmt.check_all_files_saved(index_path):
                    logger.info("index at %s already complete; skipping", index_path)
                    return index_path
            if overwrite:
                # rank 0 only: another rank clearing the shared directory would
                # delete rank 0's plan and codec under the waiting ranks
                if max(1, self.config.nranks) > 1 and self.config.rank != 0:
                    raise ValueError(
                        "overwrite=True is only valid on rank 0 in a multi-rank "
                        "build (it clears the shared index dir)"
                    )
                _clear_index_dir(index_path)
            os.makedirs(index_path, exist_ok=True)
            _build(self.config, self.encoder, self.passages, index_path)
            return index_path


def index(indexer: Indexer, index_path: str | None = None, **kw) -> str:
    """Functional alias mirroring the reference's ``index(indexer)`` export."""
    return indexer.index(index_path, **kw)


def _clear_index_dir(index_path: str) -> None:
    """Remove the index artifacts so ``overwrite=True`` starts clean."""
    if not os.path.isdir(index_path):
        return
    for name in os.listdir(index_path):
        if name.endswith((".npy", ".json")):
            os.remove(os.path.join(index_path, name))


def _resumable_codec(index_path: str, n_passages: int, *, nranks: int = 1,
                     rank: int = 0, wait_timeout_s: float = 3600.0):
    """-> (plan, codec) saved by an earlier or a concurrent build, or None.

    A saved codec is reused, never retrained: chunks already written were
    compressed against it. Completion is all four codec files
    (``avg_residual.json`` is written last), so a torn codec retrains. In a
    multi-rank build only rank 0 trains; the other ranks wait for its codec.
    A plan for another collection size raises."""
    def complete() -> bool:
        return (os.path.exists(os.path.join(index_path, "plan.json"))
                and fmt.codec_is_complete(index_path))

    if not complete():
        if nranks > 1 and rank != 0:
            logger.info("rank %d waiting for rank 0's codec", rank)
            deadline = time.time() + wait_timeout_s
            while not complete():
                if time.time() > deadline:
                    raise TimeoutError(
                        f"rank {rank}: no codec at {index_path} after "
                        f"{wait_timeout_s:.0f}s; is rank 0 running?"
                    )
                time.sleep(2.0)
        else:
            return None
    plan = fmt.load_plan(index_path)
    if int(plan.get("num_documents", -1)) != n_passages:
        raise RuntimeError(
            f"partial index at {index_path} was built from a different "
            f"collection ({plan.get('num_documents')} vs {n_passages} "
            "passages); pass overwrite=True to rebuild"
        )
    return plan, fmt.load_codec(index_path)


def _build(config: ColBERTConfig, encoder: ColBERTEncoder, passages, index_path: str) -> None:
    t0 = time.time()
    n = len(passages)
    if n == 0:
        raise ValueError("empty collection")
    dev = encoder.device
    rng = np.random.default_rng(0)
    tracer = Tracer()

    resumed = _resumable_codec(index_path, n, nranks=max(1, config.nranks), rank=config.rank)
    if resumed is not None:
        plan, codec = resumed
        logger.info("resuming build at %s: reusing saved codec (%d partitions)",
                    index_path, plan["num_partitions"])
        _build_chunks(config, encoder, passages, index_path, plan, tracer,
                      torch.from_numpy(codec["centroids"]).to(dev),
                      torch.from_numpy(codec["bucket_cutoffs"]).to(dev), t0)
        return

    # --- phase 1: sample + encode (collection_indexer.jl:56-91) ---
    with tracer.phase("sample_encode", dev):
        pids = sample_pids(n, rng)
        logger.info("sampling %d/%d passages for clustering", len(pids), n)
        sampled = (passages.take(pids) if isinstance(passages, Collection)
                   else [passages[p] for p in pids])
        sample_embs, sample_valid, sample_doclens, sample_layout = (
            encoder.encode_passages_to_device(sampled, return_layout=True))
    avg_doclen_est = float(sample_doclens.mean()) if len(sample_doclens) else 0.0

    with tracing.span("plan"):
        # heldout split over the valid rows (collection_indexer.jl:81-91)
        valid_idx = np.nonzero(sample_valid)[0]
        train_pos, heldout_pos = heldout_split_indices(len(valid_idx), rng)
        heldout_idx = valid_idx[heldout_pos]
        train_idx = valid_idx[train_pos]
        heldout = sample_embs[torch.from_numpy(heldout_idx).to(dev)]
        train_weights = np.zeros(len(sample_valid), np.float32)
        train_weights[train_idx] = 1.0
        n_train = len(train_idx)

        # --- phase 2: plan (collection_indexer.jl:115-139) ---
        plan = setup_plan(n, avg_doclen_est, n_train, config.chunksize, config.nranks)
        if config.num_partitions:
            plan["num_partitions"] = int(config.num_partitions)
        if plan["num_partitions"] > n_train:
            plan["num_partitions"] = n_train
        fmt.save_plan(index_path, plan)
        config.save(os.path.join(index_path, "config.json"))
    logger.info("plan: %d chunks x %d, %d partitions, est %.0f embeddings",
                plan["num_chunks"], plan["chunksize"], plan["num_partitions"],
                plan["num_embeddings_est"])

    # --- phase 3: codec training (collection_indexer.jl:219-237) ---
    t = time.time()
    with tracer.phase("codec_train", dev):
        init_idx = rng.choice(train_idx, size=plan["num_partitions"], replace=False)
        centroids, cutoffs, weights, avg_residual = train_codec(
            sample_embs, heldout,
            num_partitions=plan["num_partitions"], nbits=config.nbits,
            kmeans_niters=config.kmeans_niters,
            sample_weights=torch.from_numpy(train_weights).to(dev),
            init_idx=init_idx, mesh=encoder.mesh,
        )
    with tracing.span("write_codec"):
        fmt.save_codec(index_path, centroids.cpu().numpy(), cutoffs.cpu().numpy(),
                       weights.cpu().numpy(), avg_residual)
    logger.info("codec trained in %.1fs (avg_residual=%.4f)", time.time() - t, avg_residual)

    # small-corpus fast path: sample_pids takes the whole collection when
    # 16*sqrt(120*N) >= N (every N <= 30720), so the sample already holds the
    # corpus embeddings: compress them instead of encoding every chunk again.
    # Single-rank only (other ranks resume through the saved codec).
    precomputed = None
    if (config.nranks == 1 and len(pids) == n
            and sample_embs.shape[0] <= FAST_PATH_MAX_ROWS):
        with tracer.phase("chunk_encode_compress", dev):
            flat_codes, flat_res = encoder.compress_sample_to_host(
                sample_embs, sample_layout, sample_doclens, centroids, cutoffs,
                nbits=config.nbits)
        precomputed = (flat_codes, flat_res, sample_doclens)
    del sample_embs, heldout

    _build_chunks(config, encoder, passages, index_path, plan, tracer,
                  centroids, cutoffs, t0, precomputed=precomputed)


def _build_chunks(config: ColBERTConfig, encoder: ColBERTEncoder, passages,
                  index_path: str, plan: dict, tracer: Tracer,
                  centroids: torch.Tensor, cutoffs: torch.Tensor, t0: float,
                  precomputed: tuple | None = None) -> None:
    # --- phase 4: fused encode+compress per chunk (collection_indexer.jl:271-297) ---
    n = len(passages)
    chunksize = plan["chunksize"]
    nranks = max(1, config.nranks)
    if precomputed is not None:
        pre_codes, pre_res, pre_doclens = precomputed
        pre_offsets = np.concatenate([[0], np.cumsum(pre_doclens)]).astype(np.int64)
    all_codes: list[np.ndarray | None] = []
    for chunk_idx in range(plan["num_chunks"]):
        lo = chunk_idx * chunksize
        hi = min(n, lo + chunksize)
        if fmt.chunk_is_complete(index_path, chunk_idx):
            all_codes.append(fmt.load_chunk(index_path, chunk_idx)["codes"])
            logger.info("chunk %d already complete; resumed", chunk_idx)
            continue
        if nranks > 1 and chunk_idx % nranks != config.rank:
            all_codes.append(None)  # another rank's chunk, not built yet
            continue
        t = time.time()
        if precomputed is not None:
            codes = pre_codes[pre_offsets[lo]:pre_offsets[hi]]
            residuals = pre_res[pre_offsets[lo]:pre_offsets[hi]]
            doclens = pre_doclens[lo:hi]
        else:
            with tracer.phase("chunk_encode_compress"):
                codes, residuals, doclens = encoder.encode_passages_compressed(
                    passages[lo:hi], centroids, cutoffs, nbits=config.nbits)
        with tracing.span("write_chunk"):
            fmt.save_chunk(index_path, chunk_idx, codes=codes, residuals=residuals,
                           doclens=doclens, passage_offset=lo)
        all_codes.append(codes)
        logger.info("chunk %d/%d: %d passages, %d embeddings in %.1fs",
                    chunk_idx + 1, plan["num_chunks"], hi - lo, codes.shape[0],
                    time.time() - t)

    if any(c is None for c in all_codes):
        # other ranks' chunks may have landed since the loop looked
        for chunk_idx, c in enumerate(all_codes):
            if c is None and fmt.chunk_is_complete(index_path, chunk_idx):
                all_codes[chunk_idx] = fmt.load_chunk(index_path, chunk_idx)["codes"]
    if any(c is None for c in all_codes):
        done = sum(c is not None for c in all_codes)
        logger.info("rank %d/%d finished its chunks (%d/%d complete overall); the "
                    "final rank to complete builds the IVF",
                    config.rank, nranks, done, plan["num_chunks"])
        return

    # --- phase 5: offsets + IVF (indexing.jl:119-143) ---
    counts = [int(c.shape[0]) for c in all_codes]
    plan["num_embeddings"] = int(sum(counts))
    plan["embedding_offsets"] = np.cumsum([0] + counts[:-1]).tolist()
    with tracer.phase("build_ivf"):
        ivf, ivf_lengths = build_ivf(np.concatenate(all_codes), plan["num_partitions"])
        fmt.save_ivf(index_path, ivf, ivf_lengths)
    with tracing.span("write_plan"):
        plan["timings"] = tracer.as_dict()
        plan["total_build_seconds"] = round(time.time() - t0, 3)
        fmt.save_plan(index_path, plan)
        missing = fmt.check_all_files_saved(index_path)
    if missing:
        raise RuntimeError(f"index build incomplete; missing {missing}")
    logger.info("index built at %s in %.1fs", index_path, time.time() - t0)
