"""ColBERT configuration (PyTorch port).

A copy of :mod:`colbert_tpu.config`: the same fields and defaults, so either
package loads the other's ``config.json``. The one difference is that
``probe_comp_saturation`` must be positive (the JAX package divides by it in
``probe_compensation`` and raises ZeroDivisionError on 0).

The original module is the accelerator analogue of the reference's single
``ColBERTConfig`` kwdef struct (reference: src/infra/config.jl:54-90). Same
capability contract — run / tokenization / resource / doc / query /
indexing / search settings with the same defaults — plus accelerator knobs
(mesh shape, dtypes, kernel toggles) the single-GPU reference does not
have. The comments say what each knob does and which way it trades; the
port's measured figures are in PERF.md.

Unlike the reference's JSON loader (src/loaders.jl:66-74, which ``eval``s
kwargs — a wart we deliberately do not copy), (de)serialization here is a
plain dataclass <-> dict mapping with unknown-key tolerance for forward
compatibility.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any


@dataclass
class ColBERTConfig:
    # -- run settings (reference config.jl:57-63) --
    # parity-only (reference config.jl:13-14 "only supports one GPU"): the
    # port never reads it — every entry point takes an explicit ``device``
    use_gpu: bool = True
    rank: int = 0
    nranks: int = 1

    # -- tokenization settings (reference config.jl:64-70) --
    query_token_id: str = "[unused0]"
    doc_token_id: str = "[unused1]"
    query_token: str = "[Q]"
    doc_token: str = "[D]"

    # -- resource settings (reference config.jl:71-76) --
    checkpoint: str = "colbert-ir/colbertv2.0"
    collection: str = ""
    index_path: str = ""

    # -- doc settings (reference config.jl:72) --
    dim: int = 128
    doc_maxlen: int = 300
    mask_punctuation: bool = True

    # -- query settings (reference config.jl:76-78) --
    query_maxlen: int = 32
    attend_to_mask_tokens: bool = False

    # -- indexing settings (reference config.jl:79-87) --
    index_bsize: int = 64
    chunksize: int | None = None
    passages_batch_size: int = 5000
    nbits: int = 2
    kmeans_niters: int = 20
    # IVF partition count. None = the reference's planner formula
    # (2^floor(log2(16*sqrt(est_embeddings))), collection_indexer.jl:115-139).
    # A serving knob the reference does not expose: stage-1 cost per query
    # is nprobe_eff * cell_cap entries, and cell sizes scale with
    # N/partitions, so more partitions shrink cells, cell splits and the
    # per-query entry budget at the price of a proportionally longer
    # k-means (and a finer quantization). Clamped to the training-sample
    # size.
    num_partitions: int | None = None

    # -- search settings (reference config.jl:88-89) --
    nprobe: int = 2
    ncandidates: int = 8192

    # -- accelerator settings (no reference equivalent) --
    # dtype used for encoder activations; params are kept fp32 and cast in.
    activation_dtype: str = "bfloat16"
    # dtype of encode_passages outputs on the device->host copy. bf16 halves
    # the bytes of fp32 and rounds unit-norm values by ~1/256, below the
    # residual codec's bucket granularity; "float32" gives exact outputs;
    # "int8" sends round(x*127) (hosts divide by 127), half bf16's bytes at
    # the same order of error. The fused build path sends only codes and
    # packed residuals and never reads this; query encodes stay fp32.
    transfer_dtype: str = "bfloat16"
    # mesh axis sizes; data axis shards batches/collection, model axis reserved
    # for tensor parallelism of the encoder (dense/attention head sharding).
    # -1 => every device of the entry point's device list (one device
    # without a list); see colbert_torch.parallel.mesh
    mesh_data_axis: int = -1
    mesh_model_axis: int = 1
    # let the doc encoder route attention through the flash-attention
    # kernel (the port: on CUDA only; on the CPU nothing routes there)
    use_pallas: bool = True
    # the encoder routes a doc batch's attention through the flash-attention
    # kernel when its padded length is at least this and a multiple of 128
    # (the kernel's requirement; where this can trigger, doc length buckets
    # become 128 wide). The default is above BERT's 512 positions, so it
    # routes nothing unless lowered. H100 times of the kernel, the
    # materialized attention and torch's SDPA are in PERF.md.
    flash_min_seqlen: int = 2048
    # length bucketing for doc encoding: pad each batch up to the next multiple
    # of this, bounded by doc_maxlen, to limit recompilation while avoiding
    # always padding to doc_maxlen.
    length_bucket: int = 64
    # staged PLAID-style pruning: number of candidate passages kept after the
    # approximate (centroid-only) scoring stage. The reference defines
    # `ncandidates` but never uses it (SURVEY §3.4); here it is meaningful.
    use_plaid_pruning: bool = True
    # probed IVF cells with centroid score below this generate no candidates
    # (each query token's best cell is always kept); None disables cell
    # pruning. PLAID's default operating point is 0.45 (PAPERS.md).
    centroid_score_threshold: float | None = 0.45
    # candidates that survive stage-1 (centroid-only scoring) into the full
    # decompress+MaxSim stage-2. None = max(16*k, 1024), PLAID's operating
    # point. The latency/recall dial: fewer candidates cost less stage-2
    # time and lose recall where near-tied passages are interchangeable at
    # stage-1 granularity. Ignored when use_plaid_pruning is off (everything
    # is fully scored).
    plaid_stage2_docs: int | None = None
    # hybrid stage-1: rank all candidates with the cheap gather-free probed
    # bound, then re-rank a refine_width_factor-wide cut with the full
    # centroid interaction before the stage-2 budget. The probed bound alone
    # cannot separate near-duplicate candidates (same cells -> tied
    # scores); the refine restores funnel precision for the cost of its
    # gathers. It can only change the result when ncandidates is below the
    # dedup width; at ncandidates >= max_candidates it is skipped. Trades
    # per-batch time for recall at depth; the alternative dial is more
    # probes.
    plaid_stage1_refine: bool = True
    # width of the stage-1 refine window, as a multiple of the stage-2
    # budget: the refine re-ranks min(refine_width_factor * ncandidates,
    # search_max_candidates) candidates with the full centroid interaction.
    # Its cost is ~linear in this factor (it gathers width * max_doclen
    # centroid rows per query); a narrower window costs less and keeps less
    # recall where the stage-1 bound orders candidates poorly. A per-corpus
    # dial.
    refine_width_factor: int = 4
    # device-search capacity knobs (static shapes of the jitted search
    # program). None = auto-size from the index: cell_cap from the largest
    # IVF cell, max_candidates from the passage count — exact but memory-
    # hungry on big indexes; set explicitly to trade recall for speed.
    # Candidate-set truncation is score-ordered and overflow is counted
    # (DeviceIndex.overflow_candidates) and logged.
    search_cell_cap: int | None = None
    search_max_candidates: int | None = None
    # balanced IVF: cells larger than this split into sub-cells with
    # duplicated probe centroids, bounding the static per-probe entry budget
    # (oversized cells cost extra probe slots, truncated beyond 4 sub-cells).
    # None = 1024. Set 0 to disable splitting.
    # The cap is also the dominant stage-1 cost term (per-query work scales
    # with nprobe * cell_cap) and its best value depends on the corpus: a
    # smaller cap is faster and keeps recall where large cells hold
    # near-duplicates, and loses recall where they hold real mass. 1024 is
    # the safe default.
    ivf_balance_cap: int | None = None
    # add up to (probe_dup_max - 1) probe slots so split cells' duplicates
    # don't crowd out distinct cells (recall-preserving, costs entry budget
    # ~= the unbalanced index). The compensation scales with the fraction
    # of the corpus living in split cells (device_index.probe_compensation):
    # an index where one stray cell split pays ~nothing, one whose hot
    # cells all split pays the full worst case. False probes exactly nprobe
    # slots: faster, but a query token whose best cell was split may probe
    # ONLY that cell.
    probe_dup_compensation: bool = True
    # split-cell mass fraction at which the probe-dup compensation saturates
    # to the full worst case (dup_max - 1 extra probes); below it the extra
    # probes scale linearly with the mass. A higher value probes fewer extra
    # slots (faster, less recall at depth); the default stays
    # recall-maximal. See device_index.probe_compensation.
    probe_comp_saturation: float = 0.05

    def __post_init__(self) -> None:
        if self.dim % 8 != 0:
            raise ValueError("dim must be a multiple of 8 (bit-packed residuals)")
        if not (0 <= self.rank < max(1, self.nranks)):
            raise ValueError("rank must satisfy 0 <= rank < nranks")
        if self.nbits not in (1, 2, 4, 8):
            raise ValueError("nbits must be one of 1, 2, 4, 8")
        if self.query_maxlen < 3:
            raise ValueError("query_maxlen must be >= 3 ([CLS] [Q] + content)")
        if self.doc_maxlen < 3:
            raise ValueError("doc_maxlen must be >= 3 ([CLS] [D] + content)")
        if not self.probe_comp_saturation > 0:
            raise ValueError("probe_comp_saturation must be > 0")
        if self.transfer_dtype not in ("bfloat16", "float16", "float32", "int8"):
            raise ValueError(
                "transfer_dtype must be bfloat16, float16, float32 or int8"
            )

    # -- (de)serialization: plain JSON, field-name keyed --

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ColBERTConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def save(self, path: str) -> None:
        """Write config.json (reference: src/savers.jl:110-121)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "ColBERTConfig":
        """Read config.json (reference: src/loaders.jl:66-74, minus the eval)."""
        with open(path) as f:
            return cls.from_dict(json.load(f))
