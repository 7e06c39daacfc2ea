"""colbert_torch — the PyTorch/CUDA port of colbert_tpu for NVIDIA Hopper.

A second package beside the JAX reference (``colbert_tpu``), reading and
writing the same on-disk index format and ``config.json``. It imports
``torch`` and never ``jax`` or ``colbert_tpu``. Entry points take a
``device`` that defaults to ``"cuda"`` and raise when no GPU is present
unless the caller passes ``device="cpu"``.

Ported so far:

- the serving path ``Searcher.search_batch`` (query tokenize, BERT query
  encode, the device search funnel) with the stage-2 fused
  decompress+MaxSim CUDA kernel (``csrc/stage2_maxsim.cu``), and the
  reference-shaped host backend (``Searcher(backend="host")``,
  :mod:`~colbert_torch.retrieval.ranking`);
- the build path ``Indexer.index`` (sample encode, k-means and quantile
  codec training, fused doc encode+compress per chunk, IVF) whose doc
  encode routes attention through the flash-attention CUDA kernel
  (``csrc/flash_attention.cu``);
- the life of a live index: ``IndexUpdater`` (add, remove, compact),
  :mod:`~colbert_torch.serving` (``BatchingSearcher`` and its HTTP front),
  and :mod:`~colbert_torch.evaluation` (metrics, dataset runners, the exact
  oracle and the operating-point tuner).

Training and the multi-device layer are still to come (ROADMAP.md).
"""

from colbert_torch.config import ColBERTConfig

__version__ = "0.1.0"

__all__ = ["ColBERTConfig", "Indexer", "index", "Searcher", "search", "IndexUpdater",
           "__version__"]


def __getattr__(name):  # lazy: keep `import colbert_torch` light
    if name in ("Searcher", "search"):
        from colbert_torch.retrieval.searcher import Searcher, search

        return {"Searcher": Searcher, "search": search}[name]
    if name in ("Indexer", "index"):
        from colbert_torch.indexing.builder import Indexer, index

        return {"Indexer": Indexer, "index": index}[name]
    if name == "IndexUpdater":
        from colbert_torch.indexing.updater import IndexUpdater

        return IndexUpdater
    raise AttributeError(f"module 'colbert_torch' has no attribute {name!r}")
