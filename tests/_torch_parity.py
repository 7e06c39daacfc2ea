"""Shared helpers of the ``test_torch_*`` parity tests (the PyTorch port held
against the JAX package on the same numpy inputs)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch


def to_numpy(tree):
    """A JAX pytree of arrays -> the same structure of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def build_reference_index(path: str, *, nbits: int = 2, n_passages: int = 60,
                          seed: int = 0, **cfg_overrides):
    """Index a synthetic collection with the JAX package's ``Indexer``
    -> (config, JAX encoder, passages, path)."""
    from colbert_tpu.config import ColBERTConfig
    from colbert_tpu.indexing.builder import Indexer
    from colbert_tpu.utils.testing import make_encoder, synthetic_collection

    kw = dict(dim=32, doc_maxlen=64, query_maxlen=16, index_bsize=8,
              length_bucket=16, chunksize=32, nbits=nbits, kmeans_niters=5,
              nprobe=4)
    kw.update(cfg_overrides)
    cfg = ColBERTConfig(**kw)
    encoder = make_encoder(dim=32, seed=seed, config=cfg)
    passages = synthetic_collection(n_passages, seed=2)
    Indexer(cfg, encoder=encoder, collection=passages).index(path)
    return cfg, encoder, passages, path


def port_encoder(jax_encoder, *, device: str = "cpu"):
    """The port's encoder carrying the JAX encoder's weights, tokenizer
    vocab and config."""
    from colbert_torch.config import ColBERTConfig
    from colbert_torch.models.bert import BertConfig
    from colbert_torch.models.colbert import from_jax_params
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.tokenization.wordpiece import WordPieceTokenizer

    bert_cfg = BertConfig(**jax_encoder.bert_config.__dict__)
    model = from_jax_params(to_numpy(jax_encoder.params), bert_cfg)
    cfg = ColBERTConfig.from_dict(jax_encoder.config.to_dict())
    tok = WordPieceTokenizer(dict(jax_encoder.tokenizer.vocab))
    return ColBERTEncoder(model, tok, cfg, device=device)


def assert_topk_agree(p1, s1, p2, s2, tol: float) -> None:
    """Two top-k results agree up to ties: scores position by position
    within ``tol``, shared pids scored within ``tol``, and a pid found in
    only one result scored within ``tol`` of that row's k-th score (a tie
    at the cut, where either side may keep either pid)."""
    np.testing.assert_allclose(s1, s2, atol=tol, rtol=0)
    for r in range(p1.shape[0]):
        a = {int(p): float(s) for p, s in zip(p1[r], s1[r]) if p >= 0}
        b = {int(p): float(s) for p, s in zip(p2[r], s2[r]) if p >= 0}
        for pid in a.keys() & b.keys():
            assert abs(a[pid] - b[pid]) <= tol, (r, pid, a[pid], b[pid])
        finite = [s for s in list(s1[r]) + list(s2[r]) if np.isfinite(s)]
        cut = min(finite) if finite else 0.0
        for pid in a.keys() ^ b.keys():
            s = a.get(pid, b.get(pid))
            assert s - cut <= tol, f"row {r}: pid {pid} ({s}) not a tie at the cut {cut}"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work in one thread (import this fixture into a test
    module): beside the suite's other xdist workers, torch's thread pool
    waits at every op's barrier for descheduled threads, and one thread
    also fixes the order of every CPU reduction."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
