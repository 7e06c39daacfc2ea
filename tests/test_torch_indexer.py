"""The port's ``Indexer(device="cpu")`` vs the reference ``Indexer`` on the
same collection, with the reference encoder's weights carried over, at fp32
activations. The reference runs on one device (``mesh_data_axis=1``): its
8-device CPU mesh would take the sharded codec trainer, whose histogram
quantiles are approximate.

- The plan (partitions, chunks, embeddings, offsets) and the doclens are
  identical.
- Centroids, cutoffs, weights and the mean residual agree within 2^-8, one
  bf16 step of a unit-norm component: the codec-training sample is kept in
  bf16 in both packages, and an fp32 value within rounding of a bf16
  midpoint may round to either neighbour.
- Codes agree on >= 99% of rows, and every row whose code differs is a
  near-tie: its two codes score within 2^-6 of each other against the
  port's centroids (bf16 sample rows move a score by up to 2^-8, and the
  centroids differ by up to 2^-8 per component).
- Residual bytes agree wherever codes do, up to the buckets whose value
  lies within 2^-8 of a cutoff (the same bf16 step).
- Resume skips complete chunks, ``overwrite=True`` clears stale ones, and
  each package's ``Searcher`` answers over the other's index.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.config import ColBERTConfig as JConfig
from colbert_tpu.indexing.builder import Indexer as JIndexer
from colbert_tpu.models.bert import BertConfig as JBertConfig
from colbert_tpu.ops import codec as jcodec
from colbert_tpu.retrieval.searcher import Searcher as JSearcher
from colbert_tpu.utils.testing import make_encoder, synthetic_collection
from colbert_torch.config import ColBERTConfig
from colbert_torch.indexing import builder as tbuilder
from colbert_torch.indexing.builder import Indexer
from colbert_torch.retrieval.searcher import Searcher
from colbert_torch.storage import format as fmt

from _torch_parity import one_torch_thread, port_encoder  # noqa: F401

BF16_STEP = 2.0 ** -8
NEAR_TIE = 2.0 ** -6

SHORT = dict(dim=32, doc_maxlen=64, query_maxlen=16, index_bsize=8, length_bucket=16,
             chunksize=16, nbits=2, kmeans_niters=6, nprobe=4)
LONG = dict(dim=32, doc_maxlen=640, query_maxlen=16, index_bsize=4, length_bucket=128,
            chunksize=8, nbits=2, kmeans_niters=4, nprobe=4)


def _build_both(tmp_path_factory, name, cfg_kw, n, seed, words, bert_cfg=None):
    cfg = JConfig(mesh_data_axis=1, activation_dtype="float32", **cfg_kw)
    jenc = make_encoder(dim=32, seed=0, config=cfg, bert_config=bert_cfg)
    passages = synthetic_collection(n, seed=seed, words_per_doc=words)
    root = tmp_path_factory.mktemp(name)
    jpath, tpath = str(root / "ref"), str(root / "port")
    JIndexer(cfg, encoder=jenc, collection=passages).index(jpath)
    tenc = port_encoder(jenc)
    tcfg = ColBERTConfig.from_dict(cfg.to_dict())
    Indexer(tcfg, encoder=tenc, collection=passages, device="cpu").index(tpath)
    return dict(cfg=cfg, tcfg=tcfg, jenc=jenc, tenc=tenc, passages=passages,
                jpath=jpath, tpath=tpath)


@pytest.fixture(scope="module")
def short(tmp_path_factory):
    return _build_both(tmp_path_factory, "short", SHORT, 40, 1, 12)


@pytest.fixture(scope="module")
def long(tmp_path_factory):
    bert = JBertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128,
                       max_position_embeddings=768)
    return _build_both(tmp_path_factory, "long", LONG, 12, 6, 600, bert)


def _assert_codes_agree(b, jpath, tpath):
    cj, ct = fmt.load_codec(jpath), fmt.load_codec(tpath)
    codes_j, codes_t = fmt.load_all_codes(jpath), fmt.load_all_codes(tpath)
    res_j, res_t = fmt.load_all_residuals(jpath), fmt.load_all_residuals(tpath)
    same = codes_j == codes_t
    assert same.mean() >= 0.99, same.mean()
    flat, _ = b["jenc"].encode_passages(b["passages"])
    cent = ct["centroids"]
    rows = np.nonzero(~same)[0]
    gap = np.abs((flat[rows] * (cent[codes_t[rows]] - cent[codes_j[rows]])).sum(axis=1))
    assert (gap <= NEAR_TIE).all(), gap
    # residual buckets: equal unless the value sits within a bf16 step of a cutoff
    res = flat[same] - cent[codes_t[same]]
    near_cut = (np.abs(res[..., None] - ct["bucket_cutoffs"]) <= BF16_STEP).any(-1)
    nbits = b["cfg"].nbits
    bj = np.asarray(jcodec.unbinarize(jcodec.unpack_bits(jnp.asarray(res_j[same]), nbits)))
    bt = np.asarray(jcodec.unbinarize(jcodec.unpack_bits(jnp.asarray(res_t[same]), nbits)))
    assert ((bj == bt) | near_cut).all()


@pytest.mark.parametrize("case", ["short", "long"])
def test_index_matches_reference(request, case):
    b = request.getfixturevalue(case)
    jpath, tpath = b["jpath"], b["tpath"]
    assert fmt.check_all_files_saved(tpath) == []
    pj, pt = fmt.load_plan(jpath), fmt.load_plan(tpath)
    for key in ("num_partitions", "num_chunks", "num_embeddings", "embedding_offsets",
                "num_documents", "chunksize", "avg_doclen_est"):
        assert pt[key] == pj[key], key
    assert {"sample_encode", "codec_train", "chunk_encode_compress",
            "build_ivf"} <= set(pt["timings"])
    np.testing.assert_array_equal(fmt.load_all_doclens(tpath), fmt.load_all_doclens(jpath))
    cj, ct = fmt.load_codec(jpath), fmt.load_codec(tpath)
    for key in ("centroids", "bucket_cutoffs", "bucket_weights"):
        assert ct[key].dtype == np.float32 and ct[key].shape == cj[key].shape
        np.testing.assert_allclose(ct[key], cj[key], atol=BF16_STEP, rtol=0)
    assert abs(ct["avg_residual"] - cj["avg_residual"]) <= BF16_STEP
    _assert_codes_agree(b, jpath, tpath)
    ivf, lengths = fmt.load_ivf(tpath)
    codes = fmt.load_all_codes(tpath)
    np.testing.assert_array_equal(lengths, np.bincount(codes, minlength=pt["num_partitions"]))
    np.testing.assert_array_equal(ivf, np.argsort(codes, kind="stable"))
    if case == "long":  # long docs are not truncated at 512
        assert int(np.median(fmt.load_all_doclens(tpath))) > 400


def test_resume_rebuilds_only_the_missing_chunk(short, tmp_path, monkeypatch):
    """The rebuilt chunk goes through the fused per-chunk encode+compress
    (the saved codec is reused, never retrained) and agrees with the
    reference's chunk under the near-tie rule."""
    path = str(tmp_path / "resume")
    shutil.copytree(short["tpath"], path)
    os.remove(os.path.join(path, "1.codes.npy"))
    before = fmt.load_chunk(path, 0)["codes"].copy()
    centroids = np.load(os.path.join(path, "centroids.npy")).copy()

    def boom(*a, **k):
        raise AssertionError("train_codec must not run on resume")

    monkeypatch.setattr(tbuilder, "train_codec", boom)
    Indexer(short["tcfg"], encoder=short["tenc"], collection=short["passages"],
            device="cpu").index(path)
    assert fmt.check_all_files_saved(path) == []
    np.testing.assert_array_equal(fmt.load_chunk(path, 0)["codes"], before)
    np.testing.assert_array_equal(np.load(os.path.join(path, "centroids.npy")), centroids)
    _assert_codes_agree(short, short["jpath"], path)
    with pytest.raises(RuntimeError, match="different"):
        os.remove(os.path.join(path, "ivf.npy"))
        Indexer(short["tcfg"], encoder=short["tenc"], collection=short["passages"][:-3],
                device="cpu").index(path)


def test_overwrite_clears_stale_chunks(short, tmp_path):
    path = str(tmp_path / "overwrite")
    shutil.copytree(short["tpath"], path)
    shutil.copy(os.path.join(path, "1.codes.npy"), os.path.join(path, "9.codes.npy"))
    Indexer(short["tcfg"], encoder=short["tenc"], collection=short["passages"],
            device="cpu").index(path, overwrite=True)
    assert not os.path.exists(os.path.join(path, "9.codes.npy"))
    assert fmt.check_all_files_saved(path) == []
    np.testing.assert_array_equal(fmt.load_all_codes(path), fmt.load_all_codes(short["tpath"]))


def _self_hits(searcher, passages, probe=(0, 5, 11, 23, 37)):
    pids, _ = searcher.search_batch([passages[p] for p in probe], k=3)
    return sum(p in row for p, row in zip(probe, pids.tolist()))


def test_cross_load_self_retrieval(short):
    """Each package's Searcher answers over the other package's index, with
    self-retrieval as in tests/test_e2e.py (>= 4 of 5 in the top 3)."""
    passages = short["passages"]
    jsearch = JSearcher(short["tpath"], encoder=short["jenc"])
    tsearch = Searcher(short["jpath"], encoder=short["tenc"], device="cpu")
    assert _self_hits(jsearch, passages) >= 4
    assert _self_hits(tsearch, passages) >= 4


def test_device_and_mesh_rules(short):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Indexer(short["tcfg"], encoder=short["tenc"], collection=short["passages"])
    # a data axis above one device builds a mesh and attaches it to the
    # encoder (the CPU repeated); more devices than the list holds raise
    cfg = ColBERTConfig.from_dict(dict(short["tcfg"].to_dict(), mesh_data_axis=2))
    enc = port_encoder(short["jenc"])
    idx = Indexer(cfg, encoder=enc, collection=short["passages"], device="cpu")
    assert idx.mesh.shape == {"data": 2, "model": 1} and enc.mesh is idx.mesh
    cfg4 = ColBERTConfig.from_dict(dict(short["tcfg"].to_dict(), mesh_data_axis=4))
    with pytest.raises(ValueError, match="needs 4 devices"):
        Indexer(cfg4, encoder=port_encoder(short["jenc"]), collection=short["passages"],
                device=["cpu", "cpu"])
    assert Indexer(short["tcfg"], encoder=short["tenc"], collection=short["passages"],
                   device="cpu").mesh is None  # -1: the one device this Indexer drives
    assert tbuilder.load_collection(["a", "b"]) == ["a", "b"]
