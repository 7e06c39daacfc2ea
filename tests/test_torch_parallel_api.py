"""The multi-device layer through the port's public API: ``Indexer`` on a
mesh (data-parallel encode, sharded Lloyd, histogram quantiles; and a 4x2
data x tensor-parallel mesh) against the JAX ``Indexer`` on the same mesh
size, each package loading the other's index; ``Searcher(backend="sharded")``
against the JAX sharded ``Searcher``; ``search_stream`` and the
``BatchingSearcher`` on the sharded backend; and ``dryrun_multichip(4)``.
The JAX side runs on the 8-device virtual CPU mesh, the port on the CPU
repeated (fp32 activations in both).

Tolerances are those of tests/test_torch_indexer.py: the codec-training
sample is bf16 in both packages, so centroids, cutoffs and weights agree
within 2^-8 (one bf16 step), codes on >= 99% of rows. Search results on one
index agree up to ties with scores within 1e-4.
"""

import os

import numpy as np
import pytest

from colbert_tpu.config import ColBERTConfig as JConfig
from colbert_tpu.indexing.builder import Indexer as JIndexer
from colbert_tpu.retrieval.searcher import Searcher as JSearcher
from colbert_tpu.utils.testing import make_encoder, synthetic_collection
from colbert_torch.config import ColBERTConfig
from colbert_torch.indexing.builder import Indexer
from colbert_torch.retrieval.searcher import Searcher
from colbert_torch.storage import format as fmt

from _torch_parity import assert_topk_agree, one_torch_thread, port_encoder  # noqa: F401

BF16_STEP = 2.0 ** -8
TOL = 1e-4
CFG = dict(dim=32, doc_maxlen=64, query_maxlen=16, index_bsize=8, length_bucket=16,
           chunksize=32, nbits=2, kmeans_niters=5, nprobe=4, activation_dtype="float32")


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    passages = synthetic_collection(64, seed=3)
    out = {}
    for name, n_data, n_model in [("dp", 4, 1), ("tp", 4, 2)]:
        cfg = JConfig(mesh_data_axis=n_data, mesh_model_axis=n_model, **CFG)
        jenc = make_encoder(dim=32, seed=0, config=cfg)
        root = tmp_path_factory.mktemp(f"mesh_{name}")
        jpath, tpath = str(root / "ref"), str(root / "port")
        jidx = JIndexer(cfg, encoder=jenc, collection=passages)
        assert dict(jidx.mesh.shape) == {"data": n_data, "model": n_model}
        tenc = port_encoder(jenc)
        tidx = Indexer(ColBERTConfig.from_dict(cfg.to_dict()), encoder=tenc,
                       collection=passages, device="cpu")
        assert tidx.mesh.shape == {"data": n_data, "model": n_model}
        assert tenc.mesh is tidx.mesh  # the encode runs over the mesh
        jidx.index(jpath)
        tidx.index(tpath)
        out[name] = dict(cfg=cfg, jenc=jenc, tenc=tenc, jpath=jpath, tpath=tpath)
    return passages, out


@pytest.mark.parametrize("name", ["dp", "tp"])
def test_mesh_build_matches_reference(builds, name):
    passages, out = builds
    b = out[name]
    jpath, tpath = b["jpath"], b["tpath"]
    assert fmt.check_all_files_saved(tpath) == []
    pj, pt = fmt.load_plan(jpath), fmt.load_plan(tpath)
    for key in ("num_partitions", "num_chunks", "num_embeddings", "embedding_offsets",
                "num_documents", "avg_doclen_est"):
        assert pt[key] == pj[key], key
    np.testing.assert_array_equal(fmt.load_all_doclens(tpath), fmt.load_all_doclens(jpath))
    cj, ct = fmt.load_codec(jpath), fmt.load_codec(tpath)
    for key in ("centroids", "bucket_cutoffs", "bucket_weights"):
        np.testing.assert_allclose(ct[key], cj[key], atol=BF16_STEP, rtol=0)
    assert abs(ct["avg_residual"] - cj["avg_residual"]) <= BF16_STEP
    same = fmt.load_all_codes(jpath) == fmt.load_all_codes(tpath)
    assert same.mean() >= 0.99, same.mean()


def test_mesh_codec_is_the_sharded_trainers(builds, monkeypatch):
    """The mesh build trains its codec through the sharded trainer: its
    cutoffs come from the histogram quantiles, not the exact ones."""
    from colbert_torch.indexing import codec_trainer
    from colbert_torch.ops import quantile

    passages, out = builds
    calls = []
    sharded = quantile.sharded_quantiles

    def recording(*a, **kw):
        calls.append(a[2].shape)
        return sharded(*a, **kw)

    monkeypatch.setattr(quantile, "sharded_quantiles", recording)
    b = out["dp"]
    cfg = ColBERTConfig.from_dict(dict(b["cfg"].to_dict(), chunksize=64))
    path = os.path.join(os.path.dirname(b["tpath"]), "again")
    Indexer(cfg, encoder=b["tenc"], collection=passages[:40], device="cpu").index(path)
    assert calls == [{"data": 4, "model": 1}]
    assert codec_trainer.SYNC_EVERY == 5


def test_cross_load(builds):
    """Each package's Searcher answers over the other's mesh-built index:
    self-retrieval (>= 4 of 5 in the top 3), as tests/test_torch_indexer.py."""
    passages, out = builds
    probe = (0, 5, 11, 23, 37)
    for name in ("dp", "tp"):
        b = out[name]
        js = JSearcher(b["tpath"], encoder=make_encoder(dim=32, seed=0, config=b["cfg"]))
        ts = Searcher(b["jpath"], encoder=port_encoder(b["jenc"]), device="cpu")
        for s in (js, ts):
            pids, _ = s.search_batch([passages[p] for p in probe], k=3)
            assert sum(p in row for p, row in zip(probe, pids.tolist())) >= 4


@pytest.fixture(scope="module")
def sharded(builds):
    passages, out = builds
    b = out["dp"]
    jenc = make_encoder(dim=32, seed=0, config=b["cfg"])
    js = JSearcher(b["jpath"], encoder=jenc, backend="sharded")
    ts = Searcher(b["jpath"], encoder=port_encoder(jenc), backend="sharded", device="cpu")
    return passages, b, js, ts


def test_sharded_searcher_matches_reference(sharded):
    passages, b, js, ts = sharded
    assert ts.mesh.shape == {"data": 4, "model": 1} == dict(js.mesh.shape)
    assert ts.codes is None and ts.residuals is None  # no host copies of the index
    assert ts.cell_cap == js.cell_cap and ts.max_candidates == js.max_candidates
    queries = [passages[2], passages[33], passages[63], "the dog runs"]
    jp, jsc = js.search_batch(queries, k=5)
    tp, tsc = ts.search_batch(queries, k=5)
    assert_topk_agree(tp, tsc, jp, jsc, TOL)
    # and the port's own device backend on the same index
    dev = Searcher(b["jpath"], encoder=ts.encoder, device="cpu")
    dp, dsc = dev.search_batch(queries, k=5)
    assert_topk_agree(tp, tsc, dp, dsc, TOL)


def test_sharded_pipelined_serving(sharded):
    from colbert_torch.serving.batcher import BatchingSearcher

    passages, b, js, ts = sharded
    queries = [passages[i] for i in (2, 9, 33, 41, 63, 7)]
    batches = [queries[:2], queries[2:4], queries[4:]]
    seq = [ts.search_batch(qb, k=4) for qb in batches]
    streamed = list(ts.search_stream(batches, k=4, max_inflight=2))
    for (sp, ssc), (gp, gsc) in zip(seq, streamed):
        np.testing.assert_array_equal(sp, gp)
        np.testing.assert_allclose(ssc, gsc)
    with BatchingSearcher(ts, max_batch=2, max_wait_ms=5) as batcher:
        futs = [batcher.submit(q, k=4) for q in queries]
        flat = np.concatenate([p for p, _ in seq])
        for i, f in enumerate(futs):
            p, _ = f.result(timeout=120)
            np.testing.assert_array_equal(p, flat[i])
        assert batcher.stats["batches"] >= 3


def test_sharded_rebalance_and_reload(sharded):
    passages, b, js, ts = sharded
    queries = [passages[5], passages[40]]
    p0, s0 = ts.search_batch(queries, k=5)
    before = ts.sharded_index
    ts.set_balance_cap(4)
    assert ts.sharded_index is not before and ts.config.ivf_balance_cap == 4
    assert ts.sharded_index.max_cell_length <= 4 and ts.cell_cap == 32
    ts.set_balance_cap(None)
    p1, s1 = ts.search_batch(queries, k=5)
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_allclose(s0, s1)
    again = ts.reload()
    assert again.backend == "sharded" and again.mesh.shape == ts.mesh.shape
    p2, s2 = again.search_batch(queries, k=5)
    np.testing.assert_array_equal(p0, p2)


def test_sharded_searcher_device_list(builds):
    """A device list sets the mesh: two data shards here, from the list,
    whatever config.mesh_data_axis=-1 would take; a list is refused by the
    single-device backends."""
    passages, out = builds
    b = out["dp"]
    cfg = ColBERTConfig.load(os.path.join(b["jpath"], "config.json"))
    cfg.mesh_data_axis = -1
    enc = port_encoder(b["jenc"])
    s = Searcher(b["jpath"], encoder=enc, config=cfg, backend="sharded",
                 device=["cpu", "cpu"])
    assert s.mesh.shape == {"data": 2, "model": 1}
    assert sorted(s.sharded_index.shards) == [0, 1]
    pids, _ = s.search_batch([passages[11]], k=3)
    assert 11 in pids[0]
    with pytest.raises(ValueError, match="sharded"):
        Searcher(b["jpath"], encoder=enc, backend="device", device=["cpu", "cpu"])


def test_dryrun_multichip_on_cpu():
    from colbert_torch.graft_entry import dryrun_multichip

    line = dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip OK")
    assert "'data': 4" in line and "tp encode" in line
