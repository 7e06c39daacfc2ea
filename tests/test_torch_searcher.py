"""The port's ``Searcher(device="cpu").search_batch`` with the JAX encoder's
weights carried over vs the JAX ``Searcher`` on the same reference-built
index, at fp32 activations. Ties: results agree up to ties in the final
score (see ``_torch_parity.assert_topk_agree``), scores to 1e-4."""

import numpy as np
import pytest
import torch

from colbert_tpu.retrieval.searcher import Searcher as JSearcher
from colbert_torch.retrieval.searcher import Searcher
from colbert_torch.utils.tracing import Tracer

from _torch_parity import assert_topk_agree, build_reference_index, port_encoder

TOL = 1e-4


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tsearch") / "idx")
    cfg, jenc, passages, path = build_reference_index(
        path, activation_dtype="float32", n_passages=80)
    return cfg, jenc, port_encoder(jenc), passages, path


@pytest.fixture(scope="module")
def searchers(built):
    cfg, jenc, tenc, passages, path = built
    return JSearcher(path, encoder=jenc), Searcher(path, encoder=tenc, device="cpu")


def test_query_embeddings_match(built):
    _, jenc, tenc, passages, _ = built
    qs = [passages[3], "the dog runs fast", ""]
    np.testing.assert_allclose(tenc.encode_queries(qs), jenc.encode_queries(qs),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", [1, 5, 10])
def test_search_batch_matches_reference(built, searchers, k):
    _, _, _, passages, _ = built
    js, ts = searchers
    queries = [passages[5], passages[33], "the dog runs fast", passages[59],
               passages[12]]  # B=5 pads to the bucket of 8
    pj, sj = js.search_batch(queries, k=k)
    pt, st = ts.search_batch(queries, k=k)
    assert pt.shape == (5, k) and pt.dtype == np.int64 and st.dtype == np.float32
    assert_topk_agree(pt, st, pj, sj, TOL)


def test_capacities_match_reference(searchers):
    js, ts = searchers
    assert (ts.cell_cap, ts.max_candidates) == (js.cell_cap, js.max_candidates)
    assert ts._search_kwargs(10) == {
        k: v for k, v in js._device_search_kwargs(10, js.device_index).items()}


def test_padding_and_chunking(built, searchers):
    _, _, _, passages, _ = built
    _, ts = searchers
    queries = [passages[5], passages[33], "the dog runs fast", passages[59], passages[12]]
    p5, s5 = ts.search_batch(queries, k=5)
    p8, s8 = ts.search_batch(queries + [""] * 3, k=5)     # explicit pad rows
    np.testing.assert_array_equal(p5, p8[:5])
    np.testing.assert_allclose(s5, s8[:5])
    big = (queries * 27)[:130]                            # > the 128 bucket
    pb, sb = ts.search_batch(big, k=3)
    assert pb.shape == (130, 3)
    ph, sh = ts.search_batch(big[:128], k=3)
    pt, st = ts.search_batch(big[128:], k=3)
    np.testing.assert_array_equal(pb, np.concatenate([ph, pt]))
    np.testing.assert_allclose(sb, np.concatenate([sh, st]))


def test_search_single_stream_and_tracer(built, searchers):
    _, _, _, passages, _ = built
    _, ts = searchers
    p, s = ts.search(passages[10], k=3)
    pb, sb = ts.search_batch([passages[10]], k=3)
    np.testing.assert_array_equal(p, pb[0])
    batches = [[passages[1], passages[2]], [passages[3]], [passages[4]] * 3]
    streamed = list(ts.search_stream(batches, k=4))
    for qb, (sp, ss) in zip(batches, streamed):
        bp, bs = ts.search_batch(qb, k=4)
        np.testing.assert_array_equal(sp, bp)
        np.testing.assert_allclose(ss, bs)
    assert ts.search_batch([], k=4)[0].shape == (0, 4)
    ts.tracer = Tracer()
    try:
        ts.search_batch([passages[1]], k=3)
    finally:
        tracer, ts.tracer = ts.tracer, None
    assert {"tokenize", "encode", "probe", "stage1", "stage2", "topk",
            "finish"} <= set(tracer.timings)


def test_set_balance_cap_and_reload(built, searchers):
    cfg, jenc, tenc, passages, path = built
    js = JSearcher(path, encoder=jenc)
    ts = Searcher(path, encoder=tenc, device="cpu")
    js.set_balance_cap(4)
    ts.set_balance_cap(4)
    assert (ts.cell_cap, ts.device_index.probe_dup_max) == (
        js.cell_cap, js.device_index.probe_dup_max)
    queries = [passages[7], "green tree music"]
    assert_topk_agree(*ts.search_batch(queries, k=5), *js.search_batch(queries, k=5), TOL)
    fresh = ts.reload()
    assert fresh.encoder is ts.encoder and fresh.device == ts.device


def test_device_and_backend_rules(built):
    _, _, tenc, _, path = built
    with pytest.raises(ValueError, match="backend"):
        Searcher(path, encoder=tenc, device="cpu", backend="pod")
    sharded = Searcher(path, encoder=tenc, device="cpu", backend="sharded")
    assert sharded.mesh.shape == {"data": 1, "model": 1}  # -1: the one device
    assert Searcher(path, encoder=tenc, device="cpu", backend="host").backend == "host"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Searcher(path, encoder=tenc)  # device defaults to "cuda"
