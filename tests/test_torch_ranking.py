"""The port's ``retrieval/ranking.py`` and ``ops/maxsim.py`` vs the JAX
package's on the same numpy inputs (fp32 scores to 1e-5, index arrays
exactly), and the port's ``Searcher(backend="host")`` vs the reference host
backend on a reference-built index (top-k up to ties, scores to 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.ops import codec as jcodec
from colbert_tpu.ops.maxsim import maxsim_scores as j_maxsim
from colbert_tpu.retrieval import ranking as jranking
from colbert_tpu.retrieval.searcher import Searcher as JSearcher
from colbert_torch.ops.maxsim import maxsim_scores
from colbert_torch.retrieval import ranking
from colbert_torch.retrieval.searcher import Searcher

from _torch_parity import assert_topk_agree, build_reference_index, port_encoder

TOL = 1e-5


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_build_emb2pid_matches_reference():
    doclens = np.asarray([2, 0, 3, 1, 4], np.int32)
    got = ranking.build_emb2pid(doclens)
    np.testing.assert_array_equal(got, jranking.build_emb2pid(doclens))
    assert got.dtype == np.int64


@pytest.mark.parametrize("nprobe", [1, 3, 7])
def test_probe_centroids_matches_reference(rng, nprobe):
    Q = rng.standard_normal((3, 5, 16)).astype(np.float32)
    C = rng.standard_normal((40, 16)).astype(np.float32)
    got = ranking.probe_centroids(t(Q), t(C), nprobe=nprobe)
    want = np.asarray(jranking.probe_centroids(jnp.asarray(Q), jnp.asarray(C), nprobe=nprobe))
    assert got.dtype == torch.int32 and got.shape == (3, 5, nprobe)
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_centroids_ties_go_to_the_lowest_index():
    C = np.asarray([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 0.0], [0.5, 0.0]], np.float32)
    Q = np.asarray([[[1.0, 0.0]]], np.float32)
    got = ranking.probe_centroids(t(Q), t(C), nprobe=2).numpy()
    want = np.asarray(jranking.probe_centroids(jnp.asarray(Q), jnp.asarray(C), nprobe=2))
    np.testing.assert_array_equal(got, [[[0, 2]]])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cells", [[[1, 3], [3, 7]], [[0]], np.zeros((0, 2), int)])
def test_candidate_pids_matches_reference(rng, cells):
    from colbert_torch.indexing.ivf import build_ivf

    codes = rng.integers(0, 10, 100).astype(np.uint32)
    ivf, ivf_lengths = build_ivf(codes, 10)
    emb2pid = ranking.build_emb2pid(np.full(20, 5))
    cells = np.asarray(cells)
    got = ranking.candidate_pids(cells, ivf, ivf_lengths, emb2pid)
    want = jranking.candidate_pids(cells, ivf, ivf_lengths, emb2pid)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("pids,len_bucket,pid_bucket", [
    ([1, 3], 8, 4), ([0, 1, 2, 3], 4, 2), ([], 32, 256), ([2], 32, 256)])
def test_gather_padded_matches_reference(pids, len_bucket, pid_bucket):
    doclens = np.asarray([3, 5, 2, 9])
    offsets = np.concatenate([[0], np.cumsum(doclens[:-1])])
    pids = np.asarray(pids, np.int64)
    idx, mask = ranking.gather_padded(pids, doclens, offsets, len_bucket=len_bucket,
                                      pid_bucket=pid_bucket)
    jidx, jmask = jranking.gather_padded(pids, doclens, offsets, len_bucket=len_bucket,
                                         pid_bucket=pid_bucket)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(mask, jmask)
    assert idx.dtype == jidx.dtype and mask.dtype == jmask.dtype


@pytest.mark.parametrize("pid_chunk", [1, 2, 256])
def test_maxsim_scores_matches_reference(rng, pid_chunk):
    B, Lq, dim, P, Ld = 2, 4, 8, 5, 6
    Q = rng.standard_normal((B, Lq, dim)).astype(np.float32)
    D = rng.standard_normal((P, Ld, dim)).astype(np.float32)
    mask = rng.random((P, Ld)) > 0.3
    mask[0] = False  # a passage with no real tokens scores 0
    got = maxsim_scores(t(Q), t(D), t(mask), pid_chunk=pid_chunk).numpy()
    want = np.asarray(j_maxsim(jnp.asarray(Q), jnp.asarray(D), jnp.asarray(mask),
                               pid_chunk=pid_chunk))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert (got[:, 0] == 0).all()


def _codec_case(rng, nbits, dim=16, k=8, n=40):
    centroids = rng.standard_normal((k, dim)).astype(np.float32)
    codes = rng.integers(0, k, n).astype(np.uint32)
    weights = np.sort(rng.standard_normal(1 << nbits)).astype(np.float32)
    packed = np.asarray(jcodec.pack_bits(jcodec.binarize(
        jnp.asarray(rng.integers(0, 1 << nbits, (n, dim)), jnp.int32), nbits)))
    doclens = np.asarray([10, 8, 12, 6, 4])
    offsets = np.concatenate([[0], np.cumsum(doclens[:-1])])
    idx, mask = ranking.gather_padded(np.asarray([0, 2, 3, 4]), doclens, offsets,
                                      len_bucket=8, pid_bucket=3)
    Q = rng.standard_normal((2, 4, dim)).astype(np.float32)
    return Q, centroids, codes, weights, packed, idx, mask


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_score_full_matches_reference(rng, nbits):
    Q, cent, codes, weights, packed, idx, mask = _codec_case(rng, nbits)
    got = ranking.score_full(t(Q), t(codes[idx].view(np.int32)), t(packed[idx]), t(mask),
                             t(cent), t(weights), nbits=nbits, pid_chunk=2).numpy()
    want = np.asarray(jranking.score_full(
        jnp.asarray(Q), jnp.asarray(codes[idx]), jnp.asarray(packed[idx]),
        jnp.asarray(mask), jnp.asarray(cent), jnp.asarray(weights), nbits=nbits))
    assert got.shape == want.shape == (2, 6)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_score_approx_matches_reference(rng):
    Q, cent, codes, _, _, idx, mask = _codec_case(rng, 2)
    for pid_chunk in (2, 512):
        got = ranking.score_approx(t(Q), t(codes[idx].view(np.int32)), t(mask), t(cent),
                                   pid_chunk=pid_chunk).numpy()
        want = np.asarray(jranking.score_approx(
            jnp.asarray(Q), jnp.asarray(codes[idx]), jnp.asarray(mask), jnp.asarray(cent),
            pid_chunk=pid_chunk))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


# -- the host backend of the Searcher ---------------------------------------


@pytest.fixture(scope="module")
def host_pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("thost") / "idx")
    # plaid_stage2_docs=16 < the candidate count: the centroid-only pruning runs
    cfg, jenc, passages, path = build_reference_index(
        path, activation_dtype="float32", n_passages=60, plaid_stage2_docs=16)
    tenc = port_encoder(jenc)
    return (passages, JSearcher(path, encoder=jenc, backend="host"),
            Searcher(path, encoder=tenc, device="cpu", backend="host"),
            Searcher(path, encoder=tenc, device="cpu"))


@pytest.mark.parametrize("k", [1, 5, 10])
def test_host_backend_matches_reference(host_pair, k):
    passages, js, ts, _ = host_pair
    queries = [passages[5], passages[33], "the dog runs fast", passages[59]]
    pj, sj = js.search_batch(queries, k=k)
    pt, st = ts.search_batch(queries, k=k)
    assert pt.shape == (4, k) and pt.dtype == np.int64 and st.dtype == np.float32
    assert_topk_agree(pt, st, pj, sj, 1e-4)


def test_host_backend_attributes_and_rules(host_pair):
    passages, js, ts, dev = host_pair
    assert ts.codes.shape == js.codes.shape and ts.residuals.shape == js.residuals.shape
    np.testing.assert_array_equal(ts.emb2pid, js.emb2pid)
    np.testing.assert_array_equal(ts.emb_offsets, js.emb_offsets)
    for s in (ts, dev):
        np.testing.assert_array_equal(s.centroids.numpy(), np.asarray(js.centroids))
        np.testing.assert_array_equal(s.bucket_weights.numpy(), np.asarray(js.bucket_weights))
        assert s.avg_residual == js.avg_residual and s.plan == js.plan
    assert dev.codes is None and dev.centroids is dev.device_index.centroids
    with pytest.raises(NotImplementedError, match="device and sharded backends"):
        ts.set_balance_cap(4)
    with pytest.raises(NotImplementedError, match="device and sharded backends"):
        ts.launch_search([passages[0]], 3)
    batches = [[passages[1], passages[2]], [passages[3]]]
    for qb, (p, s) in zip(batches, ts.search_stream(batches, k=3)):
        bp, bs = ts.search_batch(qb, k=3)
        np.testing.assert_array_equal(p, bp)
        np.testing.assert_array_equal(s, bs)
    p, s = ts.search_batch([], k=3)
    assert p.shape == (0, 3) and s.shape == (0, 3)


def test_host_backend_agrees_with_device_backend(host_pair):
    passages, _, ts, dev = host_pair
    queries = [passages[i] for i in (0, 7, 21, 40, 52)]
    assert_topk_agree(*ts.search_batch(queries, k=3), *dev.search_batch(queries, k=3), 1e-4)
