"""The port's DeviceIndex vs the JAX package's on indexes built by the JAX
``Indexer``, with the same pre-encoded queries.

Build: identical codes, residual words, pid-valued IVF, offsets, doclens
and balanced probe tables, from a streamed index dir and from arrays.

Search: where the candidate budget covers every unique candidate (no
refine, ``ncandidates >= #candidates``) the results must agree up to ties
in the final score, scores to 1e-4. Where a cut truncates (a stage-1 or
refine cut below the unique count), which of near-tied candidates survive
the cut depends on rounding (both stage-1 sums are cumsum differences, but
XLA's and torch's cumsums add in different orders; ``lax.top_k`` and
``torch.topk`` order ties differently), so only the pids both return are
compared: their final scores must agree to 1e-4, and most of the top-k
must be shared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.retrieval.device_index import DeviceIndex as JDeviceIndex
from colbert_tpu.storage import format as jfmt
from colbert_torch.retrieval.device_index import DeviceIndex, probe_compensation

from _torch_parity import assert_topk_agree, build_reference_index, one_torch_thread  # noqa: F401

TOL = 1e-4


@pytest.fixture(scope="module", params=[1, 2, 4])
def index(request, tmp_path_factory):
    nbits = request.param
    path = str(tmp_path_factory.mktemp(f"tidx{nbits}") / "idx")
    cfg, encoder, passages, path = build_reference_index(path, nbits=nbits)
    queries = [passages[5], passages[33], "the dog runs fast", passages[59],
               "blue river city music", passages[12]]
    Q = encoder.encode_queries(queries)
    return cfg, path, Q


def _build_kwargs(path, cfg, balance_cap):
    codec = jfmt.load_codec(path)
    ivf, ivf_lengths = jfmt.load_ivf(path)
    return dict(centroids=codec["centroids"], ivf=ivf, ivf_lengths=ivf_lengths,
                doclens=np.asarray(jfmt.load_all_doclens(path), np.int64),
                bucket_weights=codec["bucket_weights"], nbits=cfg.nbits,
                balance_cap=balance_cap)


def _both(path, cfg, balance_cap=1024, stream=True):
    kw = _build_kwargs(path, cfg, balance_cap)
    if stream:
        kw["stream_from"] = path
    else:
        kw["codes"] = jfmt.load_all_codes(path)
        kw["residuals"] = jfmt.load_all_residuals(path)
    return JDeviceIndex.build(**kw), DeviceIndex.build(device="cpu", **kw)


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("balance_cap", [1024, 4])
def test_build_identical(index, stream, balance_cap):
    cfg, path, _ = index
    j, t = _both(path, cfg, balance_cap, stream)
    jres = np.asarray(j.residuals)
    assert t.residuals.dtype == (torch.int32 if jres.dtype == np.uint32 else torch.uint8)
    np.testing.assert_array_equal(t.residuals.numpy(), jres.view(t.residuals.numpy().dtype))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes).view(np.int32))
    np.testing.assert_array_equal(t.ivf.numpy(), np.asarray(j.ivf))
    np.testing.assert_array_equal(t.emb_offsets.numpy(), np.asarray(j.emb_offsets))
    np.testing.assert_array_equal(t.doclens.numpy(), np.asarray(j.doclens))
    np.testing.assert_array_equal(t.ivf_offsets.numpy(), np.asarray(j.ivf_offsets))
    np.testing.assert_array_equal(t.ivf_lengths.numpy(), np.asarray(j.ivf_lengths))
    np.testing.assert_array_equal(t.probe_centroids.numpy(), np.asarray(j.probe_centroids))
    assert (t.max_doclen, t.n_passages, t.probe_dup_max) == (j.max_doclen, j.n_passages,
                                                             j.probe_dup_max)
    assert t.probe_split_mass == pytest.approx(j.probe_split_mass)
    if balance_cap == 4:
        assert t.probe_dup_max > 1  # the small cap really splits cells


def test_rebalance_matches_build(index):
    cfg, path, _ = index
    _, t = _both(path, cfg, 1024)
    _, t4 = _both(path, cfg, 4)
    t.rebalance(jfmt.load_ivf(path)[1], 4)
    for name in ("ivf_offsets", "ivf_lengths", "probe_centroids"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), getattr(t4, name).numpy())
    assert t.compensated_nprobe(2) == t4.compensated_nprobe(2)


def _search(j, t, Q, **kw):
    pj, sj = j.search_Q_batch(jnp.asarray(Q), **kw)
    pt, st = t.search_Q_batch(torch.from_numpy(Q), **kw)
    return pj, sj, pt, st


@pytest.mark.parametrize("threshold", [None, 0.45])
@pytest.mark.parametrize("balance_cap", [1024, 4])
def test_search_exact(index, threshold, balance_cap):
    """ncandidates = max_candidates >= every unique candidate: the whole
    candidate set reaches stage 2 in both."""
    cfg, path, Q = index
    j, t = _both(path, cfg, balance_cap)
    nprobe = j.compensated_nprobe(4)
    kw = dict(k=8, nprobe=nprobe, ncandidates=128, cell_cap=64, max_candidates=128,
              centroid_threshold=threshold, stage1_refine=True)
    pj, sj, pt, st = _search(j, t, Q, **kw)
    assert_topk_agree(pt, st, pj, sj, TOL)
    assert t.overflow_candidates == j.overflow_candidates == 0
    # the >2^26-pid three-key sort of the JAX package gives the same answer
    # as the port's one int64 key
    pf, sf = j.search_Q_batch(jnp.asarray(Q), force_float_sort=True, **kw)
    assert_topk_agree(pt, st, pf, sf, TOL)


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("threshold", [None, 0.45])
def test_search_truncated(index, refine, threshold):
    """A cut below the unique candidate count: the stage-1 top-16 (no
    refine) or the refine's top-8 of a 32-wide window."""
    cfg, path, Q = index
    j, t = _both(path, cfg, 1024)
    kw = dict(k=5, nprobe=4, ncandidates=8 if refine else 16, cell_cap=64,
              max_candidates=32 if refine else 128, centroid_threshold=threshold,
              stage1_refine=refine, refine_width=4)
    pj, sj, pt, st = _search(j, t, Q, **kw)
    shared = 0
    for r in range(Q.shape[0]):
        a = {int(p): float(s) for p, s in zip(pt[r], st[r]) if p >= 0}
        b = {int(p): float(s) for p, s in zip(pj[r], sj[r]) if p >= 0}
        for pid in a.keys() & b.keys():
            assert abs(a[pid] - b[pid]) <= TOL, (r, pid, a[pid], b[pid])
        shared += len(a.keys() & b.keys())
    assert shared >= 0.8 * pt.size, f"only {shared} of {pt.size} top-k pids shared"
    # the same dedup set, so the same overflow count
    assert t.overflow_candidates == j.overflow_candidates


def test_search_single_query_and_k_beyond_candidates(index):
    cfg, path, Q = index
    _, t = _both(path, cfg, 1024)
    pids, scores = t.search_Q_batch(torch.from_numpy(Q[:1]), k=100, nprobe=1,
                                    ncandidates=128, cell_cap=64, max_candidates=128)
    valid = pids[0] >= 0
    assert len(np.unique(pids[0][valid])) == valid.sum()
    assert np.isneginf(scores[0][~valid]).all()
    assert (np.diff(scores[0][valid]) <= 1e-6).all()


def test_probe_compensation_rejects_zero_saturation():
    with pytest.raises(ValueError):
        probe_compensation(4, 0.5, saturate=0.0)
    assert probe_compensation(4, 0.01, saturate=0.05) == 1
    assert probe_compensation(1, 0.5) == 0


def _synthetic_index_kwargs(seed: int = 7, P: int = 60, K: int = 48, nbits: int = 2):
    """A small index made from a seed, with zero-doclen passages among the
    real ones: random unit centroids and codes, zero residuals, an IVF of
    the pids holding each code."""
    rng = np.random.default_rng(seed)
    doclens = rng.integers(1, 40, P)
    doclens[[3, 17, 18, P - 1]] = 0
    codes = rng.integers(0, K, int(doclens.sum())).astype(np.uint32)
    cent = rng.standard_normal((K, 128)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    pid_of = np.repeat(np.arange(P), doclens)
    cells = [np.unique(pid_of[codes == c]) for c in range(K)]
    return dict(centroids=cent, codes=codes,
                residuals=np.zeros((len(codes), 128 * nbits // 8), np.uint8),
                ivf=np.concatenate(cells).astype(np.int32),
                ivf_lengths=np.array([len(c) for c in cells], np.int64),
                doclens=doclens, bucket_weights=np.linspace(-0.1, 0.1, 1 << nbits,
                                                            dtype=np.float32),
                nbits=nbits)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("columns", [None, 7, 1])
def test_approx_maxsim_matches_jax(B, columns):
    """The refine's batched chunk passes against JAX's ``_approx_maxsim``
    query by query on the same index arrays: a 40-wide candidate window
    with sentinel pids and zero-doclen passages, in one chunk (the default
    cap), in chunks of 7 columns (40 is no multiple of 7) and of 1."""
    from colbert_tpu.retrieval import device_index as jdi
    from colbert_torch.retrieval import device_index as tdi

    kw = _synthetic_index_kwargs()
    j = JDeviceIndex.build(**kw)
    t = DeviceIndex.build(device="cpu", **kw)
    rng = np.random.default_rng(B)
    Q = rng.standard_normal((B, 32, 128)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    P = len(kw["doclens"])
    pids = rng.integers(0, P + 1, (B, 40))
    pids[:, [0, 5]] = P                        # sentinel
    pids[:, [2, 9]] = [3, 17]                  # zero doclen
    cap = {} if columns is None else {
        "chunk_bytes": columns * tdi.refine_column_bytes(B, t.max_doclen, 32)}
    got = tdi._approx_maxsim(t, torch.from_numpy(Q), torch.from_numpy(pids), **cap).numpy()
    for b in range(B):
        want = jdi._approx_maxsim(
            jnp.asarray(Q[b]), j.centroids, j.codes, j.emb_offsets[pids[b]],
            j.doclens[pids[b]], max_doclen=j.max_doclen)
        np.testing.assert_allclose(got[b], np.asarray(want), atol=TOL, rtol=0)
    assert (got[:, [0, 5, 2, 9]] == 0).all()
    real = (pids < P) & (kw["doclens"][np.minimum(pids, P - 1)] > 0)
    assert (got[real] != 0).all()
