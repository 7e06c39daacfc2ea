"""The port's DeviceIndex vs the JAX package's on indexes built by the JAX
``Indexer``, with the same pre-encoded queries.

Build: identical codes, residual words, pid-valued IVF, offsets, doclens
and balanced probe tables, from a streamed index dir and from arrays.

Search: where the candidate budget covers every unique candidate (no
refine, ``ncandidates >= #candidates``) the results must agree up to ties
in the final score, scores to 1e-4. Where a cut truncates (a stage-1 or
refine cut below the unique count), which of near-tied candidates survive
the cut depends on rounding (the JAX stage-1 sums are cumsum differences,
the port's segmented sums; ``lax.top_k`` and ``torch.topk`` order ties
differently), so only the pids both return are compared: their final
scores must agree to 1e-4, and most of the top-k must be shared.
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
