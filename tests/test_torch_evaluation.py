"""The port's ``evaluation`` package vs the JAX package's on the same inputs:
metrics on random rankings and the dataset loaders (equal), the exact
oracle (within 1e-5 on the same query embeddings), ``evaluate`` (the same
metric dict apart from latency and qps) and the operating-point tuner (the
same per-point score- and set-recall at ``time_reps=0``; the chosen point is
the port's cheapest qualifying one by its own weights). Then the tuner's
own cases on the port, including the two reference behaviours it does not
copy (the refine charged when the funnel skips it, and a default-cap
``apply`` that re-balances)."""

import numpy as np
import pytest
import torch

from colbert_tpu.config import ColBERTConfig as JConfig
from colbert_tpu.evaluation import autotune as jautotune
from colbert_tpu.evaluation import metrics as jmetrics
from colbert_tpu.evaluation import oracle as joracle
from colbert_tpu.evaluation import runner as jrunner
from colbert_tpu.indexing.builder import Indexer as JIndexer
from colbert_tpu.retrieval.searcher import Searcher as JSearcher
from colbert_tpu.utils.testing import make_encoder, synthetic_collection
from colbert_torch.evaluation import autotune, metrics, runner
from colbert_torch.evaluation.autotune import OperatingPoint, tune_operating_point
from colbert_torch.evaluation.oracle import exhaustive_scores, oracle_topk
from colbert_torch.retrieval.searcher import Searcher

from _torch_parity import one_torch_thread, port_encoder  # noqa: F401

GRID = (
    OperatingPoint(0, 8, stage1_refine=False),
    OperatingPoint(0, 64, stage1_refine=False),
    OperatingPoint(0, 64, stage1_refine=True),
)


def _jgrid(grid):
    return tuple(jautotune.OperatingPoint(*(getattr(p, f) for f in (
        "nprobe_delta", "ncandidates", "stage1_refine", "refine_width", "max_candidates")))
        for p in grid)


@pytest.fixture(scope="module")
def tuned_setup(tmp_path_factory):
    """The reference tuner tests' index (64 passages, nprobe 2,
    search_max_candidates 64) at fp32 activations, with a JAX and a port
    Searcher over it."""
    cfg = JConfig(dim=32, doc_maxlen=64, query_maxlen=16, index_bsize=8, length_bucket=16,
                  chunksize=32, nbits=2, kmeans_niters=6, nprobe=2, search_max_candidates=64,
                  activation_dtype="float32")
    jenc = make_encoder(dim=32, seed=0, config=cfg)
    passages = synthetic_collection(64, seed=1)
    path = str(tmp_path_factory.mktemp("teval") / "idx")
    JIndexer(cfg, encoder=jenc, collection=passages).index(path)
    queries = [p[:64] for p in passages[:8]]
    return (JSearcher(path, encoder=jenc), Searcher(path, encoder=port_encoder(jenc), device="cpu"),
            passages, queries)


# -- metrics and loaders ------------------------------------------------------


def _random_rankings(rng, n=30, depth=12, pool=40):
    rankings = [list(rng.choice(pool, size=int(rng.integers(0, depth)), replace=False))
                for _ in range(n)]
    relevant = [set(rng.choice(pool, size=int(rng.integers(0, 4)), replace=False).tolist())
                for _ in range(n)]
    graded = [{p: float(rng.integers(1, 4)) for p in rel} for rel in relevant]
    return rankings, relevant, graded


@pytest.mark.parametrize("k", [1, 5, 10])
def test_ranking_metrics_match_reference(rng, k):
    rankings, relevant, graded = _random_rankings(rng)
    assert metrics.mrr_at_k(rankings, relevant, k=k) == jmetrics.mrr_at_k(rankings, relevant, k=k)
    assert (metrics.success_at_k(rankings, relevant, k=k)
            == jmetrics.success_at_k(rankings, relevant, k=k))
    assert metrics.ndcg_at_k(rankings, graded, k=k) == jmetrics.ndcg_at_k(rankings, graded, k=k)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_recall_metrics_match_reference(rng, k):
    oracle = rng.standard_normal((6, 20)).astype(np.float32)
    oracle[:, 3] = oracle[:, 5]  # a tie
    got = rng.integers(-1, 20, (6, 8))
    otop = np.argsort(-oracle, axis=1)[:, :8]
    assert metrics.set_recall_at_k(got, otop, k) == jmetrics.set_recall_at_k(got, otop, k)
    for eps in (0.0, 0.01, 0.5):
        assert (metrics.score_recall_at_k(got, oracle, k, eps=eps)
                == jmetrics.score_recall_at_k(got, oracle, k, eps=eps))
    np.testing.assert_array_equal(oracle_topk(oracle, k), joracle.oracle_topk(oracle, k))


def test_lcs_metrics_match_reference():
    pairs = [("abc", "abc"), ("abc", "xyz"), ("", "abc"), ("abcd", "abxd"),
             ("hello world", "hello world!"), ("kitten", "sitting")]
    for a, b in pairs:
        assert metrics.lcs_distance(a, b) == jmetrics.lcs_distance(a, b)
    retrieved = [["hello world", "zzz"], ["qqq"], ["sitting", "kitten"]]
    gold = ["hello world!", "hello", "kitten"]
    for thr in (0.1, 0.33, 0.9):
        assert (metrics.lcs_hit_rate(retrieved, gold, threshold=thr)
                == jmetrics.lcs_hit_rate(retrieved, gold, threshold=thr))


def test_loaders_match_reference(tmp_path):
    trec = tmp_path / "qrels.tsv"
    trec.write_text("q1 0 5 1\nq1 0 7 0\nq2 0 3 2\nbad line\n")
    lotte = tmp_path / "qas.jsonl"
    lotte.write_text('{"qid": 1, "answer_pids": [2, 4]}\n{"qid": 2, "answer_pids": []}\n')
    q = tmp_path / "queries.tsv"
    q.write_text("1\twhat is a dog\n\n2\tbig\tcats\n")
    assert runner.load_qrels_trec(str(trec)) == jrunner.load_qrels_trec(str(trec)) == {
        "q1": {5}, "q2": {3}}
    assert runner.load_qrels_lotte(str(lotte)) == jrunner.load_qrels_lotte(str(lotte))
    assert runner.load_queries_tsv(str(q)) == jrunner.load_queries_tsv(str(q))


# -- the oracle and evaluate -----------------------------------------------------


@pytest.mark.parametrize("block", [7, 1024])
def test_exhaustive_scores_match_reference(tuned_setup, block):
    js, ts, _, queries = tuned_setup
    Q = js.encoder.encode_queries(queries)
    want = joracle.exhaustive_scores(js, Q, block=block)
    got = exhaustive_scores(ts, Q, block=block)
    assert got.shape == want.shape == (8, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(oracle_topk(got, 1)[:, 0], np.arange(8))
    host = Searcher(ts.index_path, encoder=ts.encoder, device="cpu", backend="host")
    np.testing.assert_allclose(exhaustive_scores(host, torch.from_numpy(Q), block=block), got,
                               atol=1e-6, rtol=0)


def test_oracle_bounds_the_funnel(tuned_setup):
    """Every pid the funnel returns is scored by stage 2 as the oracle
    scores it (the device index's plain stage 2 on the CPU)."""
    _, ts, _, queries = tuned_setup
    Q = ts.encoder.encode_queries(queries)
    oscores = exhaustive_scores(ts, Q)
    pids, scores = ts.device_index.search_Q_batch(Q, **ts._search_kwargs(5))
    valid = pids >= 0
    np.testing.assert_allclose(scores[valid],
                               np.take_along_axis(oscores, np.maximum(pids, 0), 1)[valid],
                               atol=1e-5, rtol=0)


def test_evaluate_matches_reference(tuned_setup):
    js, ts, passages, _ = tuned_setup
    qids = [str(i) for i in (2, 9, 17, 30, 41, 63)]
    queries = [passages[int(q)] for q in qids]
    qrels = {q: {int(q)} for q in qids}
    for k in (5, 10):
        got = runner.evaluate(ts, queries, qids, qrels, k=k, batch_size=4)
        want = jrunner.evaluate(js, queries, qids, qrels, k=k, batch_size=4)
        assert set(got) == set(want)
        assert got["qps"] > 0 and got["mean_latency_s"] > 0
        for key in ("num_queries", "mrr@10", "success@5", "ndcg@10"):
            assert got[key] == pytest.approx(want[key], abs=1e-12), key
        assert got["success@5"] >= 0.75


# -- the tuner -------------------------------------------------------------------


def test_tune_matches_reference_per_point(tuned_setup):
    js, ts, _, queries = tuned_setup
    got = tune_operating_point(ts, queries, k=4, target_score_recall=0.9, grid=GRID,
                               time_reps=0)
    want = jautotune.tune_operating_point(js, queries, k=4, target_score_recall=0.9,
                                          grid=_jgrid(GRID), time_reps=0)
    assert len(got.table) == len(want.table) == len(GRID)
    for tg, tw in zip(got.table, want.table):
        assert tg.score_recall == tw.score_recall and tg.set_recall == tw.set_recall
        assert tg.ms_per_batch is None
    assert got.met_target
    qualifying = [t for t in got.table if t.score_recall >= 0.9]
    assert got.chosen.cost == min(t.cost for t in qualifying)
    full = [t for t in got.table if t.point.ncandidates == 64 and t.point.stage1_refine][0]
    assert full.score_recall == 1.0


def test_tune_unmet_target_falls_back_to_best(tuned_setup):
    _, ts, _, queries = tuned_setup
    res = tune_operating_point(ts, queries, k=4, target_score_recall=1.1, grid=GRID,
                               time_reps=0)
    assert not res.met_target and "UNMET" in str(res)
    best = max(t.score_recall for t in res.table)
    assert res.chosen.score_recall == best
    assert res.chosen.cost == min(t.cost for t in res.table if t.score_recall == best)


def test_tune_times_points_when_asked(tuned_setup):
    _, ts, _, queries = tuned_setup
    res = tune_operating_point(ts, queries, k=4, target_score_recall=0.0, grid=GRID[:2],
                               time_reps=1)
    assert all(t.ms_per_batch is not None and t.ms_per_batch > 0 for t in res.table)
    assert res.chosen.ms_per_batch == min(t.ms_per_batch for t in res.table)
    assert "ms/batch" in str(res)


def test_apply_sets_config_and_search_follows(tuned_setup):
    _, ts, _, queries = tuned_setup
    res = tune_operating_point(ts, queries, k=4, target_score_recall=0.9, grid=GRID,
                               time_reps=0)
    cfg = ts.config
    before = (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe)
    try:
        res.apply(ts)
        assert cfg.plaid_stage2_docs == res.chosen.point.ncandidates
        assert cfg.plaid_stage1_refine == res.chosen.point.stage1_refine
        pids, _ = ts.search_batch(queries, k=4)
        assert (pids[:, 0] == np.arange(len(queries))).all()
    finally:
        (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe) = before


def test_tune_sweeps_balance_caps_and_restores(tuned_setup):
    js, ts, _, queries = tuned_setup
    orig_cap = ts.config.ivf_balance_cap
    orig_shape = ts.device_index.probe_centroids.shape
    res = tune_operating_point(ts, queries, k=4, target_score_recall=0.9, grid=GRID,
                               time_reps=0, balance_caps=(0, 4))
    want = jautotune.tune_operating_point(js, queries, k=4, target_score_recall=0.9,
                                          grid=_jgrid(GRID), time_reps=0, balance_caps=(0, 4))
    assert len(res.table) == 2 * len(GRID)
    assert [t.balance_cap for t in res.table] == [t.balance_cap for t in want.table]
    for tg, tw in zip(res.table, want.table):
        assert tg.score_recall == tw.score_recall and tg.set_recall == tw.set_recall
    assert all(t.swept_cap for t in res.table)
    assert ts.config.ivf_balance_cap == orig_cap
    assert ts.device_index.probe_centroids.shape == orig_shape
    cfg = ts.config
    before = (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe, cfg.refine_width_factor)
    try:
        res.apply(ts)
        assert ts._balance_cap(cfg.ivf_balance_cap) == ts._balance_cap(res.chosen.balance_cap)
        pids, _ = ts.search_batch(queries, k=4)
        assert (pids[:, 0] == np.arange(len(queries))).all()
    finally:
        (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe,
         cfg.refine_width_factor) = before
        ts.set_balance_cap(orig_cap)


def test_tune_depth_target_and_default_grid_extension(tuned_setup):
    _, ts, _, queries = tuned_setup
    res = tune_operating_point(ts, queries, k=4, target_score_recall=0.9, grid=GRID,
                               time_reps=0, depth_k=8, target_depth_recall=0.9)
    assert res.depth_k == 8 and len(res.table) == len(GRID)
    assert all(t.depth_score_recall is not None for t in res.table)
    if res.met_target:
        assert res.chosen.depth_score_recall >= 0.9
    assert "@depth" in str(res)
    Q = ts.encoder.encode_queries(queries)
    res = tune_operating_point(ts, Q=Q, k=4, target_score_recall=0.9, time_reps=0,
                               depth_k=8, target_depth_recall=0.9)
    wide = [t for t in res.table if t.point.max_candidates is not None]
    assert len(res.table) == 12 and len(wide) == 3
    assert all("maxc=16384" in t.point.label() for t in wide)


def test_tune_raw_path_with_Q_matches_production(tuned_setup):
    _, ts, _, queries = tuned_setup
    prod = tune_operating_point(ts, queries, k=4, target_score_recall=0.9, grid=GRID,
                                time_reps=0)
    raw = tune_operating_point(ts, Q=torch.from_numpy(ts.encoder.encode_queries(queries)),
                               k=4, target_score_recall=0.9, grid=GRID, time_reps=0)
    for tp, tr in zip(prod.table, raw.table):
        assert (tp.score_recall, tp.set_recall) == (tr.score_recall, tr.set_recall)


def test_max_candidates_point_sweeps_and_applies(tuned_setup):
    _, ts, _, queries = tuned_setup
    cfg = ts.config
    saved = (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe,
             cfg.refine_width_factor, cfg.search_max_candidates, ts.max_candidates)
    try:
        point = OperatingPoint(0, 8, stage1_refine=True, max_candidates=128)
        assert "maxc=128" in point.label()
        res = tune_operating_point(ts, queries, k=4, target_score_recall=0.0, grid=(point,),
                                   time_reps=0)
        assert res.chosen.point.max_candidates == 128
        assert ts.max_candidates == saved[5]  # the sweep leaks nothing
        res.apply(ts)
        assert ts.max_candidates == 128 and cfg.search_max_candidates == 128
        pids, _ = ts.search_batch(queries, k=4)
        assert (pids[:, 0] == np.arange(len(queries))).all()
    finally:
        (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe,
         cfg.refine_width_factor, cfg.search_max_candidates, ts.max_candidates) = saved


def test_tune_needs_the_device_backend(tuned_setup):
    _, ts, _, queries = tuned_setup
    host = Searcher(ts.index_path, encoder=ts.encoder, device="cpu", backend="host")
    with pytest.raises(NotImplementedError, match="device backend"):
        tune_operating_point(host, queries, k=4, time_reps=0)
    with pytest.raises(ValueError, match="queries"):
        tune_operating_point(ts, k=4, time_reps=0)


# -- the cost model and the two reference behaviours not copied --------------


KW = dict(nprobe=4, lq=16, cell_cap=64, max_doclen=32, max_candidates=4096)


def test_cost_model_orders_points_sanely():
    cheap = OperatingPoint(0, 128, stage1_refine=False).cost(**KW)
    mid = OperatingPoint(0, 128, stage1_refine=True).cost(**KW)
    wide = OperatingPoint(0, 1024, stage1_refine=True).cost(**KW)
    probes = OperatingPoint(2, 128, stage1_refine=False).cost(**KW)
    assert cheap < mid < wide
    assert cheap < probes < mid  # +2 probes cost less than the refine
    narrow = OperatingPoint(0, 128, stage1_refine=True, refine_width=2).cost(**KW)
    assert cheap < narrow < mid
    kw = dict(KW, cell_cap=1024)  # enough probed entries for a 16384 width
    base = OperatingPoint(0, 4096, stage1_refine=True)
    wider = OperatingPoint(0, 4096, stage1_refine=True, max_candidates=16384)
    assert wider.cost(**kw) > base.cost(**kw)
    t = autotune.TunedPoint(OperatingPoint(0, 128, False), 0.99, 0.97, cheap, 12.3)
    s = str(autotune.TuneResult(chosen=t, table=[t], target=0.98))
    assert "ncand=128" in s and "12.30 ms/batch" in s and "[*]" in s


def test_cost_charges_the_refine_only_when_the_funnel_runs_it():
    """At ncandidates >= the selection width the funnel skips the refine
    (device_index._search): the port's cost charges none, the reference's
    charges it."""
    on = OperatingPoint(0, 4096, stage1_refine=True)
    off = OperatingPoint(0, 4096, stage1_refine=False)
    assert on.cost(**KW) == off.cost(**KW)
    jkw = dict(KW)
    assert (jautotune.OperatingPoint(0, 4096, stage1_refine=True).cost(**jkw)
            > jautotune.OperatingPoint(0, 4096, stage1_refine=False).cost(**jkw))
    # the selection width is clamped to the probed entries, as in the funnel
    clamped = OperatingPoint(0, 1024, stage1_refine=True, max_candidates=1 << 20)
    assert clamped.cost(**KW) == OperatingPoint(0, 1024, stage1_refine=True).cost(**KW)
    # below the width the refine is charged
    assert (OperatingPoint(0, 1024, stage1_refine=True).cost(**KW)
            > OperatingPoint(0, 1024, stage1_refine=False).cost(**KW))


def test_apply_of_the_default_cap_does_not_rebalance(tuned_setup, monkeypatch):
    """A chosen cap of 1024 under a config cap of None (which means 1024):
    the port's apply re-balances nothing; the reference's re-balances."""
    js, ts, _, _ = tuned_setup
    point = OperatingPoint(0, 64, stage1_refine=True)
    calls = []
    cfg = ts.config
    before = (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe,
              cfg.refine_width_factor, cfg.ivf_balance_cap)
    assert before[4] is None
    try:
        monkeypatch.setattr(ts, "set_balance_cap", lambda cap: calls.append(cap))
        chosen = autotune.TunedPoint(point, 1.0, 1.0, 0.0, balance_cap=1024, swept_cap=True)
        autotune.TuneResult(chosen=chosen, table=[chosen]).apply(ts)
        assert calls == []
        chosen.balance_cap = 2048
        autotune.TuneResult(chosen=chosen, table=[chosen]).apply(ts)
        assert calls == [2048]
    finally:
        (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe,
         cfg.refine_width_factor, cfg.ivf_balance_cap) = before
    jcalls = []
    jcfg = js.config
    jbefore = (jcfg.plaid_stage2_docs, jcfg.plaid_stage1_refine, jcfg.nprobe,
               jcfg.refine_width_factor, jcfg.ivf_balance_cap)
    try:
        monkeypatch.setattr(js, "set_balance_cap", lambda cap: jcalls.append(cap))
        jchosen = jautotune.TunedPoint(jautotune.OperatingPoint(0, 64, True), 1.0, 1.0, 0.0,
                                       balance_cap=1024, swept_cap=True)
        jautotune.TuneResult(chosen=jchosen, table=[jchosen]).apply(js)
        assert jcalls == [1024]
    finally:
        (jcfg.plaid_stage2_docs, jcfg.plaid_stage1_refine, jcfg.nprobe,
         jcfg.refine_width_factor, jcfg.ivf_balance_cap) = jbefore
