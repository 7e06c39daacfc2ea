"""The quality drill (``colbert_torch.evaluation.quality``) against
``bench_quality.py``, and the forward-step hook (``colbert_torch.graft_entry``)
against ``__graft_entry__.py``'s, on the CPU at a tiny width.

- ``train_encoder`` from the same weights (a JAX-drawn tiny BERT: 2
  layers, hidden 64, the corpus vocabulary, dim 128; bench.py's
  configuration at fp32 activations) on the same bench corpus (128
  passages of ~32 words):
  every step's loss within 1e-4 relative of the JAX drill's (the optimizer
  steps' bound of ``tests/test_torch_training.py``) with ``doc_maxlen``
  at 192 during every step and restored after, the same stats keys.
- ``measure`` against ``bench_quality.main`` run in process on the JAX
  drill's trained weights (carried across to the port), at a stage-2
  budget of 128 candidates (the plain stage 2 on the CPU decodes every
  padded candidate slot, and the default budget's 1,600 take minutes): the
  exact oracles within 1e-4, the five operating points with the same
  arguments in the same order and their top-100s equal up to ties at
  1e-4, the same operating point at each of the four QPS timings, and the
  same summary (its recalls equal, its margin equal at its rounding; the
  keys of ``bench_quality.py``'s JSON line, ``train`` added by ``main``).
- ``entry(device="cpu")`` at a tiny width in fp32: the embeddings within
  1e-5 of the JAX ``encode_batch`` on the carried weights and the same ids
  and keep mask.
"""

import ast
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_quality
from bench import bench_vocab_tokenizer as jbench_tokenizer
from colbert_tpu.config import ColBERTConfig as JConfig
from colbert_tpu.models.bert import BertConfig as JBertConfig
from colbert_tpu.models.colbert import encode_batch, init_colbert_params
from colbert_tpu.models.encoder import ColBERTEncoder as JEncoder
from colbert_tpu.training import trainer as jtrainer
from colbert_torch.evaluation import quality
from colbert_torch.graft_entry import entry
from colbert_torch.models.bert import BertConfig
from colbert_torch.models.colbert import from_jax_params, to_jax_params
from colbert_torch.training import trainer as ttrainer
from colbert_torch.utils.testing import make_bench_encoder, synthetic_passages

from _torch_parity import assert_topk_agree, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH = 3, 4
NCAND = 32  # the drills' stage-2 budget


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread: beside the suite's other workers,
    torch's thread pool waits at every op's barrier for descheduled threads
    (an index build here took 368 s on 8 threads under load, 18.5 s on 1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(vocab_size: int) -> dict:
    return dict(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128)


def _json_keys() -> set[str]:
    """The keys of the dict that ``bench_quality.main`` prints."""
    tree = ast.parse(open(os.path.join(REPO, "bench_quality.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("bench_quality.py prints no JSON dict")


def _recording(monkeypatch, cls, into: list):
    """Record (loss, the encoder's doc_maxlen) of every step."""
    step = cls.train_step

    def record(self, *a, **k):
        m = step(self, *a, **k)
        into.append((float(m["loss"]), self.encoder.config.doc_maxlen))
        return m

    monkeypatch.setattr(cls, "train_step", record)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both drills' ``train_encoder`` on the same weights and corpus -> the
    port's encoder, config, corpus, and both loss sequences and stats."""
    passages = synthetic_passages(128, mean_words=32)
    tokenizer = jbench_tokenizer()
    bert = JBertConfig(**_tiny(len(tokenizer.vocab)))
    params = init_colbert_params(jax.random.PRNGKey(0), bert, dim=128)
    tenc, cfg = make_bench_encoder(device="cpu",
                                   model=from_jax_params(to_numpy(params), BertConfig(**_tiny(
                                       len(tokenizer.vocab)))))
    cfg.activation_dtype = "float32"
    jenc = JEncoder(params, bert, tokenizer, JConfig.from_dict(cfg.to_dict()))
    losses = {"jax": [], "port": []}
    stats = {}
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, jtrainer.ColBERTTrainer, losses["jax"])
        _recording(mp, ttrainer.ColBERTTrainer, losses["port"])
        stats["jax"] = bench_quality.train_encoder(jenc, passages, steps=STEPS, batch_size=BATCH)
        stats["port"] = quality.train_encoder(tenc, passages, steps=STEPS, batch_size=BATCH)
    return dict(enc=tenc, cfg=cfg, jenc=jenc, passages=passages, losses=losses, stats=stats)


def test_train_encoder_matches_reference(trained):
    losses, stats = trained["losses"], trained["stats"]
    assert len(losses["port"]) == len(losses["jax"]) == STEPS
    np.testing.assert_allclose([l for l, _ in losses["port"]], [l for l, _ in losses["jax"]],
                               rtol=1e-4)
    # both train at doc_maxlen 192, which the trainers read at every step
    assert {d for _, d in losses["port"] + losses["jax"]} == {192}
    assert stats["port"].keys() == stats["jax"].keys()
    assert stats["port"]["steps"] == STEPS
    assert trained["enc"].config.doc_maxlen == trained["jenc"].config.doc_maxlen == 300


def _recording_drill(mp, module, oracle_module, index_cls, timer_module, timer: str) -> dict:
    """Record a drill's exact oracle, every ``search_Q_batch`` (its
    operating point without the JAX-only ``use_pallas``, pids and scores)
    and the searcher's operating point at every QPS timing, which then
    times 8 queries at B=4 once (the timings are not compared)."""
    seen = {"points": [], "timed": []}
    oracle, search, time_qps = (oracle_module.exhaustive_scores, index_cls.search_Q_batch,
                                getattr(timer_module, timer))

    def recording_oracle(s, Q, **kw):
        seen["oracle"] = np.asarray(oracle(s, Q, **kw))
        return seen["oracle"]

    def recording_search(index, Q, **kw):
        pids, scores = search(index, Q, **kw)
        point = {k: v for k, v in kw.items() if k != "use_pallas"}
        seen["points"].append((point, np.asarray(pids), np.asarray(scores)))
        return pids, scores

    def recording_timer(s, queries, B, **kw):
        c = s.config
        seen["timed"].append((B, c.nprobe, c.probe_dup_compensation, c.plaid_stage1_refine,
                              c.refine_width_factor, c.plaid_stage2_docs))
        return time_qps(s, queries[:8], 4, reps=1)

    mp.setattr(module, "exhaustive_scores", recording_oracle)
    mp.setattr(index_cls, "search_Q_batch", recording_search)
    mp.setattr(timer_module, timer, recording_timer)
    return seen


def test_measure_matches_reference(trained, tmp_path, capsys):
    """``bench_quality.main`` in process on the JAX-trained encoder (its
    corpus and training stubbed to the fixture's), against the port's
    ``measure`` on the same trained weights carried across and the same
    index: the same oracle, the same operating points in the same order
    with the same results, and the same summary.

    The port's ``measure`` searches the index the reference built: the
    two builds agree only within ``tests/test_torch_indexer.py``'s bounds
    (centroids within one bf16 step, residual buckets at a cutoff may
    flip), which move an exact score by up to ~0.03 here. A stage-2
    budget of 32 candidates puts recall@100 below 1 at the quality-first
    point, so the summary tells the operating points apart."""
    import bench
    import colbert_torch.utils.testing as ttesting
    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.retrieval.device_index import DeviceIndex
    from colbert_tpu.indexing.builder import Indexer as JIndexer
    from colbert_tpu.retrieval.device_index import DeviceIndex as JDeviceIndex

    passages, jenc = trained["passages"], trained["jenc"]
    built = str(tmp_path / "reference_index")
    jcfg = JConfig.from_dict({**jenc.config.to_dict(), "plaid_stage2_docs": NCAND,
                             "mesh_data_axis": 1})
    jindex = JIndexer.index

    def keeping(self, path, **kw):
        jindex(self, path, **kw)
        shutil.copytree(path, built)
        return path

    with pytest.MonkeyPatch.context() as mp:
        ref = _recording_drill(mp, bench_quality, bench_quality, JDeviceIndex, bench, "_time_qps")
        mp.setattr(JIndexer, "index", keeping)
        mp.setattr(bench_quality, "make_bench_encoder", lambda: (
            JEncoder(jenc.params, jenc.bert_config, jenc.tokenizer, jcfg), jcfg))
        mp.setattr(bench_quality, "synthetic_passages", lambda n: passages[:n])
        mp.setattr(bench_quality, "train_encoder", lambda *a, **k: {})
        mp.setattr("sys.argv", ["bench_quality.py", str(len(passages)), "0"])
        bench_quality.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    bert = BertConfig(**_tiny(len(jenc.tokenizer.vocab)))
    enc, cfg = make_bench_encoder(device="cpu",
                                  model=from_jax_params(to_numpy(jenc.params), bert))
    cfg.activation_dtype = "float32"
    cfg.chunksize, cfg.search_max_candidates = 25_000, 8192  # as main sets them
    cfg.plaid_stage2_docs = NCAND
    with pytest.MonkeyPatch.context() as mp:
        port = _recording_drill(mp, quality, quality, DeviceIndex, ttesting, "time_qps")
        mp.setattr(Indexer, "index", lambda self, path, **kw: shutil.copytree(built, path))
        got = quality.measure(enc, cfg, passages)

    np.testing.assert_allclose(port["oracle"], ref["oracle"], rtol=0, atol=1e-4)
    assert len(port["points"]) == len(ref["points"]) == 5
    for (point, p, s), (jpoint, jp, js) in zip(port["points"], ref["points"]):
        assert point == jpoint
        assert_topk_agree(p, s, jp, js, 1e-4)
    assert port["timed"] == ref["timed"] and len(ref["timed"]) == 4

    assert {*got, "train"} == {*want} == _json_keys()
    assert got["n_passages"] == want["n_passages"] == len(passages)
    assert got["tune"] is want["tune"] is None
    assert want["recall_at_100"] < 1.0
    for key in ("value", "recall_at_100", "score_recall_at_10", "self_retrieval_s1"):
        assert got[key] == want[key], key
    # both round to 3 places; the oracles agree within 1e-4 above
    np.testing.assert_allclose(got["oracle_margin_top1_top10"],
                               want["oracle_margin_top1_top10"], rtol=0, atol=1e-3)
    for key in ("qps_b64_quality", "qps_b64_quality_rw2", "qps_b64_probes_no_refine",
                "qps_b64_tuned"):
        assert got[key] > 0, key


def test_graft_entry_matches_reference():
    cfg = BertConfig(**_tiny(128))
    fn, args = entry(device="cpu", bert_config=cfg, dtype="float32")
    model, ids, mask, keep = args
    assert ids.shape == mask.shape == keep.shape == (8, 128) and bool(mask.all())
    got = fn(*args)
    assert got.shape == (8, 128, 128) and not got.requires_grad
    want = encode_batch(to_jax_params(model), jnp.asarray(ids.numpy(), jnp.int32),
                        jnp.asarray(mask.numpy()), jnp.asarray(keep.numpy()),
                        cfg=JBertConfig(**cfg.__dict__), dtype_name="float32")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # the JAX hook's ids and keep mask
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(ids.numpy(), rng.integers(0, 128, (8, 128)))
    np.testing.assert_array_equal(keep.numpy(), rng.random((8, 128)) > 0.1)


def test_graft_entry_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(bert_config=BertConfig(**_tiny(128)))
