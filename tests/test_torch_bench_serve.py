"""``bench_torch.serve_and_probe`` against ``bench.serve_and_probe`` on one
index on the CPU.

The JAX ``Indexer`` builds 1,024 bench passages (``serve_and_probe``
checks that passage 900 retrieves itself) with bench.py's configuration at
the narrow width (2 layers, hidden 64), fp32 activations, and a 32-candidate
stage-2 budget for every ``Searcher`` search (``plaid_stage2_docs`` and
``ncandidates``; the port's plain stage 2 on the CPU takes ~0.1 ms per
candidate). The port's encoder carries the same weights
(``from_jax_params``) and serves the same directory. Both stages run whole,
their QPS timers cut to one batch each (speeds mean nothing here); each
funnel operating point's score-recall@10 and @100 must agree within 0.01,
self-retrieval success@1 (pruned and exhaustive) exactly, and every
stage-2 score the port's stage returns must lie within 1e-4 of the exact
MaxSim of its pid. Set recall is
compared only in the log: the corpus is tie-heavy, and tied pids may order
either way (ROADMAP "Expected differences")."""

import re

import jax
import numpy as np

import bench
import bench_torch
from colbert_tpu.config import ColBERTConfig as JConfig
from colbert_tpu.indexing.builder import Indexer as JIndexer
from colbert_tpu.models.bert import BertConfig as JBertConfig
from colbert_tpu.models.colbert import init_colbert_params
from colbert_tpu.models.encoder import ColBERTEncoder as JEncoder
from colbert_torch.models.bert import BertConfig
from colbert_torch.models.colbert import from_jax_params
from colbert_torch.utils.testing import make_bench_encoder, synthetic_passages

from _torch_parity import one_torch_thread, to_numpy  # noqa: F401

N = 1024
RECALL_TOL = 0.01
SCORE_TOL = 1e-4  # a served stage-2 score against the exact MaxSim of its pid
FUNNEL = re.compile(r"funnel recall vs exhaustive \[(.+?)\]: set recall@10 ([\d.]+) / "
                    r"@100 ([\d.]+); score-recall@10 ([\d.]+) / @100 ([\d.]+)")
SELF = re.compile(r"self-retrieval success@1: pruned funnel ([\d.]+) vs exhaustive ([\d.]+)")


def _one_batch(s, queries, B, reps=3, k=10):
    s.search_batch(queries[:B], k=k)
    return 1.0


def _parse(err: str) -> tuple[dict, tuple]:
    funnel = {m[1]: tuple(float(x) for x in m.groups()[1:]) for m in FUNNEL.finditer(err)}
    (s1,) = [tuple(float(x) for x in m.groups()) for m in SELF.finditer(err)]
    return funnel, s1


def test_serve_and_probe_matches_reference(tmp_path, monkeypatch, capsys):
    narrow = dict(vocab_size=30522, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128, max_position_embeddings=512)
    params = init_colbert_params(jax.random.PRNGKey(0), JBertConfig(**narrow), dim=128)
    tenc, cfg = make_bench_encoder(device="cpu", model=from_jax_params(
        to_numpy(params), BertConfig(**narrow)))
    cfg.activation_dtype = "float32"
    cfg.plaid_stage2_docs = cfg.ncandidates = 32
    cfg.mesh_data_axis = 1
    jcfg = JConfig.from_dict(cfg.to_dict())
    jenc = JEncoder(params, JBertConfig(**narrow), bench.bench_vocab_tokenizer(), jcfg)
    passages = synthetic_passages(N)
    JIndexer(jcfg, encoder=jenc, collection=passages).index(str(tmp_path / "idx"))
    monkeypatch.setattr(bench, "_time_qps", _one_batch)
    monkeypatch.setattr(bench_torch, "time_qps", _one_batch)

    capsys.readouterr()
    bench.serve_and_probe(jenc, jcfg, str(tmp_path), passages, N)
    jfunnel, js1 = _parse(capsys.readouterr().err)
    out = bench_torch.serve_and_probe(tenc, cfg, str(tmp_path), passages, N)
    tfunnel, ts1 = _parse(capsys.readouterr().err)

    assert list(jfunnel) == list(tfunnel) == list(out["funnel"]) == [
        "quality-first", "throughput-tuned (ncand=512)", "tight (ncand=128)"]
    for name in jfunnel:
        print(f"{name}: set recall@10/@100 jax {jfunnel[name][:2]} port {tfunnel[name][:2]}")
        for i in (2, 3):  # score-recall@10, @100 as both stages log them
            assert abs(tfunnel[name][i] - jfunnel[name][i]) <= RECALL_TOL, name
        assert round(out["funnel"][name]["score_recall_at_100"], 3) == tfunnel[name][3]
    assert ts1 == js1
    assert (out["self_s1_pruned"], out["self_s1_exhaustive"]) == ts1
    # every returned stage-2 score against the oracle's score of its pid
    assert len(out["stage2_vs_oracle"]) == 6
    assert all(e <= SCORE_TOL for e in out["stage2_vs_oracle"].values()), out["stage2_vs_oracle"]
    assert np.isfinite(out["oracle_spread"]["top1"])
