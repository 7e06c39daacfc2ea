"""``bench_torch.py`` against ``bench.py`` on the CPU: the corpus helpers
and the recall metrics equal (exactly), the FLOP count equal to a hand
count, the stdout contract of a run in a process of its own with every
stage but serving real (seven identical four-key headline lines, exit 0), a failing stage (the others still run, every
headline is printed, ``main`` returns 1), and the refusal of all four
benchmark scripts to run without a GPU unless given ``--device cpu``.
``serve_and_probe`` is held to the JAX stage in ``test_torch_bench_serve.py``,
the other three scripts run in ``test_torch_bench_scripts.py``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench
import bench_torch
from colbert_torch.utils import testing as ttesting

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE_KEYS = ["metric", "value", "unit", "vs_baseline"]
STAGES = ["encode_stages", "device_mfu_stage", "flash_probe", "serve_and_probe",
          "host_backend_stage"]


@pytest.mark.parametrize("n,mean_words,n_topics,n_words", [
    (300, 110, 64, 2000),      # bench.py's corpus
    (64, 450, 64, 2000),       # the flash probe's long passages
    (8192, 110, 128, 30000),   # bench_scale.py's "scaled" corpus: n // 64 topics
])
def test_corpus_helpers_equal(n, mean_words, n_topics, n_words):
    """The same strings, exactly."""
    assert ttesting.synthetic_passages(n, mean_words=mean_words, n_words=n_words,
                                       n_topics=n_topics) == bench.synthetic_passages(
        n, mean_words=mean_words, n_words=n_words, n_topics=n_topics)
    assert ttesting.synthetic_queries(50, n_words=n_words, n_topics=n_topics) == \
        bench.synthetic_queries(50, n_words=n_words, n_topics=n_topics)
    for t in (0, 1, n_topics // 2, n_topics - 1):
        np.testing.assert_array_equal(ttesting._topic_words(t, n_words, n_topics),
                                      bench._topic_words(t, n_words, n_topics))


def test_vocab_equal():
    assert ttesting.bench_vocab_tokenizer().vocab == bench.bench_vocab_tokenizer().vocab


@pytest.mark.parametrize("k", [1, 5, 10, 20])
def test_recall_metrics_equal(k):
    """Set recall and score recall on random pid tables with misses (-1)
    and repeats: equal to the last bit."""
    rng = np.random.default_rng(k)
    oscores = rng.normal(size=(8, 50)).astype(np.float32)
    oscores[:, :5] = oscores[:, :1]  # ties at the top
    oracle = np.argsort(-oscores, axis=1)[:, :20]
    got = rng.integers(-1, 50, size=(8, 20))
    assert bench_torch._recall(got, oracle, k) == bench._recall(got, oracle, k)
    assert bench_torch._score_recall(got, oscores, k) == bench._score_recall(got, oscores, k)


def test_flop_count_by_hand():
    """bert-base at S=128: 12 x (2 x (4 x 768^2 + 2 x 768 x 3072) + 4 x 128 x 768)
    + 2 x 768 x 128; the narrow config at S=160: 2 x (2 x (4 x 64^2 +
    2 x 64 x 128) + 4 x 160 x 64) + 2 x 64 x 128. Exact integers."""
    base = bench_torch.bench_bert_config()
    assert bench_torch.flops_per_token(base, 128, 128) == 174_784_512
    narrow = bench_torch.narrow_bert_config()
    assert bench_torch.flops_per_token(narrow, 160, 128) == 229_376
    assert bench_torch.batch_flops(narrow, 128, [(256, 160), (3, 160)]) == 259 * 160 * 229_376


def _headlines(stdout: str) -> list[dict]:
    lines = stdout.splitlines()
    assert len(lines) == 7, stdout
    assert len(set(lines)) == 1, stdout
    heads = [json.loads(line) for line in lines]
    for h in heads:
        assert list(h) == HEADLINE_KEYS
        assert h["metric"] == "index_build_passages_per_sec"
        assert h["unit"] == "passages/s" and h["value"] > 0
        assert h["vs_baseline"] == round(h["value"] / 16.1, 2)
    return heads


# bench_torch.main in a process of its own, cut down for the CPU: the
# serving stage is a stand-in (it indexes passage 900, and runs whole in
# test_torch_bench_serve.py), the searches' stage-2 budget is 32 candidates
# (the plain stage 2 is slow here) and the flash probe encodes 64 passages
RUN_CUT_DOWN = """
import sys
import bench_torch
make, probe = bench_torch.make_bench_encoder, bench_torch.flash_probe

def capped(**kw):
    encoder, cfg = make(**kw)
    cfg.plaid_stage2_docs = cfg.ncandidates = 32
    return encoder, cfg

bench_torch.make_bench_encoder = capped
bench_torch.flash_probe = lambda encoder: probe(encoder, 64)
bench_torch.serve_and_probe = lambda *a: {"stand_in": True}
sys.exit(bench_torch.main(sys.argv[1:]))
"""


def test_stdout_contract():
    """``bench_torch.py --device cpu --n 300 --bert narrow`` as its own
    process on one torch thread, cut down as ``RUN_CUT_DOWN`` says: exit
    0, stdout exactly seven identical headline lines, every stage's
    numbers on stderr."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    done = subprocess.run(
        [sys.executable, "-c", RUN_CUT_DOWN, "--device", "cpu", "--n", "300",
         "--bert", "narrow"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    _headlines(done.stdout)
    stages = {line.split()[1]: json.loads(line.split(" ", 2)[2])
              for line in done.stderr.splitlines() if line.startswith("stage ")}
    assert list(stages) == ["build"] + STAGES, done.stderr[-4000:]
    assert stages["build"]["passages"] == 300 and stages["build"]["best_warm_pps"] > 0
    assert stages["build"]["flash_launches"] == {"mma": 0, "simt": 0}
    assert stages["encode_stages"]["passages"] == 300
    assert stages["flash_probe"]["passages"] == 64
    assert stages["flash_probe"]["flash_launches"] == {"mma": 0, "simt": 0}  # no kernel on the CPU
    assert stages["serve_and_probe"]["stand_in"]
    assert stages["host_backend_stage"]["qps_vs_host_backend"] > 0
    assert stages["device_mfu_stage"]["encode_mfu"] is None  # the CPU has no peak on record


@pytest.mark.parametrize("failing", STAGES)
def test_failed_stage_exits_nonzero(failing, monkeypatch, capsys):
    """One stage raises: the other four still run, all seven headlines
    print, the traceback goes to stderr, and ``main`` returns 1. The build
    and the stages are stand-ins: this holds ``main``'s control flow."""
    ran = []
    monkeypatch.setattr(bench_torch, "headline_build", lambda *a: {
        "best_warm_pps": 100.0, "flash_launches": {}, "stage2_launches": {}})
    for name in STAGES:
        def stage(*a, name=name, **k):
            ran.append(name)
            if name == failing:
                raise ValueError(f"{name} made to fail")
            return {}
        monkeypatch.setattr(bench_torch, name, stage)
    rc = bench_torch.main(["--device", "cpu", "--n", "64", "--bert", "narrow"])
    out = capsys.readouterr()
    assert rc == 1
    assert ran == STAGES
    assert [h["value"] for h in _headlines(out.out)] == [100.0] * 7
    assert f"ValueError: {failing} made to fail" in out.err
    assert f"failed stages: ['{failing}']" in out.err


@pytest.mark.parametrize("script", ["bench_torch", "bench_mfu_torch", "bench_scale_torch",
                                    "bench_sharded_torch"])
def test_scripts_need_a_gpu(script):
    """With no arguments each script asks for the card; without one it
    raises before any work (there is no CPU fallback)."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    mod = importlib.import_module(script)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main([])
