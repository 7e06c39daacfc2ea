"""``bench_mfu_torch.py``, ``bench_scale_torch.py`` and ``bench_sharded_torch.py``
run whole on the CPU at the narrow width (2 layers, hidden 64), in process
on one torch thread, and print as their last stdout line the JSON summary
whose keys are the JAX script's (``bench_mfu.py``, ``bench_scale.py``,
``bench_sharded.py``, read from their source) with the renames listed in
CHANGES.md: ``hbm_gb`` -> ``device_gb`` (``torch.cuda.max_memory_allocated``
where the JAX script read live arrays) and ``qps_cpu_mesh`` ->
``qps_one_card`` (the shards of one device run in turn)."""

import ast
import json
import os


import bench_mfu_torch
import bench_scale_torch
import bench_sharded_torch
from colbert_torch.utils.testing import synthesize_index

from _torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json_keys(script: str, renames: dict) -> list[str]:
    """The keys of the dict that ``script`` prints last, renamed."""
    tree = ast.parse(open(os.path.join(REPO, script)).read())
    dicts = [node.args[0] for node in ast.walk(tree)
             if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
             and node.args and isinstance(node.args[0], ast.Dict)]
    return [renames.get(k.value, k.value) for k in dicts[-1].keys]


def _last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def test_mfu_sweep(capsys, monkeypatch):
    monkeypatch.setattr(bench_mfu_torch, "TOKENS_PER_PASS", 4096)  # two batches per B
    assert bench_mfu_torch.main(["32", "--device", "cpu", "--bert", "narrow"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert list(out) == _json_keys("bench_mfu.py", {})
    assert out["metric"] == "encode_mfu_sweep" and out["seqlen"] == 32
    assert out["value"] == {"128": None, "256": None, "512": None, "1024": None}


def test_scale(capsys, monkeypatch):
    make = bench_scale_torch.make_bench_encoder

    def capped(**kw):  # a 32-candidate stage-2 budget: the plain stage 2 is slow here
        encoder, cfg = make(**kw)
        cfg.plaid_stage2_docs = cfg.ncandidates = 32
        return encoder, cfg

    monkeypatch.setattr(bench_scale_torch, "make_bench_encoder", capped)
    assert bench_scale_torch.main(["256", "--device", "cpu", "--bert", "narrow"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert list(out) == _json_keys("bench_scale.py", {"hbm_gb": "device_gb"})
    assert out["n_passages"] == 256 and out["value"] > 0 and out["device_gb"] is None
    assert out["index_gb"] > 0 and 0 <= out["score_recall_at_10"] <= 1
    assert out["self_retrieval_s1"] == 1.0


def test_sharded(tmp_path, capsys):
    path = str(tmp_path / "idx")
    synthesize_index(path, 2_000, chunksize=500)
    assert bench_sharded_torch.main([path, "4", "--devices", "4", "--device", "cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert list(out) == _json_keys("bench_sharded.py", {"qps_cpu_mesh": "qps_one_card"})
    assert out["n_passages"] == 2_000 and out["qps_one_card"] > 0
    assert out["total_device_gb"] >= out["per_shard_gb"] > 0
