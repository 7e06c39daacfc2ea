"""BENCHMARK.json and the per-file layout: names, units, layers, what
each cell reports, each configuration's architecture, and that a new cell
and a new metric are found as new files alone."""

import json
import os
import re
import shutil

import pytest

from benchmark import registry

ROOT = os.path.dirname(registry.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(set(names)) == len(names)
    for e in bench[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")


def test_every_workload_has_its_cell_and_config(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = registry.cell(w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert w["traffic"] == w["name"] and cell["why"] == w["why"]
        assert os.path.isfile(os.path.join(ROOT, configs[w["config"]]["file"]))
        assert registry.config(w["config"])["name"] == w["config"]
        assert len(w["why"]) <= 200


def test_end_to_end_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_per_layer_metrics_match_their_readers(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"]: registry.cell(w["name"]) for w in bench["workloads"]}
    for m in bench["per_layer"]:
        reader = registry.metric(m["name"])
        assert reader.LAYER == m["layer"] and reader.UNIT == m["unit"]
        assert reader.MOVES == m["moves"] and m["moves"] in e2e
        for w in m["workloads"]:
            # the cell reads this metric and reports the metric it moves
            assert cells[w]["driver"] in reader.DRIVERS
            assert registry.driver(cells[w]["driver"]).METRIC == m["moves"]
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_every_configuration_names_an_architecture_file(bench):
    for c in bench["configs"]:
        cfg = registry.config(c["name"])
        name = cfg.get("arch", "bert")
        assert name in registry.names("archs")
        assert os.path.isfile(os.path.join(registry.HERE, "archs", f"{name}.py"))
        arch, widths = registry.arch_of(cfg)
        assert widths is cfg[name] and arch.vocab_size(widths) > 0
        module, cls = arch.PROGRAM_CONFIG.split(":")
        assert module.split(".")[0] == registry.PROGRAM and cls.isidentifier()


def test_every_cell_driver_names_its_end_to_end_metric(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        name = registry.cell(w["name"])["driver"]
        metric = registry.driver(name).METRIC
        assert metric in e2e and w["name"] in e2e[metric].get("workloads", [w["name"]])
        for m in registry.metrics_for(name).values():
            assert m.MOVES == metric


def test_every_cell_reports_a_layer_metric(bench):
    for w in bench["workloads"]:
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])


def test_new_cell_and_metric_are_found_as_files(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "cells" / "dummy.cell.json").write_text(json.dumps(
        {"config": "colbertv2-base", "driver": "stream", "chips": 1, "why": "a test"}))
    (root / "metrics" / "dummy.metric.py").write_text(
        "LAYER = 'device'\nUNIT = '%'\nMOVES = 'search_qps'\nDRIVERS = ('stream',)\n"
        "def read(r):\n    return None\n")
    assert "dummy.cell" in registry.names("cells", str(root))
    assert registry.cell("dummy.cell", str(root))["driver"] == "stream"
    assert "dummy.metric" in registry.metrics_for("stream", str(root))
    assert "dummy.metric" not in registry.metrics_for("build", str(root))


def test_yardstick_imports_nothing_of_the_program(tmp_path):
    assert registry.yardstick_imports() == []
    root = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "reference" / "leak.py").write_text("from colbert_torch.ops import codec\n")
    assert registry.yardstick_imports(str(root)) == ["reference/leak.py: colbert_torch.ops"]


def test_forbidden_modules_compared_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "colbert_tpu_like", types.ModuleType("colbert_tpu_like"))
    assert registry.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert registry.loaded_forbidden() == ["jax.numpy"]
