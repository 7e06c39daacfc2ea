"""The architecture files. ``archs/bert.py`` computes what the functions it
wraps compute, bit for bit: the weights at the tiny widths and at both
configurations' published ones, the reference and its control, the FLOP
counts. A configuration of a new architecture, with a cell of each driver,
is built, run and judged through new files alone, and by its own
architecture's reference."""

import json
import os
import shutil

import pytest
import torch
from conftest import TINY, TINY_LIMITS

from benchmark import registry, roofline, run
from benchmark.gen import weights
from benchmark.reference import encoder

CONFIGS = ["colbertv2-base", "colbert-large"]
BERT = registry.arch("bert")


def widths_of(name):
    return TINY["config"]["bert"] if name == "tiny" else registry.config(name)["bert"]


@pytest.mark.parametrize("name", ["tiny"] + CONFIGS)
def test_bert_weights_are_the_generators(name):
    w = widths_of(name)
    got = BERT.make_weights(11, w, 128, "cpu")
    want = weights.make_weights(11, w, 128, "cpu")
    assert list(got) == list(want)
    for n in want:
        assert got[n].dtype == want[n].dtype == torch.float32
        assert torch.equal(got[n], want[n]), n


@pytest.mark.parametrize("precision", ["float32", "fp8"])
def test_bert_encode_is_the_reference(precision):
    w = TINY["config"]["bert"]
    params = weights.make_weights(5, w, 16, "cpu")
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(5, w["vocab_size"], (4, 24), generator=g)
    mask = torch.rand(4, 24, generator=g) < 0.8
    mask[:, 0] = True
    keep = mask & (torch.rand(4, 24, generator=g) < 0.9)
    got = BERT.encode(params, w, ids, mask, keep, precision)
    want = encoder.encode(params, w, ids, mask, keep, precision)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", CONFIGS)
def test_bert_flops_and_vocabulary_are_the_roofline_and_config(name):
    w = widths_of(name)
    for tokens, keys in [(1, 1), (32, 9), (32, 17.40625), (86, 86), (300, 300)]:
        assert BERT.encoder_flops(w, 128, tokens, keys) == roofline.encoder_flops(
            w, 128, tokens, keys)
    assert BERT.vocab_size(w) == w["vocab_size"] == 30522


def copy_benchmark(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def add_bert2(root, fault=False):
    """``archs/bert2.py`` (a copy of ``bert.py``; with ``fault`` its
    reference leaves out the last layer), a tiny configuration of it that
    holds no ``"bert"`` key, and a cell of each driver over it."""
    src = (root / "archs" / "bert.py").read_text()
    if fault:
        src += ("\n\ndef encode(weights, widths, ids, mask, keep, precision='float32'):\n"
                "    short = dict(widths, num_hidden_layers=widths['num_hidden_layers'] - 1)\n"
                "    return encoder.encode(weights, short, ids, mask, keep, precision)\n")
    (root / "archs" / "bert2.py").write_text(src)
    cfg = json.loads((root / "configs" / "colbertv2-base.json").read_text())
    del cfg["bert"]
    cfg.update({k: v for k, v in TINY["config"].items() if k != "bert"},
               name="tiny2", arch="bert2", bert2=TINY["config"]["bert"])
    (root / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    for cell, like in [("tiny2.stream", "serve-stream.base"),
                       ("tiny2.build", "index-build.large")]:
        c = json.loads((root / "cells" / f"{like}.json").read_text())
        c.update(TINY["cell"], config="tiny2", limits=TINY_LIMITS[like])
        (root / "cells" / f"{cell}.json").write_text(json.dumps(c))


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "last_layer_left_out"])
@pytest.mark.parametrize("cell", ["tiny2.stream", "tiny2.build"])
def test_new_architecture_is_found_as_files(cell, fault, tmp_path, tiny):
    root = copy_benchmark(tmp_path)
    add_bert2(root, fault)
    assert "bert2" in registry.names("archs", str(root))
    assert "bert" not in registry.config("tiny2", str(root))
    res = run.execute(cell, 17, 2.0, False, "cpu", root=str(root))
    metric = registry.driver(registry.cell(cell, str(root))["driver"], str(root)).METRIC
    assert res["attempted"] > 0 and res["metrics"][metric]["value"] > 0
    # judged by the configuration's own architecture: its reference one
    # layer short disagrees with the program built from the same widths
    assert res["correct"] is (not fault)


def test_yardstick_flags_an_architecture_that_imports_the_program(tmp_path):
    root = copy_benchmark(tmp_path)
    assert registry.yardstick_imports(str(root)) == []
    (root / "archs" / "leak.py").write_text("import colbert_torch.models.bert\n")
    assert registry.yardstick_imports(str(root)) == ["archs/leak.py: colbert_torch.models.bert"]
