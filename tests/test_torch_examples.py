"""The port's entry points (``colbert_torch.examples.*`` and
``colbert_torch.evaluation.quality``) against the JAX package's scripts
(``examples/*.py``, ``bench_quality.py``).

Their surface, for all nine: ``--help`` works and lists every flag the
module docstring advertises; the options and their defaults, and the
positional arguments, are the JAX script's plus ``--device``; without a
GPU and without ``--device cpu`` each raises before it writes anything.

Then the pipeline on one fixture: both packages' ``make_eval_fixture``
write the same bytes (256 passages, 16 queries). A tiny BERT (2 layers,
hidden 64, the corpus vocabulary, dim 128), drawn by the JAX package, is
saved once as a checkpoint that both packages load. Each package's
``indexing`` builds an index from it at fp32 activations (the examples'
``ColBERTConfig`` with ``activation_dtype="float32"``; the JAX build on one
device, as in ``tests/test_torch_indexer.py``), and the two indexes agree
by that file's rules. Over the JAX-built index: ``searching`` top-k equal
up to ties with scores within 1e-4, ``evaluate``'s metrics equal, the
tuner's recall columns equal (both sweeps untimed, ``time_reps=0``), and
``update`` add/remove/compact on copies gives the artifacts of
``tests/test_torch_updater.py``'s rules. The port's ``train`` writes a
checkpoint that the JAX ``load_checkpoint`` reads back to the same weights.
"""

import argparse
import ast
import contextlib
import functools
import importlib
import importlib.util
import io
import json
import os
import re
import shutil
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from colbert_tpu.config import ColBERTConfig as JConfig
from colbert_tpu.evaluation import autotune as jautotune
from colbert_tpu.models.bert import BertConfig as JBertConfig
from colbert_tpu.models.colbert import init_colbert_params
from colbert_tpu.models.encoder import ColBERTEncoder as JEncoder
from colbert_tpu.models.hf_loader import load_checkpoint as jload_checkpoint
from colbert_tpu.models.hf_loader import save_checkpoint as jsave_checkpoint
from colbert_torch.config import ColBERTConfig
from colbert_torch.models.colbert import to_jax_params
from colbert_torch.models.hf_loader import load_checkpoint
from colbert_torch.storage import format as fmt
from colbert_torch.utils.testing import make_triples

from _torch_parity import assert_topk_agree, to_numpy
from test_torch_indexer import BF16_STEP
from test_torch_indexer import _assert_codes_agree as assert_built_codes_agree
from test_torch_updater import _assert_codes_agree as assert_updated_codes_agree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["searching", "indexing", "make_eval_fixture", "evaluate", "tune", "update",
            "serve", "train"]
# name -> (the port's module, the JAX script)
ENTRY_POINTS = {name: (f"colbert_torch.examples.{name}", f"examples/{name}.py")
                for name in EXAMPLES}
ENTRY_POINTS["quality"] = ("colbert_torch.evaluation.quality", "bench_quality.py")
N_FIXTURE = 256
N_QUERIES = 16
UPDATE_STAGES = ["added", "removed", "compacted"]
REMOVED = [3, 17, 257]  # one of them added by the update


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread: beside the suite's other workers,
    torch's thread pool waits at every op's barrier for descheduled threads
    (an index build here took 368 s on 8 threads under load, 18.5 s on 1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the surface ------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _port_parser(name, monkeypatch) -> argparse.ArgumentParser:
    """The port module's parser, caught as ``main`` hands it its argv."""
    seen = []

    def catch(self, *a, **k):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_intermixed_args", catch)
    with pytest.raises(_Parsed):
        importlib.import_module(ENTRY_POINTS[name][0]).main([])
    return seen[0]


def _jax_arguments(script: str) -> tuple[list[str], dict]:
    """The JAX script's ``add_argument`` calls -> (positional names in
    order, {option string: default})."""
    tree = ast.parse(open(os.path.join(REPO, script)).read())
    positional, options = [], {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"):
            continue
        names = [a.value for a in node.args if isinstance(a, ast.Constant)]
        kw = {k.arg: k.value for k in node.keywords}
        if names[0].startswith("-"):
            store_true = "action" in kw and ast.literal_eval(kw["action"]) == "store_true"
            default = ast.literal_eval(kw["default"]) if "default" in kw else (
                False if store_true else None)
            options.update({n: default for n in names})
        else:
            positional += names
    return positional, options


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_help_lists_every_flag_of_the_docstring(name, capsys):
    module = importlib.import_module(ENTRY_POINTS[name][0])
    with pytest.raises(SystemExit) as done:
        module.main(["--help"])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert "usage" in out.lower()
    defined = set(re.findall(r"--[a-z][a-z0-9_-]+", out))
    # a docstring may quote a pipeline of several entry points: flags on a
    # line that runs another one belong to that one
    doc = re.sub(r"\\\n\s*", " ", module.__doc__)
    own = [ln for ln in doc.splitlines()
           if not re.search(r"colbert_torch\.(examples|evaluation)\.\w+", ln)
           or ENTRY_POINTS[name][0] in ln]
    for flag in set(re.findall(r"--[a-z][a-z0-9_-]+", "\n".join(own))):
        assert flag in defined, f"{name}: docstring advertises {flag}, --help lists {defined}"


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_arguments_are_the_jax_scripts_plus_device(name, monkeypatch):
    parser = _port_parser(name, monkeypatch)
    positional, options = _jax_arguments(ENTRY_POINTS[name][1])
    got = {s: a.default for a in parser._actions for s in a.option_strings
           if s not in ("-h", "--help")}
    assert got == {**options, "--device": "cuda"}
    if name == "quality":  # bench_quality.py reads sys.argv itself: numbers, then words
        assert [a.dest for a in parser._actions if not a.option_strings] == ["args"]
    else:
        assert [a.dest for a in parser._actions if not a.option_strings] == positional


def _refusal_argv(name, tmp) -> list[str]:
    return {
        "searching": [f"{tmp}/idx", "a query"],
        "indexing": [f"{tmp}/ckpt", f"{tmp}/collection.tsv", f"{tmp}/idx"],
        "make_eval_fixture": [f"{tmp}/fx"],
        "evaluate": [f"{tmp}/idx", f"{tmp}/queries.tsv", f"{tmp}/qrels.txt"],
        "tune": [f"{tmp}/idx", f"{tmp}/queries.tsv", "--apply-to", "config"],
        "update": [f"{tmp}/idx", "add", "a passage"],
        "serve": [f"{tmp}/idx", "--port", "0"],
        "train": [f"{tmp}/ckpt", f"{tmp}/triples.tsv", f"{tmp}/out"],
        "quality": ["256", "3"],
    }[name]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_refuses_without_a_gpu(name, tmp_path, monkeypatch):
    """No GPU, no ``--device cpu``: ``resolve_device`` raises (a non-zero
    exit under ``python -m``) before anything is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    module = importlib.import_module(ENTRY_POINTS[name][0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(_refusal_argv(name, tmp_path))
    assert os.listdir(tmp_path) == []


# -- the pipeline on one fixture ----------------------------------------------------


def _jax_script(name: str):
    """A JAX example script as a fresh module, its ``main`` not yet run."""
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(name: str, argv: list[str], **patches):
    """Run a JAX example's ``main`` on ``argv`` with module attributes
    replaced by ``patches`` -> its standard output."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(os.path.join(REPO, "examples"))  # evaluate.py's `from searching`
        module = _jax_script(name)
        for attr, value in patches.items():
            mp.setattr(module, attr, value)
        mp.setattr(sys, "argv", [f"{name}.py"] + argv)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            module.main()
    return out.getvalue()


def _run_port(name: str, argv: list[str], **patches):
    module = importlib.import_module(f"colbert_torch.examples.{name}")
    with pytest.MonkeyPatch.context() as mp:
        for attr, value in patches.items():
            mp.setattr(module, attr, value)
        with contextlib.redirect_stdout(io.StringIO()):
            return module.main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The fixture written by both packages, the tiny checkpoint, and an
    index built from it by each package's ``indexing``."""
    from bench import bench_vocab_tokenizer as jbench_tokenizer

    root = tmp_path_factory.mktemp("texamples")
    out = {"root": root}
    for pkg in ("jax", "port"):
        fx = str(root / f"fx_{pkg}")
        argv = [fx, "--n", str(N_FIXTURE), "--queries", str(N_QUERIES)]
        if pkg == "jax":
            _run_jax("make_eval_fixture", argv)
        else:
            _run_port("make_eval_fixture", argv)
        out[pkg, "fx"] = fx
    fx = out["jax", "fx"]
    out["collection"] = [line.rstrip("\n").split("\t", 1)[1]
                         for line in open(os.path.join(fx, "collection.tsv"))]

    tokenizer = jbench_tokenizer()
    bert = JBertConfig(vocab_size=len(tokenizer.vocab), hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128)
    ckpt = str(root / "ckpt")
    jsave_checkpoint(ckpt, init_colbert_params(jax.random.PRNGKey(0), bert, dim=128),
                     bert, tokenizer)
    out["ckpt"] = ckpt

    argv = [ckpt, os.path.join(fx, "collection.tsv")]
    out["jax", "idx"] = str(root / "idx_jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_count", lambda *a, **k: 1)  # one device, as the port
        _run_jax("indexing", argv + [out["jax", "idx"]],
                 ColBERTConfig=functools.partial(JConfig, activation_dtype="float32"))
    out["port", "idx"] = _run_port(
        "indexing", argv + [str(root / "idx_port")],
        ColBERTConfig=functools.partial(ColBERTConfig, activation_dtype="float32"))
    params = jload_checkpoint(ckpt)
    out["jenc"] = JEncoder(params[1], params[0], params[2],
                           JConfig.load(os.path.join(out["jax", "idx"], "config.json")))
    qids, queries = [], []
    for line in open(os.path.join(fx, "queries.tsv")):
        qid, text = line.rstrip("\n").split("\t", 1)
        qids.append(qid)
        queries.append(text)
    out["queries"] = queries
    return out


def test_make_eval_fixture_writes_the_same_bytes(pipeline):
    for name in ("collection.tsv", "queries.tsv", "qrels.txt"):
        with open(os.path.join(pipeline["jax", "fx"], name), "rb") as fj, \
                open(os.path.join(pipeline["port", "fx"], name), "rb") as ft:
            assert ft.read() == fj.read(), name
    assert len(pipeline["queries"]) == N_QUERIES


def test_indexing_matches_reference(pipeline):
    jpath, tpath = pipeline["jax", "idx"], pipeline["port", "idx"]
    assert fmt.check_all_files_saved(tpath) == []
    pj, pt = fmt.load_plan(jpath), fmt.load_plan(tpath)
    for key in ("num_partitions", "num_chunks", "num_embeddings", "embedding_offsets",
                "num_documents", "chunksize", "avg_doclen_est"):
        assert pt[key] == pj[key], key
    assert pt["num_documents"] == N_FIXTURE
    np.testing.assert_array_equal(fmt.load_all_doclens(tpath), fmt.load_all_doclens(jpath))
    cj, ct = fmt.load_codec(jpath), fmt.load_codec(tpath)
    for key in ("centroids", "bucket_cutoffs", "bucket_weights"):
        np.testing.assert_allclose(ct[key], cj[key], atol=BF16_STEP, rtol=0)
    assert abs(ct["avg_residual"] - cj["avg_residual"]) <= BF16_STEP
    cfg_j = JConfig.load(os.path.join(jpath, "config.json"))
    cfg_t = ColBERTConfig.load(os.path.join(tpath, "config.json"))
    assert {**cfg_t.to_dict(), "index_path": jpath} == cfg_j.to_dict()
    assert_built_codes_agree(dict(jenc=pipeline["jenc"], passages=pipeline["collection"],
                                  cfg=cfg_j), jpath, tpath)


def test_searching_matches_reference(pipeline, monkeypatch):
    from colbert_tpu.retrieval.searcher import Searcher as JSearcher

    idx = pipeline["jax", "idx"]
    got = []
    search = JSearcher.search
    monkeypatch.setattr(JSearcher, "search",
                        lambda self, q, k=10: got.append(search(self, q, k)) or got[-1])
    for q in pipeline["queries"][:4]:
        printed = _run_jax("searching", [idx, q, "-k", "10"])
        [(pids, scores)] = _run_port("searching", [idx, q, "-k", "10"])
        pj, sj = got[-1]
        assert_topk_agree(pids[None], scores[None], np.asarray(pj)[None],
                          np.asarray(sj)[None], 1e-4)
        assert len(printed.splitlines()) == 10


def test_evaluate_matches_reference(pipeline):
    fx, idx = pipeline["jax", "fx"], pipeline["jax", "idx"]
    argv = [idx, os.path.join(fx, "queries.tsv"), os.path.join(fx, "qrels.txt")]
    want = json.loads(_run_jax("evaluate", argv))
    got = _run_port("evaluate", argv)
    for key in ("num_queries", "mrr@10", "success@5", "ndcg@10"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert got["qps"] > 0


def test_tune_recall_columns_match_reference(pipeline, tmp_path):
    from colbert_torch.examples import tune as ttune

    fx = pipeline["jax", "fx"]
    idx = str(tmp_path / "idx")
    shutil.copytree(pipeline["jax", "idx"], idx)
    results = []

    def untimed(tune):
        return lambda *a, **k: results.append(tune(*a, **{**k, "time_reps": 0})) or results[-1]

    _run_jax("tune", [idx, os.path.join(fx, "queries.tsv")],
             tune_operating_point=untimed(jautotune.tune_operating_point))
    got = _run_port("tune", [idx, os.path.join(fx, "queries.tsv"), "--apply-to", "config"],
                    tune_operating_point=untimed(ttune.tune_operating_point))
    want = results[0]
    assert got is results[1] and len(got.table) == len(want.table) > 1
    for tg, tw in zip(got.table, want.table):
        assert tg.point.label() == tw.point.label()
        assert tg.score_recall == tw.score_recall and tg.set_recall == tw.set_recall
    saved = ColBERTConfig.load(os.path.join(idx, "config.json"))
    p = got.chosen.point
    assert (saved.plaid_stage2_docs, saved.plaid_stage1_refine, saved.refine_width_factor) == (
        p.ncandidates, p.stage1_refine, p.refine_width)


@pytest.fixture(scope="module")
def updated(pipeline):
    """Both packages' ``update`` runs add -> remove -> compact on copies of
    the JAX-built index; each stage is snapshotted."""
    root, added = pipeline["root"], pipeline["collection"][:4]
    added = [" ".join(p.split()[::-1]) for p in added]  # new passages, known words
    out = {"passages": pipeline["collection"] + added}
    for pkg in ("jax", "port"):
        path = str(root / f"up_{pkg}")
        shutil.copytree(pipeline["jax", "idx"], path)
        run = _run_jax if pkg == "jax" else _run_port
        for stage, argv in zip(UPDATE_STAGES, (["add", *added],
                                               ["remove", *map(str, REMOVED)], ["compact"])):
            result = run("update", [path, *argv])
            shutil.copytree(path, str(root / f"up_{pkg}_{stage}"))
            out[pkg, stage] = str(root / f"up_{pkg}_{stage}")
    out["pid_map"] = result  # the port's compact
    return out


@pytest.mark.parametrize("stage", UPDATE_STAGES)
def test_update_artifacts_match_reference(pipeline, updated, stage):
    jpath, tpath = updated["jax", stage], updated["port", stage]
    assert fmt.check_all_files_saved(tpath) == []
    assert fmt.load_plan(tpath) == fmt.load_plan(jpath)
    np.testing.assert_array_equal(fmt.load_all_doclens(tpath), fmt.load_all_doclens(jpath))
    np.testing.assert_array_equal(fmt.load_deleted(tpath), fmt.load_deleted(jpath))
    passages = updated["passages"]
    if stage == "compacted":
        pid_map = updated["pid_map"]
        assert (pid_map[REMOVED] == -1).all() and int((pid_map >= 0).sum()) == len(passages) - 3
        passages = [p for i, p in enumerate(passages) if i not in REMOVED]
    elif stage == "removed":
        np.testing.assert_array_equal(fmt.load_deleted(tpath), sorted(REMOVED))
    assert_updated_codes_agree(jpath, tpath, pipeline["jenc"], passages)
    names = ["plan.json"] + (["deleted.npy"] if stage != "added" else [])
    if (fmt.load_all_codes(tpath) == fmt.load_all_codes(jpath)).all():
        names += ["ivf.npy", "ivf_lengths.npy"]
        for ci in range(fmt.num_chunks(tpath)):
            names += fmt.chunk_file_names(ci)
    for name in names:
        with open(os.path.join(tpath, name), "rb") as ft, \
                open(os.path.join(jpath, name), "rb") as fj:
            assert ft.read() == fj.read(), name


def test_train_checkpoint_loads_in_the_reference(pipeline, tmp_path):
    triples = make_triples(pipeline["collection"], 8, seed=0)
    with open(tmp_path / "triples.tsv", "w") as f:
        f.writelines("\t".join(t) + "\n" for t in triples)
    out = str(tmp_path / "trained")
    assert _run_port("train", [pipeline["ckpt"], str(tmp_path / "triples.tsv"), out,
                               "--batch-size", "4"]) == out
    jcfg, jparams, jtok = jload_checkpoint(out)
    cfg, model, tok = load_checkpoint(out, device="cpu")
    assert jcfg.__dict__ == cfg.__dict__ and dict(jtok.vocab) == dict(tok.vocab)
    got = jax.tree_util.tree_leaves(to_jax_params(model))
    want = jax.tree_util.tree_leaves(to_numpy(jparams))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _, before, _ = load_checkpoint(pipeline["ckpt"], device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(before.parameters(), model.parameters()))
