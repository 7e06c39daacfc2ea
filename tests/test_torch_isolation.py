"""``colbert_torch`` imports neither jax nor any module of colbert_tpu."""

import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    import colbert_torch

    names = ["colbert_torch"]
    for info in pkgutil.walk_packages(colbert_torch.__path__, "colbert_torch."):
        names.append(info.name)
    return names


def test_package_imports_no_jax():
    names = _modules()
    for name in ("ops.fused_maxsim", "ops.flash_attention", "ops.kmeans",
                 "indexing.codec_trainer", "indexing.builder", "retrieval.searcher",
                 "indexing.updater", "ops.maxsim", "retrieval.ranking",
                 "evaluation.metrics", "evaluation.runner", "evaluation.oracle",
                 "evaluation.autotune", "serving.batcher", "serving.http"):
        assert f"colbert_torch.{name}" in names
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "import colbert_torch\n"
        "colbert_torch.Searcher, colbert_torch.Indexer, colbert_torch.IndexUpdater\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'colbert_tpu' or m.startswith('colbert_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


def test_chip_smoke_imports_no_jax():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'colbert_tpu')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


def test_chip_smoke_needs_a_gpu():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        return
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert '"ok"' not in done.stdout


@pytest.mark.parametrize("script", ["tune_flash", "tune_stage2"])
def test_tune_scripts_import_no_jax_and_need_a_gpu(script):
    """The kernel tuning scripts import no JAX and, without CUDA, exit 2
    before building anything."""
    code = (
        "import sys\n"
        f"import {script}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'colbert_tpu')]\n"
        "import torch\n"
        f"rc = {script}.main() if not torch.cuda.is_available() else 2\n"
        "sys.exit(1 if bad else rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 2, done.stdout + done.stderr
