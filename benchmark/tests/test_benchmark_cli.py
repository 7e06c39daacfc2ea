"""The command's refusals: without a CUDA card, and in a directory that
holds only ``BENCHMARK.json`` and the benchmark's folder, it exits non-zero
and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARGS = ["-m", "benchmark.run", "--workload", "serve-stream.base", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable] + ARGS, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_refuses_without_a_card():
    done = _run(ROOT)
    assert done.returncode != 0 and done.stdout == ""
    assert "no CUDA device" in done.stderr


@pytest.mark.parametrize("keep", [["BENCHMARK.json", "benchmark"]])
def test_refuses_in_a_bare_checkout(tmp_path, keep):
    for name in keep:
        src = os.path.join(ROOT, name)
        if os.path.isdir(src):
            shutil.copytree(src, tmp_path / name, ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy(src, tmp_path / name)
    done = _run(tmp_path)
    assert done.returncode != 0 and done.stdout == ""
