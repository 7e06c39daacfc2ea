"""Build directory and device selection shared by the port's modules.

Native libraries (the C++ tokenizer and IVF builder from ``native/``, the
CUDA kernels from ``colbert_torch/csrc/``) are compiled at first use into
``colbert_torch/build/``, never into the JAX package's ``native/build/``.
Each library is compiled to a process-unique temporary file and renamed
into place, so concurrent processes never load a half-written library.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import torch

__all__ = ["REPO_ROOT", "BUILD_DIR", "compile_shared", "compile_cuda", "resolve_device"]

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
BUILD_DIR = os.path.join(REPO_ROOT, "colbert_torch", "build")
CSRC_DIR = os.path.join(REPO_ROOT, "colbert_torch", "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def compile_cuda(src: str, so_name: str) -> tuple[str, str]:
    """``compile_shared`` for a CUDA source with a plain C interface:
    ``nvcc`` for ``sm_90a`` with ptxas resource lines in the returned log."""
    return compile_shared([_nvcc()] + NVCC_FLAGS, src, so_name)


def compile_shared(cmd_prefix: list[str], src: str, so_name: str) -> tuple[str, str]:
    """Compile ``src`` into ``BUILD_DIR/so_name`` unless an up-to-date copy
    exists -> (the library's path, the compiler's output or "" when the
    library was up to date). ``cmd_prefix`` is the compiler and its
    flags; the output and source are appended. Raises
    ``RuntimeError`` (with the compiler's output) on a
    failed build and ``FileNotFoundError`` when the compiler is missing."""
    so = os.path.join(BUILD_DIR, so_name)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        done = subprocess.run(cmd_prefix + ["-o", tmp, src], check=True,
                              capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"building {so_name} failed:\n{e.stdout}\n{e.stderr}"
        ) from e
    os.replace(tmp, so)
    return so, done.stdout + done.stderr


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when no GPU is present: the port never continues on
    the CPU unless the caller asked for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
