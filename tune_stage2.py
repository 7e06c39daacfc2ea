#!/usr/bin/env python3
"""Times block shapes of the tensor-core stage-2 kernel on one GPU.

    python3 tune_stage2.py

Rebuilds ``colbert_torch/csrc/stage2_maxsim.cu`` once per shape with
``-DSTAGE2_MMA_WARPS=<w> -DSTAGE2_MMA_BLOCKS_PER_SM=<n> -DSTAGE2_MMA_MINB=<b>
-DSTAGE2_MMA_PREFETCH=<p>`` (warps per block, blocks per SM the grid aims
at, blocks per SM the registers are budgeted for, chunks loaded ahead), all
nvcc runs started together, into ``colbert_torch/build/tune/``. On
serving-like inputs (B=32 queries x NC=1024 candidates, Lq=32, dim=128,
nbits=2 in 32-bit words, K=32768, doclens uniform in [60, 160], ~110 on
average as in the serving index) it prints ptxas's registers and spills of the nbits-2 instantiation,
checks each shape against the plain version (1e-4) and times it with
CUDA events, twice, beside the fp32-FMA kernel (``simt``) in the same
run. The defaults in the source are the fastest shapes it found.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# (warps, blocks per SM aimed at, min blocks, prefetch); the first is the default
SHAPES = [(4, 8, 4, 3), (4, 8, 4, 1), (4, 8, 3, 3), (4, 8, 5, 3), (4, 4, 4, 3), (4, 16, 4, 3),
          (8, 8, 2, 3), (2, 8, 8, 3)]
TOL = 1e-4


def build(shape, out_dir):
    from colbert_torch.ops import fused_maxsim as fm
    from colbert_torch.utils.build import NVCC_FLAGS, _nvcc

    warps, per_sm, minb, pf = shape
    so = os.path.join(out_dir, "libstage2_{}_{}_{}_{}.so".format(*shape))
    done = subprocess.run(
        [_nvcc()] + NVCC_FLAGS + [f"-DSTAGE2_MMA_WARPS={warps}",
                                  f"-DSTAGE2_MMA_BLOCKS_PER_SM={per_sm}",
                                  f"-DSTAGE2_MMA_MINB={minb}", f"-DSTAGE2_MMA_PREFETCH={pf}",
                                  "-o", so, fm.KERNEL_SOURCE],
        capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"building {shape} failed:\n{done.stderr}")
    lines = (done.stdout + done.stderr).splitlines()
    info = next((lines[i + 1].strip() + "; " + lines[i + 2].strip().replace("ptxas info    : ", "")
                 for i, line in enumerate(lines)
                 if "Function properties" in line and "stage2_mma_kernelILi2E" in line), "")
    return so, info


def time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def serving_like_inputs(device, *, B=32, NC=1024, Lq=32, dim=128, nbits=2, K=32768,
                        n_tokens=3_700_000, Ld=160, seed=0):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    nbytes = dim // 8 * nbits
    codes = torch.randint(0, K, (n_tokens + Ld,), generator=g, device=device, dtype=torch.int32)
    res = torch.randint(0, 256, ((n_tokens + Ld) * nbytes,), generator=g, device=device,
                        dtype=torch.uint8)
    codes[n_tokens:] = 0
    res[n_tokens * nbytes:] = 0
    cent = torch.nn.functional.normalize(torch.randn(K, dim, generator=g, device=device), dim=-1)
    bw = torch.linspace(-0.025, 0.025, 1 << nbits, device=device)
    dls = torch.randint(60, Ld + 1, (B, NC), generator=g, device=device, dtype=torch.int32)
    offs = torch.randint(0, n_tokens - Ld, (B, NC), generator=g, device=device)
    Q = torch.nn.functional.normalize(torch.randn(B, Lq, dim, generator=g, device=device), dim=-1)
    return dict(Q=Q, offs=offs, dls=dls, codes=codes, residuals=res.view(torch.int32),
                centroids=cent, bucket_weights=bw), dict(nbits=nbits, max_doclen=Ld)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_stage2: torch.cuda.is_available() is False; needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    from colbert_torch.ops import fused_maxsim as fm
    from colbert_torch.utils.build import BUILD_DIR

    out_dir = os.path.join(BUILD_DIR, "tune")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SHAPES)) as ex:
        built = list(ex.map(lambda s: build(s, out_dir), SHAPES))
    fm.build_kernel()
    done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[tune] {done.stdout.strip()}; {len(SHAPES)} builds in "
          f"{time.perf_counter() - t0:.1f}s")

    args, kw = serving_like_inputs(torch.device("cuda"))
    want = fm.stage2_maxsim_plain(**args, **kw)
    simt = lambda: fm._launch("simt", **args, **kw)  # noqa: E731
    print(f"[tune] B=32 NC=1024 Lq=32 dim=128 nbits=2 tokens={int(args['dls'].sum())}: "
          f"simt_ms={time_ms(simt):.4f}")
    ok_all = True
    for shape, (so, info) in zip(SHAPES, built):
        lib = fm.load_library(so)
        run = lambda: fm._launch("mma", **args, **kw, lib=lib)  # noqa: E731
        err = float((run() - want).abs().max())
        ok = bool(np.isfinite(err) and err <= TOL)
        ok_all &= ok
        t1, t2 = time_ms(run), time_ms(run)
        print("[tune] warps={} blocks_per_sm={} minb={} prefetch={}: ".format(*shape)
              + f"kernel_ms={t1:.4f},{t2:.4f} max_abs_err={err:.3e} within {TOL}: {ok} | {info}")
    print(f"[tune] simt_ms={time_ms(simt):.4f} (again)")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
