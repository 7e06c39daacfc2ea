#!/usr/bin/env python3
"""Times block shapes of the tensor-core flash-attention kernel on one GPU.

    python3 tune_flash.py

Rebuilds ``colbert_torch/csrc/flash_attention.cu`` once per shape with
``-DFLASH_MMA_HD=<hd> -DFLASH_MMA_WARPS=<w> -DFLASH_MMA_SLICES=<n>
-DFLASH_MMA_MINB=<b>`` (warps per block, 16-row q slices per warp, blocks
per SM the registers are budgeted for; the other head dims keep their
defaults), all nvcc runs started together, into ``colbert_torch/build/tune/``.
For each shape it prints ptxas's registers and spills of the bf16
instantiation, checks the output against the plain version (within
8e-3 * max(1, |plain|)) and times it with CUDA events, twice, at
B*H = 1536 heads of S=512 (B=128, H=12 at hd 64 and 128; B=256 at hd 32)
in bf16 with a random pad mask, beside ``scaled_dot_product_attention``
with the same mask. The defaults of ``MmaShape`` in the source are the
fastest shapes it found.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
# (hd, warps, slices, min blocks); the first of each hd is the default
SHAPES = [(64, 4, 2, 1), (64, 4, 2, 2), (64, 4, 1, 1), (64, 4, 1, 4), (64, 8, 1, 1),
          (64, 8, 1, 2), (64, 2, 2, 1), (128, 4, 1, 1), (128, 8, 1, 1), (128, 4, 1, 2),
          (32, 4, 2, 1), (32, 4, 1, 1), (32, 8, 1, 1)]


def build(shape, out_dir):
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.utils.build import NVCC_FLAGS, _nvcc

    hd, warps, slices, minb = shape
    so = os.path.join(out_dir, "libflash_{}_{}_{}_{}.so".format(*shape))
    done = subprocess.run(
        [_nvcc()] + NVCC_FLAGS + [f"-DFLASH_MMA_HD={hd}", f"-DFLASH_MMA_WARPS={warps}",
                                  f"-DFLASH_MMA_SLICES={slices}", f"-DFLASH_MMA_MINB={minb}",
                                  "-o", so, fa.KERNEL_SOURCE],
        capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"building {shape} failed:\n{done.stderr}")
    lines = (done.stdout + done.stderr).splitlines()
    tag = f"flash_mma_kernelI13__nv_bfloat16Li{hd}E"
    info = next((lines[i + 1].strip() + "; " + lines[i + 2].strip().replace("ptxas info    : ", "")
                 for i, line in enumerate(lines)
                 if "Function properties" in line and tag in line), "")
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


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("tune_flash: torch.cuda.is_available() is False; needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from colbert_torch.ops import flash_attention as fa
    from colbert_torch.utils.build import BUILD_DIR

    out_dir = os.path.join(BUILD_DIR, "tune")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SHAPES)) as ex:
        built = list(ex.map(lambda s: build(s, out_dir), SHAPES))
    done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[tune] {done.stdout.strip()}; {len(SHAPES)} builds in "
          f"{time.perf_counter() - t0:.1f}s")

    g = torch.Generator(device="cuda").manual_seed(0)
    H, S = 12, 512
    cases = {}
    for hd in sorted({s[0] for s in SHAPES}):
        B = 128 * 64 // hd if hd < 64 else 128
        q, k, v = (torch.randn(B * H, S, hd, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(3))
        lens = torch.randint(100, S + 1, (B,), device="cuda", generator=g)
        bias = torch.where(torch.arange(S, device="cuda")[None] < lens[:, None], 0.0,
                           torch.finfo(torch.float32).min).float()
        n = 8 * H  # the plain version on the first 8 batch rows
        want = fa.flash_attention_plain(q[:n].float(), k[:n].float(), v[:n].float(), bias[:8],
                                        num_heads=H)
        qs, ks, vs = (x.view(B, H, S, hd) for x in (q, k, v))
        mask4 = bias.view(B, 1, 1, S).to(torch.bfloat16)
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask4))
        cases[hd] = (B, q, k, v, bias, want, n)
        print(f"[tune] hd={hd} B={B} H={H} S={S} bf16: sdpa_ms={sdpa:.4f}")

    ok_all = True
    for (hd, warps, slices, minb), (so, info) in zip(SHAPES, built):
        fn = ctypes.CDLL(so).colbert_flash_attention_mma
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
                       + [ctypes.c_int] + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
        B, q, k, v, bias, want, n = cases[hd]
        out = torch.empty_like(q)
        strides = (H * S * hd, S * hd, hd)

        def run():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                    1, B, H, S, hd, 1.0 / math.sqrt(hd), -1, *strides, *strides,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed (code {rc})")

        run()
        torch.cuda.synchronize()
        err = (out[:n].float() - want).abs()
        ok = bool((err <= 8e-3 * want.abs().clamp(min=1.0)).all())
        ok_all &= ok
        t1, t2 = time_ms(run), time_ms(run)
        print(f"[tune] hd={hd} warps={warps} slices={slices} minb={minb} "
              f"q_tile={16 * warps * slices}: kernel_ms={t1:.4f},{t2:.4f} "
              f"max_abs_err={float(err.max()):.3e} within tolerance: {ok} | {info}")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
