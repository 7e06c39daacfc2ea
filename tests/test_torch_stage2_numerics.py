"""A numpy model of the arithmetic of the stage-2 tensor-core kernel
(``stage2_mma_kernel`` in ``colbert_torch/csrc/stage2_maxsim.cu``), held
against the port's plain version on the CPU: TF32 rounding (``cvt.rna``) by
rounding the float32 bits, the three products of 3xTF32 in the kernel's
order, and the norm applied after the dot. 3xTF32 comes within 1e-5 of the
plain version on a serving-like case; one TF32 product does not. The
kernel itself, its dim permutation and fragment layout included, is held
against the plain version on the card in ``test_torch_cuda.py``."""

import numpy as np
import pytest

from colbert_torch.ops import codec
from colbert_torch.ops import fused_maxsim as fm

from _torch_stage2_cases import port_args, stage2_case

DIM = 128
NCOLS = 32         # query columns: four n8 tiles


def tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, rounding to nearest
    with ties away from zero (add half of the dropped 13 bits, truncate)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def model_scores(x, products=3):
    """Scores with the kernel's arithmetic: e = cent + w[b] in fp32 (bucket
    indices decoded by the plain version), per k8 step of 8 dims
    fp32(acc + sum of 8 exact products) for each product in turn (lo*hi,
    hi*lo, hi*hi, or hi*hi alone), the row's fp32 sum of squares, then the
    row's scores times 1 / max(sqrt(ss), 1e-12) and the max over valid
    rows, summed over Lq."""
    args, kw = port_args(x)
    nbits, Ld = x["nbits"], x["Ld"]
    words = args[4].view(-1, DIM * nbits // codec.word_bits(args[4]))
    idx = codec.bucket_indices_packed(words, nbits).numpy()
    B, Lq, _ = x["Q"].shape
    out = np.zeros(x["offs"].shape, np.float32)
    for b in range(B):
        q = np.zeros((NCOLS, DIM), np.float32)
        q[:Lq] = x["Q"][b]
        for c in range(x["offs"].shape[1]):
            dl = min(int(x["dls"][b, c]), Ld)
            if dl <= 0:
                continue
            tok = x["offs"][b, c] + np.arange(dl)
            e = x["cent"][x["codes"][tok].astype(np.int64)] + x["bw"][idx[tok]]  # (dl, DIM) f32
            acc = np.zeros((dl, NCOLS), np.float32)
            for k0 in range(0, DIM, 8):
                a, bq = e[:, k0:k0 + 8], q[:, k0:k0 + 8].T
                ahi, bhi = tf32(a), tf32(bq)
                alo, blo = tf32(a - ahi), tf32(bq - bhi)
                terms = [(alo, bhi), (ahi, blo), (ahi, bhi)] if products == 3 else [(ahi, bhi)]
                for pa, pb in terms:
                    acc = (acc.astype(np.float64)
                           + pa.astype(np.float64) @ pb.astype(np.float64)).astype(np.float32)
            ss = np.zeros(dl, np.float32)
            for d in range(DIM):   # fmaf rounds once per dim
                v = e[:, d].astype(np.float64)
                ss = (ss + v * v).astype(np.float32)
            inv = np.float32(1) / np.maximum(np.sqrt(ss), np.float32(1e-12))
            per_q = (acc * inv[:, None]).max(axis=0)[:Lq]
            out[b, c] = per_q.sum(dtype=np.float32)
    return out


@pytest.mark.parametrize("word", ["uint32", "uint8"])
def test_3xtf32_model_matches_plain_where_one_tf32_product_does_not(word):
    # the serving path's geometry: Lq 32, dim 128, nbits 2, up to 160 tokens
    x = stage2_case(11, 2, word, 32, 160, False, B=2, NC=40, K=500, n_tokens=20_000)
    args, kw = port_args(x)
    want = fm.stage2_maxsim(*args, **kw).numpy()   # CPU tensors: the plain version
    err3 = np.abs(model_scores(x, products=3) - want).max()
    err1 = np.abs(model_scores(x, products=1) - want).max()
    assert err3 <= 1e-5, err3
    assert err1 > 1e-5, err1
