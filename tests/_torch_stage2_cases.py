"""Stage-2 test cases shared by the CPU parity tests and the GPU kernel
tests. Imports no JAX, so the GPU tests run where JAX is not installed."""

import numpy as np
import torch

# (nbits, word, Lq, Ld, doclens): doclens False draws them in [1, Ld], True
# also zeroes every fifth, "full" sets every one to Ld, and "last" puts the
# last candidate on the last Ld rows of the arrays (no zeroed tail after it)
CASES = [
    (1, "uint8", 8, 16, False),
    (1, "uint32", 8, 16, True),
    (2, "uint8", 8, 16, True),
    (2, "uint32", 16, 24, False),
    (4, "uint8", 8, 16, False),
    (4, "uint32", 8, 16, True),
    (2, "uint32", 13, 21, True),   # Lq and Ld not multiples of 8
    (4, "uint8", 5, 11, True),
    # the edges of the tensor-core kernel's 16-row slices and 32 query columns
    (1, "uint32", 32, 16, False),  # one slice
    (2, "uint8", 32, 17, True),    # a second slice with one row
    (4, "uint32", 32, 32, False),  # two full slices
    (2, "uint32", 31, 48, True),   # three slices, one query column short
    (2, "uint32", 32, 160, "full"),  # the serving path's Lq and Ld, every doclen Ld
    (4, "uint8", 24, 17, "last"),
]


def stage2_case(seed, nbits, word, Lq, Ld, zeros, *, B=2, NC=24, K=40, dim=128,
                n_tokens=600):
    """Seeded numpy inputs of one stage-2 case: flat codes and residual
    words (uint8 bytes or LE uint32 words) with Ld tail rows (zeroed unless
    ``zeros == "last"``), and per-candidate offsets and doclens for B
    queries."""
    rng = np.random.default_rng(seed)
    nbytes = dim // 8 * nbits
    cent = rng.standard_normal((K, dim)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    bw = np.sort(rng.standard_normal(1 << nbits)).astype(np.float32) * 0.05
    rows = n_tokens + Ld if zeros == "last" else n_tokens
    codes = np.zeros(n_tokens + Ld, np.uint32)
    codes[:rows] = rng.integers(0, K, rows)
    res = np.zeros((n_tokens + Ld, nbytes), np.uint8)
    res[:rows] = rng.integers(0, 256, (rows, nbytes), dtype=np.uint8)
    offs = rng.integers(0, n_tokens, (B, NC)).astype(np.int64)
    dls = rng.integers(1, Ld + 1, (B, NC)).astype(np.int32)
    if zeros is True:
        dls[:, ::5] = 0
    elif zeros == "full":
        dls[:] = Ld
    elif zeros == "last":
        offs[-1, -1], dls[-1, -1] = n_tokens, Ld
    Q = rng.standard_normal((B, Lq, dim)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    flat = res.reshape(-1)
    words = flat if word == "uint8" else flat.view(np.uint32)
    return dict(Q=Q, offs=offs, dls=dls, codes=codes, words=words, cent=cent,
                bw=bw, nbits=nbits, Ld=Ld)


def port_args(x, device="cpu"):
    """A case as the port's stage-2 arguments on ``device``."""
    words = x["words"] if x["words"].dtype == np.uint8 else x["words"].view(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (t(x["Q"]), t(x["offs"]), t(x["dls"]), t(x["codes"].view(np.int32)),
            t(words), t(x["cent"]), t(x["bw"])), dict(nbits=x["nbits"], max_doclen=x["Ld"])
