"""Stage-2 fused decompress+MaxSim: the port's plain version vs the JAX
package's Pallas kernel (interpret mode, masked and summed as its caller
does) and vs ``_stage2_scores(use_pallas=False)``, tolerance 1e-4. The
CUDA kernel is held against the plain version with the same cases in
``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.ops.fused_maxsim import stage2_maxsim_pallas
from colbert_tpu.retrieval.device_index import _stage2_scores
from colbert_torch.ops import fused_maxsim as fm

from _torch_stage2_cases import CASES, port_args as _port_args, stage2_case as _inputs

TOL = 1e-4


def _jax_pallas(x):
    """The TPU kernel in interpret mode, per query, Q padded to Lq % 8 == 0
    with zero rows and the result masked and summed as in _stage2_scores."""
    Ld, nbits = x["Ld"], x["nbits"]
    dim = x["cent"].shape[1]
    nwords = dim // 8 * nbits // x["words"].dtype.itemsize
    words = x["words"].reshape(-1, nwords)
    ar = np.arange(Ld)
    out = []
    for b in range(x["Q"].shape[0]):
        tok = x["offs"][b][:, None] + ar                     # (NC, Ld)
        Lq = x["Q"].shape[1]
        Lq_pad = -(-Lq // 8) * 8
        Qp = np.zeros((Lq_pad, dim), np.float32)
        Qp[:Lq] = x["Q"][b]
        NC = tok.shape[0]
        per_q = np.asarray(stage2_maxsim_pallas(
            jnp.asarray(Qp), jnp.asarray(x["cent"][x["codes"][tok].astype(np.int64)]),
            jnp.asarray(words[tok]), jnp.asarray(ar[None, :] < x["dls"][b][:, None]),
            jnp.asarray(x["bw"]), nbits=nbits, bc=NC,
            ldb=8 if Ld % 8 == 0 else Ld, interpret=True,
        ))[:Lq]
        per_q = np.where((x["dls"][b] > 0)[None, :], per_q, 0.0)
        out.append(per_q.sum(axis=0))
    return np.stack(out)


def _jax_xla(x):
    out = []
    for b in range(x["Q"].shape[0]):
        out.append(np.asarray(_stage2_scores(
            jnp.asarray(x["Q"][b]), jnp.asarray(x["codes"]), jnp.asarray(x["words"]),
            jnp.asarray(x["cent"]), jnp.asarray(x["bw"]),
            jnp.asarray(x["offs"][b].astype(np.int32)), jnp.asarray(x["dls"][b]),
            max_doclen=x["Ld"], nbits=x["nbits"], chunk=16, use_pallas=False,
        )))
    return np.stack(out)


@pytest.mark.parametrize("nbits,word,Lq,Ld,zeros", CASES)
def test_plain_matches_pallas_and_xla(nbits, word, Lq, Ld, zeros):
    x = _inputs(nbits * 7 + Lq, nbits, word, Lq, Ld, zeros)
    args, kw = _port_args(x)
    got = fm.stage2_maxsim(*args, **kw).numpy()   # CPU tensors: plain version
    np.testing.assert_allclose(got, _jax_pallas(x), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, _jax_xla(x), atol=TOL, rtol=0)
    assert (got[x["dls"] == 0] == 0).all()


def test_wrapper_checks_inputs():
    x = _inputs(0, 2, "uint32", 8, 16, False)
    args, kw = _port_args(x)
    with pytest.raises(TypeError):
        fm.stage2_maxsim(args[0], args[1].to(torch.int32), *args[2:], **kw)
    with pytest.raises(ValueError):
        fm.stage2_maxsim(args[0], args[1], args[2], args[3], args[4][:-1], *args[5:], **kw)
    with pytest.raises(ValueError):
        fm.stage2_maxsim(args[0].transpose(1, 2), *args[1:], **kw)


def test_cpu_tensors_never_count_as_launches():
    x = _inputs(1, 2, "uint32", 8, 16, False)
    args, kw = _port_args(x)
    before = fm.stage2_maxsim.launches
    by_variant = dict(fm.stage2_maxsim.variant_launches)
    fm.stage2_maxsim(*args, **kw)
    assert fm.stage2_maxsim.launches == before
    assert fm.stage2_maxsim.variant_launches == by_variant


@pytest.mark.parametrize("Lq,dim,variant", [
    (32, 128, "mma"),     # the serving path
    (1, 128, "mma"),
    (8, 128, "mma"),
    (13, 128, "mma"),
    (31, 128, "mma"),
    (33, 128, "simt"),    # past four n8 tiles of query tokens
    (45, 128, "simt"),
    (0, 128, "simt"),
    (32, 64, "simt"),     # only dim 128 has the mma kernel
    (32, 32, "simt"),
    (32, 256, "simt"),
    (8, 96, "simt"),
])
def test_variant_routes_by_shape(Lq, dim, variant):
    assert fm._variant(Lq, dim) == variant
