"""The refine's module, ``colbert_torch.ops.approx_maxsim``, on the CPU.

Its plain version (the ``embedding_bag`` chunk passes, the route of CPU
tensors) against the JAX package's ``_approx_maxsim`` query by query on the
same index arrays, to 1e-4: Lq 1, 17, 32 and 40, max doclen 32 and 160,
chunk caps of one column, of seven and the default; every window holds
sentinel pids, zero-doclen passages and the last passage, which ends on the
last code row. The wrapper on CPU tensors returns the plain result, another
device raises, the inputs are checked, and the captured serving program
counts the wrapper's launches. The kernel itself runs on the card only
(``tests/test_torch_cuda.py``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.retrieval import device_index as jdi
from colbert_torch.ops import approx_maxsim as am
from colbert_torch.retrieval import device_index as tdi
from colbert_torch.retrieval import program as tprog

TOL = 1e-4
B, W = 3, 40


@functools.lru_cache(maxsize=None)
def _indexes(max_doclen: int):
    """Both packages' device indexes over one small index made from a seed:
    random unit centroids and codes, doclens in [1, max_doclen] with two
    zero-doclen passages, and the last passage at the full doclen (its
    tokens end on the last code row)."""
    rng = np.random.default_rng(max_doclen)
    P, K, nbits = 50, 48, 2
    doclens = rng.integers(1, max_doclen + 1, P)
    doclens[[3, 17]] = 0
    doclens[P - 1] = max_doclen
    codes = rng.integers(0, K, int(doclens.sum())).astype(np.uint32)
    cent = rng.standard_normal((K, 128)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    pid_of = np.repeat(np.arange(P), doclens)
    cells = [np.unique(pid_of[codes == c]) for c in range(K)]
    kw = dict(centroids=cent, codes=codes,
              residuals=np.zeros((len(codes), 128 * nbits // 8), np.uint8),
              ivf=np.concatenate(cells).astype(np.int32),
              ivf_lengths=np.array([len(c) for c in cells], np.int64),
              doclens=doclens, bucket_weights=np.linspace(-0.1, 0.1, 1 << nbits,
                                                          dtype=np.float32),
              nbits=nbits)
    return jdi.DeviceIndex.build(**kw), tdi.DeviceIndex.build(device="cpu", **kw), P


def _inputs(t, P: int, Lq: int, seed: int):
    """Queries (B, Lq, 128) and a (B, W) candidate window: sentinels at
    columns 0 and 5, the zero-doclen pids 3 and 17 at 2 and 9, the last
    passage at 11."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((B, Lq, 128)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    pids = rng.integers(0, P + 1, (B, W))
    pids[:, [0, 5]] = P
    pids[:, [2, 9]] = [3, 17]
    pids[:, 11] = P - 1
    p = torch.from_numpy(pids)
    return torch.from_numpy(Q), pids, (t.emb_offsets[p].contiguous(), t.doclens[p].contiguous())


@pytest.mark.parametrize("columns", [1, 7, None])
@pytest.mark.parametrize("max_doclen", [32, 160])
@pytest.mark.parametrize("Lq", [1, 17, 32, 40])
def test_plain_matches_jax(Lq, max_doclen, columns):
    """The plain version against JAX's ``_approx_maxsim`` query by query at
    1e-4; zero doclens and sentinels score 0, every other candidate not."""
    j, t, P = _indexes(max_doclen)
    assert t.max_doclen == max_doclen
    Q, pids, (offs, dls) = _inputs(t, P, Lq, seed=Lq + max_doclen)
    cap = {} if columns is None else {
        "chunk_bytes": columns * am.refine_column_bytes(B, max_doclen, Lq)}
    got = am.approx_maxsim_plain(Q, offs, dls, t.codes, t.centroids, max_doclen=max_doclen,
                                 **cap).numpy()
    for b in range(B):
        want = jdi._approx_maxsim(
            jnp.asarray(Q[b].numpy()), j.centroids, j.codes, j.emb_offsets[pids[b]],
            j.doclens[pids[b]], max_doclen=j.max_doclen)
        np.testing.assert_allclose(got[b], np.asarray(want), atol=TOL, rtol=0)
    assert (got[:, [0, 5, 2, 9]] == 0).all()
    assert (got[:, 11] != 0).all()


@pytest.mark.parametrize("Lq,max_doclen", [(32, 160), (17, 32)])
def test_wrapper_on_cpu_tensors_is_the_plain_version(Lq, max_doclen):
    """On CPU tensors the wrapper and ``device_index._approx_maxsim`` return
    the plain version's result, and no kernel launch is counted."""
    _, t, P = _indexes(max_doclen)
    Q, pids, (offs, dls) = _inputs(t, P, Lq, seed=3)
    before = am.approx_maxsim.launches
    want = am.approx_maxsim_plain(Q, offs, dls, t.codes, t.centroids, max_doclen=max_doclen)
    got = am.approx_maxsim(Q, offs, dls, t.codes, t.centroids, max_doclen=max_doclen)
    via_index = tdi._approx_maxsim(t, Q, torch.from_numpy(pids))
    assert torch.equal(got, want) and torch.equal(via_index, want)
    assert am.approx_maxsim.launches == before


def test_another_device_raises():
    """A ``meta`` tensor is neither the kernel's nor the plain version's."""
    Q = torch.empty((2, 32, 128), device="meta")
    offs = torch.empty((2, 8), dtype=torch.int64, device="meta")
    dls = torch.empty((2, 8), dtype=torch.int32, device="meta")
    codes = torch.empty(100, dtype=torch.int32, device="meta")
    cent = torch.empty((16, 128), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        am.approx_maxsim(Q, offs, dls, codes, cent, max_doclen=8)


@pytest.mark.parametrize("bad", ["device", "dtype", "shape", "contiguous"])
def test_inputs_are_checked(bad):
    """Mixed devices, wrong dtypes, mismatched shapes and strided inputs
    raise before anything runs."""
    _, t, P = _indexes(32)
    Q, _, (offs, dls) = _inputs(t, P, 32, seed=4)
    args = dict(Q=Q, offs=offs, dls=dls, codes=t.codes, centroids=t.centroids)
    if bad == "device":
        args["codes"] = args["codes"].to("meta")
        err = ValueError
    elif bad == "dtype":
        args["dls"] = args["dls"].to(torch.int64)
        err = TypeError
    elif bad == "shape":
        args["dls"] = args["dls"][:, :-1].contiguous()
        err = ValueError
    else:
        args["offs"] = torch.cat([offs, offs], dim=1)[:, ::2]
        err = ValueError
    with pytest.raises(err):
        am.approx_maxsim(**args, max_doclen=32)


def test_device_index_keeps_the_chunk_names():
    """``device_index`` re-exports the plain version's chunk cap and column
    size (read by the smoke run and the tests)."""
    assert tdi.REFINE_CHUNK_BYTES == am.REFINE_CHUNK_BYTES == 256 << 20
    assert tdi.refine_column_bytes is am.refine_column_bytes
    assert am.refine_column_bytes(32, 160, 32) == 32 * (16 * 160 + 12 * 32)


def test_serving_programs_count_the_refine():
    """The captured program's launch bookkeeping covers the refine wrapper:
    a capture's refine launches are taken out and added back per replay."""
    assert am.approx_maxsim in tprog._counted_wrappers()
    counts = tprog._launch_counts()
    assert {"table": am.approx_maxsim.variant_launches["table"]} in counts
    before = am.approx_maxsim.launches
    delta = [{v: 0 for v in c} for c in counts]
    delta[tprog._counted_wrappers().index(am.approx_maxsim)]["table"] = 2
    tprog._add_launches(delta)
    try:
        assert am.approx_maxsim.launches == before + 2
    finally:
        tprog._add_launches(delta, sign=-1)
    assert am.approx_maxsim.launches == before
