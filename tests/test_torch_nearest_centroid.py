"""The nearest-centroid kernel's Python half on the CPU: the bf16 split of
fp32 operands (each reconstructs to 2^-22 relative or better), the rows'
operand the dtype picks, and the centroid stream read back the way the
kernel's ldmatrix addresses read it (its scores within 2^-21 of the
exact fp32-class scores, its argmax the plain version's on separated
clusters); the plain route of ``assign_clusters`` and ``lloyd_stats``
exactly the fp32 ``addmm`` + ``argmax`` over row chunks it always was; and
the wrappers' refusals (no CPU fallback inside the kernel's wrapper, no
device but cuda and cpu in k-means). The kernel itself runs only on a
card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from colbert_torch.ops import kmeans as km
from colbert_torch.ops import nearest_centroid as nc
from colbert_torch.utils import tracing


def _clustered(rng, n, k, dim):
    centers = rng.standard_normal((k, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows = centers[rng.integers(0, k, n)] + 0.05 * rng.standard_normal((n, dim))
    return torch.from_numpy(rows.astype(np.float32)), torch.from_numpy(centers)


def _read_stream(stream: torch.Tensor) -> np.ndarray:
    """(TERMS, tiles * TILE, slabs * 16) float64 from the stream, each
    centroid's half h of a slab taken where the kernel reads it: at half
    ``h ^ bit 2`` of the centroid's index in its tile."""
    tiles, slabs, terms, tile, _ = stream.shape
    halves = stream.double().numpy().reshape(tiles, slabs, terms, tile, 2, 8)
    n = np.arange(tile)
    swz = (n >> 2) & 1
    read = np.stack([halves[:, :, :, n, h ^ swz, :] for h in (0, 1)], axis=4)
    return read.reshape(tiles, slabs, terms, tile, 16).transpose(2, 0, 3, 1, 4).reshape(
        terms, tiles * tile, slabs * 16)


def _kernel_scores(data: torch.Tensor, centroids: torch.Tensor) -> np.ndarray:
    """The scores the kernel forms, in float64: the rows' operand times the
    summed centroid terms read from the stream, doubled, plus the bias."""
    rows, row_terms = nc.row_operand(data)
    stream, bias = nc.centroid_stream(centroids, row_terms)
    B = _read_stream(stream).sum(axis=0)
    return 2.0 * rows.double().numpy() @ B.T + bias.double().numpy()


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 7.5e4, 1e30])
def test_split_reconstructs_fp32_to_2_pow_minus_22(rng, scale):
    """Away from fp32's subnormals, where the last terms lose their bits."""
    x = torch.from_numpy((rng.standard_normal((257, 96)) * scale).astype(np.float32))
    parts = nc.split_bf16(x)
    assert len(parts) == nc.TERMS and all(p.dtype == torch.bfloat16 for p in parts)
    back = sum(p.double() for p in parts)
    err = (back - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -22
    # each term is the bf16 rounding of the remainder: the first is bf16(x)
    assert torch.equal(parts[0], x.to(torch.bfloat16))


def test_the_rows_dtype_picks_the_split(rng):
    x = torch.from_numpy(rng.standard_normal((33, 48)).astype(np.float32))
    b = x.to(torch.bfloat16)
    rows, terms = nc.row_operand(b)
    assert terms == 1 and rows.data_ptr() == b.data_ptr()
    rows, terms = nc.row_operand(x)
    assert terms == nc.TERMS and rows.dtype == torch.bfloat16 and rows.shape == (33, 144)
    back = sum(rows[:, i * 48:(i + 1) * 48].double() for i in range(3))
    assert float(((back - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -22
    # fp16 rows are not exact in bf16: they take the three-term split
    assert nc.row_operand(x.half())[1] == nc.TERMS


@pytest.mark.parametrize("k", [1, 7, 64, 1000])
def test_stream_layout_pads_and_pairs_the_terms(rng, k):
    c = torch.from_numpy(rng.standard_normal((k, 32)).astype(np.float32))
    for row_terms in (1, 3):
        stream, bias = nc.centroid_stream(c, row_terms)
        tiles = -(-k // nc.TILE)
        assert stream.shape == (tiles, row_terms * 2, nc.TERMS, nc.TILE, 16)
        assert stream.dtype == torch.bfloat16 and stream.is_contiguous()
        assert bias.shape == (tiles * nc.TILE,)
        np.testing.assert_array_equal(bias[:k].numpy(), (-(c * c).sum(-1)).numpy())
        assert bool(torch.isneginf(bias[k:]).all())
        B = _read_stream(stream)                 # (TERMS, padded K, row_terms * 32)
        assert not B[:, k:].any()                # zero centroids on the padding
        parts = nc.split_bf16(c)
        for t in range(nc.TERMS):
            for i in range(row_terms):
                block = B[t, :k, i * 32:(i + 1) * 32]
                want = parts[t].double().numpy() if i + t < nc.TERMS else 0.0
                np.testing.assert_array_equal(block, np.broadcast_to(want, block.shape))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [32, 128])
def test_stream_scores_are_fp32_class(rng, dtype, dim):
    data, cent = _clustered(rng, 500, 150, dim)
    data = data.to(dtype)
    got = _kernel_scores(data, cent)[:, :150]
    x, c = data.double().numpy(), cent.double().numpy()
    exact = 2.0 * x @ c.T - (cent.float() * cent.float()).sum(-1).double().numpy()
    scale = 2.0 * np.linalg.norm(x, axis=1)[:, None] * np.linalg.norm(c, axis=1)[None, :]
    assert float((np.abs(got - exact) / scale).max()) <= 2.0 ** -21
    # separated clusters: the argmax of those scores is the plain version's
    np.testing.assert_array_equal(got.argmax(axis=1), km.assign_clusters(data, cent).numpy())


def _today_assign(data, centroids, bsize):
    """The plain route as it stood: fp32 ``addmm`` + ``argmax`` per chunk."""
    c = centroids.float()
    ct, b = c.t(), -(c * c).sum(dim=-1)
    bsize = km._adaptive_bsize(c.shape[0], bsize)
    return torch.cat([torch.argmax(torch.addmm(b, data[s:s + bsize].float(), ct, alpha=2.0),
                                   dim=-1) for s in range(0, data.shape[0], bsize)])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_rows_take_the_plain_route_exactly(rng, dtype):
    data = torch.from_numpy(rng.standard_normal((1500, 32)).astype(np.float32)).to(dtype)
    cent = torch.from_numpy(rng.standard_normal((40, 32)).astype(np.float32))
    w = torch.from_numpy((rng.random(1500) > 0.2).astype(np.float32))
    assign = _today_assign(data, cent, 256)
    with tracing.recording() as rec:
        assert torch.equal(km.assign_clusters(data, cent, bsize=256), assign)
        sums, counts = km.lloyd_stats(data, cent, k=40, bsize=256, weights=w)
    want_s = torch.zeros((40, 32)).index_add_(0, assign, data.float() * w[:, None])
    want_c = torch.zeros(40).index_add_(0, assign, w)
    assert torch.equal(counts, want_c)
    np.testing.assert_allclose(sums.numpy(), want_s.numpy(), rtol=0, atol=1e-5)
    assert "kmeans_assign_launches" not in rec.counters


def test_the_kernel_wrapper_refuses_what_it_cannot_run(rng):
    x = torch.zeros((8, 32))
    with pytest.raises(ValueError, match="cuda"):
        nc.nearest_centroid(x, x[:2])          # no plain fallback inside the wrapper
    with pytest.raises(ValueError, match="cuda or cpu"):
        km.assign_clusters(torch.zeros((8, 32), device="meta"), torch.zeros((2, 32)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        km.lloyd_stats(torch.zeros((8, 32), device="meta"), torch.zeros((2, 32)), k=2)
