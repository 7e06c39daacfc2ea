"""Port codec (colbert_torch.ops.codec) vs the JAX codec on the same inputs:
unpack_bits bit-identical, decompress within 1e-6 (fp32 rounding of the
renormalization); on the compress side bucket_indices, binarize, pack_bits,
compress_into_codes (on inputs without near-ties) and compress
bit-identical, bucket cutoffs, weights and the mean residual within 1e-6
(quantile interpolation and mean in fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.ops import codec as jcodec
from colbert_torch.ops import codec as tcodec


def _words(packed_u8: np.ndarray, word: str):
    """(n, nbytes) uint8 rows -> (JAX array, port tensor) of the same words."""
    if word == "uint8":
        return jnp.asarray(packed_u8), torch.from_numpy(packed_u8.copy())
    as32 = np.ascontiguousarray(packed_u8).view(np.uint32)
    return jnp.asarray(as32), torch.from_numpy(as32.view(np.int32).copy())


@pytest.mark.parametrize("word", ["uint8", "uint32"])
@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
def test_unpack_bits_bit_identical(rng, nbits, word):
    dim = 64
    packed = rng.integers(0, 256, (37, dim // 8 * nbits), dtype=np.uint8)
    jw, tw = _words(packed, word)
    want = np.asarray(jcodec.unpack_bits(jw, nbits))
    got = tcodec.unpack_bits(tw, nbits).numpy()
    assert got.shape == want.shape == (37, dim, nbits)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("word", ["uint8", "uint32"])
@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
def test_decompress_matches(rng, nbits, word):
    k, dim, n = 50, 64, 300
    cent = rng.standard_normal((k, dim)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    bw = np.sort(rng.standard_normal(1 << nbits)).astype(np.float32) * 0.05
    codes = rng.integers(0, k, n).astype(np.uint32)
    packed = rng.integers(0, 256, (n, dim // 8 * nbits), dtype=np.uint8)
    jw, tw = _words(packed, word)
    want = np.asarray(jcodec.decompress(
        jnp.asarray(codes), jw, jnp.asarray(cent), jnp.asarray(bw), nbits=nbits))
    got = tcodec.decompress(
        torch.from_numpy(codes.view(np.int32)), tw, torch.from_numpy(cent),
        torch.from_numpy(bw), nbits=nbits).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the bucket decode itself is exact
    np.testing.assert_array_equal(
        tcodec.decompress_residuals(tw, torch.from_numpy(bw), nbits=nbits).numpy(),
        np.asarray(jcodec.decompress_residuals(jnp.asarray(packed), jnp.asarray(bw),
                                               nbits=nbits)),
    )


def test_rejects_other_word_types():
    with pytest.raises(TypeError):
        tcodec.unpack_bits(torch.zeros((2, 4), dtype=torch.int64), 2)


# -- compress side: bit-identical on the same inputs --


def _residual_case(rng, nbits, n=257, dim=64):
    res = (rng.standard_normal((n, dim)) * 0.05).astype(np.float32)
    cut = np.sort(rng.standard_normal((1 << nbits) - 1) * 0.05).astype(np.float32)
    m = min(len(cut), dim)
    res[0, :m] = cut[:m]  # values equal to a cutoff: the strict ">" matters
    return res, cut


@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
def test_bucket_binarize_pack_bit_identical(rng, nbits):
    res, cut = _residual_case(rng, nbits)
    want_idx = np.asarray(jcodec.bucket_indices(jnp.asarray(res), jnp.asarray(cut)))
    got_idx = tcodec.bucket_indices(torch.from_numpy(res), torch.from_numpy(cut))
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    want_bits = np.asarray(jcodec.binarize(jnp.asarray(want_idx), nbits))
    got_bits = tcodec.binarize(got_idx, nbits)
    np.testing.assert_array_equal(got_bits.numpy(), want_bits)
    want = np.asarray(jcodec.pack_bits(jnp.asarray(want_bits)))
    got = tcodec.pack_bits(got_bits)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # and back through the port's decompress-side unpack
    np.testing.assert_array_equal(tcodec.unpack_bits(got, nbits).numpy(), want_bits)


def test_compress_into_codes_identical(rng):
    k, dim, n = 300, 64, 1000
    cent = rng.standard_normal((k, dim)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    embs = rng.standard_normal((n, dim)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    scores = embs @ cent.T
    top2 = np.sort(scores, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-5  # no near-ties in this input
    want = np.asarray(jcodec.compress_into_codes(jnp.asarray(embs), jnp.asarray(cent),
                                                 bsize=128))
    got = tcodec.compress_into_codes(torch.from_numpy(embs), torch.from_numpy(cent),
                                     bsize=128)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_compress_round_trips(rng, nbits):
    """compress is bit-identical to the JAX package and decompresses through
    the port's decompress to within the codec's own quantization."""
    k, dim, n = 40, 64, 500
    cent = rng.standard_normal((k, dim)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    embs = cent[rng.integers(0, k, n)] + 0.05 * rng.standard_normal((n, dim))
    embs = (embs / np.linalg.norm(embs, axis=1, keepdims=True)).astype(np.float32)
    codes = np.argmax(embs @ cent.T, axis=1)
    cut, bw, _ = tcodec.bucket_cutoffs_and_weights(
        nbits, torch.from_numpy(embs - cent[codes]))
    jc, jr = jcodec.compress(jnp.asarray(embs), jnp.asarray(cent), jnp.asarray(cut.numpy()),
                             nbits=nbits, bsize=128)
    tc, tr = tcodec.compress(torch.from_numpy(embs), torch.from_numpy(cent), cut,
                             nbits=nbits, bsize=128)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    back = tcodec.decompress(tc, tr, torch.from_numpy(cent), bw, nbits=nbits).numpy()
    cos = (back * embs).sum(axis=1)
    assert cos.min() > 0.9, cos.min()


@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
def test_bucket_cutoffs_and_weights_match(rng, nbits):
    res = (rng.standard_normal((2000, 32)) * 0.04).astype(np.float32)
    jcut, jw, javg = jcodec.bucket_cutoffs_and_weights(nbits, jnp.asarray(res))
    tcut, tw, tavg = tcodec.bucket_cutoffs_and_weights(nbits, torch.from_numpy(res))
    assert tcut.shape == ((1 << nbits) - 1,) and tw.shape == (1 << nbits,)
    np.testing.assert_allclose(tcut.numpy(), np.asarray(jcut), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    assert abs(float(tavg) - float(javg)) <= 1e-6


def test_bucket_cutoffs_refuses_oversized_input():
    with pytest.raises(ValueError, match="limit"):
        tcodec.bucket_cutoffs_and_weights(2, torch.zeros((1 << 24) + 1))
