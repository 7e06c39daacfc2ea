"""The doc side of the port's encoder vs the JAX package's, with the JAX
weights carried over, at fp32 activations and an fp32 transfer: the host
compaction helpers identical, ``encode_passages`` to 1e-5 with identical
doclens, and the compressed outputs (fused encode+compress, and the
device-resident sample compressed afterwards) with codes identical except
on rows whose two best centroid scores lie within 1e-5 (where fp32 rounding
of the forward may pick either) and residual bytes identical wherever the
codes agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.config import ColBERTConfig as JConfig
from colbert_tpu.models import encoder as jenc_mod
from colbert_tpu.utils.testing import make_encoder, synthetic_collection
from colbert_torch.models import encoder as tenc_mod

from _torch_parity import port_encoder

NEAR_TIE = 1e-5


@pytest.fixture(scope="module")
def encoders():
    cfg = JConfig(dim=32, doc_maxlen=64, query_maxlen=16, index_bsize=8,
                  length_bucket=16, passages_batch_size=16, nbits=2,
                  activation_dtype="float32", transfer_dtype="float32")
    jenc = make_encoder(dim=32, seed=0, config=cfg)
    passages = synthetic_collection(40, seed=3, words_per_doc=30)
    return jenc, port_encoder(jenc), passages


@pytest.fixture(scope="module")
def codec(encoders):
    """Centroids near the reference embeddings (perturbed, so no residual is
    exactly 0) and quantile cutoffs of the residuals: a codec both encoders
    compress against."""
    jenc, _, passages = encoders
    flat, _ = jenc.encode_passages(passages)
    noise = np.random.default_rng(5).standard_normal((48, flat.shape[1]))
    cent = flat[::9][:48] + 0.1 * noise
    cent = (cent / np.linalg.norm(cent, axis=1, keepdims=True)).astype(np.float32)
    codes = np.argmax(flat @ cent.T, axis=1)
    cutoffs = np.quantile(flat - cent[codes], [0.25, 0.5, 0.75]).astype(np.float32)
    return flat, cent, cutoffs


def test_host_helpers_identical(rng):
    keep = rng.random((5, 7)) < 0.6
    keep[2] = False
    take_j, v_j = jenc_mod._take_rows(keep)
    take_t, v_t = tenc_mod._take_rows(keep)
    assert v_j == v_t and take_t.dtype == take_j.dtype
    np.testing.assert_array_equal(take_t, take_j)
    idx = np.array([3, 0, 4, 1, 2])
    counts = keep.sum(axis=1).astype(np.int64)
    dest = np.concatenate([[0], np.cumsum(counts[np.argsort(idx)][:-1])])
    values = rng.standard_normal((5, 7, 3)).astype(np.float32)
    outs = [np.zeros((int(counts.sum()), 3), np.float64) for _ in range(4)]
    jenc_mod._scatter_compact(outs[0], dest, idx, keep, values)
    tenc_mod._scatter_compact(outs[1], dest, idx, keep, values)
    jenc_mod._scatter_compact_rows(outs[2], dest, idx, counts, values[keep])
    tenc_mod._scatter_compact_rows(outs[3], dest, idx, counts, values[keep])
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_encode_passages_matches(encoders):
    jenc, tenc, passages = encoders
    want, want_dl = jenc.encode_passages(passages)
    got, got_dl = tenc.encode_passages(passages)
    np.testing.assert_array_equal(got_dl, want_dl)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    empty, dl = tenc.encode_passages([])
    assert empty.shape == (0, 32) and dl.shape == (0,)


def _assert_codes_agree(got_codes, got_res, want_codes, want_res, flat, cent):
    assert got_codes.dtype == np.uint32 and got_res.dtype == np.uint8
    assert got_codes.shape == want_codes.shape and got_res.shape == want_res.shape
    differ = got_codes != want_codes
    top2 = np.sort(flat[differ] @ cent.T, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] < NEAR_TIE).all(), top2
    np.testing.assert_array_equal(got_res[~differ], want_res[~differ])


def test_encode_passages_compressed_matches(encoders, codec):
    jenc, tenc, passages = encoders
    flat, cent, cutoffs = codec
    wc, wr, wdl = jenc.encode_passages_compressed(
        passages, jnp.asarray(cent), jnp.asarray(cutoffs), nbits=2)
    gc, gr, gdl = tenc.encode_passages_compressed(
        passages, torch.from_numpy(cent), torch.from_numpy(cutoffs), nbits=2)
    np.testing.assert_array_equal(gdl, wdl)
    _assert_codes_agree(gc, gr, wc, wr, flat, cent)


def test_sample_to_device_then_compress_matches(encoders, codec):
    jenc, tenc, passages = encoders
    flat, cent, cutoffs = codec
    jbuf, jvalid, jdl, jlayout = jenc.encode_passages_to_device(passages, return_layout=True)
    tbuf, tvalid, tdl, tlayout = tenc.encode_passages_to_device(passages, return_layout=True)
    assert tbuf.dtype == torch.bfloat16 and tbuf.shape == jbuf.shape
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_array_equal(tdl, jdl)
    assert [(o, B, L) for _, _, o, B, L in tlayout] == [(o, B, L) for _, _, o, B, L in jlayout]
    # bf16 values: a one-ulp rounding flip of a near-boundary fp32 value is
    # the only difference
    np.testing.assert_allclose(tbuf.float().numpy(), np.asarray(jbuf, np.float32),
                               atol=2 ** -8, rtol=0)
    assert not tbuf.float().numpy()[~tvalid].any()  # padding rows are exact zeros
    wc, wr = jenc.compress_sample_to_host(jbuf, jlayout, jdl, jnp.asarray(cent),
                                          jnp.asarray(cutoffs), nbits=2)
    gc, gr = tenc.compress_sample_to_host(tbuf, tlayout, tdl, torch.from_numpy(cent),
                                          torch.from_numpy(cutoffs), nbits=2)
    _assert_codes_agree(gc, gr, wc, wr, flat, cent)


def test_flash_gate_stays_off_on_the_cpu(encoders):
    _, tenc, _ = encoders
    assert not tenc._flash_capable and not tenc._flash_for(512)
    assert tenc.length_bucket == tenc.config.length_bucket
    # and under a CPU mesh (the data-parallel encode) it stays off too
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.parallel.mesh import make_mesh

    meshed = ColBERTEncoder(tenc.model, tenc.tokenizer, tenc.config, device="cpu")
    meshed.attach_mesh(make_mesh(2, 1, device="cpu"))
    assert meshed.mesh.shape == {"data": 2, "model": 1}
    assert not meshed._flash_capable and not meshed._flash_for(512)
