"""The doc side of the port's encoder vs the JAX package's, with the JAX
weights carried over, at fp32 activations and an fp32 transfer: the host
compaction helpers identical, ``encode_passages`` to 1e-5 with identical
doclens, and the compressed outputs (fused encode+compress, and the
device-resident sample compressed afterwards) with codes identical except
on rows whose two best centroid scores lie within 1e-5 (where fp32 rounding
of the forward may pick either) and residual bytes identical wherever the
codes agree.

The doc programs (run eagerly on their static buffers on the CPU): each of
the three doc encodes through them is the op-by-op route bit for bit, on a
collection of full batches, one that mixes full and partial batches, and
one with full batches over the token limit; the counters add up
(``doc_replays + doc_eager_batches == doc_batches``); a codebook of
another size reuses the programs; a re-bound parameter gives new keys; a
mesh-attached encoder makes none, and its three encodes give the
single-device encoder's results."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.config import ColBERTConfig as JConfig
from colbert_tpu.models import encoder as jenc_mod
from colbert_tpu.utils.testing import make_encoder, synthetic_collection
from colbert_torch.models import encoder as tenc_mod
from colbert_torch.utils import tracing

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


# --- the doc programs -------------------------------------------------------

ENCODES = {
    "encode_passages": lambda enc, p, cent, cut: enc.encode_passages(p),
    "encode_passages_compressed": lambda enc, p, cent, cut: enc.encode_passages_compressed(
        p, torch.from_numpy(cent), torch.from_numpy(cut), nbits=2),
    "encode_passages_to_device": lambda enc, p, cent, cut: enc.encode_passages_to_device(
        p, return_layout=True),
}


def _fresh(tenc, model=None):
    """An encoder over ``tenc``'s model (or ``model``), with no programs."""
    return tenc_mod.ColBERTEncoder(model or tenc.model, tenc.tokenizer, tenc.config,
                                   device="cpu")


def _leaves(out) -> list:
    """Every array of an encode's result (tensors as numpy, the sample's
    layout flattened) in order."""
    if isinstance(out, torch.Tensor):
        return [out.view(torch.int16).numpy() if out.dtype == torch.bfloat16 else out.numpy()]
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [np.asarray(out)]


def _assert_bitwise(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _counted(fn):
    with tracing.recording() as rec:
        out = fn()
    return out, dict(rec.counters)


@pytest.mark.parametrize("collection", ["full", "mixed", "over_limit"])
@pytest.mark.parametrize("encode", list(ENCODES))
def test_doc_programs_are_the_eager_route_bit_for_bit(encoders, codec, monkeypatch,
                                                      encode, collection):
    """Through the programs, then with every batch op by op
    (``MAX_GRAPH_TOKENS`` 0): the same bytes. ``full``: 40 passages in full
    batches of 8; ``mixed``: 37, each group of 16 ending in a partial
    batch; ``over_limit``: the limit at 8 x 32 tokens, so the full batches
    padded past 32 run op by op."""
    _, tenc, passages = encoders
    _, cent, cutoffs = codec
    enc = _fresh(tenc)
    bsize = enc.config.index_bsize
    if collection == "mixed":
        passages = passages[:37]
    if collection == "over_limit":
        monkeypatch.setattr(tenc_mod, "MAX_GRAPH_TOKENS", bsize * 32)
    batches = [ids.shape for _, ids, _, _ in enc._doc_batches(passages)]
    graphed = [b == bsize and b * L <= tenc_mod.MAX_GRAPH_TOKENS for b, L in batches]
    run = ENCODES[encode]
    got, c = _counted(lambda: run(enc, passages, cent, cutoffs))
    assert c["doc_batches"] == len(batches)
    assert c.get("doc_replays", 0) + c["doc_eager_batches"] == len(batches)
    assert c.get("doc_replays", 0) + c["doc_captures"] == sum(graphed) > 0
    assert c["doc_eager_batches"] - c["doc_captures"] == len(batches) - sum(graphed)
    assert c["doc_captures"] == len(enc.programs) == enc.programs.built
    if collection == "full":
        assert all(graphed)
    else:
        assert not all(graphed)
    monkeypatch.setattr(tenc_mod, "MAX_GRAPH_TOKENS", 0)
    want, c = _counted(lambda: run(enc, passages, cent, cutoffs))
    assert c["doc_eager_batches"] == len(batches) and "doc_replays" not in c
    _assert_bitwise(got, want)


def test_a_codebook_of_another_size_reuses_the_programs(encoders, codec):
    """The codec runs after the replay: a second compressed encode against
    24 of the centroids replays the first one's programs, captures none,
    and compresses against its own codebook."""
    _, tenc, passages = encoders
    _, cent, cutoffs = codec
    enc = _fresh(tenc)
    _, first = _counted(lambda: ENCODES["encode_passages_compressed"](
        enc, passages, cent, cutoffs))
    built = enc.programs.built
    assert first["doc_captures"] == built > 0
    (codes, _, _), second = _counted(lambda: ENCODES["encode_passages_compressed"](
        enc, passages, cent[:24], cutoffs))
    assert "doc_captures" not in second and enc.programs.built == built
    assert second["doc_replays"] == second["doc_batches"]
    assert int(codes.max()) < 24


def test_a_rebound_parameter_gives_new_keys(encoders):
    """A parameter replaced by a new tensor (a reload) gives every key
    anew; the results are the same bytes; in place, the keys stay."""
    _, tenc, passages = encoders
    model = copy.deepcopy(tenc.model)
    enc = _fresh(tenc, model)
    want, c = _counted(lambda: enc.encode_passages(passages))
    keys = enc.programs.built
    assert c["doc_captures"] == keys > 0
    with torch.no_grad():
        model.linear.weight.mul_(1.0)
    _, c = _counted(lambda: enc.encode_passages(passages))
    assert "doc_captures" not in c and enc.programs.built == keys
    model.linear.weight = torch.nn.Parameter(model.linear.weight.detach().clone())
    got, c = _counted(lambda: enc.encode_passages(passages))
    assert c["doc_captures"] == keys and enc.programs.built == 2 * keys
    _assert_bitwise(got, want)


def test_a_mesh_attached_encoder_makes_no_program(encoders):
    """Under a mesh every doc batch runs op by op, through the shards."""
    from colbert_torch.parallel.mesh import make_mesh

    _, tenc, passages = encoders
    enc = _fresh(tenc)
    enc.attach_mesh(make_mesh(2, 1, device="cpu"))
    for encode in ("encode_passages", "encode_passages_to_device"):
        _, c = _counted(lambda: ENCODES[encode](enc, passages, None, None))
        assert c["doc_eager_batches"] == c["doc_batches"] > 0
        assert "doc_replays" not in c and "doc_captures" not in c
    assert len(enc.programs) == 0 and enc.programs.built == 0


def _real_blocks(buf, valid, layout):
    """A sample's blocks without a mesh's pad rows -> [(idx, keep, L,
    real rows as fp32 numpy, their valid flags)]."""
    out = []
    for idx, keep, offset, B, L in layout:
        assert B == -(-len(idx) // 2) * 2 or B == len(idx)
        rows = slice(offset, offset + len(idx) * L)
        out.append((idx, keep, L, buf[rows].float().numpy(), valid[rows]))
    assert not buf.float().numpy()[~valid].any()
    return out


@pytest.mark.parametrize("collection", ["full", "mixed"])
@pytest.mark.parametrize("encode", list(ENCODES))
def test_a_mesh_encode_is_the_single_device_encode(encoders, codec, encode, collection):
    """A 2-shard CPU mesh against one device, through each doc encode:
    embeddings within the 1e-5 of ``test_dp_encode_matches_single_and_jax``;
    codes, residuals, doclens and the sample's layout equal. ``mixed``
    (37 passages) ends in a 5-row batch, which the mesh pads to 6: the
    sample keeps that pad row (invalid, zero), the host outputs drop it."""
    from colbert_torch.parallel.mesh import make_mesh

    _, tenc, passages = encoders
    _, cent, cutoffs = codec
    if collection == "mixed":
        passages = passages[:37]
    meshed = _fresh(tenc)
    meshed.attach_mesh(make_mesh(2, 1, device="cpu"))
    run = ENCODES[encode]
    got = run(meshed, passages, cent, cutoffs)
    want = run(_fresh(tenc), passages, cent, cutoffs)
    if encode == "encode_passages":
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].shape == want[0].shape
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    elif encode == "encode_passages_compressed":
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got[2], want[2])
        if collection == "full":
            assert [(o, B, L) for *_, o, B, L in got[3]] == [(o, B, L) for *_, o, B, L in want[3]]
        gblocks, wblocks = _real_blocks(got[0], got[1], got[3]), _real_blocks(*want[:2], want[3])
        assert len(gblocks) == len(wblocks)
        for (gi, gk, gl, grows, gv), (wi, wk, wl, wrows, wv) in zip(gblocks, wblocks):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gk, wk)
            np.testing.assert_array_equal(gv, wv)
            assert gl == wl
            np.testing.assert_allclose(grows, wrows, rtol=1e-5, atol=1e-5)
