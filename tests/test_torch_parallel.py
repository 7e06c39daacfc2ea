"""The port's multi-device layer (``colbert_torch.parallel``, ``ops/quantile``)
against the JAX package's on the same mesh size: the JAX side on the
8-device virtual CPU mesh of tests/conftest.py, the port on a mesh of the
CPU repeated (``make_mesh(..., device="cpu")``), inputs from one numpy seed.

Tolerances: fp32 sums over shards in another order than XLA's reduce, so
sharded Lloyd centroids agree within 1e-5 (the JAX package's own test bound,
tests/test_parallel.py) and assignments exactly; histogram quantiles within
1e-6 (a sum of 0/1 weights is exact; the interpolation is the same fp32
arithmetic); encodes within 1e-5 in fp32 (the row-parallel partials add in
another order than one product); a bf16 tensor-parallel encode within a
per-token cosine of 0.999 of the one-device bf16 encode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.models.bert import BertConfig as JBertConfig
from colbert_tpu.ops import codec as jcodec
from colbert_tpu.ops.quantile import histogram_quantiles as j_hist_q
from colbert_tpu.ops.quantile import sharded_quantiles as j_sharded_q
from colbert_tpu.parallel import kmeans_dist as jkd
from colbert_tpu.parallel import search_dist as jsd
from colbert_tpu.parallel.index_step import make_index_train_step as j_index_step
from colbert_tpu.parallel.mesh import make_mesh as j_make_mesh
from colbert_tpu.parallel.tp import validate_tp as j_validate_tp
from colbert_tpu.retrieval import ranking as jranking
from colbert_tpu.utils.testing import make_encoder as j_make_encoder
from colbert_torch.models.bert import BertConfig
from colbert_torch.ops import kmeans as tkmeans
from colbert_torch.ops.quantile import histogram_quantiles, sharded_quantiles
from colbert_torch.parallel import kmeans_dist, search_dist
from colbert_torch.parallel.index_step import make_index_train_step
from colbert_torch.parallel.mesh import make_mesh
from colbert_torch.parallel.tp import colbert_param_specs, shard_params, validate_tp

from _torch_parity import one_torch_thread, port_encoder  # noqa: F401


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() >= 8, "conftest should provide 8 cpu devices"
    return j_make_mesh(8, 1)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(8, 1, device="cpu")


@pytest.fixture(scope="module")
def encoders():
    jenc = j_make_encoder(dim=16, seed=0, bert_config=JBertConfig.tiny())
    jenc.config.activation_dtype = "float32"
    tenc = port_encoder(jenc)
    return jenc, tenc


# -- the mesh -----------------------------------------------------------------------


def test_mesh_shapes_and_errors(monkeypatch):
    m = make_mesh(4, 2, device="cpu")
    assert m.shape == {"data": 4, "model": 2} == dict(j_make_mesh(4, 2).shape)
    assert all(d == torch.device("cpu") for d in m.devices.ravel())
    assert (m.process == 0).all() and m.owned_data_shards(0) == [0, 1, 2, 3]
    assert make_mesh(-1, device="cpu").shape == {"data": 1, "model": 1}
    assert make_mesh(-1, devices=["cpu"] * 6, n_model=2).shape == {"data": 3, "model": 2}
    assert m.model_devices(1) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs 8"):
        make_mesh(8, 1, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="no devices"):
        make_mesh(0, 1, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(2, 1)  # device="cuda" without a GPU
    # a CUDA mesh larger than the visible cards raises: no silent repeat
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices per process, have 1"):
        make_mesh(2, 1, device="cuda")
    repeated = make_mesh(2, 1, devices=["cuda:0", "cuda:0"])
    assert list(repeated.devices[:, 0]) == [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="needs 16 devices"):
        j_make_mesh(16, 1)  # as the reference does


# -- sharded k-means ----------------------------------------------------------------


def test_sharded_lloyd_step_matches_jax(rng, jmesh, tmesh):
    n, dim, k = 203, 16, 10  # not divisible by 8
    data = rng.standard_normal((n, dim)).astype(np.float32)
    cents = data[:k].copy()
    padded = -(-n // 8) * 8
    data_p = np.zeros((padded, dim), np.float32)
    data_p[:n] = data
    w = np.zeros(padded, np.float32)
    w[:n] = 1
    j_new, j_shift = jkd.lloyd_step_sharded(jnp.asarray(data_p), jnp.asarray(cents),
                                            jnp.asarray(w), jmesh, k=k, bsize=32)
    t_new, t_shift = kmeans_dist.lloyd_step_sharded(
        torch.from_numpy(data_p), torch.from_numpy(cents), torch.from_numpy(w), tmesh,
        k=k, bsize=32)
    np.testing.assert_allclose(t_new.numpy(), np.asarray(j_new), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_shift, float(j_shift), rtol=1e-4)
    one, one_shift = tkmeans.lloyd_step(torch.from_numpy(data), torch.from_numpy(cents),
                                        k=k, bsize=32)
    np.testing.assert_allclose(t_new.numpy(), one.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ndev", [4, 8])
def test_kmeans_sharded_matches_jax(rng, ndev):
    data = rng.standard_normal((500, 8)).astype(np.float32)
    init_idx = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), 500)[:16])
    jres = jkd.kmeans_sharded(data, 16, j_make_mesh(ndev, 1), niters=8, seed=0, bsize=64)
    tres = kmeans_dist.kmeans_sharded(data, 16, make_mesh(ndev, 1, device="cpu"), niters=8,
                                      bsize=64, init_idx=init_idx)
    np.testing.assert_allclose(tres.centroids.numpy(), np.asarray(jres.centroids),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tres.assignments.numpy(), np.asarray(jres.assignments))
    assert tres.iterations == 8 and tres.assignments.shape == (500,)
    # and the port's single-device fit from the same rows (1e-4, the card's bound too)
    one = tkmeans.kmeans(torch.from_numpy(data), 16, niters=8, bsize=64, init_idx=init_idx)
    np.testing.assert_allclose(tres.centroids.numpy(), one.centroids.numpy(), atol=1e-4)
    np.testing.assert_array_equal(tres.assignments.numpy(), one.assignments.numpy())


def test_kmeans_sharded_draws_rows_without_init_idx(rng, tmesh):
    data = rng.standard_normal((64, 4)).astype(np.float32)
    a = kmeans_dist.kmeans_sharded(data, 5, tmesh, niters=3, seed=7)
    b = tkmeans.kmeans(torch.from_numpy(data), 5, niters=3, seed=7)
    np.testing.assert_allclose(a.centroids.numpy(), b.centroids.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="k=65"):
        kmeans_dist.kmeans_sharded(data, 65, tmesh)


def test_assign_clusters_sharded_matches_jax(rng, jmesh, tmesh):
    data = rng.standard_normal((256, 16)).astype(np.float32)
    cents = rng.standard_normal((12, 16)).astype(np.float32)
    j = jkd.assign_clusters_sharded(jnp.asarray(data), jnp.asarray(cents), jmesh, bsize=64)
    t = kmeans_dist.assign_clusters_sharded(torch.from_numpy(data), torch.from_numpy(cents),
                                            tmesh, bsize=64)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# -- quantiles ----------------------------------------------------------------------


def test_histogram_quantiles_matches_jax(rng):
    hist = rng.integers(0, 5, size=300).astype(np.float32)
    hist[[0, 17, 299]] = 0
    qs = np.asarray([0.0, 0.01, 0.25, 0.5, 0.75, 0.99, 1.0], np.float32)
    lo, hi = np.float32(-0.7), np.float32(1.3)
    j = j_hist_q(jnp.asarray(hist), jnp.asarray(qs), jnp.float32(lo), jnp.float32(hi))
    t = histogram_quantiles(torch.from_numpy(hist), torch.from_numpy(qs),
                            torch.tensor(lo), torch.tensor(hi))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bins", [1 << 10, 1 << 16])
def test_sharded_quantiles_matches_jax(rng, jmesh, tmesh, bins):
    x = rng.standard_normal((4096, 16)).astype(np.float32)
    w = np.ones((4096,), np.float32)
    w[4000:] = 0.0  # padding rows count nowhere
    qs = np.asarray([0.25, 0.5, 0.75, 0.875], np.float32)
    jv, jm = j_sharded_q(x, qs, jmesh, weights=w, bins=bins)
    tv, tm = sharded_quantiles(torch.from_numpy(x), qs, tmesh, weights=torch.from_numpy(w),
                               bins=bins)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tm), float(jm), rtol=1e-6)
    want = np.quantile(x[:4000].reshape(-1), qs)
    np.testing.assert_allclose(tv.numpy(), want, atol=8.0 / bins)
    np.testing.assert_allclose(float(tm), np.abs(x[:4000]).mean(), rtol=1e-5)


# -- data- and tensor-parallel encode -----------------------------------------------


def _batch(rng, cfg, B, S):
    ids = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    mask[1, S - 3:] = False
    keep = mask.copy()
    keep[:, 0] = False
    return ids, mask, keep


def test_dp_encode_matches_single_and_jax(rng, encoders):
    from colbert_tpu.models.colbert import encode_batch as j_encode_batch

    jenc, tenc0 = encoders
    tenc = port_encoder(jenc)
    tenc.attach_mesh(make_mesh(8, 1, device="cpu"))
    cfg = jenc.bert_config
    ids, mask, keep = _batch(rng, cfg, 11, 12)  # 11 % 8 != 0
    with torch.no_grad():
        out = tenc._shard_forward(ids, mask, keep, dtype_name="float32")
        one = tenc0.model.encode_batch(*tenc0._put_batch(ids, mask, keep),
                                       dtype_name="float32")
    assert out.shape[0] == 16  # padded to the data axis
    np.testing.assert_allclose(out[:11].numpy(), one.numpy(), rtol=1e-5, atol=1e-5)
    jenc.attach_mesh(j_make_mesh(8, 1))
    try:
        ids_d, mask_d, keep_d = jenc._put_batch(ids, mask, keep)
        jout = np.asarray(j_encode_batch(jenc.params, ids_d, mask_d, keep_d, cfg=cfg,
                                         dtype_name="float32"))
    finally:
        jenc.mesh = None
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    # the query encode drops the pad rows
    Q = tenc.encode_query_tokens(ids[:5], mask[:5])
    assert Q.shape == (5, 12, 16)


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 4)])
def test_tp_encode_matches_single_and_jax(rng, encoders, n_data, n_model):
    from colbert_tpu.models.colbert import encode_batch as j_encode_batch
    from colbert_tpu.parallel.tp import shard_params as j_shard_params

    jenc, tenc0 = encoders
    cfg = jenc.bert_config  # 4 heads, intermediate 128
    ids, mask, keep = _batch(rng, cfg, 8, 12)
    mesh = make_mesh(n_data, n_model, device="cpu")
    tenc = port_encoder(jenc)
    tenc.attach_mesh(mesh)
    model = tenc._replicas[0]
    shard = model.bert.shards[1][0]  # model shard 1 of layer 0
    full = tenc.model.bert.layers[0]
    H, I = cfg.hidden_size, cfg.intermediate_size
    hs, ms = slice(H // n_model, 2 * H // n_model), slice(I // n_model, 2 * I // n_model)
    assert torch.equal(shard.q.weight, full.q.weight[hs])
    assert torch.equal(shard.mlp_in.bias, full.mlp_in.bias[ms])
    assert torch.equal(shard.attn_out_w, full.attn_out.weight[:, hs])
    assert torch.equal(shard.mlp_out_w, full.mlp_out.weight[:, ms])
    assert shard.num_heads == cfg.num_attention_heads // n_model
    specs = colbert_param_specs(tenc.model)
    assert specs["bert.layers.0.q.weight"] == "column"
    assert specs["bert.layers.0.mlp_out.weight"] == "row"
    assert specs["bert.layers.0.mlp_out.bias"] == "replicated"
    assert specs["bert.word.weight"] == specs["linear.weight"] == "replicated"
    with torch.no_grad():
        out = tenc._shard_forward(ids, mask, keep, dtype_name="float32")[:8]
        one = tenc0.model.encode_batch(*tenc0._put_batch(ids, mask, keep),
                                       dtype_name="float32")
    np.testing.assert_allclose(out.numpy(), one.numpy(), rtol=1e-5, atol=1e-5)
    jparams = j_shard_params(jenc.params, j_make_mesh(n_data, n_model), cfg)
    jout = np.asarray(j_encode_batch(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                     jnp.asarray(keep), cfg=cfg, dtype_name="float32"))
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        b16 = tenc._shard_forward(ids, mask, keep, dtype_name="bfloat16")[:8]
        one16 = tenc0.model.encode_batch(*tenc0._put_batch(ids, mask, keep),
                                         dtype_name="bfloat16")
    cos = (b16 * one16).sum(-1)[torch.from_numpy(keep)]
    assert float(cos.min()) >= 0.999


def test_validate_tp_errors():
    for n, kw in [(4, dict(num_attention_heads=6)), (2, dict(intermediate_size=129))]:
        cfg = BertConfig(**kw)
        with pytest.raises(ValueError, match="divisible"):
            validate_tp(cfg, n)
        with pytest.raises(ValueError, match="divisible"):
            j_validate_tp(JBertConfig(**kw), n)
    validate_tp(BertConfig(), 1)
    from colbert_torch.models.colbert import init_colbert

    model = init_colbert(BertConfig(vocab_size=64, hidden_size=24, num_hidden_layers=1,
                                    num_attention_heads=6, intermediate_size=48), 8,
                         generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="num_attention_heads"):
        shard_params(model, make_mesh(1, 4, device="cpu"))


# -- sharded scoring and the index step ---------------------------------------------


def test_score_full_sharded_topk_matches_jax(rng, jmesh, tmesh):
    nbits, dim, kcent = 2, 16, 12
    n = 64 * 8
    centroids = rng.standard_normal((kcent, dim)).astype(np.float32)
    codes = rng.integers(0, kcent, n).astype(np.uint32)
    packed = np.asarray(jcodec.pack_bits(jcodec.binarize(
        jnp.asarray(rng.integers(0, 4, (n, dim)), jnp.int32), nbits)))
    weights = np.sort(rng.standard_normal(4)).astype(np.float32)
    P_rows = 32
    doclens = np.full(P_rows, 16)
    doclens[::3] = 9  # ragged documents: masked tail tokens
    offsets = np.arange(P_rows) * 16
    idx, mask = jranking.gather_padded(np.arange(P_rows), doclens, offsets,
                                       len_bucket=16, pid_bucket=8)
    Q = rng.standard_normal((2, 4, dim)).astype(np.float32)
    js, jr = jsd.score_full_sharded_topk(
        jnp.asarray(Q), codes[idx], packed[idx], mask, jnp.asarray(centroids),
        jnp.asarray(weights), jmesh, nbits=nbits, k=5)
    ts, tr = search_dist.score_full_sharded_topk(
        torch.from_numpy(Q), codes[idx], packed[idx], mask, torch.from_numpy(centroids),
        torch.from_numpy(weights), tmesh, nbits=nbits, k=5)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.sort(tr, 1), np.sort(jr, 1))
    with pytest.raises(ValueError, match="divide"):
        search_dist.score_full_sharded_topk(
            torch.from_numpy(Q), codes[idx][:30], packed[idx][:30], mask[:30],
            torch.from_numpy(centroids), torch.from_numpy(weights), tmesh, nbits=nbits, k=5)


def test_index_train_step_matches_jax(rng, encoders, jmesh, tmesh):
    jenc, tenc = encoders
    cfg = jenc.bert_config
    k, nbits, dim = 12, 2, 16
    B, L = 16, 12
    ids = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    mask = np.ones((B, L), bool)
    keep = rng.random((B, L)) > 0.2
    cents = rng.standard_normal((k, dim)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    cutoffs = np.sort(rng.standard_normal(3) * 0.1).astype(np.float32)
    jstep = j_index_step(jmesh, cfg, nbits=nbits, num_partitions=k, dtype_name="float32")
    jc, jr, jn, jshift = jstep(jenc.params, jnp.asarray(ids), jnp.asarray(mask),
                               jnp.asarray(keep), jnp.asarray(cents), jnp.asarray(cutoffs))
    tstep = make_index_train_step(tmesh, BertConfig(**cfg.__dict__), nbits=nbits,
                                  num_partitions=k, dtype_name="float32")
    tc, trs, tn, tshift = tstep(tenc.model, ids, mask, keep, torch.from_numpy(cents),
                                torch.from_numpy(cutoffs))
    assert tc.shape == (B * L,) and trs.shape == (B * L, dim // 8 * nbits)
    np.testing.assert_array_equal(tc.numpy().view(np.uint32), np.asarray(jc))
    np.testing.assert_array_equal(trs.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tshift, float(jshift), rtol=1e-4)
