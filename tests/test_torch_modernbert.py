"""GTE-ModernColBERT's encoder in the port (``colbert_torch/models/modernbert.py``)
against the benchmark's plain fp32 reference of the published equations
(``benchmark/archs/modernbert.py``, which imports nothing of the program),
on the CPU at ``ModernBertConfig.tiny()``: two periods of (global, local,
local) layers, head dim 16, a +-8 window that binds on the 40- and 128-token
sequences here. The seeded weights carry random norm scales (the
benchmark's are all 1, under which a norm added after a norm changes
nothing), and q, k, v projections five times the benchmark's 0.02 (so
that attention is far from uniform and positions matter). Both CPU routes
(materialized attention with the band, and the plain flash route with the
window) agree with the reference within 2e-6 (the same fp32 values summed
in another order: the fused q/k/v product, ``F.layer_norm`` against the
written-out mean and variance); each planted fault moves the output by
more than 1e-4. Then a tiny ModernBERT index is
built and searched on the CPU, the counters of its routes, and the
refusals: a ``doc_maxlen`` above the positions, the mesh paths and the
checkpoint loader."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import registry
from colbert_torch.config import ColBERTConfig
from colbert_torch.indexing.builder import Indexer
from colbert_torch.models.colbert import ColBERT
from colbert_torch.models.encoder import ColBERTEncoder
from colbert_torch.models.modernbert import ModernBertConfig, _Norm
from colbert_torch.ops.flash_attention import window_tile_pairs
from colbert_torch.retrieval.searcher import Searcher
from colbert_torch.tokenization.wordpiece import WordPieceTokenizer
from colbert_torch.utils import tracing
from colbert_torch.utils.testing import make_vocab

ARCH = registry.arch("modernbert")
CFG = ModernBertConfig.tiny(vocab_size=300)
WIDTHS = dataclasses.asdict(CFG)
TOL = 2e-6
FAULT = 1e-4  # fifty times TOL; the faults here move it by 2e-3 to 6e-2


def weights(seed=7, dim=32):
    w = ARCH.make_weights(seed, WIDTHS, dim, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for name in w:
        if name.endswith("scale"):
            w[name] = 1.0 + 0.5 * torch.randn(w[name].shape, generator=g)
        elif name.endswith("qkv.weight"):
            w[name] = w[name] * 5.0  # scores of order 1: attention far from uniform
    return w


def batch(seed=1, B=4, S=128, lengths=(128, 100, 40, 7)):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, CFG.vocab_size, (B, S), generator=g)
    mask = torch.zeros(B, S, dtype=torch.bool)
    for i, n in enumerate(lengths):
        mask[i, :n] = True
    return ids, mask, mask & (torch.rand(B, S, generator=g) < 0.9)


@pytest.fixture(scope="module")
def case():
    w = weights()
    model = ColBERT(CFG, 32)
    model.load_state_dict(w, strict=True)
    ids, mask, keep = batch()
    with torch.no_grad():
        ref = ARCH.encode(w, WIDTHS, ids, mask, keep)
    return model.eval(), (ids, mask, keep), ref


def port(model, tensors, use_flash=False, dtype_name="float32"):
    with torch.no_grad():
        return model.forward_normalized(*tensors, dtype_name=dtype_name, use_flash=use_flash)


@pytest.mark.parametrize("use_flash", [False, True], ids=["materialized", "plain_flash"])
def test_port_matches_the_reference(case, use_flash):
    model, tensors, ref = case
    got = port(model, tensors, use_flash)
    assert float((got - ref).abs().max()) <= TOL


def test_bf16_port_stays_near_the_reference(case):
    # one bf16 rounding of every activation through six layers: each kept
    # row's cosine with the reference's above 0.999
    model, tensors, ref = case
    got = port(model, tensors, dtype_name="bfloat16")
    keep = tensors[2]
    assert float((got[keep] * ref[keep]).sum(-1).min()) > 0.999


def _window_left_out(model):
    for layer in model.bert.layers:
        layer.window = None


def _thetas_swapped(model):
    for layer in model.bert.layers:
        layer.theta = CFG.local_rope_theta if layer.is_global else CFG.global_rope_theta


def _norm_in_layer_0(model):
    norm = _Norm(CFG.hidden_size, CFG.norm_eps)
    norm.scale.data.copy_(model.bert.layers[1].attn_norm.scale.data)
    model.bert.layers[0].attn_norm = norm


def _geglu_halves_swapped(model):
    for layer in model.bert.layers:
        a, g = layer.mlp_in.weight.data.chunk(2, dim=0)
        layer.mlp_in.weight.data = torch.cat([g, a]).contiguous()


@pytest.mark.parametrize("plant", [_window_left_out, _thetas_swapped, _norm_in_layer_0,
                                   _geglu_halves_swapped])
def test_planted_faults_fail_the_comparison(case, plant):
    _, tensors, ref = case
    model = ColBERT(CFG, 32)
    model.load_state_dict(weights(), strict=True)
    plant(model)
    for use_flash in (False, True):
        got = port(model.eval(), tensors, use_flash)
        assert float((got - ref).abs().max()) > FAULT, (plant.__name__, use_flash)


def test_layer_kinds_and_rope_tables():
    cfg = ModernBertConfig()
    kinds = [cfg.is_global(i) for i in range(cfg.num_hidden_layers)]
    assert kinds.count(True) == 8 and kinds.count(False) == 14 and cfg.window == 64
    model = ColBERT(CFG, 8).bert
    with tracing.recording() as t:
        for _ in range(2):
            model.rope(128, CFG.local_rope_theta, "cpu")
        model.rope(128, CFG.global_rope_theta, "cpu")
    # one table built per (length, theta): two misses, one hit
    assert [s.name for s in t.spans] == ["rope_tables", "rope_tables"]


def test_window_tile_pairs_match_a_brute_count():
    # the (query, key) pairs of the 64-key tiles that a 64-row q tile
    # visits: every tile holding a key within the window of one of its rows
    for S in (128, 256, 1024):
        i = np.arange(S)
        for w in (0, 1, 8, 63, 64, 65, 200, S):
            near = np.abs(i[:, None] - i[None, :]) <= w
            tiles = near.reshape(S // 64, 64, S // 64, 64).any(axis=(1, 3))
            assert window_tile_pairs(S, w) == int(tiles.sum()) * 64 * 64
    # a 128-row sequence at w = 64: 64-row q tiles visit 2 key tiles each
    assert window_tile_pairs(128, 64) == 2 * 64 * 128
    # interior tiles of a long one visit 3 (the tile before, its own, after)
    assert window_tile_pairs(8192, 64) == 64 * 64 * (3 * 128 - 2)


def _encoder(model, **cfg_kw):
    cfg = ColBERTConfig(dim=32, nbits=2, doc_maxlen=cfg_kw.pop("doc_maxlen", 128),
                        query_maxlen=32, kmeans_niters=2, index_bsize=16,
                        activation_dtype="float32", **cfg_kw)
    return ColBERTEncoder(model, WordPieceTokenizer(make_vocab(CFG.vocab_size - 52)), cfg,
                          device="cpu")


def test_index_and_search_on_the_cpu(tmp_path):
    torch.set_num_threads(2)
    model = ColBERT(CFG, 32)
    model.load_state_dict(weights(), strict=True)
    enc = _encoder(model)
    rng = np.random.default_rng(5)
    passages = [" ".join(f"w{j}" for j in rng.integers(0, CFG.vocab_size - 52, n))
                for n in rng.integers(20, 100, 96)]
    path = str(tmp_path / "index")
    with tracing.recording() as t:
        Indexer(enc.config, encoder=enc, collection=passages, device="cpu").index(path)
    # the CPU never routes to flash: every layer of every batch materialized
    assert t.counters["attn_materialized_launches"] == 6 * t.counters["doc_batches"]
    assert "attn_window_launches" not in t.counters
    assert "attn_window_tile_pairs" not in t.counters
    searcher = Searcher(path, encoder=enc, config=enc.config, device="cpu")
    pids, scores = searcher.search(passages[17], k=5)
    assert pids[0] == 17 and np.all(np.diff(scores) <= 0)


def test_long_passages_stay_in_the_native_tokenizer(monkeypatch):
    # passages of up to doc_maxlen tokens (here 2,000, past the library's
    # default 512) are tokenized by the library, as the Python tokenizer does
    model = ColBERT(dataclasses.replace(CFG, max_position_embeddings=2048), 32)
    enc = _encoder(model, doc_maxlen=2048)
    assert enc._native_tok.available
    rng = np.random.default_rng(2)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 200, n)) for n in (1990, 700, 5)]
    want = [enc.tokenizer.encode(t) for t in texts]

    def refuse(text):
        raise AssertionError("sent to the Python tokenizer")

    monkeypatch.setattr(enc.tokenizer, "encode", refuse)
    assert enc.tokenize_batch(texts) == want


def test_doc_maxlen_above_the_positions_is_refused():
    model = ColBERT(CFG, 32)
    with pytest.raises(ValueError, match="256 positions"):
        _encoder(model, doc_maxlen=257)
    assert _encoder(model, doc_maxlen=256).config.doc_maxlen == 256


def test_mesh_paths_refuse_modernbert():
    from colbert_torch.parallel import tp
    from colbert_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="ModernBertConfig"):
        tp.validate_tp(CFG, 1)
    with pytest.raises(ValueError, match="ModernBertConfig"):
        tp.shard_params(ColBERT(CFG, 8), make_mesh(2, 1, device="cpu"))


def test_checkpoint_loader_refuses_modernbert(tmp_path):
    from colbert_torch.models import hf_loader

    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": "modernbert", **WIDTHS}))
    with pytest.raises(ValueError, match="modernbert"):
        hf_loader.load_checkpoint(str(d), device="cpu")
    tok = WordPieceTokenizer(make_vocab(CFG.vocab_size - 52))
    with pytest.raises(ValueError, match="ModernBertConfig"):
        hf_loader.save_checkpoint(str(tmp_path / "out"), ColBERT(CFG, 8), tok)
    assert not (tmp_path / "out").exists()
