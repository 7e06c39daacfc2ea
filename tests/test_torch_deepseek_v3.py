"""Moonlight-16B-A3B's encoder in the port (``colbert_torch/models/deepseek_v3.py``,
``colbert_torch/ops/moe.py``) against the benchmark's plain fp32 reference of
the published equations (``benchmark/archs/deepseek_v3.py``, which imports
nothing of the program), on the CPU at ``DeepseekV3Config.tiny()``: a dense
layer 0 and three MoE layers of 8 experts (top-2, 2 shared), MLA with
distinct latent, nope, rope and v widths. The seeded weights carry random
norm scales (the benchmark's are all 1), q and kv projections five times
the benchmark's 0.02 (attention far from uniform, positions matter) and a
router bias fifteen times it (it changes which experts are chosen for a
share of the tokens, so leaving it out shows).

The port agrees with the reference within 2e-6, one-token rows and
unpadded batches included: the same fp32 values
summed in another order (SDPA's blocked softmax against the reference's
written-out one, the expert sums slot by slot against its ``index_add_``).
Each planted fault moves the output by more than 1e-4. The grouped expert
route (two ``torch._grouped_mm`` over the slots sorted by expert; the
route of CUDA tensors) equals the plain loop within 1e-6, in fp32 and
bf16, and faults planted in its dispatch and combine move it by more than
1e-3 of the output's scale. Then
causality, a tiny index built and searched on the CPU, the counters, and
the refusals: flash, a ``doc_maxlen`` above the positions, the mesh paths
and the checkpoint loader."""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import registry
from colbert_torch.config import ColBERTConfig
from colbert_torch.indexing.builder import Indexer
from colbert_torch.models import deepseek_v3 as ds
from colbert_torch.models.colbert import ColBERT
from colbert_torch.models.deepseek_v3 import DeepseekV3Config
from colbert_torch.models.encoder import ColBERTEncoder
from colbert_torch.ops import moe as moe_ops
from colbert_torch.retrieval.searcher import Searcher
from colbert_torch.tokenization.wordpiece import WordPieceTokenizer
from colbert_torch.utils import tracing
from colbert_torch.utils.testing import make_vocab

ARCH = registry.arch("deepseek_v3")
CFG = DeepseekV3Config.tiny(vocab_size=300)
WIDTHS = dataclasses.asdict(CFG)
TOL = 2e-6
FAULT = 1e-4  # fifty times TOL


def weights(seed=7, dim=32):
    """The architecture's seeded weights in fp32, reshaped for the tests as
    the module docstring says."""
    w = {n: t.float() for n, t in ARCH.make_weights(seed, WIDTHS, dim, "cpu").items()}
    g = torch.Generator().manual_seed(seed + 1)
    for name in w:
        if name.endswith("scale"):
            w[name] = 1.0 + 0.5 * torch.randn(w[name].shape, generator=g)
        elif name.endswith(("attn.q.weight", "attn.kv_a.weight", "attn.kv_b.weight")):
            w[name] = w[name] * 5.0
        elif name.endswith("router_bias"):
            w[name] = w[name] * 15.0
    return w


def model_of(w, dim=32):
    model = ColBERT(CFG, dim)
    model.load_state_dict(w, strict=True)
    return model.eval()


def batch(seed=1, B=4, S=48, lengths=(48, 37, 12, 3)):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, CFG.vocab_size, (B, S), generator=g)
    mask = torch.zeros(B, S, dtype=torch.bool)
    for i, n in enumerate(lengths):
        mask[i, :n] = True
    return ids, mask, mask & (torch.rand(B, S, generator=g) < 0.9)


@pytest.fixture(scope="module")
def case():
    w = weights()
    tensors = batch()
    with torch.no_grad():
        ref = ARCH.encode(w, WIDTHS, *tensors)
    return w, tensors, ref


def port(model, tensors, dtype_name="float32"):
    with torch.no_grad():
        return model.forward_normalized(*tensors, dtype_name=dtype_name)


def gap(got, ref):
    return float((got - ref).abs().max())


def test_tiny_keeps_the_mechanisms():
    assert not CFG.is_moe(0) and all(CFG.is_moe(i) for i in range(1, CFG.num_hidden_layers))
    assert CFG.num_hidden_layers - 1 >= 3 and CFG.n_routed_experts >= 8
    assert CFG.num_experts_per_tok >= 2 and CFG.n_shared_experts == 2
    widths = (CFG.kv_lora_rank, CFG.qk_nope_head_dim, CFG.qk_rope_head_dim, CFG.v_head_dim)
    assert len(set(widths)) == 4 and CFG.q_lora_rank is None
    assert float(weights()["bert.layers.1.mlp.router_bias"].abs().min()) > 0
    # the published defaults are Moonlight-16B-A3B's
    full = DeepseekV3Config()
    assert (full.num_hidden_layers, full.hidden_size, full.n_routed_experts,
            full.num_experts_per_tok, full.n_shared_experts, full.kv_lora_rank,
            full.vocab_size) == (27, 2048, 64, 6, 2, 512, 163840)


def test_port_matches_the_reference(case):
    w, tensors, ref = case
    assert gap(port(model_of(w), tensors), ref) <= TOL


@pytest.mark.parametrize("B,S,lengths", [(1, 1, (1,)), (3, 17, (17, 17, 17)),
                                         (2, 64, (1, 64)), (5, 9, (9, 1, 5, 2, 7))])
def test_port_matches_the_reference_at_edge_lengths(case, B, S, lengths):
    # one-token rows, a batch with no padding, odd lengths: every query row
    # of the causal-and-pad mask keeps key 0, pad rows included
    w = case[0]
    tensors = batch(seed=S, B=B, S=S, lengths=lengths)
    with torch.no_grad():
        ref = ARCH.encode(w, WIDTHS, *tensors)
    assert gap(port(model_of(w), tensors), ref) <= TOL


def test_bf16_port_stays_near_the_reference(case):
    # bf16 rounding of every activation through four layers, with the
    # routing chosen on bf16 scores: each kept row's cosine with the
    # reference's above 0.99
    w, tensors, ref = case
    got = port(model_of(w), tensors, "bfloat16")
    keep = tensors[2]
    assert float((got[keep] * ref[keep]).sum(-1).min()) > 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_route_equals_the_plain_loop(dtype):
    g = torch.Generator().manual_seed(3)
    T, H, I, E, k = 61, 64, 32, 8, 3
    x = torch.randn(T, H, generator=g).to(dtype)
    gate_up = (torch.randn(E, 2 * I, H, generator=g) * 0.1).to(dtype)
    down = (torch.randn(E, H, I, generator=g) * 0.1).to(dtype)
    gate = torch.randn(E, H, generator=g) * 0.1
    choice, wts = moe_ops.route(x, gate, torch.randn(E, generator=g) * 0.1, k, 2.446)
    # expert 5 left without a row: an empty group
    choice = torch.where(choice == 5, (choice + 1) % E, choice)
    assert not (choice == 5).any() and choice.unique(dim=-1).shape == choice.shape
    with tracing.recording() as t:
        grouped = moe_ops.experts(x, choice, wts, gate_up, down, grouped=True)
    loop = moe_ops.experts(x, choice, wts, gate_up, down, grouped=False)
    assert grouped.dtype == loop.dtype == torch.float32
    assert gap(grouped, loop) <= 1e-6 * float(loop.abs().max())
    assert t.counters == {"moe_grouped_launches": 2}


def _last_slot_dropped(monkeypatch):
    weighted_sum = moe_ops._weighted_sum
    monkeypatch.setattr(moe_ops, "_weighted_sum",
                        lambda y, w: weighted_sum(y[:, :-1], w[:, :-1]))


def _weights_reversed(monkeypatch):
    weighted_sum = moe_ops._weighted_sum
    monkeypatch.setattr(moe_ops, "_weighted_sum", lambda y, w: weighted_sum(y, w.flip(-1)))


def _expert_offset_shifted(monkeypatch):
    # expert 4's first 16 rows computed by expert 3
    grouped_mm = torch._grouped_mm
    def shifted(a, b, offs):
        return grouped_mm(a, b, offs=offs + 16 * (torch.arange(offs.numel()) == 3).to(offs))
    monkeypatch.setattr(torch, "_grouped_mm", shifted)


@pytest.mark.parametrize("plant", [_last_slot_dropped, _weights_reversed,
                                   _expert_offset_shifted])
def test_planted_expert_layer_faults_fail(plant, monkeypatch):
    # the grouped route's dispatch and combine against the plain loop: each
    # fault moves the output by a thousand times the routes' tolerance
    g = torch.Generator().manual_seed(6)
    T, H, I, E, k = 256, 64, 32, 8, 3
    x = torch.randn(T, H, generator=g)
    gate_up = torch.randn(E, 2 * I, H, generator=g) * 0.1
    down = torch.randn(E, H, I, generator=g) * 0.1
    choice, wts = moe_ops.route(x, torch.randn(E, H, generator=g) * 0.1,
                                torch.zeros(E), k, 2.446)
    assert int((choice == 4).sum()) >= 16
    loop = moe_ops.experts(x, choice, wts, gate_up, down, grouped=False)
    plant(monkeypatch)
    grouped = moe_ops.experts(x, choice, wts, gate_up, down, grouped=True)
    assert gap(grouped, loop) > 1e-3 * float(loop.abs().max()), plant.__name__


def test_route_follows_the_published_equations():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(9, 16, generator=g).to(torch.bfloat16)
    gate, bias = torch.randn(8, 16, generator=g), torch.randn(8, generator=g)
    choice, w = moe_ops.route(x, gate, bias, 3, 2.446)
    s = torch.sigmoid(x.double() @ gate.double().T)
    for t in range(9):
        want = torch.argsort(s[t] + bias.double(), descending=True)[:3]
        assert choice[t].tolist() == want.tolist()
        picked = s[t, want]
        assert torch.allclose(w[t].double(), picked / picked.sum() * 2.446, rtol=1e-6)


def test_later_tokens_leave_earlier_embeddings_unchanged(case):
    w, (ids, mask, keep), _ = case
    model = model_of(w)
    before = port(model, (ids, mask, keep))
    ids2 = ids.clone()
    ids2[0, 30:] = (ids2[0, 30:] + 7) % CFG.vocab_size
    after = port(model, (ids2, mask, keep))
    assert torch.equal(after[0, :30], before[0, :30])
    assert gap(after[0, 30:], before[0, 30:]) > FAULT
    assert torch.equal(after[1:], before[1:])


def _no_router_bias(model, monkeypatch):
    for layer in model.bert.layers[1:]:
        layer.mlp.router_bias.zero_()


def _softmax_scores(model, monkeypatch):
    def route(x, gate, bias, top_k, scaling):
        s = torch.softmax(F.linear(x.float(), gate.float()), dim=-1)
        choice = torch.topk(s + bias, top_k, dim=-1).indices
        w = s.gather(-1, choice)
        return choice, w / (w.sum(-1, keepdim=True) + 1e-20) * scaling
    monkeypatch.setattr(moe_ops, "route", route)


def _unnormalized_weights(model, monkeypatch):
    def route(x, gate, bias, top_k, scaling):
        s = torch.sigmoid(F.linear(x.float(), gate.float()))
        choice = torch.topk(s + bias, top_k, dim=-1).indices
        return choice, s.gather(-1, choice) * scaling
    monkeypatch.setattr(moe_ops, "route", route)


def _shared_expert_dropped(model, monkeypatch):
    for layer in model.bert.layers[1:]:
        layer.mlp.shared.down.weight.data.zero_()


def _rotate_half_rope(model, monkeypatch):
    def rotary(x, cos, sin):
        h = x.shape[-1] // 2
        x0, x1 = x[..., :h].float(), x[..., h:].float()
        return torch.cat((x0 * cos - x1 * sin, x1 * cos + x0 * sin), -1).to(x.dtype)
    monkeypatch.setattr(ds, "_rotary", rotary)


def _bidirectional(model, monkeypatch):
    def allowed(attention_mask):
        S = attention_mask.shape[1]
        return attention_mask.bool()[:, None, None, :].expand(-1, 1, S, S)
    monkeypatch.setattr(ds, "allowed_keys", allowed)


@pytest.mark.parametrize("plant", [_no_router_bias, _softmax_scores, _unnormalized_weights,
                                   _shared_expert_dropped, _rotate_half_rope, _bidirectional])
def test_planted_faults_fail_the_comparison(case, plant, monkeypatch):
    w, tensors, ref = case
    model = model_of(w)
    with torch.no_grad():
        plant(model, monkeypatch)
    assert gap(port(model, tensors), ref) > FAULT, plant.__name__


def _encoder(model, **cfg_kw):
    cfg = ColBERTConfig(dim=32, nbits=2, doc_maxlen=cfg_kw.pop("doc_maxlen", 128),
                        query_maxlen=32, kmeans_niters=2, index_bsize=16,
                        activation_dtype="float32", **cfg_kw)
    return ColBERTEncoder(model, WordPieceTokenizer(make_vocab(CFG.vocab_size - 52)), cfg,
                          device="cpu")


def test_index_and_search_on_the_cpu(tmp_path):
    torch.set_num_threads(2)
    enc = _encoder(model_of(weights()))
    rng = np.random.default_rng(5)
    passages = [" ".join(f"w{j}" for j in rng.integers(0, CFG.vocab_size - 52, n))
                for n in rng.integers(20, 100, 96)]
    path = str(tmp_path / "index")
    with tracing.recording() as t:
        Indexer(enc.config, encoder=enc, collection=passages, device="cpu").index(path)
    searcher = Searcher(path, encoder=enc, config=enc.config, device="cpu")
    pids, scores = searcher.search(passages[17], k=5)
    assert pids[0] == 17 and np.all(np.diff(scores) <= 0)
    c = t.counters
    # every doc batch through 4 attention layers and 3 MoE layers; the CPU
    # takes the plain expert loop, so no grouped launch
    assert c["attn_mla_calls"] == 4 * c["doc_batches"]
    assert c["moe_layer_calls"] == 3 * c["doc_batches"]
    assert c["moe_dispatch_rows"] == 3 * CFG.num_experts_per_tok * c["doc_slots"]
    assert "moe_grouped_launches" not in c


def test_counters_of_one_forward(case):
    w, tensors, _ = case
    model = model_of(w)
    B, S = tensors[0].shape
    with tracing.recording() as t:
        port(model, tensors)
    assert t.counters == {"attn_mla_calls": 4, "moe_layer_calls": 3,
                          "moe_dispatch_rows": 3 * B * S * 2}
    # the MoE layer alone on the grouped route counts its two launches
    x = torch.randn(B * S, CFG.hidden_size)
    mlp = model.bert.layers[1].mlp
    with tracing.recording() as t, torch.no_grad():
        got = moe_ops.moe(x, mlp.router.weight, mlp.router_bias, mlp.experts_gate_up,
                          mlp.experts_down, mlp.shared.gate_up.weight, mlp.shared.down.weight,
                          top_k=2, scaling=CFG.routed_scaling_factor, grouped=True)
        want = mlp(x)
    assert t.counters["moe_grouped_launches"] == 2 and gap(got, want) <= 1e-6


def test_flash_is_refused(case):
    w, tensors, _ = case
    with pytest.raises(ValueError, match="no flash route"), torch.no_grad():
        model_of(w).forward_normalized(*tensors, dtype_name="float32", use_flash=True)


def test_unsupported_settings_are_refused():
    with pytest.raises(ValueError, match="q_lora_rank"):
        DeepseekV3Config(q_lora_rank=1536)
    with pytest.raises(ValueError, match="scoring_func"):
        DeepseekV3Config(scoring_func="softmax")


def test_doc_maxlen_above_the_positions_is_refused():
    model = ColBERT(CFG, 32)
    with pytest.raises(ValueError, match="256 positions DeepseekV3Config"):
        _encoder(model, doc_maxlen=257)
    assert _encoder(model, doc_maxlen=256).config.doc_maxlen == 256


def test_mesh_paths_refuse_deepseek_v3():
    from colbert_torch.parallel import tp
    from colbert_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="DeepseekV3Config.*expert parallelism"):
        tp.validate_tp(CFG, 1)
    with pytest.raises(ValueError, match="DeepseekV3Config"):
        tp.shard_params(ColBERT(CFG, 8), make_mesh(2, 1, device="cpu"))


def test_checkpoint_loader_refuses_deepseek_v3(tmp_path):
    from colbert_torch.models import hf_loader

    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(WIDTHS))
    with pytest.raises(ValueError, match="deepseek_v3.*parameter names"):
        hf_loader.load_checkpoint(str(d), device="cpu")
    tok = WordPieceTokenizer(make_vocab(CFG.vocab_size - 52))
    with pytest.raises(ValueError, match="DeepseekV3Config"):
        hf_loader.save_checkpoint(str(tmp_path / "out"), ColBERT(CFG, 8), tok)
    assert not (tmp_path / "out").exists()
