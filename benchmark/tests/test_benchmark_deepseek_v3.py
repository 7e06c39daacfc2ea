"""Moonlight-16B-A3B's architecture file and its reader: the configuration
against the published config, the weights under the program's names, the
FLOP count against a brute count, the fp8 control against the reference,
the reference run in blocks against the same run whole, a tiny
``"arch": "deepseek_v3"`` configuration built, run and judged through both
drivers by new files alone (and judged incorrect when its reference
chooses experts without the router's bias), and
``moe.expert_roofline.build`` on a hand-built trace and counters, None on
a BERT run."""

import json
import math
import shutil
import types

import pytest
import torch
from conftest import TINY, TINY_LIMITS

from benchmark import harness, registry, run
from benchmark.metrics import _spans

DS = registry.arch("deepseek_v3")
CONFIG = registry.config("moonlight-colbert")
BASE = CONFIG["deepseek_v3"]
# Moonlight-16B-A3B's config.json (moonshotai/Moonlight-16B-A3B), as published
PUBLISHED = {
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 11264, "kv_lora_rank": 512,
    "max_position_embeddings": 8192, "model_type": "deepseek_v3", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64, "n_shared_experts": 2,
    "norm_topk_prob": True, "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "num_nextn_predict_layers": 0,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05,
    "rope_theta": 50000, "routed_scaling_factor": 2.446, "scoring_func": "sigmoid",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1, "topk_method": "noaux_tc",
    "v_head_dim": 128, "vocab_size": 163840}
# a dense layer 0 and three MoE layers of 8 experts, top-2, 2 shared; MLA
# with distinct latent, nope, rope and v widths
TINY_DS = dict(PUBLISHED, vocab_size=2048, hidden_size=64, intermediate_size=96,
               moe_intermediate_size=32, num_hidden_layers=4, num_attention_heads=4,
               num_key_value_heads=4, n_routed_experts=8, num_experts_per_tok=2,
               kv_lora_rank=32, qk_nope_head_dim=24, qk_rope_head_dim=8, v_head_dim=16,
               max_position_embeddings=512)
# the tiny cells' limits: the build's are conftest's (a sound run reads
# code_miss_share 0.003 and bucket_miss_share 0.050, the reference without
# the router's bias 0.055 and 0.19); the stream's score_gap reads 0.030
# sound and 0.13 without the bias
LIMITS = {"serve-stream.base": {"score_gap": 0.04, "miss_share": 0.5},
          "index-build.large": TINY_LIMITS["index-build.large"]}


def test_configuration_is_the_published_config():
    assert {k: CONFIG[k] for k in PUBLISHED} == PUBLISHED
    assert BASE == PUBLISHED and CONFIG["reduced"] == {}
    assert CONFIG["source"] == ("https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/"
                                "config.json")
    # 15.62 B parameters: the published model without its LM head
    n = sum(math.prod(s) for s in DS.shapes(BASE, CONFIG["dim"]).values())
    assert 15.62e9 < n < 15.63e9
    assert CONFIG["doc_maxlen"] < CONFIG["indexing"]["flash_min_seqlen"]


def test_weights_are_the_programs_names():
    from colbert_torch.models.colbert import ColBERT
    from colbert_torch.models.deepseek_v3 import DeepseekV3Config

    w = DS.make_weights(11, TINY_DS, 16, "cpu")
    model = ColBERT(DeepseekV3Config(**TINY_DS), 16)
    want = model.state_dict()
    assert sorted(w) == sorted(want)
    assert all(w[n].shape == want[n].shape for n in w)
    for n, t in w.items():
        fp32 = n.endswith(("scale", "router_bias"))
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), n
    assert float(w["bert.layers.2.mlp.router_bias"].abs().min()) > 0
    model.load_state_dict(w, strict=True, assign=True)
    again = DS.make_weights(11, TINY_DS, 16, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)
    assert float(w["bert.word.weight"].float().std()) == pytest.approx(0.02, rel=0.05)


def _brute_flops(widths, dim, tokens, keys):
    """MACs counted product by product for one sequence of ``tokens``
    causal positions, position ``i`` seeing ``min(i + 1, keys)`` keys."""
    H, heads = widths["hidden_size"], widths["num_attention_heads"]
    nope, rope, vd = widths["qk_nope_head_dim"], widths["qk_rope_head_dim"], widths["v_head_dim"]
    rank, I, E = (widths["kv_lora_rank"], widths["moe_intermediate_size"],
                  widths["n_routed_experts"])
    macs = 0
    for layer in range(widths["num_hidden_layers"]):
        for i in range(tokens):
            macs += H * heads * (nope + rope)           # q
            macs += H * (rank + rope)                   # kv_a
            macs += rank * heads * (nope + vd)          # kv_b
            macs += heads * vd * H                      # o
            macs += min(i + 1, keys) * heads * (nope + rope + vd)  # q.k and p.v
            if layer < widths["first_k_dense_replace"]:
                macs += 3 * H * widths["intermediate_size"]
            else:
                macs += H * E                           # router
                macs += widths["num_experts_per_tok"] * 3 * H * I
                macs += 3 * H * widths["n_shared_experts"] * I
    return 2 * (macs + tokens * H * dim)


@pytest.mark.parametrize("tokens,keys", [(1, 1), (7, 7), (9, 4), (12, 5.5)])
def test_flops_match_a_brute_count(tokens, keys):
    assert DS.encoder_flops(TINY_DS, 16, tokens, keys) == pytest.approx(
        _brute_flops(TINY_DS, 16, tokens, keys), rel=1e-12)


def test_flops_per_token_at_the_cells_mean_length():
    # 4.58 GFLOP a token at 641 tokens, 59% of it in the routed experts
    per_token = DS.encoder_flops(BASE, 128, 641, 641) / 641
    assert per_token == pytest.approx(4.576e9, rel=1e-3)
    routed = 26 * 2 * 6 * 3 * 2048 * 1408
    assert routed / per_token == pytest.approx(0.59, abs=0.01)
    flops, _ = DS.moe_work(BASE, 641 * 26, 641 * 26 * 6, 52)
    assert flops == routed * 641


def _batch(seed, B, S, lengths):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, TINY_DS["vocab_size"], (B, S), generator=g)
    mask = torch.zeros(B, S, dtype=torch.bool)
    for i, n in enumerate(lengths):
        mask[i, :n] = True
    keep = mask & (torch.rand(B, S, generator=g) < 0.9)
    return ids, mask, keep


def test_the_fp8_control_differs_from_the_reference():
    w = DS.make_weights(3, TINY_DS, 16, "cpu")
    ids, mask, keep = _batch(4, 4, 40, [40, 30, 9, 2])
    ref = DS.encode(w, TINY_DS, ids, mask, keep)
    ctl = DS.encode(w, TINY_DS, ids, mask, keep, "fp8")
    cos = (ref * ctl).sum(-1)[keep]
    # the control is near the reference, and not within fp32 rounding of it
    assert float(cos.min()) > 0.5 and float((ref - ctl).abs().max()) > 1e-2
    assert torch.equal(ctl[~keep], torch.zeros_like(ctl[~keep]))


@pytest.mark.parametrize("precision", ["float32", "fp8"])
def test_encode_in_blocks_is_the_encode_whole(precision):
    w = DS.make_weights(3, TINY_DS, 16, "cpu")
    ids, mask, keep = _batch(4, 4, 40, [40, 30, 9, 1])
    whole = DS.encode_blocks(w, TINY_DS, ids, mask, keep, precision, passages=4)
    blocks = DS.encode_blocks(w, TINY_DS, ids, mask, keep, precision, passages=1)
    assert torch.equal(blocks[~keep], torch.zeros_like(blocks[~keep]))
    if precision == "float32":
        assert float((blocks - whole).abs().max()) <= 1e-5
    else:
        # per-tensor fp8 scales follow the block: held loosely, not exactly
        assert float((blocks - whole).abs().max()) <= 0.5


def add_tiny_deepseek(root, fault=False):
    """A tiny ``moonlight-colbert``-like configuration (``tinyds``) and a cell
    of each driver over it; with ``fault`` the reference chooses experts
    without the router's bias."""
    if fault:
        src = (root / "archs" / "deepseek_v3.py").read_text()
        src += ("\n\n_route_with_bias = _route\n\n\n"
                "def _route(widths, h, gate, bias, precision):\n"
                "    return _route_with_bias(widths, h, gate, bias * 0, precision)\n")
        (root / "archs" / "deepseek_v3.py").write_text(src)
    cfg = json.loads((root / "configs" / "colbertv2-base.json").read_text())
    del cfg["bert"]
    cfg.update({k: v for k, v in TINY["config"].items() if k != "bert"},
               name="tinyds", arch="deepseek_v3", deepseek_v3=TINY_DS)
    (root / "configs" / "tinyds.json").write_text(json.dumps(cfg))
    for cell, like in [("tinyds.stream", "serve-stream.base"),
                       ("tinyds.build", "index-build.large")]:
        c = json.loads((root / "cells" / f"{like}.json").read_text())
        c.update(TINY["cell"], config="tinyds", limits=LIMITS[like])
        (root / "cells" / f"{cell}.json").write_text(json.dumps(c))


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "router_bias_left_out"])
@pytest.mark.parametrize("cell", ["tinyds.stream", "tinyds.build"])
def test_deepseek_configuration_runs_and_is_judged(cell, fault, tmp_path, tiny):
    root = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_deepseek(root, fault)
    res = run.execute(cell, 17, 2.0, False, "cpu", root=str(root))
    metric = registry.driver(registry.cell(cell, str(root))["driver"], str(root)).METRIC
    assert res["attempted"] > 0 and res["metrics"][metric]["value"] > 0
    assert res["correct"] is (not fault)


def test_the_architecture_config_and_cell_are_found_as_files():
    assert "deepseek_v3" in registry.names("archs")
    assert "moonlight-colbert" in registry.names("configs")
    cell = registry.cell("index-build.moe-chunks")
    assert cell["config"] == "moonlight-colbert" and cell["driver"] == "build"
    arch, widths = registry.arch_of(registry.config(cell["config"]))
    assert arch.PROGRAM_CONFIG == "colbert_torch.models.deepseek_v3:DeepseekV3Config"
    assert widths is not None and registry.yardstick_imports() == []
    reader = registry.metric("moe.expert_roofline.build")
    assert "build" in reader.DRIVERS


# a traced window: two grouped products of 1 ms and 2 ms, and a dense GEMM
# and the shared expert's GEMM that the reader does not take
KERNELS = [("void cutlass::device_kernel<GemmUniversal<GroupProblemShape<...>>>(...)",
            0.0, 0.001, 7),
           ("sm90_xmma_gemm_bf16bf16_bf16f32", 0.001, 0.002, 7),
           ("void cutlass::device_kernel<GemmUniversal<GroupProblemShape<...>>>(...)",
            0.002, 0.004, 7),
           ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNT", 0.004, 0.005, 7)]
CARD = "NVIDIA H100 80GB HBM3"


def traced_run(arch, widths, counters, monkeypatch):
    rec = types.SimpleNamespace(spans=[types.SimpleNamespace(
        name="index", start_ns=0, end_ns=10 ** 7, parent=-1, request=1, thread=0)],
        counters=counters, dropped=0)
    monkeypatch.setattr(_spans, "_take", lambda: rec)
    return types.SimpleNamespace(
        device_trace=harness.Trace(window_s=0.01, busy_s=0.005, kernels=KERNELS, by_name={},
                                   gaps_by_span={}),
        notes={}, counters={"builds": 1}, card={"name": CARD}, arch=arch, widths=widths)


def test_expert_roofline_on_a_hand_built_trace(monkeypatch):
    # one doc batch of 3,000 true tokens in 64 x 64 slots through 26 MoE
    # layers, two grouped launches each
    c = {"doc_batches": 1, "doc_tokens": 3000, "doc_slots": 4096, "moe_layer_calls": 26,
         "moe_dispatch_rows": 26 * 4096 * 6, "moe_grouped_launches": 52}
    r = traced_run(DS, BASE, c, monkeypatch)
    got = registry.metric("moe.expert_roofline.build").read(r)
    flops = 2.0 * 3000 * 26 * 6 * 3 * 2048 * 1408
    nbytes = 26 * 64 * 3 * 2048 * 1408 * 2 + 26 * 4096 * 6 * 2 * (2048 + 2816 + 1408 + 2048)
    assert DS.moe_work(BASE, 3000 * 26, 26 * 4096 * 6, 52) == (flops, nbytes)
    want = 100 * max(flops / 989e12, nbytes / 3.35e12) / 0.003
    assert got == pytest.approx(want)
    note = r.notes["moe.expert_roofline.build"]
    assert note.startswith("bound by bytes") and "2 device operations matched" in note
    assert "52 grouped launches counted" in note


def test_expert_roofline_reads_none_without_experts(monkeypatch):
    reader = registry.metric("moe.expert_roofline.build")
    bert = registry.arch("bert")
    r = traced_run(bert, {}, {"doc_batches": 1, "doc_tokens": 3, "doc_slots": 4}, monkeypatch)
    assert reader.read(r) is None
    # a program that counts no grouped launch (the parent, or the CPU loop)
    r = traced_run(DS, BASE, {"doc_batches": 1, "doc_tokens": 3, "moe_layer_calls": 26},
                   monkeypatch)
    assert reader.read(r) is None
    r.device_trace = None
    assert reader.read(r) is None
