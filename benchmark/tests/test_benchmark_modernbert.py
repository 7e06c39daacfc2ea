"""GTE-ModernColBERT's architecture file and its readers: the FLOP and
attention-work counts against hand counts, the reference run in blocks
against the same run whole, a tiny ``"arch": "modernbert"`` configuration
built, run and judged through both drivers by new files alone (and judged
incorrect when its reference leaves the window out), and the three
attention readers on a hand-built trace and counters, None on a BERT
run."""

import json
import shutil
import types

import numpy as np
import pytest
import torch
from conftest import TINY, TINY_LIMITS

from benchmark import harness, registry, run
from benchmark.metrics import _attn, _spans

MB = registry.arch("modernbert")
# two periods of (global, local, local), head dim 16, a window of +-2: it
# binds on the tiny cells' passages of 13-33 tokens
TINY_MB = {"vocab_size": 2048, "hidden_size": 64, "num_hidden_layers": 6,
           "num_attention_heads": 4, "intermediate_size": 96, "max_position_embeddings": 512,
           "global_attn_every_n_layers": 3, "local_attention": 4,
           "global_rope_theta": 160000.0, "local_rope_theta": 10000.0, "norm_eps": 1e-5,
           "norm_bias": False, "attention_bias": False, "mlp_bias": False,
           "hidden_activation": "gelu"}
BASE = registry.config("gte-moderncolbert")["modernbert"]
# the tiny cells' limits: the build's are conftest's; the stream's
# score_gap reads 0.010-0.012 sound and 0.080 with the window left out,
# while its miss_share swings with the 16 sampled queries (0.06-0.12
# sound, 0.19 faulty), so score_gap is the number that tells them apart
LIMITS = {"serve-stream.base": {"score_gap": 0.04, "miss_share": 0.5},
          "index-build.large": TINY_LIMITS["index-build.large"]}


def test_configuration_keeps_the_published_widths():
    assert BASE["num_hidden_layers"] == 22 and BASE["hidden_size"] == 768
    assert BASE["num_attention_heads"] == 12 and BASE["intermediate_size"] == 1152
    assert MB.vocab_size(BASE) == 50368 and BASE["max_position_embeddings"] == 8192
    assert [MB._is_global(BASE, i) for i in range(22)].count(True) == 8


@pytest.mark.parametrize("tokens", [1, 40, 65])
def test_flops_where_every_key_is_in_the_window(tokens):
    # at <= 65 tokens the +-64 window holds every key: each layer counts
    # the keys given, as BERT's count does
    h, f, dim = 768, 1152, 128
    per_layer = 2 * (4 * h * h + 3 * h * f) + 4 * tokens * h
    want = tokens * (22 * per_layer + 2 * h * dim)
    assert MB.encoder_flops(BASE, dim, tokens, tokens) == want


def test_flops_and_attention_work_of_a_long_passage():
    h, f, dim, n = 768, 1152, 128, 6144
    # each of 6,144 positions sees 129 keys but for the 64 nearest each end
    local = (n * 129 - 2 * sum(64 - d for d in range(64))) / n
    assert MB.window_keys(n, 64) == n * 129 - 64 * 65
    want = n * (22 * 2 * (4 * h * h + 3 * h * f) + 4 * h * (8 * n + 14 * local)
                + 2 * h * dim)
    assert MB.encoder_flops(BASE, dim, n, n) == pytest.approx(want, rel=1e-12)
    # keys given below the window's count cap the local layers too
    assert MB.encoder_flops(BASE, dim, n, 32) == n * (22 * 2 * (4 * h * h + 3 * h * f)
                                                      + 4 * h * 22 * 32 + 2 * h * dim)
    work = MB.attention_work(BASE, [n, 40])
    pairs_local = n * 129 - 64 * 65 + 40 * 40
    assert MB.window_pairs(BASE, [n, 40]) == 14 * 12 * pairs_local
    assert work["local"][0] == 14 * 4 * 64 * 12 * pairs_local
    assert work["global"][0] == 8 * 4 * 64 * 12 * (n * n + 40 * 40)
    nbytes = (n + 40) * (4 * 768 * 2 + 4)
    assert work["local"][1] == 14 * nbytes and work["global"][1] == 8 * nbytes


@pytest.mark.parametrize("window", [0, 1, 8, 64])
def test_window_keys_match_a_brute_count(window):
    for n in (1, 5, 9, 10, 64, 65, 66, 200):
        want = sum(abs(i - j) <= window for i in range(n) for j in range(n))
        assert MB.window_keys(n, window) == want


def _batch(seed, B, S, lengths):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, TINY_MB["vocab_size"], (B, S), generator=g)
    mask = torch.zeros(B, S, dtype=torch.bool)
    for i, n in enumerate(lengths):
        mask[i, :n] = True
    keep = mask & (torch.rand(B, S, generator=g) < 0.9)
    return ids, mask, keep


@pytest.mark.parametrize("precision", ["float32", "fp8"])
def test_encode_in_blocks_is_the_encode_whole(precision):
    w = MB.make_weights(3, TINY_MB, 16, "cpu")
    ids, mask, keep = _batch(4, 4, 48, [48, 30, 9, 1])
    whole = MB.encode_blocks(w, TINY_MB, ids, mask, keep, precision, passages=4, rows=48)
    blocks = MB.encode_blocks(w, TINY_MB, ids, mask, keep, precision, passages=1, rows=7)
    assert torch.equal(blocks[~keep], torch.zeros_like(blocks[~keep]))
    if precision == "float32":
        # the same sums over other block shapes: fp32 rounding only
        assert float((blocks - whole).abs().max()) <= 1e-5
    else:
        # per-tensor fp8 scales follow the block: held loosely, not exactly
        assert float((blocks - whole).abs().max()) <= 0.1
    assert torch.equal(MB.encode(w, TINY_MB, ids, mask, keep, precision),
                       MB.encode_blocks(w, TINY_MB, ids, mask, keep, precision))


def test_weights_are_the_programs_names():
    from colbert_torch.models.colbert import ColBERT
    from colbert_torch.models.modernbert import ModernBertConfig

    w = MB.make_weights(11, TINY_MB, 16, "cpu")
    model = ColBERT(ModernBertConfig(**TINY_MB), 16)
    assert sorted(w) == sorted(model.state_dict())
    model.load_state_dict(w, strict=True)
    again = MB.make_weights(11, TINY_MB, 16, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)


def add_tiny_modernbert(root, fault=False):
    """A tiny ``gte-moderncolbert``-like configuration (``tinymb``) and a
    cell of each driver over it; with ``fault`` the reference leaves the
    window out (every layer global)."""
    if fault:
        src = (root / "archs" / "modernbert.py").read_text()
        src += "\n\ndef _window(widths):\n    return 10 ** 6\n"
        (root / "archs" / "modernbert.py").write_text(src)
    cfg = json.loads((root / "configs" / "colbertv2-base.json").read_text())
    del cfg["bert"]
    cfg.update({k: v for k, v in TINY["config"].items() if k != "bert"},
               name="tinymb", arch="modernbert", modernbert=TINY_MB)
    (root / "configs" / "tinymb.json").write_text(json.dumps(cfg))
    for cell, like in [("tinymb.stream", "serve-stream.base"),
                       ("tinymb.build", "index-build.large")]:
        c = json.loads((root / "cells" / f"{like}.json").read_text())
        c.update(TINY["cell"], config="tinymb", limits=LIMITS[like])
        (root / "cells" / f"{cell}.json").write_text(json.dumps(c))


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "window_left_out"])
@pytest.mark.parametrize("cell", ["tinymb.stream", "tinymb.build"])
def test_modernbert_configuration_runs_and_is_judged(cell, fault, tmp_path, tiny):
    root = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_modernbert(root, fault)
    res = run.execute(cell, 17, 2.0, False, "cpu", root=str(root))
    metric = registry.driver(registry.cell(cell, str(root))["driver"], str(root)).METRIC
    assert res["attempted"] > 0 and res["metrics"][metric]["value"] > 0
    assert res["correct"] is (not fault)


# a traced window of two builds: two windowed launches of 1 ms, one global
# of 4 ms, and a BERT-named kernel that neither reader takes
KERNELS = [("void flash_mma_window_kernel<__nv_bfloat16, 64>(...)", 0.0, 0.001, 7),
           ("void flash_mma_kernel<__nv_bfloat16, 64>(...)", 0.002, 0.006, 7),
           ("void flash_mma_window_kernel<__nv_bfloat16, 64>(...)", 0.007, 0.008, 7),
           ("ampere_bf16_gemm", 0.008, 0.009, 7)]
CARD = "NVIDIA H100 80GB HBM3"


def traced_run(arch, counters, monkeypatch):
    rec = types.SimpleNamespace(spans=[types.SimpleNamespace(
        name="index", start_ns=0, end_ns=10 ** 7, parent=-1, request=1, thread=0)],
        counters=counters, dropped=0)
    monkeypatch.setattr(_spans, "_take", lambda: rec)
    r = types.SimpleNamespace(
        device_trace=harness.Trace(window_s=0.01, busy_s=0.007, kernels=KERNELS, by_name={},
                                   gaps_by_span={}),
        notes={}, counters={"builds": 2}, card={"name": CARD}, arch=arch,
        widths=BASE if arch is MB else {})
    r._attn_lengths = np.array([6000, 3000])
    return r


def test_attention_readers_on_a_hand_built_trace(monkeypatch):
    # the windowed launches computed 4 times the window's true pairs
    tiles = 4 * 2 * MB.window_pairs(BASE, [6000, 3000])
    r = traced_run(MB, {"attn_window_tile_pairs": tiles}, monkeypatch)
    read = {n: registry.metric(n).read(r) for n in
            ("attn.window_roofline.build", "attn.global_roofline.build",
             "attn.window_waste_share.build")}
    local, glob = MB.attention_work(BASE, [6000, 3000]).values()
    # 2 builds' work over 2 ms of windowed and 4 ms of global launches
    bound_local = max(2 * local[0] / 989e12, 2 * local[1] / 3.35e12)
    bound_global = max(2 * glob[0] / 989e12, 2 * glob[1] / 3.35e12)
    assert read["attn.window_roofline.build"] == pytest.approx(100 * bound_local / 0.002)
    assert read["attn.global_roofline.build"] == pytest.approx(100 * bound_global / 0.004)
    assert read["attn.window_waste_share.build"] == pytest.approx(75.0)
    assert r.notes["attn.window_roofline.build"].startswith("bound by bytes")
    assert r.notes["attn.global_roofline.build"].startswith("bound by flops")


def test_encoded_lengths_follow_the_builds_sample(tiny):
    cfg = dict(registry.config("gte-moderncolbert"), collection_passages=5)
    cell = dict(registry.cell("index-build.modern-long"), min_words=20, max_words=30)
    r = types.SimpleNamespace(seed=3, config=cfg, cell=cell, arch=MB, widths=BASE)
    lens = _attn.encoded_lengths(r)
    # 5 passages are their own sample: each counted once, 3 tokens over its words
    assert len(lens) == 5 and all(23 <= n <= 32 for n in lens)


@pytest.mark.parametrize("name", ["attn.window_roofline.build", "attn.global_roofline.build",
                                  "attn.window_waste_share.build"])
def test_attention_readers_read_none_on_a_bert_run(name, monkeypatch):
    bert = registry.arch("bert")
    r = traced_run(bert, {"doc_tokens": 3, "doc_slots": 4}, monkeypatch)
    # BERT's flash launches carry the global kernel's name: its architecture
    # counts no attention work, so the reader takes none
    assert registry.metric(name).read(r) is None
    r.device_trace = None
    assert registry.metric(name).read(r) is None
