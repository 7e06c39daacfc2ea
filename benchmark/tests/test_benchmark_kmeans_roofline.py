"""``kmeans.assign_roofline.build`` on hand-made traces and program
counters: None without a trace, without the counters or without a
nearest-centroid launch; the share of the counted work over the traced
time of those launches alone; bound by FLOPs at both build cells' shapes;
and 100% for the least time the rule allows."""

import threading
import types

import pytest

from benchmark import registry, roofline
from benchmark.metrics import _spans

NAME = "kmeans.assign_roofline.build"
H100 = "NVIDIA H100 80GB HBM3"
KERNEL = "void (anonymous namespace)::nearest_centroid_kernel<4>(__nv_bfloat16 const*, ...)"
# (rows a pass, centroids) of index-build.large and index-build.modern-long
SHAPES = [(2_883_584, 16_384), (1_179_648, 8_192)]


def run_of(monkeypatch, counters, kernels, dim=128):
    span = types.SimpleNamespace(name="index", start_ns=0, end_ns=9_000_000_000, parent=-1,
                                 request=1, thread=threading.get_ident())
    rec = types.SimpleNamespace(spans=[span], counters=counters, dropped=0)
    monkeypatch.setattr(_spans, "_take", lambda: rec)
    trace = types.SimpleNamespace(window_s=10.0, busy_s=4.0, kernels=kernels, by_name={},
                                  gaps_by_span={})
    return types.SimpleNamespace(device_trace=trace, notes={}, config={"dim": dim},
                                 card={"name": H100})


def counters(passes, rows, k):
    return {"kmeans_assign_launches": passes, "kmeans_assign_rows": passes * rows,
            "kmeans_assign_pairs": passes * rows * k}


def launches(passes, seconds_each, other=()):
    out, t = [], 1.0
    for _ in range(passes):
        out.append((KERNEL, t, t + seconds_each, 7))
        t += 2 * seconds_each
    return out + [(name, t, t + 5.0, 7) for name in other]


def test_none_without_a_trace():
    r = types.SimpleNamespace(device_trace=None, notes={}, config={"dim": 128},
                              card={"name": H100})
    assert registry.metric(NAME).read(r) is None


def test_none_without_the_counters_or_the_kernel(monkeypatch):
    m = registry.metric(NAME)
    assert m.read(run_of(monkeypatch, {}, launches(3, 0.05))) is None
    assert m.read(run_of(monkeypatch, {"kmeans_iters": 20}, launches(3, 0.05))) is None
    sgemm = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x128x8_stage3"
    assert m.read(run_of(monkeypatch, counters(3, 1000, 64), [(sgemm, 1.0, 2.0, 7)])) is None


@pytest.mark.parametrize("rows,k", SHAPES)
def test_share_of_the_counted_work_over_the_kernels_time(monkeypatch, rows, k):
    m = registry.metric(NAME)
    # other operations in the window (the scatter, the encoder) do not count
    r = run_of(monkeypatch, counters(20, rows, k), launches(20, 0.05, ["index_add", "gemm"]))
    got = m.read(r)
    flops = 2.0 * 128 * 20 * rows * k
    assert got == pytest.approx(100.0 * flops / roofline.PEAKS[H100]["flops"] / 1.0)
    assert "bound by flops; 20 launches" in r.notes[NAME]


@pytest.mark.parametrize("rows,k", SHAPES)
def test_flop_bound_and_100_percent_at_the_least_time(rows, k):
    m = registry.metric(NAME)
    flops, nbytes = m.work(128, 1, rows, rows * k)
    assert flops == 2.0 * 128 * rows * k
    assert nbytes == rows * (128 * 2 + 8) + k * 128 * 4
    p = roofline.PEAKS[H100]
    assert flops / p["flops"] > 10 * nbytes / p["bytes"]
    least = flops / p["flops"]
    share, bound = roofline.share(flops, nbytes, least, H100)
    assert share == pytest.approx(100.0) and bound == "flops"
    # three bf16 products per centroid at the bf16 rate read a third
    assert roofline.share(flops, nbytes, 3 * least, H100)[0] == pytest.approx(100.0 / 3)


def test_is_a_build_metric_of_the_codec_layer():
    m = registry.metric(NAME)
    assert m.DRIVERS == ("build",) and m.MOVES == "index_passages_per_s" and m.UNIT == "%"
    assert m.LAYER == registry.metric("build.codec_train_share").LAYER
    assert NAME in registry.metrics_for("build") and NAME not in registry.metrics_for("stream")
