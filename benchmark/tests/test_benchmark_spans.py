"""The readers of the program's own spans (benchmark/metrics/_spans.py and
the per-layer metrics on it) on a hand-built device trace and span list:
each stretch of device idle goes to the innermost span open on the driver's
thread, exactly; a program without a span recorder reads None."""

import threading
import types

import pytest

from benchmark import harness, registry
from benchmark.metrics import _spans

ME = threading.get_ident()

# busy [0, 2], [4, 5], [8, 9]: idle [2, 4] and [5, 8]
KERNELS = [("k", 0.0, 1.0, 7), ("k", 0.5, 2.0, 7), ("k", 4.0, 5.0, 7), ("k", 8.0, 9.0, 7)]
STREAM = [  # (name, start s, end s, parent, request, thread)
    ("launch_search", 1.5, 6.0, -1, 1, ME),
    ("tokenize", 2.5, 3.5, 0, 1, ME),
    ("program_launch", 3.5, 4.5, 0, 1, ME),
    ("copy_in", 3.75, 4.25, 2, 1, ME),
    ("finish_search", 7.0, 9.5, -1, 1, ME),
    ("wait", 7.5, 8.5, 4, 1, ME),
    ("elsewhere", 2.0, 9.0, -1, 2, ME + 1),  # another thread: not the driver's
]
BUILD = [
    ("index", 0.0, 9.0, -1, 5, ME),
    ("sample_encode", 1.0, 3.0, 0, 5, ME),
    ("doc_dispatch", 2.0, 2.5, 1, 5, ME),
    ("h2d", 2.25, 2.5, 2, 5, ME),  # inside a doc_ span
    ("codec_train", 3.0, 7.0, 0, 5, ME),
    ("kmeans", 3.0, 3.5, 4, 5, ME),
    ("quantiles", 5.5, 6.0, 4, 5, ME),
]


def trace():
    return harness.Trace(window_s=10.0, busy_s=4.0, kernels=KERNELS, by_name={},
                         gaps_by_span={})


def test_idle_goes_to_the_innermost_open_span():
    idle = _spans.attribute(trace(), STREAM, ME)
    assert idle == {0: 1.5, 1: 1.0, 2: 0.25, 3: 0.25, -1: 1.0, 4: 0.5, 5: 0.5}
    assert _spans.attribute(trace(), STREAM, ME + 1) == {6: 5.0}
    assert _spans.attribute(trace(), [], ME) == {-1: 5.0}


def test_innermost_segments_of_nested_spans():
    segs = _spans.innermost_segments([(0.0, 10.0, 0), (0.0, 4.0, 1), (1.0, 2.0, 2),
                                      (6.0, 8.0, 3)])
    assert segs == [(0.0, 1.0, 1), (1.0, 2.0, 2), (2.0, 4.0, 1), (4.0, 6.0, 0),
                    (6.0, 8.0, 3), (8.0, 10.0, 0)]


class Recorder:
    def __init__(self, spans, counters):
        self.spans = [types.SimpleNamespace(name=n, start_ns=round(s * 1e9),
                                            end_ns=round(e * 1e9), parent=p, request=q,
                                            thread=t) for n, s, e, p, q, t in spans]
        self.counters = counters
        self.dropped = 0


def run_of(monkeypatch, spans, counters):
    rec = Recorder(spans, counters)
    monkeypatch.setattr(_spans, "_take", lambda: rec)
    return types.SimpleNamespace(device_trace=trace(), notes={})


def read(name, r):
    return registry.metric(name).read(r)


def test_stream_metrics_and_notes(monkeypatch):
    r = run_of(monkeypatch, STREAM, {"program_replay_device_ns": 7_000_000,
                                     "program_replays_timed": 2})
    assert read("search.tokenize_ms.stream", r) == pytest.approx(1000.0)
    assert read("program.launch_ms.stream", r) == pytest.approx(1000.0)
    assert read("program.replay_event_ms.stream", r) == pytest.approx(3.5)
    # idle under the roots or under no span: 1.5 + 0.5 + 1.0 of 5.0
    assert read("device.idle_unexplained_share.stream", r) == pytest.approx(60.0)
    idle = r.notes["idle_by_program_span"]
    assert idle["launch_search"] == pytest.approx([1.5, 15.0])
    assert idle[_spans.NONE] == pytest.approx([1.0, 10.0])
    spans = r.notes["program_spans"]
    assert spans["requests"] == 2 and spans["idle_s"] == pytest.approx(5.0)
    assert spans["spans"]["launch_search"]["self_ms_per_request"] == pytest.approx(1250.0)
    assert spans["spans"]["program_launch"]["mean_ms"] == pytest.approx(1000.0)


def test_build_metrics(monkeypatch):
    r = run_of(monkeypatch, BUILD, {"doc_tokens": 300, "doc_slots": 400})
    # idle [2, 4]: doc_dispatch 2-2.25, h2d 2.25-2.5, sample_encode 2.5-3, kmeans 3-3.5,
    # codec_train 3.5-4; [5, 8]: codec_train 5-5.5 and 6-7, quantiles
    # 5.5-6, index 7-8
    assert read("build.encode_idle_share.build", r) == pytest.approx(5.0)
    assert read("build.codec_idle_share.build", r) == pytest.approx(30.0)
    assert read("encode.pad_share.build", r) == pytest.approx(25.0)
    assert read("device.idle_unexplained_share.build", r) == pytest.approx(20.0)


@pytest.mark.parametrize("name", ["search.tokenize_ms.stream", "program.launch_ms.stream",
                                  "program.replay_event_ms.stream",
                                  "device.idle_unexplained_share.stream",
                                  "build.encode_idle_share.build", "build.codec_idle_share.build",
                                  "encode.pad_share.build",
                                  "device.idle_unexplained_share.build"])
def test_a_program_without_spans_reads_none(monkeypatch, name):
    from colbert_torch.utils import tracing

    monkeypatch.delattr(tracing, "take")
    r = types.SimpleNamespace(device_trace=trace(), notes={})
    assert read(name, r) is None and r.notes == {}
    monkeypatch.undo()
    assert read(name, types.SimpleNamespace(device_trace=None, notes={})) is None
