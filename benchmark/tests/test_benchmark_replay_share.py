"""The doc encoder's replay share (``encode.replay_share.build``) on
hand-made program counters: None where the program counts no route (no
counters at all, or only the older ``doc_batches``), 100 where every batch
replayed, 0 where every batch ran op by op, and the share between."""

import threading
import types

import pytest

from benchmark import registry
from benchmark.metrics import _spans

NAME = "encode.replay_share.build"


def run_of(monkeypatch, counters):
    span = types.SimpleNamespace(name="index", start_ns=0, end_ns=9_000_000_000, parent=-1,
                                 request=1, thread=threading.get_ident())
    rec = types.SimpleNamespace(spans=[span], counters=counters, dropped=0)
    monkeypatch.setattr(_spans, "_take", lambda: rec)
    trace = types.SimpleNamespace(window_s=10.0, busy_s=4.0, kernels=[], by_name={},
                                  gaps_by_span={})
    return types.SimpleNamespace(device_trace=trace, notes={})


@pytest.mark.parametrize("counters, want", [
    ({}, None),
    ({"doc_batches": 12, "doc_tokens": 300, "doc_slots": 400}, None),
    ({"doc_batches": 12, "doc_replays": 12}, 100.0),
    ({"doc_batches": 3, "doc_eager_batches": 3}, 0.0),
    ({"doc_batches": 40, "doc_replays": 39, "doc_eager_batches": 1, "doc_captures": 0}, 97.5),
])
def test_replay_share_reads_the_counters(monkeypatch, counters, want):
    got = registry.metric(NAME).read(run_of(monkeypatch, counters))
    assert got == (None if want is None else pytest.approx(want))


def test_replay_share_reads_none_without_a_trace():
    assert registry.metric(NAME).read(types.SimpleNamespace(device_trace=None, notes={})) is None


def test_replay_share_is_a_build_metric():
    m = registry.metric(NAME)
    assert m.DRIVERS == ("build",) and m.MOVES == "index_passages_per_s" and m.UNIT == "%"
    assert NAME in registry.metrics_for("build") and NAME not in registry.metrics_for("stream")
