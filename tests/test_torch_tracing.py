"""The port's spans and counters (``colbert_torch.utils.tracing``) on the
CPU: nothing is recorded, and no profiler range, CUDA event or synchronize
comes from tracing, while recording is off; with it on, a search batch and
a build give the span trees of their layer boundaries, one request id per
batch and per build; the buffer is bounded; spans start on the clock of
the profiler's ranges (with CUDA activity too, where a card is present);
the index build's phase timings come from CUDA events, never a synchronize."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from colbert_torch.config import ColBERTConfig
from colbert_torch.indexing.builder import Indexer
from colbert_torch.retrieval.device_index import DeviceIndex
from colbert_torch.retrieval.searcher import Searcher
from colbert_torch.utils import tracing
from colbert_torch.utils.testing import make_encoder, synthetic_collection

CFG = dict(dim=32, doc_maxlen=64, query_maxlen=16, index_bsize=8, length_bucket=16,
           kmeans_niters=2, nbits=2)
PHASES = {"sample_encode", "codec_train", "chunk_encode_compress", "build_ivf"}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    enc = make_encoder(dim=32, config=ColBERTConfig(**CFG), device="cpu")
    passages = synthetic_collection(60, seed=1, words_per_doc=20)
    path = str(tmp_path_factory.mktemp("trace") / "idx")
    Indexer(enc.config, encoder=enc, collection=passages, device="cpu").index(path)
    return enc, passages, path


@pytest.fixture
def searcher(built):
    enc, _, path = built
    return Searcher(path, encoder=enc, device="cpu")


@pytest.fixture(autouse=True)
def empty_process_recorder():
    tracing.take()
    yield
    tracing.take()


def _tree(rec) -> list:
    """(depth, name, parent name) of every span, in recording order."""
    out = []
    for s in rec.spans:
        depth, p = 0, s.parent
        while p >= 0:
            depth, p = depth + 1, rec.spans[p].parent
        out.append((depth, s.name, rec.spans[s.parent].name if s.parent >= 0 else None))
    return out


def _forbid(monkeypatch, *names):
    def refuse(*a, **kw):
        raise AssertionError("tracing touched the profiler or the device")

    for name in names:
        monkeypatch.setattr(name, refuse)


def test_off_records_nothing_and_touches_nothing(built, searcher, monkeypatch, tmp_path):
    enc, passages, _ = built
    _forbid(monkeypatch, "torch.profiler.record_function", "torch.cuda.Event",
            "torch.cuda.synchronize")
    assert not tracing.active()
    assert tracing.span("a") is tracing.span("b")  # one shared no-op
    with tracing.span("a", request=tracing.NEW) as sp:
        tracing.count("c")
    assert sp.request is None
    list(searcher.search_stream([passages[:3], passages[3:4]], k=3))
    Indexer(enc.config, encoder=enc, collection=passages[:40],
            device="cpu").index(str(tmp_path / "idx"))
    rec = tracing.take()
    assert rec.spans == [] and rec.counters == {} and rec.dropped == 0


@pytest.mark.parametrize("route", ["eager", "program"])
def test_a_search_batch_gives_its_span_tree(built, searcher, monkeypatch, route):
    """The CPU's eager route (its query encode's copy-in and launches are
    ``h2d`` and ``forward``), and the program route forced on the CPU (a
    program there runs its function on its static buffers)."""
    _, passages, _ = built
    if route == "program":
        monkeypatch.setattr(
            DeviceIndex, "search_tokens_batch_async",
            lambda self, enc, ids, mask, *, k, tracer=None, **kw:
                self._program_search_tokens(enc, ids, mask, k=k, **kw))
    with tracing.recording() as rec:
        handle = searcher.launch_search(passages[:3], k=3)
        pids, _ = searcher.finish_search(handle, k=3)
    assert pids.shape == (3, 3)
    program = [(2, "program_key", "launch_search"), (2, "program_launch", "launch_search"),
               (3, "copy_in", "program_launch"), (3, "replay", "program_launch"),
               (3, "copy_out", "program_launch")]
    assert _tree(rec) == [
        (0, "launch_search", None), (1, "program_key", "launch_search"),
        (1, "tokenize", "launch_search")] + (
        [(1, n, p) if d == 2 else (2, n, p) for d, n, p in program] if route == "program"
        else [(1, "h2d", "launch_search"), (1, "forward", "launch_search")]) + [
        (0, "finish_search", None), (1, "wait", "finish_search"),
        (1, "read_back", "finish_search"), (1, "read_back", "finish_search")]
    assert {s.request for s in rec.spans} == {handle.request} and handle.request > 0
    assert all(0 < s.start_ns <= s.end_ns for s in rec.spans)
    assert {s.thread for s in rec.spans} == {threading.get_ident()}
    assert rec.counters == {"search_batches": 1, "search_queries": 3, "search_pad_rows": 1,
                            "query_tokenize_native": 4, "query_tokenize_fallback": 0}


def test_each_batch_and_each_build_draws_its_own_request(built, searcher, tmp_path):
    enc, passages, _ = built
    with tracing.recording() as rec:
        list(searcher.search_stream([passages[:2], passages[2:4], passages[4:5]], k=2))
        Indexer(enc.config, encoder=enc, collection=passages[:40],
                device="cpu").index(str(tmp_path / "idx"))
    roots = [s for s in rec.spans if s.parent < 0]
    assert [s.name for s in roots] == ["launch_search", "launch_search", "finish_search",
                                       "launch_search", "finish_search", "finish_search",
                                       "index"]
    ids = [s.request for s in roots]
    assert ids[0] == ids[2] and ids[1] == ids[4] and ids[3] == ids[5]
    assert len(set(ids)) == 4
    build = [s for s in rec.spans if s.request == ids[-1]]
    assert {s.name for s in build} >= {"index", "sample_encode", "plan", "codec_train",
                                       "kmeans", "quantiles", "write_codec",
                                       "chunk_encode_compress", "write_chunk", "build_ivf",
                                       "write_plan", "doc_tokenize", "doc_tensorize",
                                       "doc_dispatch"}


def test_build_counters(built, tmp_path):
    """``doc_tokens`` and ``doc_slots`` count the mask's ones and B x L of
    every encoded batch; each batch is a replay of its key's program (the
    full ones; a key's first batch counts as a capture) or an eager one (the
    group's last, partial batch); ``kmeans_iters`` the iterations run."""
    enc, passages, _ = built
    with tracing.recording() as rec:
        enc.encode_passages_compressed(passages[:20], torch.zeros((8, 32)),
                                       torch.zeros((3,)), nbits=2)
    tokens = slots = batches = full = 0
    for _, ids, mask, _ in enc._doc_batches(passages[:20]):
        tokens, slots, batches = tokens + int(mask.sum()), slots + mask.size, batches + 1
        full += ids.shape[0] == CFG["index_bsize"]
    c = dict(rec.counters)
    replays, eager, captures = (c.pop(k, 0) for k in
                                ("doc_replays", "doc_eager_batches", "doc_captures"))
    assert c == {"doc_batches": batches, "doc_tokens": tokens, "doc_slots": slots}
    assert 0 < full < batches and replays + eager == batches
    assert replays + captures == full and eager == batches - full + captures
    assert {s.name for s in rec.spans} == {"doc_tokenize", "doc_tensorize", "doc_dispatch",
                                           "h2d", "forward", "doc_drain", "doc_scatter",
                                           "program_launch", "copy_in", "replay"}
    assert all(rec.spans[s.parent].name == "doc_dispatch" for s in rec.spans
               if s.name in ("h2d", "forward"))
    assert all(rec.spans[s.parent].name == "forward" for s in rec.spans
               if s.name == "program_launch")
    with tracing.recording() as rec:
        Indexer(enc.config, encoder=enc, collection=passages[:40],
                device="cpu").index(str(tmp_path / "idx"))
    assert 1 <= rec.counters["kmeans_iters"] <= CFG["kmeans_niters"]


def test_the_buffer_is_bounded_and_counts_drops():
    with tracing.recording(capacity=3) as rec:
        for _ in range(5):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    pass
    assert [s.name for s in rec.spans] == ["outer", "inner", "outer"]
    assert rec.dropped == 7
    assert rec.spans[1].parent == 0 and rec.spans[2].parent == -1


def test_diverted_counts_stay_on_their_thread():
    """Inside ``diverted`` the calling thread's counts go to the block's
    dict, recording or not, and its spans record nothing; another thread
    still records; after the block counting is as before."""
    seen = {}

    def other():
        with tracing.span("worker"):
            tracing.count("elsewhere")
        seen["done"] = True

    with tracing.recording() as rec:
        with tracing.diverted() as counts:
            assert tracing.active()
            with tracing.span("hidden") as s:
                tracing.count("inside", 2)
                tracing.count("inside")
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
        tracing.count("after")
    assert s.request is None and seen["done"]
    assert counts == {"inside": 3}
    assert rec.counters == {"elsewhere": 1, "after": 1}
    assert [sp.name for sp in rec.spans] == ["worker"]
    with tracing.diverted() as counts:
        tracing.count("unrecorded")
    assert counts == {"unrecorded": 1} and not tracing.active()


def test_spans_nest_per_thread_and_record_exceptions():
    seen = {}

    def other():
        with tracing.span("worker") as s:
            seen["parent"] = None
        seen["parent"] = s.parent

    with tracing.recording() as rec:
        with tracing.span("main", request=tracing.NEW) as m:
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            with pytest.raises(ValueError), tracing.span("fails"):
                raise ValueError
            with tracing.span("given", request=7) as g:
                pass
    assert not t.is_alive() and seen["parent"] == -1  # another thread's root
    by_name = {s.name: s for s in rec.spans}
    assert by_name["fails"].parent == 0 and by_name["fails"].end_ns > 0
    assert by_name["fails"].request == m.request and g.request == 7


def test_under_the_profiler_spans_start_with_their_ranges():
    """Each span records into the process recorder and opens a
    ``record_function`` range of its name that starts within 1 ms of the
    span's start (the profiler's own records; the first range of a process
    takes longer to open, so one is opened first, as a benchmark opens its
    window); a thread the profiler does not run on records nothing. With a
    card, CUDA activity is on and the spans enclose device work."""
    from torch.autograd import DeviceType

    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    x = torch.randn(256, 256, device="cuda" if cuda else "cpu")
    with torch.profiler.profile(activities=acts) as prof, \
            torch.profiler.record_function("window"):  # as a benchmark opens its window
        assert tracing.active()
        for i in range(20):
            with tracing.span("outer", request=tracing.NEW):
                with tracing.span("inner"):
                    x = (x @ x).tanh()
                tracing.count("steps")
        t = threading.Thread(target=lambda: tracing.span("elsewhere").__enter__())
        t.start()
        t.join(timeout=30)
        if cuda:
            torch.cuda.synchronize()
    assert not t.is_alive() and not tracing.active()
    rec = tracing.take()
    assert rec.counters == {"steps": 20} and len(rec.spans) == 40
    ranges = {"outer": [], "inner": []}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ranges and e.device_type() == DeviceType.CPU:
            ranges[e.name()].append(e.start_ns())
    for name, starts in ranges.items():
        mine = [s.start_ns for s in rec.spans if s.name == name]
        gaps = np.abs(np.array(sorted(starts)) - np.array(mine))
        assert len(starts) == 20 and gaps.max() < 1e6, (name, gaps)


def test_tracer_phases_on_a_card_read_events_and_never_synchronize(monkeypatch):
    """``Tracer.phase(name, cuda device)`` records two CUDA events and reads
    them at ``as_dict`` (faked here: no card); host phases keep the host
    clock."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t = None
            made.append(self)

        def record(self, stream=None):
            self.t = 1000.0 * len(made)  # ms

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.t - self.t

    monkeypatch.setattr("torch.cuda.Event", Event)
    _forbid(monkeypatch, "torch.cuda.synchronize")
    tr = tracing.Tracer()
    for _ in range(2):
        with tr.phase("encode", "cuda:0"):
            pass
    with tr.phase("write"):
        pass
    assert "encode" not in tr.timings and len(made) == 4
    got = tr.as_dict()
    assert got["encode"] == {"seconds": 2.0, "count": 2}
    assert got["write"]["count"] == 1 and 0 <= got["write"]["seconds"] < 1


@pytest.mark.parametrize("chunk_pass", [False, True])
def test_a_build_times_its_phases_without_a_synchronize(built, monkeypatch, tmp_path,
                                                        chunk_pass):
    """``plan.json`` keeps the phase keys, on the small-collection path and
    in the chunk pass; no phase calls ``torch.cuda.synchronize`` (refused
    here with a card claimed present)."""
    from colbert_torch.indexing import builder

    enc, passages, _ = built
    if chunk_pass:
        monkeypatch.setattr(builder, "FAST_PATH_MAX_ROWS", 0)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    _forbid(monkeypatch, "torch.cuda.synchronize")
    path = str(tmp_path / "idx")
    with tracing.recording() as rec:
        Indexer(ColBERTConfig(**CFG, chunksize=25), encoder=enc, collection=passages,
                device="cpu").index(path)
    with open(os.path.join(path, "plan.json")) as f:
        timings = json.load(f)["timings"]
    assert set(timings) == PHASES
    assert all(v["seconds"] >= 0 and v["count"] >= 1 for v in timings.values())
    assert timings["chunk_encode_compress"]["count"] == (3 if chunk_pass else 1)
    names = [s.name for s in rec.spans]
    assert names.count("write_chunk") == 3
    assert names.count("chunk_encode_compress") == (3 if chunk_pass else 1)
    assert names.count("doc_tokenize") == (4 if chunk_pass else 1)  # the sample, each chunk
