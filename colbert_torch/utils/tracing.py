"""Spans, counters and phase timing (the port's counterpart of
``colbert_tpu.utils.tracing``).

**Spans and counters.** The program opens a span at each layer boundary
(``with span("tokenize"):``) and counts work there (``count("doc_tokens",
n)``). Both record only while one of two things holds:

- an operator's ``with recording() as t:`` is open, process-wide: spans
  and counters go into ``t`` (``t.spans``, ``t.counters``, ``t.dropped``);
- ``torch.profiler`` runs on the calling thread
  (``torch.autograd._profiler_enabled()``, a per-thread flag): they go
  into the process recorder, which :func:`take` hands over and empties.
  Each span then also opens a ``record_function`` range of its name, so
  the program's spans appear in any Chrome trace (:func:`profile_trace`'s
  included).

Otherwise a span site costs one check and returns a shared no-op context
(no allocation, no ``record_function``, no CUDA event, no synchronize),
and a count site costs the same check. Recording never changes a route:
a captured serving program is replayed whether it is on or off.

Inside :func:`diverted` (a CUDA graph capture, which runs nothing) the
calling thread's spans record nothing and its counts go into the block's
own dict, whether or not anything records: the captured program adds
them back on each replay (:mod:`colbert_torch.retrieval.program`).

A :class:`Span` holds its name, start and end in integer nanoseconds on
the clock of the profiler's events (``kineto_results.events()``'s
``start_ns()``: Unix-epoch nanoseconds, ``time.time_ns()``'s; a recorder
maps the monotonic clock onto it once, at its first span), the index of
its parent (the innermost span open on the same thread, -1 for a root),
a request id and the thread's id. A span opened with ``request=NEW``
draws a fresh id; one given an id keeps it; any other inherits its
parent's. A recorder keeps at most ``capacity`` spans and counts the rest
as ``dropped``.

**Phase timing.** :class:`Tracer` sums named phases. :meth:`Tracer.phase`
times a phase on the host clock or, given a CUDA device, between two CUDA
events read when :meth:`Tracer.as_dict` is called (the index build's
``plan.json`` timings: no phase waits for the device). Every phase is
also a span of its name. :func:`device_phase` is the eager stage timing
(``Searcher.tracer``, ``DeviceIndex``'s ``tracer=``): per-stage device
times on the eager route, for debugging; it synchronizes the device at
each stage end, so it is never on a path that is measured.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch
from torch.autograd import _profiler_enabled

__all__ = ["NEW", "Recorder", "Span", "Tracer", "active", "count", "device_phase",
           "diverted", "profile_trace", "recording", "span", "take"]

# ``span(..., request=NEW)`` draws a fresh request id
NEW = -1
# spans a recorder keeps before it counts the rest as dropped
CAPACITY = 1 << 20


class Span:
    """One recorded span (times in ns on the profiler's clock; ``end_ns``
    is 0 while it is open) and, while open, the context that closes it."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "thread",
                 "_rec", "_index", "_range")

    def __init__(self, rec: "Recorder", name: str, request: int | None):
        self._rec = rec
        self.name = name
        self.request = request

    def __enter__(self) -> "Span":
        rec = self._rec
        stack = _open_spans()
        top = stack[-1] if stack else None
        if self.request is None:
            self.request = top.request if top is not None else 0
        elif self.request == NEW:
            self.request = next(_requests)
        self.parent = top._index if top is not None and top._rec is rec else -1
        self.thread = threading.get_ident()
        self.end_ns = 0
        self._index = rec._append(self)
        stack.append(self)
        self._range = None
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = rec.now()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = self._rec.now()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _open_spans().pop()  # spans close in the order a thread opened them
        return False


class _NoSpan:
    """The shared context of a span site while nothing records."""

    __slots__ = ()
    request = None

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class Recorder:
    """Spans (at most ``capacity``; the rest counted in ``dropped``) and
    counters of one recording."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.dropped = 0
        self._lock = threading.Lock()
        self._offset: int | None = None

    def now(self) -> int:
        """ns on the profiler's clock: the monotonic clock, mapped onto
        the Unix epoch at this recorder's first reading."""
        t = time.perf_counter_ns()
        if self._offset is None:
            self._offset = time.time_ns() - t
        return t + self._offset

    def _append(self, s: Span) -> int:
        with self._lock:
            if len(self.spans) >= self.capacity:
                self.dropped += 1
                return -1
            self.spans.append(s)
            return len(self.spans) - 1

    def _count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n


_requests = itertools.count(1)
_local = threading.local()
_active: Recorder | None = None  # an operator's recording()
_profiled = Recorder()  # spans recorded under torch.profiler
_diverting = 0  # threads inside diverted() now
_diverting_lock = threading.Lock()


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _diverted_counts() -> dict | None:
    """The calling thread's :func:`diverted` dict, or None."""
    return getattr(_local, "diverted", None) if _diverting else None


def active() -> bool:
    """Whether count sites record on this thread now (guards a count whose
    value costs work to compute)."""
    return _active is not None or _profiler_enabled() or _diverted_counts() is not None


def span(name: str, request: int | None = None):
    """A context that records the span ``name`` while recording is on (a
    shared no-op otherwise, and inside :func:`diverted`); ``request``:
    ``NEW``, an id, or None to inherit the parent's. The context's
    ``request`` is the span's id (None when nothing records)."""
    if _active is None and not _profiler_enabled() or _diverted_counts() is not None:
        return _NO_SPAN
    return Span(_active or _profiled, name, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on (to the
    :func:`diverted` dict inside one)."""
    diverted_to = _diverted_counts()
    if diverted_to is not None:
        diverted_to[name] = diverted_to.get(name, 0) + n
    elif _active is not None or _profiler_enabled():
        (_active or _profiled)._count(name, n)


@contextlib.contextmanager
def diverted() -> Iterator[dict]:
    """For the block, on the calling thread: spans record nothing and every
    count goes into the yielded dict (name -> total), recording or not."""
    global _diverting
    prev = getattr(_local, "diverted", None)
    counts: dict[str, int] = {}
    _local.diverted = counts
    with _diverting_lock:
        _diverting += 1
    try:
        yield counts
    finally:
        _local.diverted = prev
        with _diverting_lock:
            _diverting -= 1


@contextlib.contextmanager
def recording(capacity: int = CAPACITY) -> Iterator[Recorder]:
    """Record every thread's spans and counters into a fresh
    :class:`Recorder` for the block."""
    global _active
    rec, prev = Recorder(capacity), _active
    _active = rec
    try:
        yield rec
    finally:
        _active = prev


def take() -> Recorder:
    """The process recorder (what was recorded under ``torch.profiler``
    outside any :func:`recording`), replaced by an empty one."""
    global _profiled
    rec, _profiled = _profiled, Recorder()
    return rec


class _Phase:
    __slots__ = ("tracer", "name", "device", "span", "t0", "start")

    def __init__(self, tracer: "Tracer", name: str, device):
        self.tracer, self.name, self.device = tracer, name, device

    def __enter__(self) -> "_Phase":
        self.span = span(self.name)
        self.span.__enter__()
        if self.device is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self.tracer
        if self.device is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            tr._events.append((self.name, self.start, end))
        else:
            tr.timings[self.name] = tr.timings.get(self.name, 0.0) + time.perf_counter() - self.t0
        tr.counts[self.name] = tr.counts.get(self.name, 0) + 1
        self.span.__exit__(*exc)
        return False


@dataclass
class Tracer:
    """Collects named phase durations."""

    timings: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
    _events: list = field(default_factory=list, repr=False)

    def phase(self, name: str, device: torch.device | str | None = None) -> _Phase:
        """Time a phase under ``name`` (and record it as a span). On a CUDA
        ``device`` its seconds are the device's, from reaching the phase to
        finishing its work, read from two CUDA events at :meth:`as_dict`;
        otherwise the host's wall time."""
        timed = device is not None and torch.device(device).type == "cuda"
        return _Phase(self, name, torch.device(device) if timed else None)

    def as_dict(self) -> dict:
        """name -> {"seconds", "count"}; waits for the device phases' end
        events."""
        for name, start, end in self._events:
            end.synchronize()
            self.timings[name] = self.timings.get(name, 0.0) + start.elapsed_time(end) / 1e3
        self._events.clear()
        return {
            name: {"seconds": round(self.timings[name], 6), "count": self.counts[name]}
            for name in self.timings
        }


@contextlib.contextmanager
def device_phase(tracer: Tracer | None, name: str) -> Iterator[None]:
    """A stage of the eager stage timing: synchronizes the device at the end
    so the phase's wall time covers the work it launched. A no-op (and no
    synchronization, and no span) without a tracer."""
    if tracer is None:
        yield
        return
    with tracer.phase(name):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(trace_dir: str | None) -> Iterator[None]:
    """``torch.profiler`` trace of the block, written into ``trace_dir`` as a
    Chrome trace file (CPU ops, and CUDA kernels when a GPU is present);
    a no-op when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
