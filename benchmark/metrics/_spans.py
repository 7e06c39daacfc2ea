"""The program's own spans and counters in a traced run (not a metric: the
registry skips files whose name starts with ``_``).

A program whose ``colbert_torch.utils.tracing`` records spans while
``torch.profiler`` runs keeps them in a process recorder; :func:`get` takes
it once after the window and reduces it:

- device idle is the complement of the union of the traced device
  operations, between the window's first and last of them; each stretch of
  it is put down to the innermost program span open on the calling thread
  (the driver's) at that time, or to none;
- every span's self time (its duration less its children's) per request
  (the distinct request ids: a search batch, a build), its mean duration
  and count, and the program's counters.

Both go into the run's notes (``idle_by_program_span``: seconds and % of
the window per innermost span name, ``(none)`` where no span was open;
``program_spans``). A program without that recorder, or a run without a
trace, gives None and notes nothing.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass

NONE = "(none)"


@dataclass
class ProgramTrace:
    """``spans``: (name, start s, end s, parent index, request, thread) on
    the device trace's clock; ``idle``: span index (-1 for none) -> idle
    seconds of the calling thread; ``window_s``: the traced window."""
    spans: list
    counters: dict
    idle: dict
    window_s: float
    dropped: int = 0

    def ancestry(self, i: int):
        """``i``, its parent, its parent's parent, ... (indexes)."""
        while i >= 0:
            yield i
            i = self.spans[i][3]

    def idle_where(self, accept) -> float:
        """Idle seconds whose innermost span index ``accept`` takes (-1 for none)."""
        return sum(s for i, s in self.idle.items() if accept(i))

    def unexplained_s(self) -> float:
        """Idle while no span, or only a root span, was open."""
        return self.idle_where(lambda i: i < 0 or self.spans[i][3] < 0)

    def idle_s(self) -> float:
        return sum(self.idle.values())

    def durations(self, name: str) -> list:
        return [e - s for n, s, e, *_ in self.spans if n == name]

    def self_s(self) -> dict:
        """name -> total self seconds (duration less the children's)."""
        own = [e - s for _, s, e, *_ in self.spans]
        for _, s, e, parent, *_ in self.spans:
            if parent >= 0:
                own[parent] -= e - s
        out = defaultdict(float)
        for (name, *_), t in zip(self.spans, own):
            out[name] += t
        return dict(out)


def busy_intervals(kernels) -> list:
    """Union of the (name, start, end, stream) operations, in start order."""
    out = []
    for _, s, e, _ in kernels:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def innermost_segments(spans) -> list:
    """(start, end, index) stretches in which span ``index`` is the
    innermost open one, from (start, end, index) spans of one thread, which
    nest; stretches with no span open are left out."""
    segs, stack, t = [], [], float("-inf")

    def close_until(x):
        nonlocal t
        while stack and stack[-1][0] <= x:
            end, i = stack.pop()
            if end > t:
                segs.append((t, end, i))
                t = end

    for s, e, i in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        if stack and s > t:
            segs.append((t, s, stack[-1][1]))
        t = max(t, s)
        stack.append((e, i))
    close_until(float("inf"))
    return segs


def attribute(trace, spans, thread) -> dict:
    """Span index (-1 for none) -> seconds of device idle during which it
    was the innermost span open on ``thread``. ``trace`` is the run's
    ``Trace``; ``spans`` as :class:`ProgramTrace` holds them."""
    busy = busy_intervals(trace.kernels)
    idle = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    segs = innermost_segments([(s, e, i) for i, (_, s, e, _, _, th) in enumerate(spans)
                               if th == thread and e > s])
    out = defaultdict(float)
    j = 0
    for a, b in idle:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] += hi - lo
                covered += hi - lo
            k += 1
        if b - a - covered > 0:
            out[-1] += b - a - covered
    return dict(out)


def _take():
    """The program's process recorder, or None where the program has none."""
    try:
        from colbert_torch.utils import tracing
    except ImportError:
        return None
    take = getattr(tracing, "take", None)
    return take() if take is not None else None


def get(r) -> ProgramTrace | None:
    """The run's :class:`ProgramTrace` (taken and noted once), or None."""
    if not hasattr(r, "_program_trace"):
        r._program_trace = _read(r)
    return r._program_trace


def _read(r) -> ProgramTrace | None:
    if r.device_trace is None:
        return None
    rec = _take()
    if rec is None or not rec.spans:
        return None
    # a span still open when the recorder was taken counts as empty
    spans = [(s.name, s.start_ns / 1e9, max(s.start_ns, s.end_ns) / 1e9, s.parent, s.request,
              s.thread) for s in rec.spans]
    pt = ProgramTrace(spans=spans, counters=dict(rec.counters),
                      idle=attribute(r.device_trace, spans, threading.get_ident()),
                      window_s=r.device_trace.window_s, dropped=rec.dropped)
    _note(r, pt)
    return pt


def _note(r, pt: ProgramTrace) -> None:
    by_name = defaultdict(float)
    for i, s in pt.idle.items():
        by_name[NONE if i < 0 else pt.spans[i][0]] += s
    r.notes["idle_by_program_span"] = {
        n: [s, 100.0 * s / pt.window_s]
        for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])}
    requests = len({sp[4] for sp in pt.spans})
    spans = {}
    for name, own in sorted(pt.self_s().items(), key=lambda kv: -kv[1]):
        d = pt.durations(name)
        spans[name] = {"n": len(d), "mean_ms": 1e3 * sum(d) / len(d),
                       "self_ms_per_request": 1e3 * own / requests}
    r.notes["program_spans"] = {"requests": requests, "dropped": pt.dropped,
                                "idle_s": pt.idle_s(), "unexplained_idle_s": pt.unexplained_s(),
                                "spans": spans, "counters": pt.counters}
