"""One run of one cell: the clock of set-up, the measured window, the
benchmark's own host spans, the device trace and its reduction, and the
card's description.

A driver builds the system, calls :meth:`Run.window` when set-up is done
(the first timed request follows), measures inside it, then frees the
program's state (:meth:`Run.read_memory_peak` first) and checks the answers.
With ``trace`` the window runs under ``torch.profiler`` (CPU and CUDA
activity); nothing else about the run changes.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import gc
import os
import subprocess
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start time in
    ``/proc/self/stat`` against ``/proc/uptime``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card(device: torch.device) -> dict:
    """The card's name (``torch.cuda.get_device_name``) and, from
    ``nvidia-smi``, its power limit."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": "n/a"}
    name = torch.cuda.get_device_name(device)
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", str(device.index or 0)],
                              capture_output=True, text=True, timeout=30)
        limit = done.stdout.strip().split(",")[-1].strip() if done.returncode == 0 else "unknown"
    except (FileNotFoundError, subprocess.TimeoutExpired):
        limit = "unknown"
    return {"name": name, "power_limit": limit}


@dataclass
class Trace:
    """The device side of a traced window. Times in seconds; ``kernels``
    holds (name, start, end, stream) of every device operation inside the
    window, in start order."""
    window_s: float
    busy_s: float
    kernels: list
    by_name: dict
    gaps_by_span: dict


@dataclass
class Run:
    workload: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    workdir: str
    card: dict = field(default_factory=dict)
    # the configuration's architecture module and its widths
    # (:func:`benchmark.registry.arch_of`)
    arch: object = None
    widths: dict = field(default_factory=dict)
    spans: dict = field(default_factory=lambda: defaultdict(list))
    counters: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    notes: dict = field(default_factory=dict)
    setup_phases: dict = field(default_factory=dict)
    setup_s: float | None = None
    window_s: float | None = None
    memory_peak_bytes: int = 0
    device_trace: Trace | None = None
    _prof: object = None

    # -- host spans ------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a call into the program under ``name`` (also a profiler
        range ``bench.<name>`` in a traced run)."""
        rf = torch.profiler.record_function(f"bench.{name}") if self._prof else None
        if rf:
            rf.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append(time.perf_counter() - t)
            if rf:
                rf.__exit__(None, None, None)

    def wrap(self, obj, method: str, name: str | None = None) -> None:
        """Replace ``obj.method`` on this instance by a spanned call."""
        inner = getattr(obj, method)

        @functools.wraps(inner)
        def spanned(*a, **kw):
            with self.span(name or method):
                return inner(*a, **kw)

        setattr(obj, method, spanned)

    # -- the window ------------------------------------------------------

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        """Set-up ends at entry; yields the window's start on
        ``time.perf_counter``. The spans start afresh here."""
        self.sync()
        # set-up's objects stay out of the collector's scans in the window
        gc.collect()
        gc.freeze()
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        self.spans.clear()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        rf = torch.profiler.record_function(WINDOW) if self._prof else None
        t0 = time.perf_counter()
        self.setup_s = process_age_s()
        if rf:
            rf.__enter__()
        try:
            yield t0
            self.sync()
        finally:
            gc.unfreeze()
            self.window_s = time.perf_counter() - t0
            if rf:
                rf.__exit__(None, None, None)
            if self._prof:
                prof, self._prof = self._prof, None
                prof.__exit__(None, None, None)
                self.device_trace = reduce_trace(_records(prof))

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a step of set-up; the steps are noted in the result."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.setup_phases[name] = self.setup_phases.get(name, 0.0) + time.perf_counter() - t

    def read_memory_peak(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _records(prof):
    """-> (name, on the device, start s, end s, stream) of every profiler
    event, read from the profiler's own records (building its Python event
    tree takes minutes for a window of builds)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() != DeviceType.CPU:
            continue  # the device's copy of a host range
        s = e.start_ns() / 1e9
        out.append((e.name(), e.device_type() != DeviceType.CPU, s, s + e.duration_ns() / 1e9,
                    e.device_resource_id()))
    return out


def reduce_trace(records) -> Trace | None:
    """Profiler records (:func:`_records`) -> :class:`Trace` of the
    ``bench.window`` range."""
    win = [r for r in records if r[0] == WINDOW and not r[1]]
    if not win:
        return None
    w0, w1 = win[0][2], win[0][3]
    kernels, spans = [], []
    for name, on_device, s, t, stream in records:
        if on_device:
            s, t = max(s, w0), min(t, w1)
            if t > s and not name.startswith("bench."):
                kernels.append((name, s, t, stream))
        elif name.startswith("bench.") and name != WINDOW:
            spans.append((s, t, name[len("bench."):]))
    kernels.sort(key=lambda k: k[1])
    busy = _union([(k[1], k[2]) for k in kernels])
    by_name = defaultdict(float)
    for name, s, t, _ in kernels:
        by_name[name] += t - s
    # idle gaps, each put down to the benchmark span the host was in at its
    # middle (the latest-starting one that covers it; spans are short, so
    # it lies among the last few that started before the middle)
    gaps_by_span = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans.sort()
    starts = [s for s, _, _ in spans]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = "other"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 64), -1):
            if spans[j][1] >= mid:
                label = spans[j][2]
                break
        gaps_by_span[label] += b - a
    return Trace(window_s=w1 - w0, busy_s=sum(e - s for s, e in busy),
                 kernels=kernels, by_name=dict(by_name), gaps_by_span=dict(gaps_by_span))


def kernel_seconds(trace: Trace, match) -> tuple[float, int]:
    """(seconds, launches) of the device operations whose name ``match`` accepts."""
    sel = [k for k in trace.kernels if match(k[0])]
    return sum(k[2] - k[1] for k in sel), len(sel)


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
