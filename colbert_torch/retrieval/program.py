"""Captured serving programs: one CUDA graph per static search key (the
port's counterpart of the JAX package's jitted ``_search_batch`` and
``_search_tokens``).

The JAX package serves a query batch as ONE compiled program (query encode,
probe, stage 1, refine, stage 2, top-k) and launches it without blocking.
Here a :class:`Program` captures the same sequence of launches once per
static key into a ``torch.cuda.CUDAGraph`` and replays it:

- its inputs are static device buffers (token ids and mask, or ``Q``),
  filled before each replay from pinned host staging with
  ``non_blocking=True``; a staging slot is rewritten only after the event
  of its last copy has completed;
- its outputs (pids, scores, overflow) are copied after each replay, on the
  same stream, into fresh pinned host tensors that the launch owns, and an
  event marks them ready: nothing waits on the device until the caller reads
  them, so a later replay never overwrites an earlier batch's results;
- one lock per program covers copy-in, replay and copy-out;
- while spans record (:mod:`colbert_torch.utils.tracing`), a launch is the
  span ``program_launch`` > ``copy_in``, ``replay``, ``copy_out`` (or
  ``capture`` on a key's first launch), and two timing events on the
  replay stream bracket the replay; the caller reads them once ``ready``
  has completed (``DeviceIndex.finalize``), so they never block. Nothing
  is recorded inside a capture, and the route is the same either way.

The first run of a key is the warm-up: it runs the function eagerly on the
static buffers (the batch's own results) on a capture stream, then captures
it under ``capture_error_mode="thread_local"`` (the batcher and the HTTP
server search from threads other than the main one). Every replay of every
program runs on one replay stream per device, which waits for the caller's
stream before it starts and which the caller's stream waits for after it,
so in-place weight updates (training) order with serving as in eager
execution. A capture or a replay that fails raises; nothing runs the eager
route in its place.

A replay never enters the kernels' Python wrappers, so the launches a
capture records (``stage2_maxsim``, ``flash_attention`` and
``approx_maxsim`` counts, by kernel, and ``flash_attention``'s windowed
launches) are taken back out of the counts after the capture and added on
each replay: the counts keep saying how many times each kernel ran. The
capture's tracing counts (:func:`colbert_torch.utils.tracing.diverted`:
ModernBERT's attention routes, the windowed tile pairs) are added to each
replay's in the same way.

A launch can also leave its outputs on the device (``to_host=False``, the
doc encoder's codec and sample buffer): the caller reads them on its own
stream, which waits for the replay, and the next launch of the program
waits for that stream before it overwrites them.

:class:`ProgramCache` keys programs on the search knobs, the batch shape
and the addresses, shapes and dtypes of every tensor a program reads (so a
tensor replaced by ``rebalance``, a reload or a re-bound parameter gives a
new key, and a stale program is never replayed) and keeps at most
``MAX_PROGRAMS`` of them, least recently used first out. On the CPU a
program runs its function eagerly on the same static buffers at every
launch: the tests drive the buffers, the keys and the result ownership
there, and capture and replay only on the card.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from colbert_torch.utils import tracing

__all__ = ["Program", "ProgramCache", "MAX_PROGRAMS", "STAGING_SLOTS",
           "capture", "input_dtype", "tensor_signature"]

# programs kept per index: every batch bucket of one operating point
# (Searcher.QUERY_BATCH_BUCKETS) fits, a sweep of points cycles through
MAX_PROGRAMS = 8
# pinned staging slots per program input: a slot is reused STAGING_SLOTS
# launches later, long after its copy has completed
STAGING_SLOTS = 4

_capture_lock = threading.Lock()
_streams: dict[int, tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}


def _device_streams(device: torch.device) -> tuple[torch.cuda.Stream, torch.cuda.Stream]:
    """(capture stream, replay stream) of a card, shared by every program on
    it: replays serialize on one stream, so graphs captured on one stream
    (and sharing its cuBLAS workspace) never run at once."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _capture_lock:
        if index not in _streams:
            _streams[index] = (torch.cuda.Stream(index), torch.cuda.Stream(index))
        return _streams[index]


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, stream: torch.cuda.Stream):
    """``torch.cuda.graph`` on ``stream`` in thread-local mode, with the
    interpreter's cyclic garbage collector held off: a collection during
    the capture may finalize an unreachable program (its graph, its pool,
    its events), and those CUDA calls are illegal while a stream captures
    (the process aborts). ``torch.cuda.graph`` collects once on entry."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            yield
    finally:
        if enabled:
            gc.enable()


def tensor_signature(tensors: Sequence[torch.Tensor | None]) -> tuple:
    """(address, shape, dtype) of each tensor: what a captured program bakes
    in about the tensors it reads."""
    return tuple(None if t is None else (t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in tensors)


def input_dtype(array) -> torch.dtype:
    """The device dtype of a host batch array: int32 token ids widen to
    int64, as ``ColBERTEncoder._put_batch`` widens them."""
    dtype = torch.as_tensor(array[:0]).dtype
    return torch.int64 if dtype == torch.int32 else dtype


def _counted_wrappers():
    from colbert_torch.ops.approx_maxsim import approx_maxsim
    from colbert_torch.ops.flash_attention import flash_attention
    from colbert_torch.ops.fused_maxsim import stage2_maxsim

    return (stage2_maxsim, flash_attention, approx_maxsim)


def _launch_counts() -> list[dict]:
    return [dict(w.variant_launches) for w in _counted_wrappers()]


def _add_launches(delta: list[dict], sign: int = 1) -> None:
    for w, d in zip(_counted_wrappers(), delta):
        for variant, n in d.items():
            w.variant_launches[variant] += sign * n
            w.launches += sign * n


def _window_launches() -> int:
    from colbert_torch.ops.flash_attention import flash_attention

    return flash_attention.window_launches


def _add_window_launches(n: int) -> None:
    from colbert_torch.ops.flash_attention import flash_attention

    flash_attention.window_launches += n


class Program:
    """One static program: ``fn(*inputs) -> tuple of output tensors`` over
    static input buffers of the given shapes and dtypes on ``device``."""

    def __init__(self, fn: Callable, shapes: Sequence[tuple], dtypes: Sequence[torch.dtype],
                 device: torch.device):
        self.fn = fn
        self.device = device
        self.cuda = device.type == "cuda"
        self.inputs = [torch.empty(s, dtype=d, device=device) for s, d in zip(shapes, dtypes)]
        self.outputs = None
        self.graph = None
        self.lock = threading.Lock()
        self.launches = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._delta = None  # kernel launches one replay makes
        self._windowed = 0  # windowed flash launches one replay makes
        self._counts: dict[str, int] = {}  # tracing counts one replay makes
        if self.cuda:
            self._staging = [[torch.empty(s, dtype=d, pin_memory=True) for s, d in
                              zip(shapes, dtypes)] for _ in range(STAGING_SLOTS)]
            self._staged = [None] * STAGING_SLOTS
            self._slot = 0

    def _copy_in(self, stream, host: Sequence) -> None:
        """Host arrays or tensors (any device) -> the static input buffers."""
        if not self.cuda:
            for buf, a in zip(self.inputs, host):
                buf.copy_(torch.as_tensor(a))
            return
        slot = self._slot
        self._slot = (slot + 1) % STAGING_SLOTS
        if self._staged[slot] is not None and not self._staged[slot].query():
            tracing.count("program_staging_waits")
            self._staged[slot].synchronize()
        for buf, pinned, a in zip(self.inputs, self._staging[slot], host):
            if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                buf.copy_(a)
                a.record_stream(stream)
                continue
            pinned.copy_(torch.as_tensor(a))
            buf.copy_(pinned, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
        self._staged[slot] = event

    def launch(self, *host, to_host: bool = True
               ) -> tuple[list[torch.Tensor], torch.cuda.Event | None, tuple | None]:
        """Fill the inputs from ``host`` and run the program -> (output
        tensors this launch owns, the event after which they are readable,
        or None on the CPU, and while tracing records the (start, end)
        timing events around a replay, else None). With ``to_host`` False
        the outputs stay on the device and the event is None: the caller's
        stream reads them, and they hold until the next launch of this
        program."""
        with tracing.span("program_launch"), self.lock, torch.no_grad():
            self.launches += 1
            if not self.cuda:
                with tracing.span("copy_in"):
                    self._copy_in(None, host)
                with tracing.span("replay"):
                    outs = self.fn(*self.inputs)
                if not to_host:
                    return list(outs), None, None
                with tracing.span("copy_out"):
                    return [o.clone() for o in outs], None, None
            capture_stream, replay_stream = _device_streams(self.device)
            caller = torch.cuda.current_stream(self.device)
            timing = None
            if self.graph is None:
                with tracing.span("capture"):
                    outs = self._warm_up_and_capture(capture_stream, host)
                tracing.count("program_captures")
                stream = capture_stream
            else:
                with torch.cuda.stream(replay_stream):
                    with tracing.span("copy_in"):
                        replay_stream.wait_stream(caller)
                        self._copy_in(replay_stream, host)
                    with tracing.span("replay"):
                        if tracing.active():
                            timing = (torch.cuda.Event(enable_timing=True),
                                      torch.cuda.Event(enable_timing=True))
                            timing[0].record(replay_stream)
                        self.graph.replay()
                        if timing is not None:
                            timing[1].record(replay_stream)
                        _add_launches(self._delta)
                        _add_window_launches(self._windowed)
                        for name, n in self._counts.items():
                            tracing.count(name, n)
                        self.replays += 1
                tracing.count("program_replays")
                outs, stream = self.outputs, replay_stream
            if not to_host:
                caller.wait_stream(stream)
                if stream is capture_stream:  # the warm-up's own outputs
                    for o in outs:
                        o.record_stream(caller)
                return list(outs), None, timing
            with tracing.span("copy_out"):
                with torch.cuda.stream(stream):
                    host_outs = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                                 for o in outs]
                    for h, o in zip(host_outs, outs):
                        h.copy_(o, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(stream)
                caller.wait_stream(stream)
        return host_outs, ready, timing

    def _warm_up_and_capture(self, stream, host) -> list[torch.Tensor]:
        """The key's first launch: the function run eagerly on the static
        buffers (its outputs are this batch's results), then captured."""
        with _capture_lock:
            t0 = time.perf_counter()
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                self._copy_in(stream, host)
                warm = [o.clone() for o in self.fn(*self.inputs)]
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            before, windowed = _launch_counts(), _window_launches()
            graph = torch.cuda.CUDAGraph()
            with capture(graph, stream), tracing.diverted() as counts:
                self.outputs = list(self.fn(*self.inputs))
            after = _launch_counts()
            self._delta = [{v: a[v] - b[v] for v in a} for a, b in zip(after, before)]
            self._windowed = _window_launches() - windowed
            self._counts = counts
            _add_launches(self._delta, -1)  # the capture ran nothing
            _add_window_launches(-self._windowed)
            self.graph = graph
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
            self.capture_s = time.perf_counter() - t0
        return warm


class ProgramCache:
    """At most ``capacity`` programs by key, least recently used evicted."""

    def __init__(self, capacity: int = MAX_PROGRAMS):
        self.capacity = capacity
        self._programs: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.built = 0  # programs made since the cache was created

    def get(self, key, make: Callable[[], Program]) -> Program:
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                return prog
            prog = make()
            self._programs[key] = prog
            self.built += 1
            while len(self._programs) > self.capacity:
                self._programs.popitem(last=False)
            return prog

    def rekey(self, old, new) -> None:
        """File the program of ``old`` under ``new``: what it reads has
        changed identity under it (a training step's first launch makes the
        optimizer's state)."""
        with self._lock:
            prog = self._programs.pop(old, None)
            if prog is not None:
                self._programs[new] = prog

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()

    def __len__(self) -> int:
        return len(self._programs)

    def programs(self) -> list[Program]:
        with self._lock:
            return list(self._programs.values())

    def stats(self) -> dict:
        """Programs held, built, their capture seconds and pool bytes."""
        progs = self.programs()
        return dict(held=len(progs), built=self.built,
                    capture_s=float(np.sum([p.capture_s for p in progs])),
                    pool_bytes=int(np.sum([p.pool_bytes for p in progs])),
                    replays=int(np.sum([p.replays for p in progs])))
