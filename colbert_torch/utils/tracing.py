"""Phase tracing (a copy of ``colbert_tpu.utils.tracing.Tracer``).

Every traced phase adds its wall time and a count under its name;
``as_dict()`` is the structured record. Phases that time device work must
end in a ``torch.cuda.synchronize()`` inside the phase, since CUDA launches
return before the work is done: :class:`colbert_torch.retrieval.searcher.Searcher`
does so only when it is given a tracer, so untraced serving keeps its
launches asynchronous. :func:`profile_trace` writes a ``torch.profiler``
trace (a Chrome trace file) of what runs inside it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch

logger = logging.getLogger(__name__)

__all__ = ["Tracer", "device_phase", "profile_trace"]


@dataclass
class Tracer:
    """Collects named phase durations."""

    timings: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            logger.debug("phase %s: %.4fs", name, dt)

    def as_dict(self) -> dict:
        return {
            name: {"seconds": round(self.timings[name], 6), "count": self.counts[name]}
            for name in self.timings
        }


@contextlib.contextmanager
def device_phase(tracer: Tracer | None, name: str) -> Iterator[None]:
    """A traced stage of device work: synchronizes the device at the end so
    the phase's wall time covers the work it launched. A no-op (and no
    synchronization) without a tracer."""
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
