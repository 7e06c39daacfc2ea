"""Cross-request batching around a Searcher (a copy of
``colbert_tpu.serving.batcher``, numpy and the standard library only).

A search batch costs a fixed host and launch overhead whatever its size,
while throughput grows with the batch, so a serving front coalesces
concurrent single queries into one batched search. This batcher implements
the standard collect-up-to-(max_batch | max_wait) loop over the
``Searcher`` (whose batch-size buckets keep the set of batch shapes small).

The loop runs searches on its own thread. PyTorch's grad mode and current
device are per thread, so every path it reaches holds its own
``no_grad`` and names its device (``Searcher`` and ``DeviceIndex`` do);
it inherits nothing from the caller.

The reference serves one query at a time from a REPL (searching.jl:93-128)
and lists serving infrastructure as future work (README.md:179-190).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

__all__ = ["BatchingSearcher"]


@dataclass
class _Request:
    query: str
    k: int
    future: Future


@dataclass
class BatchingSearcher:
    """Thread-safe batching front over a ``Searcher``.

    ``submit`` returns a Future resolving to ``(pids (k,), scores (k,))``;
    ``search`` is the blocking convenience wrapper. One background thread
    drains the queue: it waits at most ``max_wait_ms`` for the batch to
    fill to ``max_batch``, then issues ONE ``search_batch``. Mixed ``k``
    values batch together (scored at the batch max, sliced per request).

    On the device backend the loop pipelines through
    ``Searcher.launch_search``/``finish_search``: up to ``max_inflight``
    launched batches stay in flight, so batch N+1's host work (queue drain,
    tokenization, launches) overlaps batch N's device execution, the same
    overlap as ``Searcher.search_stream``. Results equal those of the
    sequential path. Other backends search synchronously.
    """

    searcher: "object"            # colbert_torch.retrieval.searcher.Searcher
    max_batch: int = 128
    max_wait_ms: float = 10.0
    max_inflight: int = 2

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: list[_Request] = []
        self._wake = threading.Event()
        self._closed = False
        self.stats = {"queries": 0, "batches": 0, "max_batch_seen": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def submit(self, query: str, k: int = 10) -> Future:
        if self._closed:
            raise RuntimeError("BatchingSearcher is closed")
        req = _Request(query, k, Future())
        with self._lock:
            self._pending.append(req)
        self._wake.set()
        return req.future

    def search(self, query: str, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        return self.submit(query, k).result()

    def search_many(
        self, queries: Sequence[str], k: int = 10
    ) -> list[Tuple[np.ndarray, np.ndarray]]:
        futs = [self.submit(q, k) for q in queries]
        return [f.result() for f in futs]

    def swap(self, searcher) -> None:
        """Atomically swap the underlying Searcher — zero-downtime index
        updates: run :class:`~colbert_torch.indexing.updater.IndexUpdater`,
        construct a fresh ``Searcher`` over the updated artifacts
        (``Searcher.reload()``), then ``swap`` it in. The in-flight batch finishes on the old snapshot;
        every later batch sees the new one."""
        self.searcher = searcher  # read once per batch in _loop; atomic

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        self._thread.join(timeout=30)
        with self._lock:
            pending, self._pending = self._pending, []
        for r in pending:
            r.future.set_exception(RuntimeError("server closed"))

    def __enter__(self) -> "BatchingSearcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------

    def _take_batch(self) -> list[_Request]:
        """Collect up to max_batch requests, waiting up to max_wait_ms for
        stragglers once the first request is in."""
        deadline = None
        while not self._closed:
            with self._lock:
                n = len(self._pending)
                if n >= self.max_batch or (deadline and time.time() >= deadline):
                    batch, self._pending = (
                        self._pending[: self.max_batch],
                        self._pending[self.max_batch :],
                    )
                    return batch
                if n and deadline is None:
                    deadline = time.time() + self.max_wait_ms / 1e3
            timeout = (deadline - time.time()) if deadline else 0.1
            self._wake.clear()
            self._wake.wait(timeout=max(1e-4, timeout))
        with self._lock:
            batch, self._pending = self._pending, []
        return batch

    def _resolve(self, batch, fetch) -> None:
        """Run ``fetch`` -> (pids, scores) and settle the batch's futures."""
        try:
            pids, scores = fetch()
            for i, r in enumerate(batch):
                r.future.set_result((pids[i, : r.k], scores[i, : r.k]))
        except Exception as e:  # propagate to every waiter, keep serving
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
        self.stats["queries"] += len(batch)
        self.stats["batches"] += 1
        self.stats["max_batch_seen"] = max(
            self.stats["max_batch_seen"], len(batch)
        )

    def _loop(self) -> None:
        from collections import deque

        inflight: deque = deque()  # (batch, kmax, handle, searcher)
        while True:
            with self._lock:
                has_pending = bool(self._pending)
            if inflight and (
                len(inflight) >= max(1, self.max_inflight)
                or not has_pending
            ):
                # pipeline full, or no new work queued: retire the oldest
                # launch (its waiters block on this finish)
                batch, kmax, handle, searcher = inflight.popleft()
                self._resolve(
                    batch, lambda: searcher.finish_search(handle, kmax)
                )
                continue
            if self._closed and not has_pending:
                return
            batch = self._take_batch()
            if not batch:
                continue
            kmax = max(r.k for r in batch)
            queries = [r.query for r in batch]
            searcher = self.searcher  # read once; swap() is atomic
            if getattr(searcher, "backend", None) == "device":
                try:
                    handle = searcher.launch_search(queries, kmax)
                except Exception as e:
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)
                    # count failed batches like _resolve does, so stats
                    # stay a complete served-batch ledger during incidents
                    self.stats["queries"] += len(batch)
                    self.stats["batches"] += 1
                    self.stats["max_batch_seen"] = max(
                        self.stats["max_batch_seen"], len(batch)
                    )
                    continue
                inflight.append((batch, kmax, handle, searcher))
            else:  # host backend: synchronous
                self._resolve(
                    batch, lambda: searcher.search_batch(queries, k=kmax)
                )
