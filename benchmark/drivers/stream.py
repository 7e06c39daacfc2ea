"""Closed-loop batched retrieval through ``Searcher.search_stream``.

The cell gives the batch (``batch`` queries of text each), ``k``,
``max_inflight`` and how many batches the seed's query pool holds
(``pool_batches``; the window cycles through it). Set-up builds the system
and streams ``warmup_batches`` batches (the batch shape's program is
captured there). The window streams batches until ``--seconds`` have
passed; ``search_qps`` is the queries of the batches answered inside the
window over its length. Every answer is kept; a seeded sample is held
against the reference once the program's state is freed.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import serving
from benchmark.gen.queries import query_pool

METRIC = "search_qps"


def run(r) -> dict:
    c = r.cell
    B, k, inflight = c["batch"], c["k"], c["max_inflight"]
    served = serving.serve(r)
    searcher = served.searcher
    pool = query_pool(r.seed, c["pool_batches"] * B, served.n_words)
    batches = [pool[i:i + B] for i in range(0, len(pool), B)]
    r.wrap(searcher, "launch_search")
    r.wrap(searcher, "finish_search")
    with r.phase("warm_up"):
        for _ in searcher.search_stream(batches[:c["warmup_batches"]], k=k,
                                        max_inflight=inflight):
            pass

    answers = []
    sent = [0]
    with r.window() as t0:
        end = t0 + r.seconds

        def feed():
            while time.perf_counter() < end:
                yield batches[sent[0] % len(batches)]
                sent[0] += 1

        stamps = []
        for pids, scores in searcher.search_stream(feed(), k=k, max_inflight=inflight):
            stamps.append(time.perf_counter() - t0)
            answers.append((pids, scores))
        in_window = sum(t <= r.seconds for t in stamps)
    del searcher
    r.notes["batches_per_second"] = np.bincount(np.array(stamps, int)).tolist()
    r.counters["batches"] = len(answers)
    r.work["batch"] = B
    serving.release(r, served)

    queries = [q for i in range(len(answers)) for q in batches[i % len(batches)]]
    pids = np.concatenate([p for p, _ in answers])
    scores = np.concatenate([s for _, s in answers])
    found = serving.check(r, served.index, queries, pids, scores, k)
    correct, checks = serving.verdict(found, c["limits"])
    ctl = serving.control(r, served.index, queries, k) if c.get("control") else None
    if ctl is not None:
        ctl["correct"] = serving.verdict(ctl, c["limits"])[0]
    bad = int(serving.malformed(pids, scores, len(served.index.doclens)).sum())
    return {"attempted": sent[0] * B, "failed": (sent[0] - len(answers)) * B + bad,
            "readings": found, "correct": correct, "checks": checks, "control": ctl,
            "metrics": {METRIC: (in_window * B / r.seconds, "queries/s")}}
