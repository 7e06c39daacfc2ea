"""Back-to-back index builds through ``Indexer.index(overwrite=True)``.

The collection is the configuration's ``collection_passages`` passages of
``min_words`` to ``max_words - 1`` filler words (the cell's), drawn from the
seed. Set-up builds the
system, runs one build of the first ``warmup_passages`` passages and one
encode-and-compress pass over the first ``warmup_chunk`` of them (every
kernel a build runs loads there). The window starts builds into the run's
work directory until ``--seconds`` have passed and waits for the last;
``index_passages_per_s`` is the passages of every build over the time from
the window's start to the end of the last. The index of the last build is
then checked against the reference (:mod:`benchmark.building`).
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from benchmark import building, serving
from benchmark.gen.queries import passage_pool
from benchmark.gen.vocab import filler_words, make_vocab
from benchmark.reference.codec import sample_pids
from benchmark.reference.tokenize import tensorize_docs

METRIC = "index_passages_per_s"


def run(r) -> dict:
    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.tokenization.wordpiece import WordPieceTokenizer

    c, cfg = r.cell, r.config
    n_vocab = r.arch.vocab_size(r.widths)
    passages = passage_pool(r.seed, cfg["collection_passages"], filler_words(n_vocab),
                            c["min_words"], c["max_words"])
    with r.phase("model"):
        encoder = ColBERTEncoder(serving.build_model(r), WordPieceTokenizer(make_vocab(n_vocab)),
                                 serving.colbert_config(cfg), device=r.device)
        indexer = Indexer(encoder.config, encoder=encoder, collection=passages, device=r.device)
    path = os.path.join(r.workdir, "index")
    with r.phase("warm_up"):
        warm = passages[:c["warmup_passages"]]
        Indexer(encoder.config, encoder=encoder, collection=warm,
                device=r.device).index(path, overwrite=True)
        ix = building.read_index(path)
        encoder.encode_passages_compressed(
            warm[:c["warmup_chunk"]], torch.from_numpy(ix["centroids"]).to(r.device),
            torch.from_numpy(ix["cutoffs"]).to(r.device), nbits=cfg["nbits"])
        del ix
    builds = []
    with r.window() as t0:
        while time.perf_counter() < t0 + r.seconds:
            t = time.perf_counter()
            with r.span("index"):
                indexer.index(path, overwrite=True)
            builds.append(time.perf_counter() - t)
    with open(os.path.join(path, "plan.json")) as f:
        plan = json.load(f)
    r.work["timings"] = plan.get("timings", {})
    r.work["build_total_s"] = plan.get("total_build_seconds")
    r.notes["build_s"] = builds
    del indexer, encoder
    serving.release(r)
    found, ctl = building.judge(r, path, passages, c.get("control", False))
    correct, checks = serving.verdict(found, c["limits"])
    if ctl is not None:
        ctl["correct"] = serving.verdict(ctl, c["limits"])[0]
    shutil.rmtree(path, ignore_errors=True)
    # the encoder's work per build: the codec's sample, then every passage
    # again unless the sample is the whole collection
    vocab = make_vocab(n_vocab)
    lens = np.concatenate([tensorize_docs(passages[s:s + 1024], vocab, cfg["doc_maxlen"])[1]
                           .sum(axis=1) for s in range(0, len(passages), 1024)])
    pids = sample_pids(len(passages), np.random.default_rng(0))
    flops = [r.arch.encoder_flops(r.widths, cfg["dim"], int(n), int(n)) for n in lens]
    r.work["encode_flops_per_build"] = float(
        sum(flops[p] for p in pids) + (sum(flops) if len(pids) < len(passages) else 0.0))
    r.work["build_seconds"] = r.window_s
    r.counters["builds"] = len(builds)
    return {"attempted": len(builds) * len(passages), "failed": 0,
            "readings": found, "correct": correct and bool(builds), "checks": checks,
            "control": ctl, "metrics": {METRIC: (
                len(passages) * len(builds) / r.window_s, "passages/s")}}
