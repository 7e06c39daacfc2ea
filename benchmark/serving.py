"""What the serving drivers share: building the served system from a
configuration and a seed, and the check of its answers against the plain
reference.

The system is the port's public API: the synthetic index written under the
run's work directory, a ``ColBERT`` over the configuration's architecture
with the seed's weights (drawn on the device), a ``ColBERTEncoder`` over
the synthetic vocabulary and a ``Searcher`` over the index.

The check (:func:`check`): for a sample of the answered queries drawn from
the seed, the architecture's reference encodes each query again (fp32,
TF32 off) and runs its own funnel over the same index arrays. Two numbers
are compared, each the widest over the sample:

- ``score_gap``: how far a returned score lies from the reference's exact
  score of the returned passage;
- ``miss_share``: the share of the reference's ``k`` best passages that
  the answer leaves out.

``rank_gap`` (how far below the reference's j-th best score the
reference's score of the j-th returned passage lies) is read beside them
and not compared: a widest gap, it swings with one near tie (PERF.md).

An answer with a missing or unknown pid or a non-finite score is failed.
"""

from __future__ import annotations

import gc
import importlib
import os
import shutil
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.gen import index as gen_index
from benchmark.gen.vocab import filler_words, make_vocab
from benchmark.reference import funnel as ref_funnel
from benchmark.reference.tokenize import tensorize_queries


@dataclass
class Served:
    searcher: object
    index: gen_index.SyntheticIndex
    n_words: int


def colbert_config(cfg: dict):
    from colbert_torch.config import ColBERTConfig

    return ColBERTConfig(dim=cfg["dim"], nbits=cfg["nbits"], query_maxlen=cfg["query_maxlen"],
                         doc_maxlen=cfg["doc_maxlen"], activation_dtype=cfg["activation_dtype"],
                         **cfg["search"], **cfg.get("indexing", {}))


def build_model(r):
    """The port's ColBERT of run ``r``'s architecture (its config class
    named by ``PROGRAM_CONFIG``), holding the seed's weights (no host copy,
    no per-leaf init)."""
    from colbert_torch.models.colbert import ColBERT

    module, name = r.arch.PROGRAM_CONFIG.split(":")
    program_config = getattr(importlib.import_module(module), name)
    dim = r.config["dim"]
    with torch.device("meta"):
        model = ColBERT(program_config(**r.widths), dim)
    model.load_state_dict(r.arch.make_weights(r.seed, r.widths, dim, r.device),
                          assign=True, strict=True)
    return model


def serve(r) -> Served:
    """Build the served system of run ``r``."""
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.tokenization.wordpiece import WordPieceTokenizer

    cfg = r.config
    ix_cfg = cfg["index"]
    with r.phase("synthesize"):
        ix = gen_index.synthesize(r.seed, ix_cfg["n_passages"], dim=cfg["dim"],
                                  nbits=cfg["nbits"], avg_doclen=ix_cfg["avg_doclen"],
                                  num_partitions=ix_cfg["num_partitions"],
                                  chunksize=ix_cfg["chunksize"],
                                  code_locality=ix_cfg["code_locality"])
    path = os.path.join(r.workdir, "index")
    with r.phase("write"):
        shutil.rmtree(path, ignore_errors=True)
        gen_index.write_index(path, ix, {"dim": cfg["dim"], "nbits": cfg["nbits"]})
    with r.phase("model"):
        vocab = make_vocab(r.arch.vocab_size(r.widths))
        encoder = ColBERTEncoder(build_model(r), WordPieceTokenizer(vocab),
                                 colbert_config(cfg), device=r.device)
    with r.phase("searcher"):
        searcher = Searcher(path, encoder=encoder, config=encoder.config, device=r.device)
    return Served(searcher=searcher, index=ix,
                  n_words=filler_words(r.arch.vocab_size(r.widths)))


def release(r, served: Served | None = None) -> None:
    """Read the peak, then free the program's state on the device (the
    caller drops its own references first)."""
    r.read_memory_peak()
    if served is not None:
        served.searcher = None
        shutil.rmtree(os.path.join(r.workdir, "index"), ignore_errors=True)
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()


def sample(seed: int, n_answered: int, n: int) -> np.ndarray:
    """Positions of ``n`` answered queries drawn from ``seed``, in order."""
    rng = np.random.default_rng([seed, 3])
    return np.sort(rng.choice(n_answered, size=min(n, n_answered), replace=False))


@torch.no_grad()
def reference_answers(r, ix, queries: list[str], k: int, precision: str = "float32",
                      batch: int = 64) -> tuple[list, object]:
    """-> (the reference's answer to each query, encoded by run ``r``'s
    architecture at ``precision`` (``"fp8"`` is the control) and then
    through its funnel; the reference's index)."""
    cfg, device = r.config, r.device
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        weights = r.arch.make_weights(r.seed, r.widths, cfg["dim"], device)
        vocab = make_vocab(r.arch.vocab_size(r.widths))
        Qs = []
        for s in range(0, len(queries), batch):
            ids, mask = tensorize_queries(queries[s:s + batch], vocab, cfg["query_maxlen"])
            ids, mask = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
            Qs.append(r.arch.encode(weights, r.widths, ids, mask, torch.ones_like(mask),
                                    precision))
        del weights
        Q = torch.cat(Qs)
        rix = ref_funnel.load_index(ix, device)
        p = ref_funnel.params(cfg["search"], rix, cfg["query_maxlen"], k)
        out = []
        for q in Q:
            a = ref_funnel.search(rix, q, p)
            a["Q"] = q
            out.append(a)
        return out, rix
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def malformed(pids: np.ndarray, scores: np.ndarray, n_passages: int) -> np.ndarray:
    """Rows of answers ``(n, k)`` that hold an unknown pid (-1 marks a
    missing one) or a non-finite score."""
    return ((pids < 0) | (pids >= n_passages) | ~np.isfinite(scores)).any(axis=1)


def readings(rix, ref: list[dict], pids: np.ndarray, scores: np.ndarray) -> dict:
    """The compared numbers for answers ``pids, scores (n, k)`` against the
    reference's answers to the same queries, and how many were malformed."""
    score_gap = rank_gap = 0.0
    missed = wanted = 0
    bad = malformed(pids, scores, rix.doclens.shape[0])
    for a, p, s, b in zip(ref, pids, scores, bad):
        if b:
            continue
        exact = ref_funnel.maxsim(rix, a["Q"], torch.as_tensor(p, device=a["Q"].device))
        exact = exact.double().cpu().numpy()
        best = a["scores"].double().cpu().numpy()
        score_gap = max(score_gap, float(np.abs(s.astype(np.float64) - exact).max()))
        rank_gap = max(rank_gap, float((best[:len(exact)] - exact).max()))
        missed += int((~np.isin(a["pids"].cpu().numpy(), p)).sum())
        wanted += len(a["pids"])
    return {"score_gap": score_gap, "rank_gap": rank_gap,
            "miss_share": missed / max(1, wanted), "failed": int(bad.sum())}


def check(r, ix, queries: list[str], pids: np.ndarray, scores: np.ndarray, k: int) -> dict:
    """Readings of the run's answers to a seeded sample of ``queries``
    (all answered; ``pids``/``scores`` aligned with them), and the work the
    reference funnel counted per query (for the roofline readers)."""
    pick = sample(r.seed, len(queries), r.cell["check_queries"])
    chosen = [queries[i] for i in pick]
    ref, rix = reference_answers(r, ix, chosen, k)
    out = readings(rix, ref, pids[pick], scores[pick])
    _, mask = tensorize_queries(chosen, make_vocab(r.arch.vocab_size(r.widths)),
                                r.config["query_maxlen"])
    r.work["true_tokens_per_query"] = float(mask.sum(axis=1).mean())
    for key in ("candidates", "refine_passages", "refine_tokens", "stage2_passages",
                "stage2_tokens"):
        r.work[f"{key}_per_query"] = float(np.mean([a["work"][key] for a in ref]))
    return out


def control(r, ix, queries: list[str], k: int) -> dict:
    """The control's readings on the same seeded sample: the reference put
    in the program's place with its encoder in fp8."""
    pick = sample(r.seed, len(queries), r.cell["check_queries"])
    chosen = [queries[i] for i in pick]
    ref, rix = reference_answers(r, ix, chosen, k)
    ctl, _ = reference_answers(r, ix, chosen, k, precision="fp8")
    pids = np.stack([a["pids"].cpu().numpy() for a in ctl])
    scores = np.stack([a["scores"].cpu().numpy() for a in ctl])
    return readings(rix, ref, pids, scores)


def verdict(found: dict, limits: dict) -> tuple[bool, list]:
    """-> (correct, [(name, value, limit)]) for the compared numbers."""
    checks = [(name, found[name], limits[name]) for name in limits]
    return found["failed"] == 0 and all(v <= lim for _, v, lim in checks), checks
