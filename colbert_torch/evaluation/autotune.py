"""Operating-point auto-tuner for the serving funnel (port of
``colbert_tpu.evaluation.autotune``).

The reference has no pruning and therefore no knobs: every probed candidate
is fully scored (reference: src/searching.jl:93-128; config.jl:89's
``ncandidates`` is never read). The staged funnel (probe -> stage-1 bound
-> optional full-centroid refine -> stage-2 decompress+MaxSim) trades
recall for time through ``nprobe``, ``plaid_stage2_docs`` (the stage-2 doc
budget), ``plaid_stage1_refine``, ``refine_width_factor``,
``search_max_candidates`` (the selection/refine width) and the build-side
``ivf_balance_cap``, and their right setting depends on the corpus.

This module maps the knobs automatically: score a query sample exactly
(:mod:`.oracle`), sweep a small grid of operating points through the real
serving path, and return the cheapest point whose tie-aware
score-recall@k meets the target. "Cheapest" is the measured batch time
(best of ``time_reps``, host clock around ``launch_search`` and
``finish_search``, whose read-back to the host is the synchronization
point) when ``time_reps > 0``, else (and for ties) an analytic cost in
funnel units weighted by the per-unit stage times traced on the card
(see ``_W_*`` below).

When ``queries`` (strings) are given on the device backend, each point is
searched and timed through the production entry points
(``Searcher.launch_search``/``finish_search``: query encode, batch
bucketing, host postprocess), so the tuner's ordering is the ordering of
serving. Pass pre-encoded ``Q`` to sweep the raw ``search_Q_batch`` path.

``balance_caps`` additionally sweeps ``ivf_balance_cap`` values by
re-balancing the probe tables in place (``DeviceIndex.rebalance``: no
re-index, no re-upload).

Typical offline use (one time per corpus)::

    result = tune_operating_point(searcher, queries, k=10,
                                  target_score_recall=0.98,
                                  balance_caps=(1024, 2048, 4096))
    result.apply(searcher)          # sets the config knobs in place

Two behaviours differ from the JAX module, where it disagrees with what
the funnel runs: :meth:`OperatingPoint.cost` charges the refine only when
the funnel runs it (``ncandidates`` below the clamped selection width, as
``device_index._search`` decides), and :meth:`TuneResult.apply` compares
balance caps by their meaning (None is 1024), so choosing the default
re-balances nothing.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from colbert_torch.evaluation.metrics import score_recall_at_k, set_recall_at_k
from colbert_torch.evaluation.oracle import exhaustive_scores, oracle_topk

logger = logging.getLogger(__name__)

__all__ = ["OperatingPoint", "TunedPoint", "TuneResult", "tune_operating_point"]

# Analytic per-unit weights, relative to one stage-1 entry. From the traced
# per-stage times of one B=32 search batch on an NVIDIA H100 80GB HBM3 at
# 700 W (chip_smoke.py's [serve] phase: stage1 2.05 ms, refine 40.65 ms,
# stage2 0.82 ms), each divided by the units cost() counts at that
# configuration (per query: 2 probes x 32 tokens x cell_cap 672 = 43,008
# entries; min(4 x 1024, 8192) x 160 = 655,360 refine rows; 1024 x 160 =
# 163,840 stage-2 rows): PERF.md has the arithmetic. Used only to rank
# points, never to predict time. The refine's weight reflects the refine's
# host loop (ROADMAP C2) and is recalibrated when that changes.
_W_STAGE1_ENTRY = 1.0
_W_REFINE_ROW = 1.30
_W_STAGE2_ROW = 0.105


@dataclass(frozen=True)
class OperatingPoint:
    """One funnel knob setting, relative to the searcher's config."""

    nprobe_delta: int = 0      # added on top of the compensated nprobe
    ncandidates: int = 1024    # stage-2 doc budget (config.plaid_stage2_docs)
    stage1_refine: bool = True
    refine_width: int = 4      # config.refine_width_factor
    max_candidates: int | None = None  # config.search_max_candidates override
    # (the selection/refine width, the binding knob of recall at depth)

    def label(self) -> str:
        parts = [f"ncand={self.ncandidates}",
                 "refine" if self.stage1_refine else "no-refine"]
        if self.stage1_refine and self.refine_width != 4:
            parts.append(f"rw={self.refine_width}")
        if self.nprobe_delta:
            parts.append(f"nprobe+{self.nprobe_delta}")
        if self.max_candidates is not None:
            parts.append(f"maxc={self.max_candidates}")
        return ", ".join(parts)

    def cost(self, *, nprobe: int, lq: int, cell_cap: int, max_doclen: int,
             max_candidates: int) -> float:
        """Analytic funnel work per query (relative units; see the module
        docstring), counting what the funnel runs: the selection width is
        clamped to the probed entries and the refine runs only when the
        stage-2 budget is below it (``device_index._search``)."""
        entries = (nprobe + self.nprobe_delta) * lq * cell_cap
        mc = min(self.max_candidates or max_candidates, entries)
        nc = min(self.ncandidates, mc)
        refine_rows = (min(self.refine_width * nc, mc) * max_doclen
                       if self.stage1_refine and nc < mc else 0)
        stage2_rows = nc * max_doclen
        return (_W_STAGE1_ENTRY * entries + _W_REFINE_ROW * refine_rows
                + _W_STAGE2_ROW * stage2_rows)


_DEFAULT_GRID = (
    OperatingPoint(0, 128, stage1_refine=True),
    OperatingPoint(0, 512, stage1_refine=False),
    OperatingPoint(0, 512, stage1_refine=True, refine_width=2),
    OperatingPoint(0, 512, stage1_refine=True),
    OperatingPoint(0, 1024, stage1_refine=False),
    OperatingPoint(2, 1024, stage1_refine=False),
    OperatingPoint(0, 1024, stage1_refine=True, refine_width=2),
    OperatingPoint(0, 1024, stage1_refine=True),
    OperatingPoint(0, 4096, stage1_refine=True),
)

# Appended to the default grid when a depth target is requested: recall at
# depth is bound by the selection/refine width (search_max_candidates) more
# than by the stage-2 budget.
_DEPTH_GRID_EXTRA = (
    OperatingPoint(0, 4096, stage1_refine=True, max_candidates=16384),
    OperatingPoint(0, 8192, stage1_refine=True, max_candidates=16384),
    OperatingPoint(2, 8192, stage1_refine=True, max_candidates=16384),
)


@dataclass
class TunedPoint:
    point: OperatingPoint
    score_recall: float
    set_recall: float
    cost: float
    ms_per_batch: float | None = None  # best of time_reps
    balance_cap: int | None = None     # config.ivf_balance_cap it ran under
    swept_cap: bool = False            # whether caps were swept at all
    depth_score_recall: float | None = None  # score-recall@depth_k


@dataclass
class TuneResult:
    chosen: TunedPoint
    table: list[TunedPoint] = field(default_factory=list)
    target: float = 0.0
    met_target: bool = True
    depth_k: int | None = None
    depth_target: float | None = None

    def apply(self, searcher) -> None:
        """Write the chosen point's knobs into ``searcher.config`` (and
        re-balance the probe tables when a cap sweep chose a cap that means
        something else than the current one)."""
        p = self.chosen.point
        cfg = searcher.config
        cfg.plaid_stage2_docs = p.ncandidates
        cfg.plaid_stage1_refine = p.stage1_refine
        cfg.refine_width_factor = p.refine_width
        cfg.nprobe = cfg.nprobe + p.nprobe_delta
        if p.max_candidates is not None:
            cfg.search_max_candidates = p.max_candidates
            searcher.max_candidates = p.max_candidates
        if self.chosen.swept_cap and (
            searcher._balance_cap(cfg.ivf_balance_cap)
            != searcher._balance_cap(self.chosen.balance_cap)
        ):
            searcher.set_balance_cap(self.chosen.balance_cap)

    def __str__(self) -> str:
        lines = []
        for t in self.table:
            label = t.point.label()
            if t.swept_cap:
                label += f", cap={t.balance_cap}"
            line = (f"  [{'*' if t is self.chosen else ' '}] {label:<40} "
                    f"score-recall@k {t.score_recall:.3f}  set {t.set_recall:.3f}")
            if t.depth_score_recall is not None:
                line += f"  @depth {t.depth_score_recall:.3f}"
            if t.ms_per_batch:
                line += f"  {t.ms_per_batch:.2f} ms/batch"
            lines.append(line)
        head = (f"tuned operating points (target score-recall "
                f"{self.target:.2f}{'' if self.met_target else ' — UNMET'}")
        if self.depth_target is not None:
            head += f", score-recall@{self.depth_k} >= {self.depth_target:.2f}"
        head += "):"
        return "\n".join([head] + lines)


def _best_ms(fn, reps: int) -> float | None:
    """Best of ``reps`` host-clock timings of ``fn`` (which must return only
    after its device work is read back), in ms; None for ``reps <= 0``."""
    if reps <= 0:
        return None
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _sweep_point(searcher, p: OperatingPoint, *, Q, queries, k_run: int,
                 nprobe: int, search_kw: dict, time_reps: int,
                 use_production: bool) -> tuple[np.ndarray, float | None]:
    """Search one grid point -> (pids (B, k_run), best-of-reps ms or None).

    Production mode writes the point's knobs into the live config for the
    sweep (``Searcher._search_kwargs`` reads it per launch) and drives
    ``launch_search``/``finish_search``, query encode and host postprocess
    included. Raw mode sweeps ``search_Q_batch`` with pre-encoded Q."""
    if use_production:
        cfg = searcher.config
        saved = (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe,
                 cfg.refine_width_factor, searcher.max_candidates)
        try:
            cfg.plaid_stage2_docs = p.ncandidates
            cfg.plaid_stage1_refine = p.stage1_refine
            cfg.nprobe = cfg.nprobe + p.nprobe_delta
            cfg.refine_width_factor = p.refine_width
            if p.max_candidates is not None:
                searcher.max_candidates = p.max_candidates
            qs = list(queries)
            pids, _ = searcher.search_batch(qs, k_run)  # warm-up and the recall pids
            ms = _best_ms(lambda: searcher.finish_search(searcher.launch_search(qs, k_run),
                                                         k_run), time_reps)
            return np.asarray(pids), ms
        finally:
            (cfg.plaid_stage2_docs, cfg.plaid_stage1_refine, cfg.nprobe,
             cfg.refine_width_factor, searcher.max_candidates) = saved

    mc = p.max_candidates or searcher.max_candidates
    kw = dict(k=k_run, nprobe=nprobe + p.nprobe_delta, ncandidates=min(p.ncandidates, mc),
              stage1_refine=p.stage1_refine, refine_width=p.refine_width, **search_kw)
    kw["max_candidates"] = mc
    pids, _ = searcher.device_index.search_Q_batch(Q, **kw)
    # search_Q_batch returns host numpy: the read-back is the sync point
    ms = _best_ms(lambda: searcher.device_index.search_Q_batch(Q, **kw), time_reps)
    return np.asarray(pids), ms


def tune_operating_point(
    searcher,
    queries=None,
    *,
    Q=None,
    k: int = 10,
    target_score_recall: float = 0.98,
    grid: tuple[OperatingPoint, ...] = _DEFAULT_GRID,
    time_reps: int = 2,
    tie_eps: float = 0.01,
    balance_caps: tuple[int | None, ...] | None = None,
    depth_k: int | None = None,
    target_depth_recall: float | None = None,
) -> TuneResult:
    """Sweep ``grid`` against the exact oracle and pick the cheapest point
    with score-recall@k >= ``target_score_recall``.

    ``queries`` are sample query strings: the sweep then runs through the
    production serving path. Pass pre-encoded ``Q`` (B, Lq, dim) instead
    to sweep the raw ``search_Q_batch`` path. ``time_reps=0`` ranks by the
    analytic cost only (deterministic; the CPU tests use it); otherwise by
    the best of ``time_reps`` measured batch times.

    ``balance_caps`` sweeps ``config.ivf_balance_cap`` values by
    re-balancing the probe tables in place per cap; the grid runs once per
    cap, the winner carries its cap, and the original cap is restored
    afterwards (``TuneResult.apply`` applies the chosen one). Caps follow
    the config: None = 1024, <= 0 = no splitting.

    ``depth_k``/``target_depth_recall`` add a depth constraint: the sweep
    searches at ``max(k, depth_k)`` and a point qualifies only if its
    score-recall@``depth_k`` also meets ``target_depth_recall``.

    If no point meets the target(s), the highest-recall point is chosen,
    ``met_target`` is False and a warning is logged. Device backend only
    (the sweep drives ``device_index``); the oracle reads the chunk mmaps.
    """
    if searcher.backend != "device":
        raise NotImplementedError("tune_operating_point: device backend only")
    if Q is None:
        if queries is None:
            raise ValueError("pass queries (strings) or Q (embeddings)")
        Q = searcher.encoder.encode_queries(list(queries))
    Q = torch.as_tensor(Q, dtype=torch.float32).to(searcher.device)
    use_production = queries is not None
    if depth_k is not None and target_depth_recall is None:
        target_depth_recall = target_score_recall
    if target_depth_recall is not None and depth_k is None:
        depth_k = 100
    if grid is _DEFAULT_GRID and depth_k is not None:
        grid = grid + _DEPTH_GRID_EXTRA  # custom grids are left as they are
    k_run = max(k, depth_k) if depth_k is not None else k

    oscores = exhaustive_scores(searcher, Q)
    otop = oracle_topk(oscores, k)

    sweep_caps = balance_caps is not None and len(balance_caps) > 0
    cfg = searcher.config
    orig_cap = cfg.ivf_balance_cap
    caps = tuple(balance_caps) if sweep_caps else (orig_cap,)

    lq = int(Q.shape[1])
    table: list[TunedPoint] = []
    try:
        for cap in caps:
            if sweep_caps:
                searcher.set_balance_cap(cap)
            index = searcher.device_index
            nprobe = cfg.nprobe
            if cfg.probe_dup_compensation:
                nprobe = index.compensated_nprobe(nprobe, saturate=cfg.probe_comp_saturation)
            cost_kw = dict(nprobe=nprobe, lq=lq, cell_cap=searcher.cell_cap,
                           max_doclen=index.max_doclen,
                           max_candidates=searcher.max_candidates)
            search_kw = dict(cell_cap=searcher.cell_cap,
                             max_candidates=searcher.max_candidates,
                             centroid_threshold=cfg.centroid_score_threshold)
            for p in grid:
                pids, ms = _sweep_point(
                    searcher, p, Q=Q, queries=queries, k_run=k_run, nprobe=nprobe,
                    search_kw=search_kw, time_reps=time_reps,
                    use_production=use_production,
                )
                table.append(TunedPoint(
                    point=p,
                    score_recall=score_recall_at_k(pids, oscores, k, eps=tie_eps),
                    set_recall=set_recall_at_k(pids, otop, k),
                    cost=p.cost(**cost_kw),
                    ms_per_batch=ms,
                    balance_cap=cap,
                    swept_cap=sweep_caps,
                    depth_score_recall=(score_recall_at_k(pids, oscores, depth_k, eps=tie_eps)
                                        if depth_k is not None else None),
                ))
    finally:
        if sweep_caps:
            searcher.set_balance_cap(orig_cap)

    def rank_key(t: TunedPoint):
        # measured time when there is one; the analytic cost breaks ties and
        # is the only key at time_reps=0
        return (t.ms_per_batch if t.ms_per_batch is not None else 0.0, t.cost)

    def qualifies(t: TunedPoint) -> bool:
        if t.score_recall < target_score_recall:
            return False
        return target_depth_recall is None or (
            (t.depth_score_recall or 0.0) >= target_depth_recall)

    qualifying = [t for t in table if qualifies(t)]
    met = bool(qualifying)
    if met:
        chosen = min(qualifying, key=rank_key)
    else:
        # the cheapest of the highest-recall points (max keeps the first
        # maximal element of the cost-sorted table); depth breaks recall ties
        chosen = max(sorted(table, key=rank_key),
                     key=lambda t: (t.score_recall, t.depth_score_recall or 0.0))
        best_k = max(t.score_recall for t in table)
        if best_k >= target_score_recall and target_depth_recall is not None:
            logger.warning(
                "score-recall@%d %.3f is reachable (best %.3f) but no grid point "
                "also meets score-recall@%d >= %.3f (best joint point %s: %.3f / "
                "%.3f); widen max_candidates / nprobe",
                k, target_score_recall, best_k, depth_k, target_depth_recall,
                chosen.point.label(), chosen.score_recall, chosen.depth_score_recall or 0.0,
            )
        else:
            logger.warning(
                "no operating point reaches score-recall %.3f (best %.3f: %s); "
                "widen the grid or raise search_max_candidates",
                target_score_recall, chosen.score_recall, chosen.point.label(),
            )
    return TuneResult(chosen=chosen, table=table, target=target_score_recall,
                      met_target=met, depth_k=depth_k, depth_target=target_depth_recall)
