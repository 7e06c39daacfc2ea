"""Run one cell of the benchmark once and print one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics and ``setup_s``;
``--trace 1`` runs the same window under ``torch.profiler`` and reports the
per-layer metrics that read the cell's driver. Both check the answers
against the plain reference (``correct``). The run refuses to start without
the cards the cell asks for, and fails when a module of JAX or of the JAX
package is loaded, or when the reference or the generators import the
program. The compared numbers and their limits are the last lines on
standard error and the last key of the result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

# a library the port may load must not bring JAX in with it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from benchmark import harness, registry


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str | torch.device,
            root: str = registry.HERE, overrides: dict | None = None) -> dict:
    """Run ``workload`` once -> the result line's dict, ``checks`` (each
    compared number with its limit) last. ``overrides`` replace top-level
    keys of the configuration and the cell (tests shrink them)."""
    overrides = overrides or {}
    cell = {**registry.cell(workload, root), **overrides.get("cell", {})}
    config = {**registry.config(cell["config"], root), **overrides.get("config", {})}
    device = torch.device(device)
    workdir = os.path.join(tempfile.gettempdir(), "colbert_bench", workload)
    os.makedirs(workdir, exist_ok=True)
    arch, widths = registry.arch_of(config, root)
    r = harness.Run(workload=workload, cell=cell, config=config, seed=seed, seconds=seconds,
                    trace=trace, device=device, workdir=workdir, card=harness.card(device),
                    arch=arch, widths=widths)
    r.setup_phases["process_start_to_driver"] = harness.process_age_s()
    with r.phase("device_init"):
        torch.zeros(1, device=device)
    out = registry.driver(cell["driver"], root).run(r)
    if trace:
        metrics = {}
        for name, m in registry.metrics_for(cell["driver"], root).items():
            v = m.read(r)
            if v is not None:
                metrics[name] = {"value": v, "unit": m.UNIT}
    else:
        metrics = {n: {"value": v, "unit": u} for n, (v, u) in out["metrics"].items()}
        metrics["setup_s"] = {"value": r.setup_s, "unit": "s"}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": r.card["name"],
           "count": 1, "memory_peak_bytes": r.memory_peak_bytes,
           "power_limit": r.card["power_limit"]}
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace and r.device_trace is not None:
        t = r.device_trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": harness.top(t.by_name),
                               "idle_gaps": harness.top(t.gaps_by_span)}
    for extra in ("control", "readings"):
        if out.get(extra) is not None:
            result[extra] = out[extra]
    result["notes"] = {"power_limit": r.card["power_limit"],
                       "setup_phases_s": r.setup_phases, **r.notes}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out["checks"]}
    return result


def fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bad = registry.yardstick_imports()
    if bad:
        fail("the reference or the generators import the program or JAX: " + ", ".join(bad))
    try:
        cell = registry.cell(args.workload)
    except KeyError as e:
        fail(str(e))
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell asks for {cell['chips']} cards, {torch.cuda.device_count()} present")
    result = execute(args.workload, args.seed % (1 << 63), args.seconds, bool(args.trace), "cuda")
    loaded = registry.loaded_forbidden()
    if loaded:
        fail("modules of JAX or of the JAX package are loaded: " + ", ".join(loaded), 3)
    for name, note in result["notes"].items():
        print(f"note {name}: {note}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
