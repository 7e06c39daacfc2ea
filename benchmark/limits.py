"""Readings for setting a cell's limits: the program's compared numbers on many
seeds and the control's on the same samples, in one process (set-up builds
the kernels once).

    python3 -m benchmark.limits --workload <cell> --seeds 11,12,13 --seconds 2

prints one JSON line per seed: ``{"seed", "program": {...}, "control":
{...}}``, the control's readings with its verdict under the cell's limits.
The control is the reference put in the program's place with its encoder
in fp8 (``benchmark.reference.encoder``). Not part of a run.
"""

from __future__ import annotations

import argparse
import json

import torch

from benchmark import run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("limits: no CUDA device")
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.execute(args.workload, seed, args.seconds, False, "cuda",
                          overrides={"cell": {"control": bool(args.control)}})
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": res.get("readings"),
                          "control": res.get("control"), "metrics": res["metrics"],
                          "notes": res["notes"],
                          "device": res["device"]}), flush=True)


if __name__ == "__main__":
    main()
