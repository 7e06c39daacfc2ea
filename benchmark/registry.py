"""Finding the benchmark's parts by name, and checking what may be loaded.

- a cell is ``cells/<name>.json``: its configuration, its driver and the
  driver's traffic parameters and limits;
- a configuration is ``configs/<name>.json``; its optional ``"arch"``
  (``"bert"`` where absent) names its encoder's architecture, whose widths
  it holds under the key of that name;
- a driver is ``drivers/<name>.py`` with ``run(r: benchmark.harness.Run)``
  and ``METRIC``, the end-to-end metric it reports besides ``setup_s``;
- a per-layer metric is ``metrics/<name>.py`` with ``LAYER``, ``UNIT``,
  ``MOVES``, ``DRIVERS`` (the drivers whose runs it reads) and
  ``read(r) -> float | None``;
- an encoder architecture is ``archs/<name>.py``, part of the yardstick
  (it imports nothing of the program), with
  ``make_weights(seed, widths, dim, device)`` (the seed's fp32 weights
  under the port's ``state_dict`` names),
  ``encode(weights, widths, ids, mask, keep, precision)`` (the plain
  reference at ``"float32"``, TF32 off, and its control at ``"fp8"``),
  ``encoder_flops(widths, dim, tokens, keys_per_token)``,
  ``vocab_size(widths)`` and ``PROGRAM_CONFIG``, the ``"module:Class"``
  of the port's config class that ``ColBERT`` takes for it.

Adding any of them is adding a file: nothing here lists them.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# top-level module names no run may load, and the program's, which the
# yardstick's own folders may not import
FORBIDDEN = ("jax", "jaxlib", "flax", "colbert_tpu")
PROGRAM = "colbert_torch"
YARDSTICK_DIRS = ("reference", "gen", "archs")


def _json(kind: str, name: str, root: str = HERE) -> dict:
    path = os.path.join(root, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: str = HERE) -> dict:
    return _json("cells", name, root)


def config(name: str, root: str = HERE) -> dict:
    return _json("configs", name, root)


def names(kind: str, root: str = HERE) -> list[str]:
    """Every part of ``kind`` (``cells``, ``configs``, ``drivers``,
    ``metrics``, ``archs``) found under ``root``."""
    ext = ".json" if kind in ("cells", "configs") else ".py"
    d = os.path.join(root, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def _module(kind: str, name: str, root: str = HERE):
    path = os.path.join(root, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    key = f"benchmark_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: str = HERE):
    return _module("drivers", name, root)


def metric(name: str, root: str = HERE):
    return _module("metrics", name, root)


def arch(name: str, root: str = HERE):
    return _module("archs", name, root)


def arch_of(cfg: dict, root: str = HERE) -> tuple:
    """-> (the architecture module of configuration ``cfg``, its widths)."""
    name = cfg.get("arch", "bert")
    return arch(name, root), cfg[name]


def metrics_for(driver_name: str, root: str = HERE) -> dict:
    """name -> module of every per-layer metric that reads ``driver_name``'s runs."""
    out = {}
    for n in names("metrics", root):
        m = metric(n, root)
        if driver_name in m.DRIVERS:
            out[n] = m
    return out


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def yardstick_imports(root: str = HERE) -> list[str]:
    """``file: module`` for every import in the reference, the generators
    and the architectures of the program or of a forbidden package (by
    top-level name, whole)."""
    bad = []
    for sub in YARDSTICK_DIRS:
        d = os.path.join(root, sub)
        for f in sorted(os.listdir(d)):
            if not f.endswith(".py"):
                continue
            with open(os.path.join(d, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                    mods = [node.module]
                bad += [f"{sub}/{f}: {m}" for m in mods
                        if m.split(".")[0] in FORBIDDEN + (PROGRAM,)]
    return bad
