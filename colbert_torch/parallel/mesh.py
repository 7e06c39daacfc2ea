"""Device mesh (port of ``colbert_tpu.parallel.mesh``).

A :class:`Mesh` is an ``(n_data, n_model)`` grid of ``torch.device`` with
the axis names of the JAX package:

  - ``data`` shards batches, collection rows, candidate sets and k-means
    points;
  - ``model`` shards the encoder's blocks Megatron-style
    (:mod:`colbert_torch.parallel.tp`).

Each cell also records the rank of the process that addresses it
(:mod:`colbert_torch.parallel.launch`): ranks own contiguous blocks of
cells, process-major, as ``jax.devices()`` orders a multi-process mesh.
A device may appear in more than one cell only when the caller passes the
list of ``devices`` with it repeated: ``["cuda:0"] * 4`` puts four real
data shards on one card, the port's stand-in for XLA's virtual host
devices (``--xla_force_host_platform_device_count``). On ``device="cpu"``
the default list is the CPU repeated as often as the mesh asks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "resolve_devices", "canonical"]


@dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray   # (n_data, n_model) object array of torch.device
    process: np.ndarray   # (n_data, n_model) int: the rank addressing each cell

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.devices.shape[0], "model": self.devices.shape[1]}

    def data_device(self, s: int) -> torch.device:
        """The device that holds data shard ``s`` (its first model cell)."""
        return self.devices[s, 0]

    def model_devices(self, s: int) -> list[torch.device]:
        """Data shard ``s``'s model group, in model-axis order."""
        return list(self.devices[s])

    def owned_data_shards(self, rank: int) -> list[int]:
        """Data-axis indices with a cell that process ``rank`` addresses."""
        return [s for s in range(self.shape["data"]) if (self.process[s] == rank).any()]


def resolve_devices(device) -> tuple[torch.device, list[torch.device] | None]:
    """An entry point's ``device`` argument -> (primary device, explicit
    device list or None). A list or tuple names every device of a mesh in
    order (repeats allowed) and its first entry is the primary device; a
    single device (``"cuda"``, ``"cpu"``) gives no list. ``"cuda"`` raises
    without a GPU (:func:`colbert_torch.utils.build.resolve_device`)."""
    from colbert_torch.utils.build import resolve_device

    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        devices = [canonical(resolve_device(d)) for d in device]
        return devices[0], devices
    return resolve_device(device), None


def canonical(device: torch.device) -> torch.device:
    """``cuda`` without an index -> the current card's ``cuda:i``, so that
    two names of one card compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_data: int = -1, n_model: int = 1, *,
              devices: Sequence[str | torch.device] | None = None,
              device: str | torch.device = "cuda") -> Mesh:
    """An ``(n_data, n_model)`` mesh over this process's ``devices``.

    ``devices`` defaults to every visible card on ``device="cuda"`` (never
    repeated) and to the CPU repeated as often as the mesh needs on
    ``device="cpu"``; ``n_data=-1`` takes every device of the list (one CPU
    on the CPU). In a multi-process run (:func:`launch.initialize`) the mesh
    spans every process: each owns ``n_data * n_model / process_count``
    cells, in rank order, filled from its own list. A mesh larger than the
    list raises, as the JAX package's does."""
    from colbert_torch.parallel import launch
    from colbert_torch.utils.build import resolve_device

    nproc = launch.process_count()
    if devices is not None:
        local = [canonical(resolve_device(d)) for d in devices]
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        elif n_data == -1:
            local = [dev]
        else:
            local = [dev] * max(1, n_data * n_model // nproc)
    if n_data == -1:
        n_data = len(local) * nproc // n_model
    use = n_data * n_model
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model} has no devices")
    if use % nproc:
        raise ValueError(f"mesh {n_data}x{n_model} does not split over {nproc} processes")
    per = use // nproc
    if per > len(local):
        raise ValueError(f"mesh {n_data}x{n_model} needs {per} devices per process, "
                         f"have {len(local)}")
    cells = np.empty(use, dtype=object)
    for r in range(nproc):
        for i in range(per):
            cells[r * per + i] = local[i]
    process = np.repeat(np.arange(nproc), per)
    return Mesh(cells.reshape(n_data, n_model), process.reshape(n_data, n_model))
