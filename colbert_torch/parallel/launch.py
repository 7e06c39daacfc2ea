"""Multi-process launch and the collectives of the mesh (port of
``colbert_tpu.parallel.launch``) over ``torch.distributed``.

One process per host (or per card), all running the same program:

    from colbert_torch.parallel import launch
    launch.initialize(backend="nccl")   # COLBERT_COORDINATOR etc.
    mesh = make_mesh(n_data)             # spans every process
    s = Searcher(path, encoder=enc, backend="sharded", device=...)

Every process loads only the index shards its devices hold, and every
process returns the same merged results. The coordinator, process count and
rank come from the arguments or from ``COLBERT_COORDINATOR`` (``host:port``),
``COLBERT_NUM_PROCESSES`` and ``COLBERT_PROCESS_ID``; with none of them the
call is a no-op, so a bare single-process run needs nothing. ``backend`` is
explicit: ``"nccl"`` for meshes of cards, ``"gloo"`` for CPU meshes. A failed
NCCL init raises; nothing here falls back to another backend.

A cross-process sum or gather is each process's own shards, in shard order,
followed by one ``all_gather``; sums add the gathered per-shard parts in
global shard order, so a multi-process run adds in the same order as a
single-process one and gives the same bits. A mesh training step gathers
the shards' embeddings the same way, its own shards' keeping their graphs
(:func:`gather_keeping_grads`), and sums the gradients over the processes
in rank order (:func:`sum_grads`).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "process_index", "process_count",
           "owned_data_shards", "put_replicated", "put_data_sharded", "gather_shards",
           "sum_shards", "gather_keeping_grads", "sum_grads", "allgather_host"]

BACKENDS = ("nccl", "gloo")


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None) -> None:
    """Join (or create) the process group. Idempotent; a no-op with no
    coordinator and no process count in the arguments or the environment."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("COLBERT_COORDINATOR")
    if num_processes is None and "COLBERT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["COLBERT_NUM_PROCESSES"])
    if process_id is None and "COLBERT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["COLBERT_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator address, the process "
                         "count and this process's id")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend='nccl' needs a GPU")
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id), timeout=datetime.timedelta(seconds=600))


def is_initialized() -> bool:
    return dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def owned_data_shards(mesh) -> list[int]:
    """Data-axis indices whose devices this process addresses."""
    return mesh.owned_data_shards(process_index())


def put_replicated(arr, mesh) -> dict[int, torch.Tensor]:
    """``arr`` (numpy or tensor) copied to each owned data shard's device ->
    ``{shard: tensor}``. Shards on one device share one copy."""
    t = torch.as_tensor(arr)
    by_dev: dict[torch.device, torch.Tensor] = {}
    out = {}
    for s in owned_data_shards(mesh):
        dev = mesh.data_device(s)
        if dev not in by_dev:
            by_dev[dev] = t.to(dev)
        out[s] = by_dev[dev]
    return out


def put_data_sharded(arr, mesh) -> dict[int, torch.Tensor]:
    """Split ``arr``'s leading dim into ``n_data`` equal row blocks ->
    ``{shard: block on its device}`` for the owned shards. The leading dim
    must divide the data-axis size (pad first)."""
    t = torch.as_tensor(arr)
    D = mesh.shape["data"]
    if t.shape[0] % D:
        raise ValueError(f"data-axis size {D} must divide leading dim {t.shape[0]}")
    rows = t.shape[0] // D
    return {s: t[s * rows:(s + 1) * rows].to(mesh.data_device(s))
            for s in owned_data_shards(mesh)}


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_shards(parts: dict[int, torch.Tensor], mesh) -> tuple[list[torch.Tensor], torch.device]:
    """Every data shard's tensor (equal shapes), in shard order ->
    (the list, the device it lies on). Without a process group the parts
    move to shard 0's device; in one (even of one process) each process's
    owned parts travel in one ``all_gather``."""
    D = mesh.shape["data"]
    if not dist.is_initialized():
        home = mesh.data_device(0)
        if sorted(parts) != list(range(D)):
            raise ValueError(f"missing shard parts: have {sorted(parts)} of {D}")
        return [parts[s].to(home) for s in range(D)], home
    dev = _comm_device()
    owned = owned_data_shards(mesh)
    if sorted(parts) != owned:
        raise ValueError(f"parts for shards {sorted(parts)}, this process owns {owned}")
    local = torch.stack([parts[s].to(dev) for s in owned])
    bufs = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, local)
    gathered = [row for b in bufs for row in b]
    if len(gathered) != D:
        raise ValueError(f"gathered {len(gathered)} shard parts, mesh has {D}")
    return gathered, dev


def sum_shards(parts: dict[int, torch.Tensor], mesh) -> tuple[torch.Tensor, torch.device]:
    """The sum of every data shard's tensor, added in shard order (the
    ``psum`` of the JAX package) -> (sum, its device)."""
    gathered, dev = gather_shards(parts, mesh)
    total = gathered[0].clone()
    for t in gathered[1:]:
        total += t
    return total, dev


def gather_keeping_grads(parts: dict[int, torch.Tensor], mesh,
                         device: torch.device) -> list[torch.Tensor]:
    """Every data shard's tensor (equal shapes), in shard order, on
    ``device``, where this process's own parts keep their autograd graphs:
    the other processes' parts arrive through one ``all_gather`` without
    grad and this process's own are spliced back in. Every process then
    computes the same function of the gathered tensors, and a backward
    through it reaches exactly the local shards' graphs. Without a process
    group the parts just move to ``device``."""
    if not dist.is_initialized():
        D = mesh.shape["data"]
        if sorted(parts) != list(range(D)):
            raise ValueError(f"missing shard parts: have {sorted(parts)} of {D}")
        return [parts[s].to(device) for s in range(D)]
    gathered, _ = gather_shards({s: t.detach() for s, t in parts.items()}, mesh)
    out = [t.to(device) for t in gathered]
    for s, t in parts.items():
        out[s] = t.to(device)
    return out


def sum_grads(params: list[torch.Tensor]) -> None:
    """Replace each parameter's ``.grad`` with its sum over the processes:
    one ``all_gather`` of a flat buffer of every gradient, added in rank
    order (as :func:`sum_shards` adds), so the result is the same bits on
    every process and from run to run. A no-op without a process group."""
    if not dist.is_initialized():
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]).to(_comm_device())
    bufs = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, flat)
    total = bufs[0].clone()
    for b in bufs[1:]:
        total += b
    offset = 0
    for g in grads:
        g.copy_(total[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def allgather_host(arr: np.ndarray) -> np.ndarray:
    """Every process's copy of a small host array, stacked in rank order
    -> ``(process_count, *arr.shape)`` (``process_allgather``)."""
    arr = np.asarray(arr)
    if not dist.is_initialized():
        return arr[None]
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(_comm_device())
    bufs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, t)
    return np.stack([b.cpu().numpy() for b in bufs])
