"""Captured training steps: one CUDA graph per static step key (the port's
counterpart of the JAX trainer's jitted ``step``).

The JAX trainer runs a training step as ONE compiled program
(``value_and_grad`` of the loss with each layer recomputed, the clipped
``adamw`` update at the schedule's count, the parameter update) and reads
its metrics back once. Here a :class:`StepProgram` captures the same
sequence of launches once per static key into a ``torch.cuda.CUDAGraph``
(:func:`colbert_torch.training.trainer.make_device_step`: forward, backward,
clipping, ``optimizer.step()``) and replays it:

- the first launch of a key is a real step run eagerly on the static input
  buffers, on the card's capture stream: it creates the optimizer's state
  tensors and the stream's cuBLAS workspace, which the graph then reads;
- the second launch zeroes the gradients to None and captures the step (the
  capture runs nothing), so every ``.grad`` lives in the graph's private
  pool and each replay overwrites it; then it replays, and that replay is
  the step's update;
- every later launch copies its inputs in from pinned staging and replays.
  After each replay ``p.grad`` is bound to the graph's gradient again, so
  it holds that step's gradient whatever the caller did to it since.

The optimizer must be capturable: its learning rate is a device tensor that
the schedule fills in place on the host's side of the step
(``LambdaLR.step()`` after the launch), and its step count lives on the
card. Replays run on the card's one replay stream
(:func:`colbert_torch.retrieval.program._device_streams`), which waits for
the caller's stream and which the caller's stream waits for, so serving
programs keyed on the same parameter addresses, encodes and checkpoints see
the updated weights. A capture or a replay that fails raises: nothing runs
the eager step in its place.

The key (:func:`step_key`) holds everything a graph bakes in: the batch's
shapes and dtypes, the objective, the activation dtype, ``max_grad_norm``,
the matmul precision flags, the optimizer's hyperparameters and the
(address, shape, dtype) of every parameter and optimizer state tensor, so a
reloaded state dict or ``optimizer.load_state_dict`` gives a new program and
a stale one is never replayed. On the CPU a program runs the eager step on
the same static buffers at every launch: the tests drive the buffers and
the keys there, and capture and replay only on the card.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from colbert_torch.retrieval.program import (Program, _capture_lock, _device_streams, capture,
                                             input_dtype, tensor_signature)

__all__ = ["StepProgram", "TRAIN_PROGRAMS", "input_dtype", "step_key", "step_route"]

# programs kept per trainer: ``train`` drops the ragged tail, so one batch
# shape per objective
TRAIN_PROGRAMS = 4


def step_route(device: torch.device, mesh, optimizer: torch.optim.Optimizer) -> str:
    """How a step of ``optimizer`` runs on ``device``: ``"mesh"`` over an
    attached mesh (eager), ``"eager"`` on the CPU, ``"graphed"`` on a card.
    A card refuses an optimizer with a param group that is not capturable,
    which a graph cannot replay (``ValueError``)."""
    if mesh is not None:
        return "mesh"
    if torch.device(device).type != "cuda":
        return "eager"
    groups = [i for i, g in enumerate(optimizer.param_groups) if not g.get("capturable")]
    if groups:
        raise ValueError(
            f"training on a card replays a captured step: param group(s) {groups} of "
            f"{type(optimizer).__name__} must be built with capturable=True (and a tensor "
            f"lr on the card where a schedule drives it)")
    return "graphed"


def _baked(value):
    """A hyperparameter as a graph bakes it in: a tensor by identity, the
    rest by value."""
    if isinstance(value, torch.Tensor):
        return tensor_signature([value])
    if isinstance(value, list):
        return tuple(value)
    return value


def step_key(host: dict, optimizer: torch.optim.Optimizer, *, objective: str,
             dtype_name: str, max_grad_norm: float | None, graphed: bool) -> tuple:
    """The static key of a step on the batch ``host`` (name -> array).
    A float learning rate is part of it only when ``graphed`` (a graph bakes
    it in; the eager route reads it at every step)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = [t for p in params for _, t in sorted(optimizer.state.get(p, {}).items())
             if isinstance(t, torch.Tensor)]
    hyper = tuple(
        tuple((k, _baked(v)) for k, v in sorted(g.items())
              if k != "params" and (graphed or isinstance(v, torch.Tensor)
                                    or k not in ("lr", "initial_lr")))
        for g in optimizer.param_groups)
    matmul = torch.backends.cuda.matmul
    flags = (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction,
             matmul.allow_fp16_reduced_precision_reduction)
    shapes = tuple((k, tuple(v.shape), str(v.dtype)) for k, v in host.items())
    return (shapes, objective, dtype_name, max_grad_norm, flags, hyper,
            tensor_signature(params), tensor_signature(state))


class StepProgram(Program):
    """One static training step: ``fn(*inputs) -> (3,) fp32 metrics`` over
    static input buffers of the given shapes and dtypes on ``device``,
    updating ``optimizer``'s parameters in place."""

    def __init__(self, fn: Callable, optimizer: torch.optim.Optimizer,
                 shapes: Sequence[tuple], dtypes: Sequence[torch.dtype], device: torch.device):
        super().__init__(fn, shapes, dtypes, device)
        self.optimizer = optimizer
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.grads = None  # the graph's gradient tensors
        self.launches = 0

    def launch(self, *host) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        """Fill the inputs from ``host`` and run one step -> (its metrics on
        the host, the event after which they are readable, or None on the
        CPU)."""
        with self.lock:
            if not self.cuda:
                self._copy_in(None, host)
                self.optimizer.zero_grad(set_to_none=True)
                values = self.fn(*self.inputs)
                self.launches += 1
                return values, None
            capture_stream, replay_stream = _device_streams(self.device)
            caller = torch.cuda.current_stream(self.device)
            if not self.launches:
                values, stream = self._warm_up(capture_stream, caller, host), capture_stream
            else:
                if self.graph is None:
                    self._capture(capture_stream)
                replay_stream.wait_stream(caller)
                with torch.cuda.stream(replay_stream):
                    self._copy_in(replay_stream, host)
                    self.graph.replay()
                    self.replays += 1
                for p, g in zip(self.params, self.grads):
                    if p.grad is not g:
                        p.grad = g
                values, stream = self.outputs, replay_stream
            self.launches += 1
            with torch.cuda.stream(stream):
                out = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
                out.copy_(values, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(stream)
            caller.wait_stream(stream)
        return out, ready

    def _warm_up(self, stream, caller, host) -> torch.Tensor:
        """The key's first launch: one real step, run eagerly on the static
        buffers on the capture stream."""
        with _capture_lock:
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                self._copy_in(stream, host)
                self.optimizer.zero_grad(set_to_none=True)
                return self.fn(*self.inputs)

    def _capture(self, stream) -> None:
        """The key's second launch: capture the step, its gradients new in
        the graph's pool. The capture runs nothing."""
        with _capture_lock:
            t0 = time.perf_counter()
            torch.cuda.synchronize(self.device)
            self.optimizer.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            with capture(graph, stream):
                self.outputs = self.fn(*self.inputs)
            self.grads = [p.grad for p in self.params]
            self.graph = graph
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
            self.capture_s = time.perf_counter() - t0
