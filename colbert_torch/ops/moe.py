"""A sparse expert layer: DeepSeek-V3's router, dispatch, expert products,
combine and shared expert (Moonlight-16B-A3B's MoE layers).

Per token ``x`` (``(T, H)`` rows in the activation dtype):

- the router's logits ``x_fp32 . W_g_fp32^T`` (``W_g`` ``(E, H)``) and scores
  ``s = sigmoid(logits)``, in fp32;
- the ``k`` experts of largest ``s + bias`` (``bias`` the fp32
  ``e_score_correction_bias``: it picks experts, it does not weigh them);
- their weights ``s`` at the chosen experts over their sum plus 1e-20,
  times ``scaling`` (``routed_scaling_factor``);
- each chosen expert's SwiGLU ``down(silu(gate x) * up x)`` (``silu(g) * u``
  in fp32, rounded once), weighted and summed in fp32 in the order of the
  choice, plus the shared experts' SwiGLU, rounded once.

Every token reaches all ``k`` of its experts: no capacity, no dropping.

Two routes compute the experts, with the same values:

- :func:`experts_grouped` (CUDA tensors): the ``(token, choice)`` slots are
  sorted by expert on the device, per-expert row offsets come from a
  scatter-add of ones and a cumsum, and the gate/up and down products of
  all experts are two grouped products (``torch._grouped_mm`` with the
  offsets on the device). Nothing depends on the routing's counts on the
  host: no ``.item()``, ``nonzero``, ``bincount`` or data-dependent shape,
  so one forward runs eagerly or inside a captured CUDA graph alike. The
  outputs go back to slot order by a gather, and the weighted sum adds the
  ``k`` slots of a token in order, so a replay is bit for bit its eager
  run (no atomics);
- :func:`experts_loop` (CPU tensors): a plain loop over the experts, which
  reads each expert's rows on the host.

Expert weights are held stacked, ``(E, 2 I, H)`` (gate rows, then up rows)
and ``(E, H, I)``, each expert's matrix in ``nn.Linear``'s ``(out, in)``
layout; the grouped products read them transposed (``K``-major), and a
parameter in another dtype than the activations is cast per product.

While recording (:mod:`colbert_torch.utils.tracing`) a layer counts
``moe_layer_calls`` (one), ``moe_dispatch_rows`` (``T k``, padding
included) and, on the grouped route, ``moe_grouped_launches`` (two).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from colbert_torch.utils import tracing

__all__ = ["experts", "experts_grouped", "experts_loop", "moe", "route", "swiglu"]


def route(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor, top_k: int,
          scaling: float) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (chosen experts ``(T, k)`` int64 in order of ``s + bias``,
    descending; their fp32 weights ``(T, k)``)."""
    s = torch.sigmoid(F.linear(x.float(), gate.float()))
    choice = torch.topk(s + bias.float(), top_k, dim=-1).indices
    w = s.gather(-1, choice)
    return choice, w / (w.sum(-1, keepdim=True) + 1e-20) * scaling


def swiglu(gu: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``silu(g) * u`` of the halves of ``gu`` (gate first), in fp32 and
    rounded once to ``dtype``."""
    g, u = gu.chunk(2, dim=-1)
    return (F.silu(g.float()) * u).to(dtype)


def _weighted_sum(y: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``(T, k, H)`` slot outputs, ``(T, k)`` weights -> ``(T, H)`` fp32, the
    slots added in order."""
    out = y[:, 0].float() * weights[:, :1]
    for j in range(1, y.shape[1]):
        out += y[:, j].float() * weights[:, j:j + 1]
    return out


def experts_grouped(x: torch.Tensor, choice: torch.Tensor, weights: torch.Tensor,
                    gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The chosen experts' weighted sum ``(T, H)`` fp32 by two grouped
    products over the slots sorted by expert (no host read)."""
    T, k = choice.shape
    E = gate_up.shape[0]
    flat = choice.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    offs = counts.cumsum(0).to(torch.int32)
    rows = x.index_select(0, order // k)
    tracing.count("moe_grouped_launches", 2)
    h = swiglu(torch._grouped_mm(rows, gate_up.to(x.dtype).mT, offs=offs), x.dtype)
    y = torch._grouped_mm(h, down.to(x.dtype).mT, offs=offs)
    # sorted position of each slot: the inverse of ``order``
    where = torch.empty_like(order)
    where.scatter_(0, order, torch.arange(order.numel(), device=x.device))
    return _weighted_sum(y.index_select(0, where).view(T, k, -1), weights)


def experts_loop(x: torch.Tensor, choice: torch.Tensor, weights: torch.Tensor,
                 gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The plain route of :func:`experts_grouped`: one product pair per
    expert over the rows the host finds routed to it."""
    T, k = choice.shape
    y = torch.zeros(T, k, down.shape[1], dtype=x.dtype, device=x.device)
    for e in range(gate_up.shape[0]):
        tok, slot = (choice == e).nonzero(as_tuple=True)
        if tok.numel():
            h = swiglu(F.linear(x[tok], gate_up[e].to(x.dtype)), x.dtype)
            y[tok, slot] = F.linear(h, down[e].to(x.dtype))
    return _weighted_sum(y, weights)


def experts(x, choice, weights, gate_up, down, grouped: bool | None = None) -> torch.Tensor:
    """The grouped route for CUDA tensors, the loop otherwise (``grouped``
    overrides)."""
    if grouped is None:
        grouped = x.is_cuda
    return (experts_grouped if grouped else experts_loop)(x, choice, weights, gate_up, down)


def moe(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor, gate_up: torch.Tensor,
        down: torch.Tensor, shared_gate_up: torch.Tensor, shared_down: torch.Tensor, *,
        top_k: int, scaling: float, grouped: bool | None = None) -> torch.Tensor:
    """One MoE layer of ``(..., H)`` activations -> the same shape and dtype:
    the routed experts' weighted sum plus the shared experts' output."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    tracing.count("moe_layer_calls")
    tracing.count("moe_dispatch_rows", x.shape[0] * top_k)
    choice, weights = route(x, gate, bias, top_k, scaling)
    routed = experts(x, choice, weights, gate_up, down, grouped)
    shared = F.linear(swiglu(F.linear(x, shared_gate_up.to(x.dtype)), x.dtype),
                      shared_down.to(x.dtype))
    return (routed + shared.float()).to(x.dtype).view(shape)
