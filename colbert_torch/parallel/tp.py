"""Tensor parallelism for the encoder (port of ``colbert_tpu.parallel.tp``).

The ``model`` axis of a mesh splits each BERT block the Megatron way:

  - q, k, v and mlp_in are column-parallel (output features split): each
    model shard computes its own attention heads and MLP slice with no
    communication;
  - attn_out and mlp_out are row-parallel (input features split): each
    shard has a partial sum, added once per block before the residual
    layer norm (:class:`colbert_torch.models.bert.TensorParallelBert`);
  - embeddings, layer norms and the ColBERT linear head are replicated.

Contiguous column slices split whole heads when ``num_attention_heads %
n_model == 0`` (:func:`validate_tp`). Composes with data parallelism:
every data shard holds one model group.
"""

from __future__ import annotations

import copy

import torch

from colbert_torch.models.bert import BertConfig, TensorParallelBert
from colbert_torch.models.colbert import ColBERT

__all__ = ["validate_tp", "colbert_param_specs", "replicate", "shard_params"]

_COLUMN = ("q", "k", "v", "mlp_in")
_ROW = ("attn_out", "mlp_out")


def validate_tp(cfg: BertConfig, n_model: int) -> None:
    if n_model <= 1:
        return
    if cfg.num_attention_heads % n_model:
        raise ValueError(
            f"tensor parallelism needs num_attention_heads "
            f"({cfg.num_attention_heads}) divisible by the model axis ({n_model})")
    if cfg.intermediate_size % n_model:
        raise ValueError(
            f"tensor parallelism needs intermediate_size "
            f"({cfg.intermediate_size}) divisible by the model axis ({n_model})")


def colbert_param_specs(model: ColBERT) -> dict[str, str]:
    """How each parameter of ``model`` splits over the model axis:
    ``"column"`` (an ``(out, in)`` weight's rows, or a bias, split by output
    feature), ``"row"`` (a weight's columns: input features) or
    ``"replicated"``. Row-parallel biases are replicated: they are added
    once, after the partial sums."""
    specs = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        kind = parts[-2] if len(parts) >= 2 else ""
        if parts[0] == "bert" and parts[1] == "layers" and kind in _COLUMN:
            specs[name] = "column"
        elif parts[0] == "bert" and parts[1] == "layers" and kind in _ROW:
            specs[name] = "row" if parts[-1] == "weight" else "replicated"
        else:
            specs[name] = "replicated"
    return specs


def replicate(model: ColBERT, device: torch.device) -> ColBERT:
    """``model`` on ``device``: the model itself when it lies there, else a
    copy."""
    if next(model.parameters()).device == device:
        return model
    return copy.deepcopy(model).to(device).eval()


def shard_params(model: ColBERT, mesh) -> list[ColBERT]:
    """One model per data shard of ``mesh``: with a model axis of 1 the
    model replicated on the shard's device, else a tensor-parallel model
    whose BERT splits over the shard's model group and whose head lies on
    the group's first device. Shards on the same devices share one model."""
    n_model = mesh.shape["model"]
    validate_tp(model.bert_config, n_model)
    built: dict[tuple, ColBERT] = {}
    out = []
    for s in range(mesh.shape["data"]):
        group = tuple(mesh.model_devices(s))
        if group not in built:
            base = replicate(model, group[0])
            if n_model == 1:
                built[group] = base
            else:
                tp = ColBERT(model.bert_config, model.dim,
                             bert=TensorParallelBert(base.bert, group))
                tp.linear = base.linear
                built[group] = tp.eval()
        out.append(built[group])
    return out
