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

Training over a mesh keeps the optimizer on the full model: the shards'
gradients add into the full parameters' (:func:`reduce_grads`), and after
the update the full weights are copied back into every shard
(:func:`refresh_replicas`). Each logical entry then has one gradient and
one optimizer state, as optax has on sharded params, so the global norm of
the clipping counts it once.
"""

from __future__ import annotations

import copy

import torch

from colbert_torch.models.bert import BertConfig, TensorParallelBert
from colbert_torch.models.colbert import ColBERT

__all__ = ["validate_tp", "colbert_param_specs", "replicate", "shard_params",
           "param_links", "reduce_grads", "refresh_replicas"]

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


def shard_params(model: ColBERT, mesh, shards=None) -> dict[int, ColBERT]:
    """One model per data shard of ``mesh`` (``shards``, default every one)
    -> ``{shard: model}``: with a model axis of 1 the model replicated on
    the shard's device, else a tensor-parallel model whose BERT splits over
    the shard's model group and whose head lies on the group's first
    device. Shards on the same devices share one model."""
    n_model = mesh.shape["model"]
    validate_tp(model.bert_config, n_model)
    built: dict[tuple, ColBERT] = {}
    out = {}
    for s in range(mesh.shape["data"]) if shards is None else shards:
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
        out[s] = built[group]
    return out


def param_links(model: ColBERT, replica: ColBERT) -> list[tuple]:
    """``(full parameter, replica parameter, index)`` for every parameter
    that ``replica``'s forward reads: ``model``'s ``full[index]`` is the
    replica's copy (``index`` None: the whole tensor). A plain replica
    links each parameter whole. A tensor-parallel replica (whose
    :class:`TensorParallelBert` is no ``nn.Module``, so its
    ``.parameters()`` hold only the head) links the replicated parameters
    whole, then model shard by model shard each layer's column slices (q,
    k, v, mlp_in rows and biases) and row slices (attn_out, mlp_out
    columns). A link whose replica parameter is the full one (the replica
    lies on the model's device) stays in the list."""
    bert = replica.bert
    if not isinstance(bert, TensorParallelBert):
        return [(p, r, None) for p, r in zip(model.parameters(), replica.parameters())]
    full = dict(model.named_parameters())
    mine = dict(bert.base.named_parameters(prefix="bert"))
    mine.update(replica.linear.named_parameters(prefix="linear"))
    names = [n for n, spec in colbert_param_specs(model).items() if spec == "replicated"]
    links = [(full[n], mine[n], None) for n in names]
    for layers in bert.shards:
        for i, sh in enumerate(layers):
            L = model.bert.layers[i]
            for kind, col in (("q", sh.hs), ("k", sh.hs), ("v", sh.hs), ("mlp_in", sh.ms)):
                lin = getattr(sh, kind)
                links += [(getattr(L, kind).weight, lin.weight, col),
                          (getattr(L, kind).bias, lin.bias, col)]
            links += [(L.attn_out.weight, sh.attn_out_w, (slice(None), sh.hs)),
                      (L.mlp_out.weight, sh.mlp_out_w, (slice(None), sh.ms))]
    return links


def _distinct(replicas) -> list[ColBERT]:
    """The replicas in data-shard order, each once (shards on the same
    devices share one)."""
    seen, out = set(), []
    for s in sorted(replicas):
        if id(replicas[s]) not in seen:
            seen.add(id(replicas[s]))
            out.append(replicas[s])
    return out


def reduce_grads(model: ColBERT, replicas: dict[int, ColBERT]) -> None:
    """Add every replica parameter's ``.grad`` into the matching entries of
    ``model``'s (a column shard into a row slice of the weight and its
    bias, a row shard into a column slice, a replicated parameter whole),
    replica by replica in data-shard order and within one in model-shard
    order, so the sum has one fixed order; then drop the replicas' grads.
    A replica parameter that is the full parameter already accumulated
    into it and is not added again; a parameter no replica reached gets a
    zero gradient, so that AdamW decays it as optax's adamw does."""
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for replica in _distinct(replicas):
            for full, rep, index in param_links(model, replica):
                if rep is full or rep.grad is None:
                    continue
                g = rep.grad.to(full.device)
                if index is None:
                    full.grad += g
                else:
                    full.grad[index] += g
                rep.grad = None


def refresh_replicas(model: ColBERT, replicas: dict[int, ColBERT]) -> None:
    """Copy ``model``'s weights into every replica and every
    :class:`BertLayerShard` slice, so that the replicas compute the model's
    current function (after an optimizer step on the full model)."""
    with torch.no_grad():
        for replica in _distinct(replicas):
            for full, rep, index in param_links(model, replica):
                if rep is not full:
                    rep.copy_(full if index is None else full[index])
