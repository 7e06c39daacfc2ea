"""BERT encoder as a PyTorch ``nn.Module`` (port of ``colbert_tpu.models.bert``).

Same math as ``bert_encode``: fp32 parameters cast to the activation dtype
for each matrix product, layer norms computed in fp32, erf- or tanh-GELU
on fp32 values, an additive attention-mask bias of ``finfo(float32).min``,
and the materialized softmax attention of ``_attention(use_flash=False)``
written out in torch ops (scores and the probability-weighted sum are
accumulated in fp32 from the activation-dtype operands, as the JAX
package's ``preferred_element_type=float32`` products are). With
``use_flash`` attention goes through
:func:`colbert_torch.ops.flash_attention.flash_attention_bsh` (the CUDA
kernel on the card, its plain version on the CPU) with the bias
``mask_bias[:, 0, 0, :]``, as ``bert_encode(use_flash=True)`` routes it
through the Pallas kernel. With ``remat`` each layer runs under
``torch.utils.checkpoint`` (``bert_encode(remat=True)``'s ``jax.checkpoint``):
the backward recomputes a layer's activations instead of keeping every
layer's attention temporaries; the values do not change.
:class:`TensorParallelBert` is the forward split over a mesh's model axis
(Megatron; :mod:`colbert_torch.parallel.tp`), each shard a
:class:`BertLayerShard` per layer; autograd goes through it, so the mesh
trainer differentiates it as it does :class:`BertModel`.

Parameter names follow the JAX pytree (``q``, ``k``, ``v``, ``attn_out``,
``attn_ln``, ``mlp_in``, ``mlp_out``, ``mlp_ln`` per layer); ``nn.Linear``
weights are ``(out, in)``, the transpose of the JAX ``(in, out)`` kernels.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from colbert_torch.ops.flash_attention import flash_attention_bsh

__all__ = ["BertConfig", "BertModel", "BertLayerShard", "TensorParallelBert"]


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"

    @classmethod
    def from_hf_dict(cls, d: dict) -> "BertConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class LayerNorm(nn.Module):
    """Layer norm in fp32 whatever the input dtype; output in the input dtype."""

    def __init__(self, hidden: int, eps: float) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` with fp32 params cast to the activation dtype."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("gelu", "gelu_new"):
        # HF "gelu" is erf-based; "gelu_new" is the tanh approximation
        return F.gelu(x, approximate="tanh" if name == "gelu_new" else "none")
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unsupported activation {name!r}")


def _attention(q, k, v, mask_bias, num_heads: int, use_flash: bool = False):
    """Multi-head attention of ``(B, S, heads * hd)`` projections under a
    ``(B, 1, 1, S)`` additive mask bias."""
    B, S, H = q.shape
    hd = H // num_heads
    if use_flash:
        return flash_attention_bsh(q, k, v, mask_bias[:, 0, 0, :], num_heads=num_heads)

    def split(x):  # (B, S, H) -> (B, heads, S, hd)
        return x.reshape(B, S, num_heads, hd).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores + mask_bias, dim=-1).to(q.dtype)
    out = torch.matmul(probs.float(), vh.float())
    return out.transpose(1, 2).reshape(B, S, H).to(q.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.num_heads = cfg.num_attention_heads
        self.act = cfg.hidden_act
        self.q = nn.Linear(H, H)
        self.k = nn.Linear(H, H)
        self.v = nn.Linear(H, H)
        self.attn_out = nn.Linear(H, H)
        self.attn_ln = LayerNorm(H, cfg.layer_norm_eps)
        self.mlp_in = nn.Linear(H, I)
        self.mlp_out = nn.Linear(I, H)
        self.mlp_ln = LayerNorm(H, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor,
                use_flash: bool = False) -> torch.Tensor:
        attn = _attention(_dense(self.q, x), _dense(self.k, x), _dense(self.v, x),
                          mask_bias, self.num_heads, use_flash)
        x = self.attn_ln(x + _dense(self.attn_out, attn))
        h = _activation(self.act, _dense(self.mlp_in, x).float()).to(x.dtype)
        return self.mlp_ln(x + _dense(self.mlp_out, h))


class BertModel(nn.Module):
    """Full BERT forward -> final hidden states ``(B, S, hidden)``."""

    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.word = nn.Embedding(cfg.vocab_size, H)
        self.position = nn.Embedding(cfg.max_position_embeddings, H)
        self.token_type = nn.Embedding(cfg.type_vocab_size, H)
        self.emb_ln = LayerNorm(H, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def embed(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
              dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (embedding-layer output in ``dtype``, the (B, 1, 1, S) fp32
        attention-mask bias)."""
        B, S = input_ids.shape
        pos = torch.arange(S, device=input_ids.device)
        x = (self.word(input_ids) + self.position(pos)[None]
             + self.token_type.weight[0][None, None])
        x = self.emb_ln(x).to(dtype)
        neg = torch.finfo(torch.float32).min
        mask_bias = torch.where(attention_mask.bool(), 0.0, neg)
        return x, mask_bias.to(torch.float32)[:, None, None, :]

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16, use_flash: bool = False,
                remat: bool = False) -> torch.Tensor:
        x, mask_bias = self.embed(input_ids, attention_mask, dtype)
        for layer in self.layers:
            if remat:
                # no dropout anywhere, so no RNG state to replay
                x = checkpoint(layer, x, mask_bias, use_flash, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, mask_bias, use_flash)
        return x


class BertLayerShard(nn.Module):
    """Model shard ``m`` of ``n`` of a :class:`BertLayer`, split the
    Megatron way: q, k, v and mlp_in keep output columns (whole heads, a
    slice of the MLP), attn_out and mlp_out the matching input rows. Each
    returns its partial sum of the row-parallel product; the biases of
    attn_out and mlp_out and the layer norms stay with the replicated
    layer (:class:`TensorParallelBert`)."""

    def __init__(self, layer: BertLayer, m: int, n: int) -> None:
        super().__init__()
        H, I = layer.q.in_features, layer.mlp_in.out_features
        # the full layer's hidden (heads) and MLP slices this shard holds
        self.hs = hs = slice(m * H // n, (m + 1) * H // n)
        self.ms = ms = slice(m * I // n, (m + 1) * I // n)
        self.num_heads = layer.num_heads // n
        self.act = layer.act

        def column(lin: nn.Linear, rows: slice) -> nn.Linear:
            out = nn.Linear(lin.in_features, rows.stop - rows.start)
            out.weight.data.copy_(lin.weight.data[rows])
            out.bias.data.copy_(lin.bias.data[rows])
            return out

        self.q, self.k, self.v = (column(layer.q, hs), column(layer.k, hs),
                                  column(layer.v, hs))
        self.mlp_in = column(layer.mlp_in, ms)
        self.attn_out_w = nn.Parameter(layer.attn_out.weight.data[:, hs].clone())
        self.mlp_out_w = nn.Parameter(layer.mlp_out.weight.data[:, ms].clone())

    def attention_partial(self, x, mask_bias, use_flash: bool = False) -> torch.Tensor:
        attn = _attention(_dense(self.q, x), _dense(self.k, x), _dense(self.v, x),
                          mask_bias, self.num_heads, use_flash)
        return F.linear(attn, self.attn_out_w.to(x.dtype))

    def mlp_partial(self, x: torch.Tensor) -> torch.Tensor:
        h = _activation(self.act, _dense(self.mlp_in, x).float()).to(x.dtype)
        return F.linear(h, self.mlp_out_w.to(x.dtype))


class TensorParallelBert:
    """A BERT forward split over a model group of ``devices``: shard ``m``
    (:class:`BertLayerShard`) runs its heads and its MLP slice on
    ``devices[m]``; the row-parallel partials are added in shard order on
    ``devices[0]`` (in fp32, then the bias, then the activation dtype), the
    one all-reduce per block of the Megatron scheme, before the residual
    layer norm. The embeddings, layer norms and row-parallel biases are
    replicated: they run once, on ``devices[0]``, whose result every shard
    reads. Autograd goes through it under the caller's grad mode: moving
    ``x`` to a shard's device and the reduce's sum are differentiable, so
    their backward gives Megatron's f/g operators (the column-parallel
    input's gradient summed over the shards, the reduce's gradient copied
    to each); with ``remat`` each block runs under ``torch.utils.checkpoint``
    as :class:`BertModel`'s layers do. Not an ``nn.Module``, so moving a
    model that holds it leaves the shards on their devices, and its
    ``.parameters()`` list none of the shards' weights
    (:func:`colbert_torch.parallel.tp.param_links` enumerates them). ``bert``
    must lie on ``devices[0]``."""

    def __init__(self, bert: BertModel, devices) -> None:
        self.config = bert.config
        self.base = bert
        self.devices = list(devices)
        n = len(self.devices)
        self.shards = [[BertLayerShard(layer, m, n).to(dev) for layer in bert.layers]
                       for m, dev in enumerate(self.devices)]

    def _reduce(self, parts: list[torch.Tensor], bias: torch.Tensor) -> torch.Tensor:
        home = self.devices[0]
        total = parts[0].to(home, torch.float32)
        for p in parts[1:]:
            total = total + p.to(home, torch.float32)
        return (total + bias.to(parts[0].dtype).float()).to(parts[0].dtype)

    def _block(self, i: int, x: torch.Tensor, biases: list[torch.Tensor],
               use_flash: bool) -> torch.Tensor:
        """Layer ``i``: the attention partials, their reduce, the layer norm,
        the MLP partials, their reduce and the layer norm."""
        layer = self.base.layers[i]
        attn = self._reduce([sh[i].attention_partial(x.to(d), b, use_flash)
                             for sh, d, b in zip(self.shards, self.devices, biases)],
                            layer.attn_out.bias)
        x = layer.attn_ln(x + attn)
        mlp = self._reduce([sh[i].mlp_partial(x.to(d))
                            for sh, d in zip(self.shards, self.devices)],
                           layer.mlp_out.bias)
        return layer.mlp_ln(x + mlp)

    def __call__(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = False,
                 remat: bool = False) -> torch.Tensor:
        x, mask_bias = self.base.embed(input_ids, attention_mask, dtype)
        biases = [mask_bias.to(d) for d in self.devices]
        for i in range(len(self.base.layers)):
            if remat:
                x = checkpoint(self._block, i, x, biases, use_flash, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._block(i, x, biases, use_flash)
        return x
