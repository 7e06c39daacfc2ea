"""ModernBERT encoder as a PyTorch ``nn.Module``: the encoder of
GTE-ModernColBERT (lightonai/GTE-ModernColBERT-v1, over
Alibaba-NLP/gte-modernbert-base at answerdotai/ModernBERT-base's widths).

The Hugging Face ``ModernBertModel`` equations (Warner et al. 2024): token
embeddings and a layer norm; per layer a pre-norm attention block (layer 0
has no attention norm) and a pre-norm GeGLU MLP, each added to the
residual stream; a final layer norm. Layer ``i`` attends globally when
``i % global_attn_every_n_layers == 0``; every other layer attends within
``local_attention // 2`` positions of each query (``|i - j| <= 64`` at
ModernBERT-base's 128). Queries and keys carry rotary positions (the
rotate-half convention), at ``global_rope_theta`` on global layers and
``local_rope_theta`` on local ones. No linear layer and no norm has a bias;
the MLP's ``mlp_in`` gives ``(a, g)`` halves and passes ``gelu(a) * g``.

Precision follows :mod:`colbert_torch.models.bert`: fp32 parameters cast to
the activation dtype for each product; layer norms in fp32; RoPE in fp32 on
the projections (tables fp32, built once per padded length, theta and
device: the span ``rope_tables``), rounded once; GeGLU in fp32, rounded
once; an additive pad bias of ``finfo(float32).min`` on the keys. Without
``use_flash`` attention is :func:`colbert_torch.models.bert._attention`'s
materialized route, with the band ``|i - j| > w`` at ``-inf`` on local
layers (left out where the padded length is at most ``w + 1``, since the
window then holds every key); with ``use_flash`` both layer kinds go through
:func:`colbert_torch.ops.flash_attention.flash_attention_bsh`, local layers
with ``window=w``. While recording (:mod:`colbert_torch.utils.tracing`)
each layer counts its route: ``attn_window_launches``,
``attn_global_launches`` (flash) or ``attn_materialized_launches``.

Parameter names are the port's own: ``word``, ``emb_norm``, per layer
``attn_norm`` (not in layer 0), ``qkv`` (the fused ``(3H, H)`` projection:
q, k, v rows in that order, heads contiguous in each), ``attn_out``,
``mlp_norm``, ``mlp_in`` (``(2F, H)``: the GELU half first, then the gate),
``mlp_out``, and ``final_norm``. No checkpoint loader reads them yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from colbert_torch.models.bert import _activation, _attention, _embedding
from colbert_torch.ops.flash_attention import band_mask, flash_attention_bsh
from colbert_torch.utils import tracing

__all__ = ["ModernBertConfig", "ModernBertModel"]


@dataclass(frozen=True)
class ModernBertConfig:
    """Hugging Face ``ModernBertConfig``'s keys that the forward reads, at
    ModernBERT-base's values."""

    vocab_size: int = 50368
    hidden_size: int = 768
    num_hidden_layers: int = 22
    num_attention_heads: int = 12
    intermediate_size: int = 1152
    max_position_embeddings: int = 8192
    global_attn_every_n_layers: int = 3
    local_attention: int = 128
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm_bias: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    hidden_activation: str = "gelu"

    def __post_init__(self) -> None:
        if self.norm_bias or self.attention_bias or self.mlp_bias:
            raise ValueError("ModernBERT with biases is not implemented (ModernBERT-base "
                             "has none: norm_bias, attention_bias and mlp_bias are false)")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a multiple of "
                             f"num_attention_heads {self.num_attention_heads}")

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "ModernBertConfig":
        """Test-sized: two periods of three layers (global, local, local),
        head dim 16, a window of +-8 positions."""
        return cls(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=6,
                   num_attention_heads=4, intermediate_size=96, max_position_embeddings=256,
                   local_attention=16)

    @property
    def window(self) -> int:
        """A local layer's half width: keys with ``|i - j| <= window``."""
        return self.local_attention // 2

    def is_global(self, layer: int) -> bool:
        return layer % self.global_attn_every_n_layers == 0


class _Norm(nn.Module):
    """Bias-free layer norm in fp32; output in the input dtype."""

    def __init__(self, hidden: int, eps: float) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(hidden))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, None, self.eps).to(x.dtype)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype))


def rope_tables(S: int, hd: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(cos, sin)``, each ``(S, hd)``: position ``p`` times
    ``theta^(-2i/hd)`` for the ``hd/2`` frequencies, repeated for both
    halves (Hugging Face's ``ModernBertRotaryEmbedding``)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, device=device,
                                             dtype=torch.int64).float() / hd))
    freqs = torch.outer(torch.arange(S, device=device, dtype=torch.float32), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def _rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int) -> torch.Tensor:
    """RoPE on ``(B, S, heads * hd)`` projections in fp32, rounded once to
    ``x``'s dtype: ``x cos + rotate_half(x) sin`` per head, written as its
    two halves (``x1 c - x2 s``, ``x2 c + x1 s``; the tables' halves are
    equal), each product of an activation and an fp32 table computed in
    fp32 and the sum stored into the output once."""
    B, S, H = x.shape
    h2 = H // heads // 2
    x4 = x.reshape(B, S, heads, 2 * h2)
    x1, x2 = x4[..., :h2], x4[..., h2:]
    c, s = cos[None, :, None, :h2], sin[None, :, None, :h2]
    out = torch.empty(B, S, heads, 2 * h2, dtype=x.dtype, device=x.device)
    out[..., :h2] = x1 * c - x2 * s
    out[..., h2:] = x2 * c + x1 * s
    return out.view(B, S, H)


class ModernBertLayer(nn.Module):
    def __init__(self, cfg: ModernBertConfig, layer: int) -> None:
        super().__init__()
        H, Fi = cfg.hidden_size, cfg.intermediate_size
        self.num_heads = cfg.num_attention_heads
        self.act = cfg.hidden_activation
        self.is_global = cfg.is_global(layer)
        self.window = None if self.is_global else cfg.window
        self.theta = cfg.global_rope_theta if self.is_global else cfg.local_rope_theta
        self.attn_norm = None if layer == 0 else _Norm(H, cfg.norm_eps)
        self.qkv = nn.Linear(H, 3 * H, bias=False)
        self.attn_out = nn.Linear(H, H, bias=False)
        self.mlp_norm = _Norm(H, cfg.norm_eps)
        self.mlp_in = nn.Linear(H, 2 * Fi, bias=False)
        self.mlp_out = nn.Linear(Fi, H, bias=False)

    def _attend(self, q, k, v, mask_bias, use_flash):
        S = q.shape[1]
        if use_flash:
            tracing.count("attn_global_launches" if self.is_global else "attn_window_launches")
            return flash_attention_bsh(q, k, v, mask_bias[:, 0, 0, :], num_heads=self.num_heads,
                                       window=self.window)
        tracing.count("attn_materialized_launches")
        if self.window is not None and S - 1 > self.window:
            band = band_mask(S, self.window, q.device)
            mask_bias = mask_bias.masked_fill(band[None, None], float("-inf"))
        return _attention(q, k, v, mask_bias, self.num_heads)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor, rope: tuple,
                use_flash: bool = False) -> torch.Tensor:
        h = x if self.attn_norm is None else self.attn_norm(x)
        q, k, v = _dense(self.qkv, h).chunk(3, dim=-1)
        cos, sin = rope
        q = _rotary(q, cos, sin, self.num_heads)
        k = _rotary(k, cos, sin, self.num_heads)
        x = x + _dense(self.attn_out, self._attend(q, k, v.contiguous(), mask_bias, use_flash))
        a, g = _dense(self.mlp_in, self.mlp_norm(x)).chunk(2, dim=-1)
        # the gate is promoted to fp32 inside the product
        h = (_activation(self.act, a.float()) * g).to(x.dtype)
        return x + _dense(self.mlp_out, h)


class ModernBertModel(nn.Module):
    """Full ModernBERT forward -> final hidden states ``(B, S, hidden)``
    (after the final norm); the call of :class:`~colbert_torch.models.bert.BertModel`."""

    def __init__(self, cfg: ModernBertConfig) -> None:
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.word = _embedding(cfg.vocab_size, H)
        self.emb_norm = _Norm(H, cfg.norm_eps)
        self.layers = nn.ModuleList(ModernBertLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.final_norm = _Norm(H, cfg.norm_eps)
        self._rope: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, S: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The cached fp32 tables of padded length ``S`` and ``theta``. A
        table first built under a CUDA graph capture is not kept: its memory
        would belong to the graph's pool."""
        key = (S, theta, torch.device(device))
        got = self._rope.get(key)
        if got is None:
            with tracing.span("rope_tables"):
                hd = self.config.hidden_size // self.config.num_attention_heads
                got = rope_tables(S, hd, theta, device)
            if not (got[0].is_cuda and torch.cuda.is_current_stream_capturing()):
                self._rope[key] = got
        return got

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16, use_flash: bool = False,
                remat: bool = False) -> torch.Tensor:
        S = input_ids.shape[1]
        x = self.emb_norm(self.word(input_ids)).to(dtype)
        neg = torch.finfo(torch.float32).min
        mask_bias = torch.where(attention_mask.bool(), 0.0, neg).to(torch.float32)[:, None, None, :]
        for layer in self.layers:
            rope = self.rope(S, layer.theta, input_ids.device)
            if remat:
                x = checkpoint(layer, x, mask_bias, rope, use_flash, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, mask_bias, rope, use_flash)
        return self.final_norm(x)
