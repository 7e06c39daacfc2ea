"""DeepSeek-V3's decoder block as a ColBERT encoder: Moonlight-16B-A3B
(moonshotai/Moonlight-16B-A3B, ``model_type`` ``deepseek_v3``), every output
token projected by ColBERT's head, as ColPali and ColQwen2 use a decoder.

The equations of the published modelling code (Hugging Face
``DeepseekV3Model``): token embeddings (not scaled); per layer a pre-norm
attention block and a pre-norm MLP, each added to the residual stream
(``h = x + Attn(RMSNorm(x))``, ``out = h + FFN(RMSNorm(h))``); a final
RMSNorm. No linear layer has a bias.

- RMSNorm: ``w x / sqrt(mean(x^2) + eps)`` in fp32, rounded once.
- Attention is multi-head latent attention without a query latent
  (``q_lora_rank`` null): ``q`` (``heads x (nope + rope)``) from the hidden
  state; ``kv_a`` gives the latent ``c_kv`` (``kv_lora_rank``) and one
  rotary key ``k_pe`` (``qk_rope_head_dim``) that every head shares; ``c_kv``
  passes an RMSNorm and ``kv_b`` (``heads x (nope + v)``) gives each head's
  ``k_nope`` and ``v``. RoPE rotates adjacent pairs ``(2i, 2i+1)`` of
  ``q_pe`` and ``k_pe`` at frequency ``theta^(-2i/rope)`` (DeepSeek's
  interleaved layout; fp32 tables, each product in fp32, rounded once).
  Scores are ``[q_nope, q_pe] . [k_nope, k_pe]`` over
  ``sqrt(nope + rope)``, causal, with ``finfo(float32).min`` on pad keys;
  ``o`` maps the heads' ``v`` back to the hidden width.
- Layer 0 (``first_k_dense_replace``) has a dense SwiGLU MLP of width
  ``intermediate_size``; every other layer is a MoE layer
  (:mod:`colbert_torch.ops.moe`: ``n_routed_experts`` SwiGLU experts of width
  ``moe_intermediate_size``, ``num_experts_per_tok`` chosen by the largest
  bias-corrected sigmoid scores, weights normalized and scaled by
  ``routed_scaling_factor``, and ``n_shared_experts`` shared experts as one
  SwiGLU of ``n_shared_experts`` times that width).

Attention is causal, as the published LM computes it; right padding puts
no pad key before a real query. It runs through
``scaled_dot_product_attention`` under a boolean causal-and-pad mask (each
query row must keep a key, which position 0 gives every row this port
builds): on an H100 at the build cell's 64-passage batches it took 0.61 ms
at 448 tokens and 2.0 ms at 1,024 against a materialized route's (fp32
scores and softmax) 3.1 and 14.8 ms, and 0.4 GiB against 12 (PERF.md).
Flash is refused: MLA's 192-wide q and k against 128-wide v are not a
shape ``flash_mma_kernel`` computes.

Parameters are used in the dtype they are given (the benchmark holds this
model's matrices in bf16), cast to the activation dtype per product. While
recording (:mod:`colbert_torch.utils.tracing`) each layer counts
``attn_mla_calls`` and its MoE layer the counters of :mod:`colbert_torch.ops.moe`.

Parameter names are the port's own: ``word``, per layer ``attn_norm``,
``attn.q``, ``attn.kv_a`` (``c_kv`` rows, then ``k_pe``), ``attn.kv_norm``,
``attn.kv_b`` (per head ``k_nope`` rows, then ``v``), ``attn.o``,
``mlp_norm``, then layer 0's ``mlp.gate_up`` (gate rows, then up) and
``mlp.down``, or a MoE layer's ``mlp.router`` (``(E, H)``), the fp32 buffer
``mlp.router_bias``, ``mlp.experts_gate_up`` (``(E, 2 I, H)``),
``mlp.experts_down`` (``(E, H, I)``), ``mlp.shared.gate_up`` and
``mlp.shared.down``; and ``final_norm``. No checkpoint loader reads them
yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from colbert_torch.models.bert import _embedding
from colbert_torch.ops import moe as moe_ops
from colbert_torch.utils import tracing

__all__ = ["DeepseekV3Config", "DeepseekV3Model", "allowed_keys", "rope_tables"]

@dataclass(frozen=True)
class DeepseekV3Config:
    """Hugging Face ``DeepseekV3Config``'s keys, at Moonlight-16B-A3B's
    values. Keys the forward does not read are kept so that the published
    config is taken whole; the mechanisms it names are checked."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    n_group: int = 1
    topk_group: int = 1
    topk_method: str = "noaux_tc"
    scoring_func: str = "sigmoid"
    norm_topk_prob: bool = True
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    ep_size: int = 1
    seq_aux: bool = True
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    max_position_embeddings: int = 8192
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    hidden_act: str = "silu"
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    num_nextn_predict_layers: int = 0
    model_type: str = "deepseek_v3"

    def __post_init__(self) -> None:
        unsupported = {
            "q_lora_rank": self.q_lora_rank is not None,
            "scoring_func": self.scoring_func != "sigmoid",
            "topk_method": self.topk_method != "noaux_tc",
            "n_group/topk_group": (self.n_group, self.topk_group) != (1, 1),
            "norm_topk_prob": not self.norm_topk_prob,
            "moe_layer_freq": self.moe_layer_freq != 1,
            "hidden_act": self.hidden_act != "silu",
            "attention_bias": self.attention_bias,
            "num_key_value_heads": self.num_key_value_heads != self.num_attention_heads,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"DeepSeek-V3 with these settings is not implemented: {bad} "
                             "(Moonlight-16B-A3B: no query latent, sigmoid scores, noaux_tc "
                             "top-k in one group, normalized weights, SwiGLU, no bias)")

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "DeepseekV3Config":
        """Test-sized, every mechanism kept: a dense layer 0 and three MoE
        layers of 8 experts, top-2, 2 shared; MLA with distinct latent,
        nope, rope and v widths (32, 24, 8, 16)."""
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=96,
                   moe_intermediate_size=32, num_hidden_layers=4, num_attention_heads=4,
                   num_key_value_heads=4, n_routed_experts=8, num_experts_per_tok=2,
                   kv_lora_rank=32, qk_nope_head_dim=24, qk_rope_head_dim=8, v_head_dim=16,
                   max_position_embeddings=256)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


class RMSNorm(nn.Module):
    """``scale * x / sqrt(mean(x^2) + eps)`` in fp32; output in the input dtype."""

    def __init__(self, hidden: int, eps: float) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(hidden))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        out = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (self.scale.float() * out).to(x.dtype)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype))


def rope_tables(S: int, rope_dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(cos, sin)``, each ``(S, rope_dim / 2)``: position ``p`` times
    ``theta^(-2i/rope_dim)``, one column per adjacent pair."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, rope_dim, 2, device=device,
                                             dtype=torch.int64).float() / rope_dim))
    freqs = torch.outer(torch.arange(S, device=device, dtype=torch.float32), inv_freq)
    return freqs.cos(), freqs.sin()


def _rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on the adjacent pairs of ``(B, heads, S, rope)`` in fp32, rounded
    once: ``(x0 c - x1 s, x1 c + x0 s)`` per pair."""
    x0, x1 = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.stack((x0 * cos - x1 * sin, x1 * cos + x0 * sin), dim=-1).flatten(-2).to(x.dtype)


def allowed_keys(attention_mask: torch.Tensor) -> torch.Tensor:
    """``(B, S)`` attention mask -> ``(B, 1, S, S)`` boolean: query ``i`` may
    read key ``j`` where ``j <= i`` and ``j`` is not padding."""
    S = attention_mask.shape[1]
    causal = torch.ones(S, S, dtype=torch.bool, device=attention_mask.device).tril()
    return causal[None, None] & attention_mask.bool()[:, None, None, :]


class MLAttention(nn.Module):
    def __init__(self, cfg: DeepseekV3Config) -> None:
        super().__init__()
        H, n = cfg.hidden_size, cfg.num_attention_heads
        self.heads, self.nope, self.rope = n, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        self.v_dim, self.rank = cfg.v_head_dim, cfg.kv_lora_rank
        self.scale = cfg.qk_head_dim ** -0.5
        self.q = nn.Linear(H, n * cfg.qk_head_dim, bias=False)
        self.kv_a = nn.Linear(H, cfg.kv_lora_rank + cfg.qk_rope_head_dim, bias=False)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b = nn.Linear(cfg.kv_lora_rank, n * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                              bias=False)
        self.o = nn.Linear(n * cfg.v_head_dim, H, bias=False)

    def forward(self, x: torch.Tensor, allowed: torch.Tensor, rope: tuple) -> torch.Tensor:
        """``allowed``: boolean ``(B, 1, S, S)``, the keys each query reads."""
        B, S, _ = x.shape
        n, nope, rope_dim = self.heads, self.nope, self.rope
        tracing.count("attn_mla_calls")
        q = _dense(self.q, x).view(B, S, n, nope + rope_dim).transpose(1, 2)
        c, k_pe = _dense(self.kv_a, x).split((self.rank, rope_dim), dim=-1)
        kv = _dense(self.kv_b, self.kv_norm(c)).view(B, S, n, nope + self.v_dim).transpose(1, 2)
        k_nope, v = kv.split((nope, self.v_dim), dim=-1)
        q_pe = _rotary(q[..., nope:], *rope)
        k_pe = _rotary(k_pe[:, None], *rope).expand(B, n, S, rope_dim)
        q = torch.cat((q[..., :nope], q_pe), dim=-1)
        k = torch.cat((k_nope, k_pe), dim=-1)
        out = F.scaled_dot_product_attention(q, k, v.contiguous(), attn_mask=allowed,
                                             scale=self.scale)
        return _dense(self.o, out.transpose(1, 2).reshape(B, S, n * self.v_dim))


class DenseMLP(nn.Module):
    """SwiGLU ``down(silu(gate x) * up x)``; ``gate_up`` holds the gate rows,
    then the up rows."""

    def __init__(self, hidden: int, width: int) -> None:
        super().__init__()
        self.gate_up = nn.Linear(hidden, 2 * width, bias=False)
        self.down = nn.Linear(width, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(self.down, moe_ops.swiglu(_dense(self.gate_up, x), x.dtype))


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV3Config) -> None:
        super().__init__()
        H, E, I = cfg.hidden_size, cfg.n_routed_experts, cfg.moe_intermediate_size
        self.top_k, self.scaling = cfg.num_experts_per_tok, cfg.routed_scaling_factor
        self.router = nn.Linear(H, E, bias=False)
        self.register_buffer("router_bias", torch.zeros(E, dtype=torch.float32))
        self.experts_gate_up = nn.Parameter(torch.empty(E, 2 * I, H))
        self.experts_down = nn.Parameter(torch.empty(E, H, I))
        for w in (self.experts_gate_up, self.experts_down):
            if w.device.type != "meta":
                nn.init.normal_(w, std=0.02)
        self.shared = DenseMLP(H, cfg.n_shared_experts * I)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_ops.moe(x, self.router.weight, self.router_bias, self.experts_gate_up,
                           self.experts_down, self.shared.gate_up.weight,
                           self.shared.down.weight, top_k=self.top_k, scaling=self.scaling)


class DeepseekV3Layer(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, layer: int) -> None:
        super().__init__()
        H = cfg.hidden_size
        self.attn_norm = RMSNorm(H, cfg.rms_norm_eps)
        self.attn = MLAttention(cfg)
        self.mlp_norm = RMSNorm(H, cfg.rms_norm_eps)
        self.mlp = MoE(cfg) if cfg.is_moe(layer) else DenseMLP(H, cfg.intermediate_size)

    def forward(self, x: torch.Tensor, allowed: torch.Tensor, rope: tuple) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), allowed, rope)
        return x + self.mlp(self.mlp_norm(x))


class DeepseekV3Model(nn.Module):
    """Full forward -> final hidden states ``(B, S, hidden)`` (after the
    final norm); the call of :class:`~colbert_torch.models.bert.BertModel`."""

    def __init__(self, cfg: DeepseekV3Config) -> None:
        super().__init__()
        self.config = cfg
        self.word = _embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DeepseekV3Layer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self._rope: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, S: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The cached fp32 tables of padded length ``S``. A table first built
        under a CUDA graph capture is not kept: its memory would belong to
        the graph's pool."""
        key = (S, torch.device(device))
        got = self._rope.get(key)
        if got is None:
            with tracing.span("rope_tables"):
                got = rope_tables(S, self.config.qk_rope_head_dim, self.config.rope_theta,
                                  device)
            if not (got[0].is_cuda and torch.cuda.is_current_stream_capturing()):
                self._rope[key] = got
        return got

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16, use_flash: bool = False,
                remat: bool = False) -> torch.Tensor:
        if use_flash:
            raise ValueError("DeepSeek-V3's latent attention has no flash route: its 192-wide "
                             "q and k against 128-wide v are not a shape flash_mma_kernel "
                             "computes (keep flash_min_seqlen above doc_maxlen)")
        S = input_ids.shape[1]
        dev = input_ids.device
        x = self.word(input_ids).to(dtype)
        allowed, rope = allowed_keys(attention_mask), self.rope(S, dev)
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, allowed, rope, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, allowed, rope)
        return self.final_norm(x)
