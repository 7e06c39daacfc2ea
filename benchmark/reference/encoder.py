"""ColBERT's encoder in plain PyTorch: BERT (Devlin et al. 2019; the
Hugging Face ``BertModel`` equations: word + position + token-type-0
embeddings and a layer norm, then per layer self-attention with an
additive mask on the keys, a residual layer norm, an erf-GELU MLP and a
residual layer norm), a bias-free linear head to ``dim`` and an L2
normalization of every position (ColBERT, Khattab & Zaharia 2020).

``precision="float32"`` is the reference: everything in fp32 (the caller
turns TF32 off). ``precision="fp8"`` is the control, the step below the
bfloat16 activations the configurations state: every activation a layer
hands on (the embedding and layer-norm outputs, each projection's output,
the attention probabilities and context, the GELU output) and every matrix
product's two operands, weights included, rounded to float8 e4m3 with a
per-tensor scale (amax to 448); products accumulate in fp32, layer norms,
softmax and GELU compute in fp32, as a bf16 program does in bf16."""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()  # the rounded value; gradients pass straight through


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return torch.matmul(_round(a, precision), _round(b, precision))


def _linear(x, w, b, precision):
    y = _mm(x, w.t(), precision)
    return _round(y if b is None else y + b, precision)


def _ln(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def encode(weights: dict, bert: dict, ids: torch.Tensor, mask: torch.Tensor,
           keep: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """-> (B, S, dim) unit embeddings (positions outside ``keep`` are 0)."""
    W = weights
    eps = bert["layer_norm_eps"]
    heads = bert["num_attention_heads"]
    B, S = ids.shape
    H = bert["hidden_size"]
    hd = H // heads
    x = (W["bert.word.weight"][ids] + W["bert.position.weight"][:S][None]
         + W["bert.token_type.weight"][0][None, None])
    x = _round(_ln(x, W["bert.emb_ln.scale"], W["bert.emb_ln.bias"], eps), precision)
    bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)[:, None, None, :]
    for i in range(bert["num_hidden_layers"]):
        p = f"bert.layers.{i}."

        def dense(name, h):
            return _linear(h, W[p + name + ".weight"], W[p + name + ".bias"], precision)

        def heads_of(t):
            return t.view(B, S, heads, hd).transpose(1, 2)

        q, k, v = (heads_of(dense(n, x)) for n in ("q", "k", "v"))
        probs = torch.softmax(_mm(q, k.transpose(-1, -2), precision) / math.sqrt(hd) + bias, -1)
        ctx = _round(_mm(probs, v, precision), precision).transpose(1, 2).reshape(B, S, H)
        x = _round(_ln(x + dense("attn_out", ctx), W[p + "attn_ln.scale"],
                       W[p + "attn_ln.bias"], eps), precision)
        h = _round(torch.nn.functional.gelu(dense("mlp_in", x)), precision)
        x = _round(_ln(x + dense("mlp_out", h), W[p + "mlp_ln.scale"], W[p + "mlp_ln.bias"],
                       eps), precision)
    emb = _mm(x, W["linear.weight"].t(), precision) * keep[..., None].float()
    return emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-12)
