"""ModernBERT under ColBERT's bias-free linear head: GTE-ModernColBERT-v1's
encoder (lightonai/GTE-ModernColBERT-v1, PyLate, over
Alibaba-NLP/gte-modernbert-base at answerdotai/ModernBERT-base's widths).
The widths are a configuration's ``"modernbert"`` group (Hugging Face
``ModernBertConfig``'s keys).

The reference (``encode`` at ``"float32"``, the caller turning TF32 off) is
the published equations (Warner et al. 2024; Hugging Face's
``ModernBertModel``) written out: token embeddings and a layer norm; per
layer ``i`` a pre-norm attention block (layer 0 has no attention norm) with
rotary positions (rotate-half) on q and k, global where ``i %
global_attn_every_n_layers == 0`` (theta ``global_rope_theta``), else
within ``|i - j| <= local_attention // 2`` (theta ``local_rope_theta``),
an additive ``finfo(float32).min`` on pad keys; a pre-norm GeGLU MLP
(``gelu(a) * g`` of the halves of ``mlp_in``, erf GELU); residual adds; a
final norm; no bias anywhere; then the head and an L2 normalization of
every kept position. It runs a few passages at a time, each cut to its
last real token, and attention over blocks of query rows against the keys
they can reach (full-size passages of 8,192 tokens would not fit whole).
At ``"fp8"`` it is the control, rounding as
:mod:`benchmark.reference.encoder` does: every activation a layer hands on
(the residual stream included) and every product's two operands to float8
e4m3 with a per-tensor scale.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.encoder import _mm, _round

PROGRAM_CONFIG = "colbert_torch.models.modernbert:ModernBertConfig"
# passages a reference block encodes at once, and query rows an attention
# block scores at once
PASSAGES = 1
ROWS = 1024


def vocab_size(widths: dict) -> int:
    return widths["vocab_size"]


def _is_global(widths: dict, layer: int) -> bool:
    return layer % widths["global_attn_every_n_layers"] == 0


def _window(widths: dict) -> int:
    return widths["local_attention"] // 2


def shapes(widths: dict, dim: int) -> dict[str, tuple]:
    """Parameter name -> shape (the port's ``state_dict`` names;
    ``nn.Linear``'s ``(out, in)``)."""
    H, F = widths["hidden_size"], widths["intermediate_size"]
    out = {"bert.word.weight": (widths["vocab_size"], H), "bert.emb_norm.scale": (H,)}
    for i in range(widths["num_hidden_layers"]):
        p = f"bert.layers.{i}."
        if i:
            out[p + "attn_norm.scale"] = (H,)
        out.update({p + "qkv.weight": (3 * H, H), p + "attn_out.weight": (H, H),
                    p + "mlp_norm.scale": (H,), p + "mlp_in.weight": (2 * F, H),
                    p + "mlp_out.weight": (H, F)})
    out["bert.final_norm.scale"] = (H,)
    out["linear.weight"] = (dim, H)
    return out


def make_weights(seed: int, widths: dict, dim: int, device) -> dict[str, torch.Tensor]:
    """-> name -> fp32 tensor on ``device``: every matrix and the embedding
    table N(0, 0.02^2) from one draw of a generator on the device (views of
    one buffer), every norm scale 1."""
    shp = shapes(widths, dim)
    random = [n for n in shp if n.endswith("weight")]
    sizes = [int(torch.Size(shp[n]).numel()) for n in random]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    flat.mul_(0.02)
    out = dict(zip(random, (t.view(shp[n]) for n, t in zip(random, flat.split(sizes)))))
    for n, s in shp.items():
        if n.endswith("scale"):
            out[n] = torch.ones(s, device=device)
    return out


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale


def _linear(x, w, precision):
    return _round(_mm(x, w.t(), precision), precision)


def _rope(x: torch.Tensor, theta: float, precision: str) -> torch.Tensor:
    """Rotate-half RoPE of ``(b, heads, n, hd)`` at positions ``0..n-1``."""
    n, hd = x.shape[-2], x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device).float() / hd))
    freqs = torch.outer(torch.arange(n, device=x.device, dtype=torch.float32), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return _round(x * emb.cos() + torch.cat((-x2, x1), dim=-1) * emb.sin(), precision)


def _attention(q, k, v, bias, window, rows, precision):
    """``(b, heads, n, hd)`` q, k, v, ``(b, n)`` key bias -> ``(b, n, heads*hd)``;
    query rows in blocks of ``rows``, each against the keys it can reach."""
    b, heads, n, hd = q.shape
    out = []
    for r in range(0, n, rows):
        r1 = min(n, r + rows)
        lo, hi = (0, n) if window is None else (max(0, r - window), min(n, r1 + window))
        s = _mm(q[:, :, r:r1], k[:, :, lo:hi].transpose(-1, -2), precision) / math.sqrt(hd)
        s = s + bias[:, None, None, lo:hi]
        if window is not None:
            i = torch.arange(r, r1, device=q.device)
            j = torch.arange(lo, hi, device=q.device)
            s = s.masked_fill((i[:, None] - j[None, :]).abs() > window, float("-inf"))
        probs = torch.softmax(s, -1)
        out.append(_round(_mm(probs, v[:, :, lo:hi], precision), precision))
    return torch.cat(out, dim=2).transpose(1, 2).reshape(b, n, heads * hd)


def _encode_block(W, widths, ids, mask, keep, precision, rows):
    if widths.get("hidden_activation", "gelu") != "gelu":
        raise ValueError("ModernBERT's MLP is erf-GELU GeGLU (hidden_activation 'gelu')")
    b, n = ids.shape
    eps = widths["norm_eps"]
    H = widths["hidden_size"]
    heads = widths["num_attention_heads"]
    F = widths["intermediate_size"]
    x = _round(_norm(W["bert.word.weight"][ids], W["bert.emb_norm.scale"], eps), precision)
    bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)
    for i in range(widths["num_hidden_layers"]):
        p = f"bert.layers.{i}."
        glob = _is_global(widths, i)
        theta = widths["global_rope_theta"] if glob else widths["local_rope_theta"]
        h = x if i == 0 else _round(_norm(x, W[p + "attn_norm.scale"], eps), precision)
        qkv = _linear(h, W[p + "qkv.weight"], precision)
        q, k, v = (t.reshape(b, n, heads, H // heads).transpose(1, 2)
                   for t in qkv.split(H, dim=-1))
        q, k = _rope(q, theta, precision), _rope(k, theta, precision)
        ctx = _attention(q, k, v, bias, None if glob else _window(widths), rows, precision)
        x = _round(x + _linear(ctx, W[p + "attn_out.weight"], precision), precision)
        h = _round(_norm(x, W[p + "mlp_norm.scale"], eps), precision)
        a, g = _linear(h, W[p + "mlp_in.weight"], precision).split(F, dim=-1)
        h = _round(torch.nn.functional.gelu(a) * g, precision)
        x = _round(x + _linear(h, W[p + "mlp_out.weight"], precision), precision)
    x = _round(_norm(x, W["bert.final_norm.scale"], eps), precision)
    emb = _mm(x, W["linear.weight"].t(), precision) * keep[..., None].float()
    return emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def encode_blocks(weights: dict, widths: dict, ids: torch.Tensor, mask: torch.Tensor,
                  keep: torch.Tensor, precision: str = "float32", passages: int = PASSAGES,
                  rows: int = ROWS) -> torch.Tensor:
    """:func:`encode` with its block sizes given."""
    B, S = ids.shape
    out = torch.zeros(B, S, weights["linear.weight"].shape[0], device=ids.device)
    for s in range(0, B, passages):
        rows_ = slice(s, s + passages)
        # keys after the block's last real token weigh nothing: cut them off
        used = (mask[rows_] | keep[rows_]).any(dim=0).nonzero()
        n = int(used.max()) + 1 if len(used) else 1
        out[rows_, :n] = _encode_block(weights, widths, ids[rows_, :n], mask[rows_, :n],
                                       keep[rows_, :n], precision, rows)
    return out


def encode(weights: dict, widths: dict, ids: torch.Tensor, mask: torch.Tensor,
           keep: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """-> (B, S, dim) unit embeddings (positions outside ``keep`` are 0)."""
    return encode_blocks(weights, widths, ids, mask, keep, precision)


def _layer_kinds(widths: dict) -> tuple[int, int]:
    """-> (global layers, local layers)."""
    L = widths["num_hidden_layers"]
    n_global = sum(_is_global(widths, i) for i in range(L))
    return n_global, L - n_global


def window_keys(n: int, window: int) -> int:
    """(query, key) pairs of one sequence of ``n`` tokens with ``|i - j| <=
    window``: the diagonal and twice ``n - d`` at each distance ``d``."""
    m = max(0, min(window, n - 1))
    return n + 2 * m * n - m * (m + 1)


def window_pairs(widths: dict, lengths) -> int:
    """(query, key) pairs inside the window over every local layer and head
    of passages of ``lengths`` true tokens."""
    _, n_local = _layer_kinds(widths)
    return n_local * widths["num_attention_heads"] * sum(
        window_keys(int(x), _window(widths)) for x in lengths)


def encoder_flops(widths: dict, dim: int, tokens: int, keys_per_token: float) -> float:
    """Forward FLOPs of ``tokens`` positions, each attending on global
    layers to ``keys_per_token`` keys on average and on local layers to
    the keys inside its window of a ``tokens``-long sequence, capped at
    ``keys_per_token``: per token and layer the fused q, k, v and the output
    projections (``4 h^2`` MACs) and the GeGLU MLP (``3 h f``), the two
    attention products (``2 keys h``), and the head (``h dim``); 2 FLOPs a
    MAC."""
    h, f = widths["hidden_size"], widths["intermediate_size"]
    n_global, n_local = _layer_kinds(widths)
    local = min(keys_per_token, window_keys(int(tokens), _window(widths)) / max(1, tokens))
    per_token = ((n_global + n_local) * 2 * (4 * h * h + 3 * h * f)
                 + 4 * h * (n_global * keys_per_token + n_local * local) + 2 * h * dim)
    return tokens * per_token


def attention_work(widths: dict, lengths) -> dict[str, tuple[float, float]]:
    """-> ``{"local": (FLOPs, bytes), "global": (FLOPs, bytes)}`` of the
    attention of every local and every global layer over passages of
    ``lengths`` true tokens: ``4 hd`` FLOPs per (query, key) pair and head
    (every key on global layers, those inside the window on local ones);
    bytes of q, k, v and the output in bf16 once per layer and the fp32 key
    bias."""
    h, heads = widths["hidden_size"], widths["num_attention_heads"]
    hd = h // heads
    n = np.asarray(lengths, np.int64)
    n_global, n_local = _layer_kinds(widths)
    pairs_global = float((n * n).sum())
    nbytes = float(n.sum()) * (4 * h * 2 + 4)
    return {"local": (4 * hd * float(window_pairs(widths, n)), n_local * nbytes),
            "global": (n_global * 4 * hd * heads * pairs_global, n_global * nbytes)}
