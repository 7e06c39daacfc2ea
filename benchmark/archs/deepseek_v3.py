"""DeepSeek-V3's decoder under ColBERT's bias-free linear head:
Moonlight-16B-A3B (moonshotai/Moonlight-16B-A3B, ``model_type``
``deepseek_v3``) with every output token projected and L2-normalized, as
ColPali and ColQwen2 use a decoder. The widths are a configuration's
``"deepseek_v3"`` group (Hugging Face ``DeepseekV3Config``'s keys).

The reference (``encode`` at ``"float32"``, the caller turning TF32 off) is
the published equations (DeepSeek-V3's modelling code) written out in fp32,
each weight upcast for its product:

- token embeddings, not scaled; per layer ``h = x + Attn(RMSNorm(x))``,
  then ``x = h + FFN(RMSNorm(h))``; a final RMSNorm; no bias anywhere;
  RMSNorm ``w x / sqrt(mean(x^2) + eps)``;
- latent attention with no query latent: ``q`` of ``heads x (nope +
  rope)``; ``kv_a`` gives the latent ``c_kv`` and the shared rotary key
  ``k_pe``; ``c_kv`` through an RMSNorm and ``kv_b`` gives ``k_nope`` and
  ``v`` per head; RoPE on the adjacent pairs ``(2i, 2i+1)`` of ``q_pe`` and
  ``k_pe`` at ``rope_theta^(-2i/rope)``; scores over ``sqrt(nope + rope)``,
  causal (``-inf`` above the diagonal), ``finfo(float32).min`` on pad keys;
- layer 0 a dense SwiGLU ``down(silu(gate x) * up x)``; every other layer
  routes each token by ``s = sigmoid(x W_g^T)``: the ``num_experts_per_tok``
  experts of largest ``s + e_score_correction_bias``, weighted by ``s`` over
  its sum over them plus 1e-20, times ``routed_scaling_factor``; each chosen
  expert's SwiGLU, weighted and added, plus the shared experts' SwiGLU
  (``n_shared_experts`` times ``moe_intermediate_size`` wide). The
  reference makes its own choice on its own fp32 scores and takes nothing
  from the program's routing;
- the head and an L2 normalization of every kept position.

It runs :data:`PASSAGES` passages at a time, each block cut to its last
real token. At ``"fp8"`` it is the control, rounding as
:mod:`benchmark.reference.encoder` does: every activation a layer hands on
(the residual stream included) and every product's two operands, the
router's input and weights included, to float8 e4m3 with a per-tensor
scale.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.encoder import _mm, _round

PROGRAM_CONFIG = "colbert_torch.models.deepseek_v3:DeepseekV3Config"
# passages a reference block encodes at once: 16 x 1,024 tokens keep a
# layer's fp32 scores near 1 GiB
PASSAGES = 16
# rows of a weight matrix drawn at once (bounds the fp32 draw's memory)
DRAW_ROWS = 1 << 14


def vocab_size(widths: dict) -> int:
    return widths["vocab_size"]


def _is_moe(widths: dict, layer: int) -> bool:
    return layer >= widths["first_k_dense_replace"]


def shapes(widths: dict, dim: int) -> dict[str, tuple]:
    """Parameter name -> shape (the port's ``state_dict`` names;
    ``nn.Linear``'s ``(out, in)``; experts stacked first)."""
    H, heads = widths["hidden_size"], widths["num_attention_heads"]
    nope, rope, vd = (widths["qk_nope_head_dim"], widths["qk_rope_head_dim"],
                      widths["v_head_dim"])
    rank, E, I = widths["kv_lora_rank"], widths["n_routed_experts"], widths[
        "moe_intermediate_size"]
    out = {"bert.word.weight": (widths["vocab_size"], H)}
    for i in range(widths["num_hidden_layers"]):
        p = f"bert.layers.{i}."
        out.update({p + "attn_norm.scale": (H,), p + "attn.q.weight": (heads * (nope + rope), H),
                    p + "attn.kv_a.weight": (rank + rope, H), p + "attn.kv_norm.scale": (rank,),
                    p + "attn.kv_b.weight": (heads * (nope + vd), rank),
                    p + "attn.o.weight": (H, heads * vd), p + "mlp_norm.scale": (H,)})
        if _is_moe(widths, i):
            S = widths["n_shared_experts"] * I
            out.update({p + "mlp.router.weight": (E, H), p + "mlp.router_bias": (E,),
                        p + "mlp.experts_gate_up": (E, 2 * I, H),
                        p + "mlp.experts_down": (E, H, I),
                        p + "mlp.shared.gate_up.weight": (2 * S, H),
                        p + "mlp.shared.down.weight": (H, S)})
        else:
            F = widths["intermediate_size"]
            out.update({p + "mlp.gate_up.weight": (2 * F, H), p + "mlp.down.weight": (H, F)})
    out["bert.final_norm.scale"] = (H,)
    out["linear.weight"] = (dim, H)
    return out


def make_weights(seed: int, widths: dict, dim: int, device) -> dict[str, torch.Tensor]:
    """-> name -> tensor on ``device``: every matrix, the expert stacks and
    the embedding table N(0, 0.02^2) drawn in fp32 from one generator on the
    device and rounded once to bf16; each router's
    ``e_score_correction_bias`` N(0, 0.02^2) in fp32; every norm scale 1.

    The matrices are bf16, the published checkpoint's precision: at this
    model's 15.6 B parameters fp32 would take 62.5 GB of the card's 80,
    leaving too little for a batch's activations and the captured
    programs' pools (the program casts them per product, which for bf16
    copies nothing; the reference upcasts each for its product)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    out = {}
    for name, shape in shapes(widths, dim).items():
        if name.endswith("scale"):
            out[name] = torch.ones(shape, device=device)
        elif name.endswith("router_bias"):
            out[name] = torch.randn(shape, generator=g, device=device) * 0.02
        else:
            t = torch.empty(shape, dtype=torch.bfloat16, device=device)
            flat = t.view(-1, shape[-1])
            for r in range(0, flat.shape[0], DRAW_ROWS):
                part = flat[r:r + DRAW_ROWS]
                part.copy_(torch.randn(part.shape, generator=g, device=device) * 0.02)
            out[name] = t
    return out


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def _linear(x, w, precision):
    return _round(_mm(x, w.float().t(), precision), precision)


def _swiglu(gu: torch.Tensor, precision: str) -> torch.Tensor:
    g, u = gu.chunk(2, dim=-1)
    return _round(torch.nn.functional.silu(g) * u, precision)


def _rope(x: torch.Tensor, theta: float, precision: str) -> torch.Tensor:
    """RoPE on the adjacent pairs of ``(..., n, rope)`` at positions
    ``0..n-1``."""
    n, d = x.shape[-2], x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float() / d))
    ang = torch.outer(torch.arange(n, device=x.device, dtype=torch.float32), inv_freq)
    c, s = ang.cos(), ang.sin()
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return _round(torch.stack((x0 * c - x1 * s, x1 * c + x0 * s), dim=-1).flatten(-2),
                  precision)


def _route(widths: dict, h: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor,
           precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (chosen experts ``(t, k)``, their weights) of rows ``h``."""
    s = torch.sigmoid(_mm(h, gate.float().t(), precision))
    choice = torch.topk(s + bias.float(), widths["num_experts_per_tok"], dim=-1).indices
    w = s.gather(-1, choice)
    return choice, w / (w.sum(-1, keepdim=True) + 1e-20) * widths["routed_scaling_factor"]


def _moe(W: dict, p: str, widths: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    """A MoE layer of rows ``h (t, H)``: the routed experts' weighted sum
    plus the shared experts'."""
    choice, w = _route(widths, h, W[p + "mlp.router.weight"], W[p + "mlp.router_bias"],
                       precision)
    routed = torch.zeros_like(h)
    gate_up, down = W[p + "mlp.experts_gate_up"], W[p + "mlp.experts_down"]
    for e in range(widths["n_routed_experts"]):
        tok, slot = (choice == e).nonzero(as_tuple=True)
        if tok.numel():
            y = _linear(_swiglu(_linear(h[tok], gate_up[e], precision), precision), down[e],
                        precision)
            routed.index_add_(0, tok, y * w[tok, slot, None])
    shared = _linear(_swiglu(_linear(h, W[p + "mlp.shared.gate_up.weight"], precision),
                             precision), W[p + "mlp.shared.down.weight"], precision)
    return _round(routed + shared, precision)


def _attention(W: dict, p: str, widths: dict, h: torch.Tensor, bias: torch.Tensor,
               precision: str) -> torch.Tensor:
    b, n, _ = h.shape
    heads = widths["num_attention_heads"]
    nope, rope, vd = (widths["qk_nope_head_dim"], widths["qk_rope_head_dim"],
                      widths["v_head_dim"])
    eps, theta = widths["rms_norm_eps"], widths["rope_theta"]
    q = _linear(h, W[p + "attn.q.weight"], precision).view(b, n, heads, nope + rope)
    q = q.transpose(1, 2)
    c, k_pe = _linear(h, W[p + "attn.kv_a.weight"], precision).split(
        (widths["kv_lora_rank"], rope), dim=-1)
    c = _round(_rms(c, W[p + "attn.kv_norm.scale"], eps), precision)
    kv = _linear(c, W[p + "attn.kv_b.weight"], precision).view(b, n, heads, nope + vd)
    k_nope, v = kv.transpose(1, 2).split((nope, vd), dim=-1)
    q = torch.cat((q[..., :nope], _rope(q[..., nope:], theta, precision)), dim=-1)
    k_pe = _rope(k_pe[:, None], theta, precision).expand(b, heads, n, rope)
    k = torch.cat((k_nope, k_pe), dim=-1)
    s = _mm(q, k.transpose(-1, -2), precision) / math.sqrt(nope + rope) + bias
    ctx = _round(_mm(torch.softmax(s, -1), v, precision), precision)
    return _linear(ctx.transpose(1, 2).reshape(b, n, heads * vd), W[p + "attn.o.weight"],
                   precision)


def _encode_block(W, widths, ids, mask, keep, precision):
    b, n = ids.shape
    eps = widths["rms_norm_eps"]
    x = _round(W["bert.word.weight"][ids].float(), precision)
    causal = torch.ones(n, n, dtype=torch.bool, device=ids.device).triu(1)
    bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)[:, None, None, :]
    bias = bias.masked_fill(causal, float("-inf"))
    for i in range(widths["num_hidden_layers"]):
        p = f"bert.layers.{i}."
        h = _round(_rms(x, W[p + "attn_norm.scale"], eps), precision)
        x = _round(x + _attention(W, p, widths, h, bias, precision), precision)
        h = _round(_rms(x, W[p + "mlp_norm.scale"], eps), precision)
        if _is_moe(widths, i):
            f = _moe(W, p, widths, h.reshape(b * n, -1), precision).view(b, n, -1)
        else:
            f = _linear(_swiglu(_linear(h, W[p + "mlp.gate_up.weight"], precision), precision),
                        W[p + "mlp.down.weight"], precision)
        x = _round(x + f, precision)
    x = _round(_rms(x, W["bert.final_norm.scale"], eps), precision)
    emb = _mm(x, W["linear.weight"].float().t(), precision) * keep[..., None].float()
    return emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def encode_blocks(weights: dict, widths: dict, ids: torch.Tensor, mask: torch.Tensor,
                  keep: torch.Tensor, precision: str = "float32",
                  passages: int = PASSAGES) -> torch.Tensor:
    """:func:`encode` with its block size given."""
    B, S = ids.shape
    out = torch.zeros(B, S, weights["linear.weight"].shape[0], device=ids.device)
    for s in range(0, B, passages):
        rows = slice(s, s + passages)
        # positions after the block's last real token reach no real one
        used = (mask[rows] | keep[rows]).any(dim=0).nonzero()
        n = int(used.max()) + 1 if len(used) else 1
        out[rows, :n] = _encode_block(weights, widths, ids[rows, :n], mask[rows, :n],
                                      keep[rows, :n], precision)
    return out


def encode(weights: dict, widths: dict, ids: torch.Tensor, mask: torch.Tensor,
           keep: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """-> (B, S, dim) unit embeddings (positions outside ``keep`` are 0)."""
    return encode_blocks(weights, widths, ids, mask, keep, precision)


def causal_keys(tokens: int, keys: float) -> float:
    """Keys summed over ``tokens`` causal positions, position ``i`` seeing
    ``min(i + 1, keys)``."""
    m = min(tokens, math.floor(keys))
    return m * (m + 1) / 2 + (tokens - m) * keys


def encoder_flops(widths: dict, dim: int, tokens: int, keys_per_token: float) -> float:
    """Forward FLOPs of ``tokens`` causal positions attending to at most
    ``keys_per_token`` keys: per token the active work of every layer
    (MLA's q, kv_a, kv_b and o projections; layer 0's dense SwiGLU; a MoE
    layer's router, its ``num_experts_per_tok`` chosen experts and its
    shared experts, each SwiGLU ``3 h f`` MACs), the two attention products
    at ``(nope + rope) + v`` MACs per (query, key) pair and head, and the
    head (``h dim``); 2 FLOPs a MAC."""
    H, heads, L = widths["hidden_size"], widths["num_attention_heads"], widths[
        "num_hidden_layers"]
    nope, rope, vd = (widths["qk_nope_head_dim"], widths["qk_rope_head_dim"],
                      widths["v_head_dim"])
    rank, I = widths["kv_lora_rank"], widths["moe_intermediate_size"]
    mla = H * heads * (nope + rope) + H * (rank + rope) + rank * heads * (nope + vd) \
        + heads * vd * H
    n_moe = sum(_is_moe(widths, i) for i in range(L))
    moe = (H * widths["n_routed_experts"]
           + 3 * H * I * (widths["num_experts_per_tok"] + widths["n_shared_experts"]))
    dense = 3 * H * widths["intermediate_size"]
    per_token = L * mla + n_moe * moe + (L - n_moe) * dense + H * dim
    pairs = causal_keys(int(tokens), keys_per_token)
    return 2.0 * (tokens * per_token + L * heads * (nope + rope + vd) * pairs)


def moe_work(widths: dict, tokens: float, rows: float, launches: int) -> tuple[float, float]:
    """-> (FLOPs, bytes) of the routed experts' grouped products: ``tokens``
    true tokens summed over the MoE layer calls, each through
    ``num_experts_per_tok`` experts' SwiGLU (``3 h i`` MACs); bytes of the
    held experts' bf16 weights once per launch (a gate/up launch reads the
    ``(E, 2 i, h)`` stack, a down launch the ``(E, h, i)`` one: half the
    launches each), and ``rows`` dispatched rows (padding included) in and
    out of both products in bf16."""
    H, I, E = widths["hidden_size"], widths["moe_intermediate_size"], widths["n_routed_experts"]
    flops = 2.0 * tokens * widths["num_experts_per_tok"] * 3 * H * I
    nbytes = launches / 2 * E * 3 * H * I * 2 + rows * 2 * (H + 2 * I + I + H)
    return flops, nbytes
