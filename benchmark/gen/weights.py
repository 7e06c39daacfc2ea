"""Random ColBERT weights drawn on the device from a seed, in a few large
calls: every matrix and embedding table N(0, 0.02^2) from one draw of a
``torch.Generator`` on the device, biases 0, layer-norm scales 1 (the init
scheme of ``colbert_torch.models.colbert.init_colbert``, not its numbers).
Names are those of the port's ``state_dict``; shapes are ``nn.Linear``'s
``(out, in)``. The same seed on the same device gives the same weights."""

from __future__ import annotations

import torch

LAYER_DENSE = ("q", "k", "v", "attn_out", "mlp_in", "mlp_out")
LAYER_LN = ("attn_ln", "mlp_ln")


def shapes(bert: dict, dim: int) -> dict[str, tuple]:
    """Parameter name -> shape for a BERT config dict and the head's width."""
    H, I = bert["hidden_size"], bert["intermediate_size"]
    out = {"bert.word.weight": (bert["vocab_size"], H),
           "bert.position.weight": (bert["max_position_embeddings"], H),
           "bert.token_type.weight": (bert["type_vocab_size"], H),
           "bert.emb_ln.scale": (H,), "bert.emb_ln.bias": (H,)}
    dense = {"q": (H, H), "k": (H, H), "v": (H, H), "attn_out": (H, H),
             "mlp_in": (I, H), "mlp_out": (H, I)}
    for i in range(bert["num_hidden_layers"]):
        for name in LAYER_DENSE:
            out[f"bert.layers.{i}.{name}.weight"] = dense[name]
            out[f"bert.layers.{i}.{name}.bias"] = (dense[name][0],)
        for name in LAYER_LN:
            out[f"bert.layers.{i}.{name}.scale"] = (H,)
            out[f"bert.layers.{i}.{name}.bias"] = (H,)
    out["linear.weight"] = (dim, H)
    return out


def make_weights(seed: int, bert: dict, dim: int, device) -> dict[str, torch.Tensor]:
    """-> name -> fp32 tensor on ``device``; the random ones are views of one
    buffer, so the draw is one call."""
    shp = shapes(bert, dim)
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
        elif n.endswith("bias"):
            out[n] = torch.zeros(s, device=device)
    return out
