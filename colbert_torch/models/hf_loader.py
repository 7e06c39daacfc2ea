"""HuggingFace ColBERT checkpoints (port of ``colbert_tpu.models.hf_loader``).

A checkpoint directory holds ``config.json``, ``vocab.txt`` and the weights
as ``model.safetensors`` or ``pytorch_model.bin``, with HF ``BertModel``
names plus the ColBERT ``linear`` head. ``load_checkpoint`` reads one;
``save_checkpoint`` writes one (fp32 safetensors, ``bert.``-prefixed BERT
names, ``linear.weight`` unprefixed: the JAX exporter's layout, so either
package loads what the other wrote). Safetensors files are read and written
by a small implementation of the format (an 8-byte little-endian header
length, a JSON header padded with spaces to a multiple of 8, then the raw
tensor bytes), so no ``safetensors`` package is needed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, Tuple

import torch

from colbert_torch.models.bert import BertConfig
from colbert_torch.models.colbert import ColBERT
from colbert_torch.tokenization.wordpiece import WordPieceTokenizer
from colbert_torch.utils.build import resolve_device

__all__ = ["load_checkpoint", "load_state_dict", "read_safetensors", "save_checkpoint",
           "state_dict_from_model", "write_safetensors"]

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def _refuse_other_arch(cfg) -> None:
    """A ``ValueError`` naming the architecture for anything but BERT: a
    port config (``ModernBertConfig``, ``DeepseekV3Config``) or an HF
    ``config.json`` dict whose ``model_type`` is another's. Only BERT
    checkpoints are read and written: no other architecture has a map from
    its published parameter names to the port's."""
    name = (cfg.get("model_type", "bert") if isinstance(cfg, dict)
            else "bert" if isinstance(cfg, BertConfig) else type(cfg).__name__)
    if name != "bert":
        raise ValueError(f"checkpoints of {name} are not read or written: the loader "
                         "handles BERT ColBERT checkpoints only (no map of its published "
                         "parameter names to the port's)")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        dtype = _ST_DTYPES[info["dtype"]]
        buf = bytearray(data[lo:hi])  # a writable copy owned by the tensor
        t = torch.frombuffer(buf, dtype=dtype) if hi > lo else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` as a ``.safetensors`` file (names sorted, data
    back to back in that order, little-endian as the host's memory is)."""
    names = {dt: name for name, dt in _ST_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for blob in blobs:
            f.write(blob)


def load_state_dict(directory: str) -> Dict[str, torch.Tensor]:
    """Raw weights from ``model.safetensors`` (preferred) or ``pytorch_model.bin``."""
    st_path = os.path.join(directory, "model.safetensors")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    pt_path = os.path.join(directory, "pytorch_model.bin")
    if os.path.exists(pt_path):
        return dict(torch.load(pt_path, map_location="cpu", weights_only=True))
    raise FileNotFoundError(
        f"no model.safetensors or pytorch_model.bin under {directory}"
    )


_HF_DENSE = {
    "q": "attention.self.query", "k": "attention.self.key",
    "v": "attention.self.value", "attn_out": "attention.output.dense",
    "mlp_in": "intermediate.dense", "mlp_out": "output.dense",
}
_HF_LN = {"attn_ln": "attention.output.LayerNorm", "mlp_ln": "output.LayerNorm"}


def _model_state_dict(raw: Dict[str, torch.Tensor], cfg: BertConfig,
                      prefix: str) -> Dict[str, torch.Tensor]:
    """HF names (``prefix`` = what precedes ``linear.weight``) -> the port's."""
    bert = {k[len(prefix):]: v for k, v in raw.items() if k.startswith(prefix)}
    if any(k.startswith("bert.") for k in bert):
        bert = {(k[5:] if k.startswith("bert.") else k): v for k, v in bert.items()}

    def f32(name):
        return bert[name].to(torch.float32)

    sd = {
        "bert.word.weight": f32("embeddings.word_embeddings.weight"),
        "bert.position.weight": f32("embeddings.position_embeddings.weight"),
        "bert.token_type.weight": f32("embeddings.token_type_embeddings.weight"),
        "bert.emb_ln.scale": f32("embeddings.LayerNorm.weight"),
        "bert.emb_ln.bias": f32("embeddings.LayerNorm.bias"),
        "linear.weight": f32("linear.weight"),
    }
    if "linear.bias" in bert:
        sd["linear.bias"] = f32("linear.bias")
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}"
        for ours, hf in _HF_DENSE.items():
            w = f32(f"{p}.{hf}.weight")
            sd[f"bert.layers.{i}.{ours}.weight"] = w
            b = bert.get(f"{p}.{hf}.bias")
            sd[f"bert.layers.{i}.{ours}.bias"] = (
                torch.zeros(w.shape[0]) if b is None else b.to(torch.float32))
        for ours, hf in _HF_LN.items():
            sd[f"bert.layers.{i}.{ours}.scale"] = f32(f"{p}.{hf}.weight")
            sd[f"bert.layers.{i}.{ours}.bias"] = f32(f"{p}.{hf}.bias")
    return sd


def state_dict_from_model(model: ColBERT, *, prefix: str = "bert.") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`_model_state_dict`: a port model -> HF-named fp32
    CPU tensors (``prefix`` before every BERT name, ``linear.*``
    unprefixed), as ``state_dict_from_params`` names the JAX pytree."""
    def f32(t):
        return t.detach().to("cpu", torch.float32)

    _refuse_other_arch(model.bert_config)
    bert = model.bert
    sd = {
        f"{prefix}embeddings.word_embeddings.weight": f32(bert.word.weight),
        f"{prefix}embeddings.position_embeddings.weight": f32(bert.position.weight),
        f"{prefix}embeddings.token_type_embeddings.weight": f32(bert.token_type.weight),
        f"{prefix}embeddings.LayerNorm.weight": f32(bert.emb_ln.scale),
        f"{prefix}embeddings.LayerNorm.bias": f32(bert.emb_ln.bias),
    }
    for i, layer in enumerate(bert.layers):
        p = f"{prefix}encoder.layer.{i}"
        for ours, hf in _HF_DENSE.items():
            sd[f"{p}.{hf}.weight"] = f32(getattr(layer, ours).weight)
            sd[f"{p}.{hf}.bias"] = f32(getattr(layer, ours).bias)
        for ours, hf in _HF_LN.items():
            sd[f"{p}.{hf}.weight"] = f32(getattr(layer, ours).scale)
            sd[f"{p}.{hf}.bias"] = f32(getattr(layer, ours).bias)
    sd["linear.weight"] = f32(model.linear.weight)
    if model.linear.bias is not None:
        sd["linear.bias"] = f32(model.linear.bias)
    return sd


def save_checkpoint(directory: str, model: ColBERT, tokenizer: WordPieceTokenizer) -> None:
    """Write an HF-compatible ColBERT checkpoint directory
    (``model.safetensors``, ``config.json``, ``vocab.txt``) that
    :func:`load_checkpoint`, and the JAX package's loader, read back. A
    tokenizer whose vocab ids are not ``0..n-1`` cannot be written as
    ``vocab.txt`` and is refused before anything is written."""
    _refuse_other_arch(model.bert_config)
    ids = sorted(tokenizer.vocab.values())
    if ids != list(range(len(ids))):
        raise ValueError("tokenizer vocab ids must be contiguous to export vocab.txt")
    os.makedirs(directory, exist_ok=True)
    write_safetensors(os.path.join(directory, "model.safetensors"),
                      state_dict_from_model(model))
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(model.bert_config), f, indent=2)
    by_id = sorted(tokenizer.vocab.items(), key=lambda kv: kv[1])
    with open(os.path.join(directory, "vocab.txt"), "w") as f:
        f.write("\n".join(tok for tok, _ in by_id) + "\n")


def load_checkpoint(
    directory: str, *, device: str | torch.device = "cuda",
) -> Tuple[BertConfig, ColBERT, WordPieceTokenizer]:
    """A ColBERT HF checkpoint dir -> (bert_cfg, model on ``device``, tokenizer).

    The ``linear`` head (hidden -> dim) is required, as in the reference's
    local loader (local_loading.jl:97-99)."""
    dev = resolve_device(device)
    with open(os.path.join(directory, "config.json")) as f:
        hf = json.load(f)
    _refuse_other_arch(hf)
    cfg = BertConfig.from_hf_dict(hf)
    raw = load_state_dict(directory)
    linear_key = next((k for k in raw if k in ("linear.weight", "model.linear.weight")), None)
    if linear_key is None:
        raise KeyError(
            "checkpoint has no 'linear.weight' projection head — not a ColBERT checkpoint"
        )
    prefix = linear_key[: -len("linear.weight")]
    sd = _model_state_dict(raw, cfg, prefix)
    model = ColBERT(cfg, sd["linear.weight"].shape[0],
                    linear_bias="linear.bias" in sd)
    model.load_state_dict(sd, strict=True)
    tokenizer = WordPieceTokenizer.from_pretrained(directory)
    return cfg, model.to(dev).eval(), tokenizer
