"""ColBERT = BERT + a hidden->dim linear head (port of ``colbert_tpu.models.colbert``).

The encoder is BERT (:class:`~colbert_torch.models.bert.BertConfig`),
ModernBERT (:class:`~colbert_torch.models.modernbert.ModernBertConfig`,
GTE-ModernColBERT's) or DeepSeek-V3
(:class:`~colbert_torch.models.deepseek_v3.DeepseekV3Config`,
Moonlight-16B-A3B's), built by the config's type; either way the backbone
is the attribute ``bert`` and its config ``bert_config``.

``forward_normalized`` is ``_forward_normalized``: project the final hidden
states (activation-dtype operands, fp32 accumulation), add the optional
head bias, zero the positions outside ``keep_mask`` and L2-normalize with
the norm clamped inside the sqrt. ``encode_batch`` adds the output-dtype
conversion of the JAX ``encode_batch`` (a float dtype, or ``"int8"`` as
``round(x * 127)``). ``use_flash`` routes BERT's attention through the
flash-attention kernel. ``compress_rows`` is the residual codec the build
path runs on the doc encode's kept rows.
``remat`` (training) recomputes each BERT layer in the backward.
``from_jax_params`` and ``to_jax_params`` carry weights between the port and
the JAX package's pytree.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from colbert_torch.models.bert import BertConfig, BertModel
from colbert_torch.models.deepseek_v3 import DeepseekV3Config, DeepseekV3Model
from colbert_torch.models.modernbert import ModernBertConfig, ModernBertModel
from colbert_torch.ops import codec as codec_ops

__all__ = ["ColBERT", "DTYPES", "from_jax_params", "to_jax_params", "init_colbert",
           "skiplist_keep_mask", "compact_doc_embeddings", "compress_rows"]

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def encoder_for(cfg: BertConfig | ModernBertConfig | DeepseekV3Config) -> nn.Module:
    """A fresh encoder of the config's architecture."""
    if isinstance(cfg, ModernBertConfig):
        return ModernBertModel(cfg)
    if isinstance(cfg, DeepseekV3Config):
        return DeepseekV3Model(cfg)
    if isinstance(cfg, BertConfig):
        return BertModel(cfg)
    raise TypeError(f"no encoder architecture for a {type(cfg).__name__}")


class ColBERT(nn.Module):
    """``bert`` replaces the encoder of the model (a
    :class:`~colbert_torch.models.bert.TensorParallelBert`, which
    :func:`colbert_torch.parallel.tp.shard_params` builds); by default it is
    a fresh :class:`BertModel`, :class:`ModernBertModel` or
    :class:`DeepseekV3Model`, by the type of ``cfg``."""

    def __init__(self, cfg: BertConfig | ModernBertConfig | DeepseekV3Config,
                 dim: int = 128, *, linear_bias: bool = False, bert=None):
        super().__init__()
        self.bert_config = cfg
        self.bert = encoder_for(cfg) if bert is None else bert
        self.linear = nn.Linear(cfg.hidden_size, dim, bias=linear_bias)

    @property
    def dim(self) -> int:
        return self.linear.out_features

    def forward_normalized(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
        keep_mask: torch.Tensor, *, dtype_name: str = "bfloat16",
        use_flash: bool = False, remat: bool = False,
    ) -> torch.Tensor:
        """-> unit-norm fp32 embeddings ``(B, L, dim)``; dropped rows are 0.
        The norm is clamped inside the sqrt, so a dropped row's gradient is
        0, not NaN."""
        hidden = self.bert(input_ids, attention_mask, DTYPES[dtype_name], use_flash, remat)
        w = self.linear.weight.to(hidden.dtype)
        emb = torch.matmul(hidden.float(), w.float().t())
        if self.linear.bias is not None:
            emb = emb + self.linear.bias
        emb = emb * keep_mask[..., None].to(emb.dtype)
        sq = (emb * emb).sum(dim=-1, keepdim=True)
        return emb / torch.sqrt(torch.clamp(sq, min=1e-24))

    def encode_batch(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
        keep_mask: torch.Tensor, *, dtype_name: str = "bfloat16",
        out_dtype_name: str = "float32", use_flash: bool = False, remat: bool = False,
    ) -> torch.Tensor:
        emb = self.forward_normalized(input_ids, attention_mask, keep_mask,
                                      dtype_name=dtype_name, use_flash=use_flash,
                                      remat=remat)
        return _to_out_dtype(emb, out_dtype_name)


def _to_out_dtype(emb: torch.Tensor, out_dtype_name: str) -> torch.Tensor:
    """A float dtype, or ``"int8"`` as ``round(x * 127)`` (hosts divide by
    127)."""
    if out_dtype_name == "int8":
        return torch.clamp(torch.round(emb * 127.0), -127, 127).to(torch.int8)
    return emb.to(DTYPES[out_dtype_name])


def compress_rows(flat, centroids, bucket_cutoffs, nbits):
    """fp32 rows ``(M, dim)`` -> (codes ``(M,)`` int32, packed residuals
    ``(M, dim // 8 * nbits)`` uint8)."""
    codes = codec_ops.compress_into_codes(flat, centroids, bsize=1024)
    residuals = codec_ops.compress_residuals(flat, centroids[codes.long()],
                                             bucket_cutoffs, nbits=nbits)
    return codes, residuals


def skiplist_keep_mask(ids: np.ndarray, mask: np.ndarray, skiplist: list[int]) -> np.ndarray:
    """Host-side keep mask: attended positions whose token id is not skipped."""
    if not skiplist:
        return mask.copy()
    return mask & ~np.isin(ids, np.asarray(skiplist, dtype=ids.dtype))


def compact_doc_embeddings(emb: np.ndarray, keep: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Drop masked token positions -> (flat ``(sum(doclens), dim)``,
    doclens ``(B,)``) (reference embedding_utils.jl:195-205)."""
    doclens = keep.sum(axis=1).astype(np.int64)
    return np.ascontiguousarray(emb[keep]), doclens


def init_colbert(cfg: BertConfig | ModernBertConfig, dim: int = 128, *,
                 generator: torch.Generator,
                 linear_bias: bool = False) -> ColBERT:
    """Random ColBERT with the JAX package's init: dense kernels and
    embeddings N(0, 0.02^2), zero biases, unit layer-norm scales. Draws come
    from ``generator`` (a CPU ``torch.Generator``) in parameter order, so a
    seed fixes the model."""
    model = ColBERT(cfg, dim, linear_bias=linear_bias)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
    return model


_LAYER_DENSE = ("q", "k", "v", "attn_out", "mlp_in", "mlp_out")
_LAYER_LN = ("attn_ln", "mlp_ln")


def from_jax_params(params: Mapping[str, Any], cfg: BertConfig) -> ColBERT:
    """The weight carry-over: a JAX ColBERT pytree (``{"bert": ...,
    "linear": ...}`` with scan-stacked ``(L, in, out)`` layer kernels, the
    layout of ``colbert_tpu.models.hf_loader``), given as numpy arrays or
    anything ``np.asarray`` takes -> a port model computing the same
    function. ``cfg`` supplies what the shapes cannot (head count,
    activation, layer-norm eps)."""
    bert, lin = params["bert"], params["linear"]
    model = ColBERT(cfg, int(np.asarray(lin["kernel"]).shape[1]),
                    linear_bias="bias" in lin)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    emb = bert["embeddings"]
    sd = {
        "bert.word.weight": t(emb["word"]),
        "bert.position.weight": t(emb["position"]),
        "bert.token_type.weight": t(emb["token_type"]),
        "bert.emb_ln.scale": t(emb["ln"]["scale"]),
        "bert.emb_ln.bias": t(emb["ln"]["bias"]),
        "linear.weight": t(lin["kernel"]).t().contiguous(),
    }
    if "bias" in lin:
        sd["linear.bias"] = t(lin["bias"])
    layers = bert["layers"]
    for i in range(cfg.num_hidden_layers):
        for name in _LAYER_DENSE:
            sd[f"bert.layers.{i}.{name}.weight"] = (
                t(np.asarray(layers[name]["kernel"])[i]).t().contiguous())
            sd[f"bert.layers.{i}.{name}.bias"] = t(np.asarray(layers[name]["bias"])[i])
        for name in _LAYER_LN:
            sd[f"bert.layers.{i}.{name}.scale"] = t(np.asarray(layers[name]["scale"])[i])
            sd[f"bert.layers.{i}.{name}.bias"] = t(np.asarray(layers[name]["bias"])[i])
    model.load_state_dict(sd, strict=True)
    return model


def to_jax_params(model: ColBERT) -> dict:
    """Inverse of :func:`from_jax_params`: a port model -> the JAX ColBERT
    pytree as numpy fp32 arrays (``{"bert": {"embeddings", "layers"},
    "linear"}``, per-layer weights stacked on a leading layer axis, dense
    kernels ``(in, out)``)."""
    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().to("cpu", torch.float32).numpy().copy()

    bert = model.bert
    layers = {}
    for name in _LAYER_DENSE:
        mods = [getattr(layer, name) for layer in bert.layers]
        layers[name] = {"kernel": np.stack([a(m.weight).T for m in mods]),
                        "bias": np.stack([a(m.bias) for m in mods])}
    for name in _LAYER_LN:
        mods = [getattr(layer, name) for layer in bert.layers]
        layers[name] = {"scale": np.stack([a(m.scale) for m in mods]),
                        "bias": np.stack([a(m.bias) for m in mods])}
    linear = {"kernel": np.ascontiguousarray(a(model.linear.weight).T)}
    if model.linear.bias is not None:
        linear["bias"] = a(model.linear.bias)
    embeddings = {"word": a(bert.word.weight), "position": a(bert.position.weight),
                  "token_type": a(bert.token_type.weight),
                  "ln": {"scale": a(bert.emb_ln.scale), "bias": a(bert.emb_ln.bias)}}
    return {"bert": {"embeddings": embeddings, "layers": layers}, "linear": linear}
