"""The port's ``BertModel`` against ``transformers.BertModel``.

The same random HF state dict initializes ``transformers.BertModel`` and the
port's model, through the port's HF name mapping
(``hf_loader._model_state_dict``, what ``load_checkpoint`` uses); hidden
states and the full ColBERT forward must agree in fp32 within 2e-4 (the
JAX package's ``tests/test_hf_parity.py`` cases and bounds).
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from colbert_torch.models.bert import BertConfig, LayerNorm  # noqa: E402
from colbert_torch.models.colbert import ColBERT  # noqa: E402
from colbert_torch.models.hf_loader import _model_state_dict  # noqa: E402

ATOL = 2e-4


def _hf_model(seed: int, **overrides):
    """A random HF BertModel (no pooler) and the port's matching config."""
    kwargs = dict(vocab_size=97, hidden_size=64, num_hidden_layers=3,
                  num_attention_heads=4, intermediate_size=128,
                  max_position_embeddings=48, type_vocab_size=2,
                  layer_norm_eps=1e-12, hidden_act="gelu")
    kwargs.update(overrides)
    torch.manual_seed(seed)
    hf_cfg = transformers.BertConfig(attn_implementation="eager", **kwargs)
    model = transformers.BertModel(hf_cfg, add_pooling_layer=False).eval()
    return model, BertConfig(**kwargs)


def _ours_from_hf(model, cfg, linear: torch.nn.Linear | None = None, dim: int = 8) -> ColBERT:
    """The port's ColBERT carrying the HF model's weights (``bert.``-prefixed
    names and a ``linear`` head, as a ColBERT checkpoint holds them)."""
    raw = {f"bert.{k}": v.detach().clone() for k, v in model.state_dict().items()}
    if linear is None:
        linear = torch.nn.Linear(cfg.hidden_size, dim, bias=False)
    raw["linear.weight"] = linear.weight.detach().clone()
    sd = _model_state_dict(raw, cfg, "")
    ours = ColBERT(cfg, sd["linear.weight"].shape[0])
    ours.load_state_dict(sd, strict=True)
    return ours.eval()


def _compare(model, cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    lens = rng.integers(max(1, S // 3), S + 1, B)
    lens[0] = S  # ragged masks with one fully attended row
    mask = np.arange(S)[None, :] < lens[:, None]
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        ref = model(input_ids=ids_t, attention_mask=mask_t.long()).last_hidden_state
        out = _ours_from_hf(model, cfg).bert(ids_t, mask_t, torch.float32)
    # masked positions produce hidden states in both; compare every one
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("B,S", [(2, 16), (3, 48), (1, 7)])
def test_hidden_states_match_hf(B, S):
    model, cfg = _hf_model(seed=0)
    _compare(model, cfg, B, S, seed=B * 100 + S)


def test_gelu_new_variant():
    """HF's ``gelu_new`` (the tanh approximation) maps to the tanh GELU."""
    model, cfg = _hf_model(seed=1, hidden_act="gelu_new")
    assert cfg.hidden_act == "gelu_new"
    _compare(model, cfg, 2, 24, seed=7)


def test_layer_norm_eps_respected():
    """The configured eps reaches the normalization: on near-constant rows,
    where eps dominates the denominator, the port's LayerNorm equals
    torch's; and a full forward honours ``layer_norm_eps=1e-5``."""
    rng = np.random.default_rng(5)
    H = 64
    x = torch.from_numpy((1e-3 * rng.standard_normal((4, H)) + 0.5).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal(H).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(H).astype(np.float32))
    outs = {}
    for eps in (1e-12, 1e-5, 1e-3):
        ln = LayerNorm(H, eps)
        with torch.no_grad():
            ln.scale.copy_(scale)
            ln.bias.copy_(bias)
            ours = ln(x)
        ref = torch.nn.functional.layer_norm(x, (H,), scale, bias, eps)
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)
        outs[eps] = ours.numpy()
    assert not np.allclose(outs[1e-12], outs[1e-3], rtol=1e-3, atol=1e-3)
    model, cfg = _hf_model(seed=2, layer_norm_eps=1e-5)
    assert cfg.layer_norm_eps == 1e-5
    _compare(model, cfg, 2, 24, seed=9)


def test_full_colbert_forward_matches_hf():
    """HF BertModel + a torch linear head + L2 normalisation of the kept
    rows == the port's ``forward_normalized`` in fp32."""
    model, cfg = _hf_model(seed=3)
    torch.manual_seed(4)
    linear = torch.nn.Linear(cfg.hidden_size, 24, bias=False).eval()
    rng = np.random.default_rng(3)
    B, S = 3, 20
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    mask = torch.ones((B, S), dtype=torch.bool)
    keep = torch.from_numpy(rng.random((B, S)) > 0.2)
    with torch.no_grad():
        h = model(input_ids=ids, attention_mask=mask.long()).last_hidden_state
        proj = linear(h).numpy()
        out = _ours_from_hf(model, cfg, linear).forward_normalized(
            ids, mask, keep, dtype_name="float32").numpy()
    proj = np.where(keep.numpy()[..., None], proj, 0.0)
    norms = np.linalg.norm(proj, axis=-1, keepdims=True)
    ref = np.where(norms > 0, proj / np.maximum(norms, 1e-30), 0.0)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=ATOL)
