"""The port's flash attention on the CPU (its plain version, the materialized
fp32 softmax) vs the JAX package's Pallas kernel in interpret mode, to 2e-5
at fp32 (the two round the online and the materialized softmax apart); and
the port's BERT with ``use_flash=True`` vs ``bert_encode(use_flash=True)``
with interpret-mode flash, to 1e-4 on the hidden states of real tokens."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import colbert_tpu.ops.flash_attention as jfa
from colbert_tpu.models.bert import BertConfig as JBertConfig, bert_encode, init_bert_params
from colbert_torch.models.bert import BertConfig
from colbert_torch.models.colbert import from_jax_params
from colbert_torch.ops import flash_attention as tfa

from _torch_parity import to_numpy

NEG = float(np.finfo(np.float32).min)


def _case(rng, B, H, S, hd):
    q, k, v = (rng.standard_normal((B * H, S, hd)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, S), bool)
    mask[1, S // 2:] = False          # one batch row padded from S/2
    if S > 128:
        mask[0, S - 128:] = False     # one row whose last 128-key tile is all pad
    bias = np.where(mask, 0.0, NEG).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("S", [128, 256])
def test_plain_matches_pallas_interpret(rng, S):
    B, H, hd = 2, 3, 32
    q, k, v, bias = _case(rng, B, H, S, hd)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        num_heads=H, interpret=True))
    t = [torch.from_numpy(x) for x in (q, k, v, bias)]
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(*t, num_heads=H)
    assert got.dtype == torch.float32 and got.shape == (B * H, S, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(tfa.flash_attention_plain(*t, num_heads=H).numpy(), want,
                               atol=2e-5, rtol=0)
    assert tfa.flash_attention.launches == before  # CPU tensors launch nothing


def test_bsh_entry_point_matches(rng):
    B, H, S, hd = 2, 3, 256, 32
    q, k, v, bias = _case(rng, B, H, S, hd)

    def to_bsh(x):  # (B*H, S, hd) -> (B, S, H*hd)
        return torch.from_numpy(x).reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)

    got = tfa.flash_attention_bsh(to_bsh(q), to_bsh(k), to_bsh(v), torch.from_numpy(bias),
                                  num_heads=H)
    want = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, bias)), num_heads=H)
    np.testing.assert_array_equal(got.numpy(), to_bsh(want.numpy()).numpy())


@pytest.mark.parametrize("dtype,hd,variant", [
    (torch.bfloat16, 32, "mma"), (torch.bfloat16, 64, "mma"), (torch.bfloat16, 128, "mma"),
    (torch.float16, 32, "mma"), (torch.float16, 64, "mma"), (torch.float16, 128, "mma"),
    (torch.float32, 32, "simt"), (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 8, "simt"), (torch.bfloat16, 40, "simt"), (torch.float16, 96, "simt"),
])
def test_variant_depends_on_dtype_and_head_dim(dtype, hd, variant):
    assert tfa._variant(dtype, hd) == variant


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cpu_half_inputs_take_the_plain_version(rng, dtype):
    B, H, S, hd = 2, 2, 128, 64
    t = [torch.from_numpy(x) for x in _case(rng, B, H, S, hd)]
    q, k, v = (x.to(dtype) for x in t[:3])
    before = (tfa.flash_attention.launches, dict(tfa.flash_attention.variant_launches))
    got = tfa.flash_attention(q, k, v, t[3], num_heads=H)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v, t[3], num_heads=H))
    assert (tfa.flash_attention.launches, tfa.flash_attention.variant_launches) == before


def test_rejects_unaligned_and_bad_inputs():
    q = torch.zeros((2, 100, 32))
    with pytest.raises(ValueError, match="multiple of 128"):
        tfa.flash_attention(q, q, q, torch.zeros((1, 100)), num_heads=2)
    q = torch.zeros((2, 128, 12))
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q, torch.zeros((1, 128)), num_heads=2)
    q = torch.zeros((2, 128, 32))
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention(q, q, q, torch.zeros((2, 128)), num_heads=2)


def test_bert_flash_matches_bert_encode_flash(rng, monkeypatch):
    jcfg = JBertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=64,
                       max_position_embeddings=128)
    params = init_bert_params(jax.random.PRNGKey(0), jcfg)
    ids = rng.integers(0, 64, (2, 128)).astype(np.int32)
    mask = np.ones((2, 128), bool)
    mask[1, 64:] = False
    monkeypatch.setattr(jfa, "flash_attention",
                        functools.partial(jfa.flash_attention, interpret=True))
    want = np.asarray(bert_encode(params, jnp.asarray(ids), jnp.asarray(mask), cfg=jcfg,
                                  dtype_name="float32", use_flash=True))
    model = from_jax_params(to_numpy({"bert": params, "linear": {
        "kernel": np.zeros((32, 8), np.float32)}}), BertConfig(**dataclasses.asdict(jcfg)))
    with torch.no_grad():
        got = model.bert(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                         torch.float32, use_flash=True).numpy()
        plain = model.bert(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                           torch.float32).numpy()
    np.testing.assert_allclose(got[mask], want[mask], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[mask], plain[mask], atol=1e-4, rtol=0)
