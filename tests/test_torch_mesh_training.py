"""Training over a device mesh: the port's ``ColBERTTrainer`` through
``ColBERTEncoder.attach_mesh`` (DP, TP and dp x tp on the CPU repeated)
against the JAX package's ``ColBERTTrainer`` over the same mesh on the
8-device virtual CPU mesh of tests/conftest.py, from the same weights
(``tests/test_torch_training.py``'s tiny encoder, fp32) and triples.

Tolerances (those of tests/test_torch_training.py):
- each step's loss 1e-4 relative;
- each parameter within 1e-2 x lr of the JAX package's after every step.
  Entries whose first-step gradient is nonzero and below 1e-6 are counted
  apart, as chip_smoke.py's card-vs-CPU training step counts them, and
  held to 5e-2 x lr: Adam's first update is lr * g / (|g| + 1e-8), so
  there a rounding difference of g moves the entry by a share of lr. One
  such entry (a value-projection weight, |g| 3.95e-9) moves 1.09e-2 x lr
  between the JAX package's own 4x1 mesh step and its one-device step,
  and 1.9e-2 x lr between the port's 1x2 step and the JAX 1x2 step;
- the gradient before any update within 1e-4 x its max |g| + 1e-7 of the
  JAX step's exact gradient;
- a mesh encode after training within 1e-5 of the trained model's encode.
"""

import copy

import numpy as np
import pytest
import torch

from colbert_torch.models.colbert import to_jax_params
from colbert_torch.parallel.mesh import make_mesh
from colbert_torch.training import trainer as pt
from colbert_tpu.parallel.mesh import make_mesh as j_make_mesh
from colbert_tpu.training import trainer as jt
from tests._torch_parity import one_torch_thread, to_numpy  # noqa: F401
from tests.test_torch_training import (LR, _encoders, _jax_grads, _leaves, _paired,
                                       _port_batch, _port_grads, _triples)

TEACHER = np.tile(np.asarray([[1.0, 3.0]], np.float32), (8, 1))
CASES = {  # mesh, in-batch negatives, teacher scores
    "2x1": ((2, 1), True, None),
    "4x1": ((4, 1), True, None),
    "1x2": ((1, 2), True, None),
    "2x2": ((2, 2), True, None),
    "4x1-pairwise": ((4, 1), False, None),
    "2x2-pairwise": ((2, 2), False, None),
    "2x2-distill": ((2, 2), True, TEACHER),
}


def _meshed(shape, **kw):
    """(JAX trainer, port trainer) over an ``shape`` mesh from the same weights."""
    jenc, penc = _encoders()
    jenc.attach_mesh(j_make_mesh(*shape))
    penc.attach_mesh(make_mesh(*shape, device="cpu"))
    return jt.ColBERTTrainer(jenc, **kw), pt.ColBERTTrainer(penc, **kw)


def _assert_params_close(model, jparams, first_grads, what: str) -> None:
    """Every entry within 1e-2 x lr; entries whose first-step gradient is
    nonzero and below 1e-6 within 5e-2 x lr (module doc)."""
    for path, got, want in _paired(to_jax_params(model), to_numpy(jparams)):
        g = np.abs(first_grads[path])
        apart = (g < 1e-6) & (g != 0)
        diff = np.abs(got - want)
        assert diff[~apart].max(initial=0.0) <= 1e-2 * LR, f"{what} {path}"
        assert diff[apart].max(initial=0.0) <= 5e-2 * LR, f"{what} {path} (near-zero grads)"


def _grads_by_path(model) -> dict:
    return dict(_leaves(_port_grads(model)))


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_steps_match_jax(case):
    """Three AdamW steps (clipping, constant lr) over the same mesh in both
    packages: the loss of every step and every parameter after it."""
    shape, in_batch, teacher = CASES[case]
    jtr, ptr = _meshed(shape, learning_rate=LR, in_batch_negatives=in_batch)
    triples = _triples(8, seed=3)
    for step in range(3):
        jm = jtr.train_step(triples, teacher)
        pm = ptr.train_step(triples, teacher)
        if step == 0:
            first = _grads_by_path(ptr.encoder.model)
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-4)
        _assert_params_close(ptr.encoder.model, jtr.encoder.params, first, f"step {step}")


def test_mesh_gradient_matches_exact_jax_gradient():
    """The dp x tp step's gradient (read before the update: the optimizer's
    lr is 0) against the JAX step's exact gradient of the whole batch."""
    jenc, penc = _encoders()
    triples = _triples(8, seed=3)
    want, jmetrics = _jax_grads(jenc, triples)
    penc.attach_mesh(make_mesh(2, 2, device="cpu"))
    trainer = pt.ColBERTTrainer(penc, optimizer=lambda p: torch.optim.SGD(p, lr=0.0))
    metrics = trainer.train_step(triples)
    np.testing.assert_allclose(metrics["loss"], jmetrics["loss"], rtol=1e-5)
    for path, g, w in _paired(_port_grads(penc.model), want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=path)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_mesh_encode_after_training_is_the_trained_model(shape):
    """The tensor-parallel shards copy their slices of the weights: after a
    step they take the updated weights, so a mesh encode is the trained
    model's (stale shards differed by 0.0716 before the trainer refreshed
    them)."""
    _, penc = _encoders()
    penc.attach_mesh(make_mesh(*shape, device="cpu"))
    pt.ColBERTTrainer(penc, learning_rate=LR).train_step(_triples(8, seed=3))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, penc.bert_config.vocab_size, (8, 16))
    mask = np.ones((8, 16), bool)
    mask[3, 10:] = False
    with torch.no_grad():
        got = penc._shard_forward(ids, mask, mask, dtype_name="float32")[:8]
        want = penc.model.encode_batch(*penc._put_batch(ids, mask, mask),
                                       dtype_name="float32")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_batch_must_divide_the_data_axis():
    jtr, ptr = _meshed((4, 1), learning_rate=LR)
    triples = _triples(6, seed=3)
    with pytest.raises(ValueError, match="must divide the data axis") as port_err:
        ptr.train_step(triples)
    with pytest.raises(ValueError) as jax_err:
        jtr.train_step(triples)
    assert str(port_err.value) == str(jax_err.value)
    assert ptr.history == []


def test_mesh_checkpoint_loads_in_both_packages(tmp_path):
    from colbert_torch.models.hf_loader import load_checkpoint
    from colbert_tpu.models.hf_loader import load_checkpoint as jax_load

    jtr, ptr = _meshed((2, 2), learning_rate=LR)
    triples = _triples(8, seed=3)
    jtr.train_step(triples)
    ptr.train_step(triples)
    first = _grads_by_path(ptr.encoder.model)
    ckpt = str(tmp_path / "ckpt")
    ptr.save_checkpoint(ckpt)
    _, model, _ = load_checkpoint(ckpt, device="cpu")
    _assert_params_close(model, jtr.encoder.params, first, "port load")
    _, params, _ = jax_load(ckpt)
    for path, got, want in _paired(to_numpy(params), to_jax_params(model)):
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_step_without_a_mesh_is_make_train_step():
    """Without a mesh the trainer's step is ``make_train_step``'s, bit for bit."""
    _, penc = _encoders()
    twin = copy.deepcopy(penc.model)
    trainer = pt.ColBERTTrainer(penc, learning_rate=LR)
    opt = torch.optim.AdamW(twin.parameters(), lr=LR, weight_decay=0.01)
    step = pt.make_train_step(
        twin, opt, dtype_name="float32", max_grad_norm=1.0,
        scheduler=torch.optim.lr_scheduler.LambdaLR(opt, pt.lr_multiplier()))
    triples = _triples(8, seed=3)
    batch = _port_batch(trainer, triples)
    for _ in range(2):
        assert trainer.train_step(triples) == step(batch)
    for a, b in zip(penc.model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
