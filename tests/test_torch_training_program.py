"""The training step program on the CPU (``colbert_torch.training.program``).

On the CPU a :class:`~colbert_torch.training.program.StepProgram` runs the
eager step on its static input buffers at every launch (capture and replay
are on the card only, ``tests/test_torch_cuda.py``). Held here:
- the trainer's route through the program equals ``make_train_step`` bit
  for bit over three steps (metrics, gradients, parameters, lr), for each of
  the three objectives, with the static buffers holding the last batch;
- the program's key: one program per batch shape, objective, set of
  parameter tensors, optimizer state and matmul precision flags; the same
  program otherwise (the first launch's optimizer state re-files it);
- the route decision: a card refuses a non-capturable optimizer
  (``ValueError`` naming ``capturable=True``), the CPU and a mesh take any;
- a tensor lr under ``LambdaLR(lr_multiplier)`` is filled in place with the
  multiplier's sequence (1e-6 relative: an fp32 lr), and AdamW's steps with
  it stay within 1e-2 x lr of the float lr's;
- the program route against the JAX trainer for the pairwise and the
  distillation objectives: loss 1e-4 relative, parameters within 1e-2 x lr
  after each of three steps, entries whose gradient was ever nonzero but
  below 1e-6 within 2 x lr per step (``test_torch_training.py`` holds the
  in-batch one).
"""

import copy

import numpy as np
import pytest
import torch

from colbert_torch.models.colbert import from_jax_params
from colbert_torch.training import program as tp
from colbert_torch.training import trainer as pt
from colbert_tpu.training import trainer as jt
from tests._torch_parity import one_torch_thread, to_numpy  # noqa: F401
from tests.test_torch_training import LR, _encoders, _paired, _port_batch, _triples

OBJECTIVES = {"in_batch": dict(in_batch_negatives=True),
              "pairwise": dict(in_batch_negatives=False),
              "distillation": dict(in_batch_negatives=True)}
SCHEDULE = dict(warmup_steps=2, total_steps=6)


def _teacher(objective, n, seed):
    if objective != "distillation":
        return None
    return np.random.default_rng(seed).standard_normal((n, 2)).astype(np.float32)


@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
def test_cpu_route_is_make_train_step(objective):
    """Three steps of the trainer (warm-up + cosine, clipping) on new
    batches each, against ``make_train_step`` on a twin fed the same
    batches: bit-equal metrics, gradients, parameters and lr; one program,
    launched three times, its buffers holding the last batch."""
    _, enc = _encoders()
    kw = OBJECTIVES[objective]
    twin = copy.deepcopy(enc.model)
    trainer = pt.ColBERTTrainer(enc, learning_rate=LR, **kw, **SCHEDULE)
    opt = torch.optim.AdamW(twin.parameters(), lr=LR, weight_decay=0.01)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, pt.lr_multiplier(**SCHEDULE))
    step = pt.make_train_step(twin, opt, dtype_name="float32", scheduler=sched,
                              max_grad_norm=1.0, **kw)
    for i in range(3):
        triples, teacher = _triples(8, seed=10 + i), _teacher(objective, 8, i)
        batch = _port_batch(trainer, triples, teacher)
        assert trainer.train_step(triples, teacher_scores=teacher) == step(batch)
        for p, q in zip(enc.model.parameters(), twin.parameters()):
            assert torch.equal(p, q) and torch.equal(p.grad, q.grad)
        assert trainer.optimizer.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    (prog,) = trainer.programs.programs()
    assert prog.launches == 3 and trainer.programs.built == 1
    for buf, want in zip(prog.inputs, batch.values()):
        assert buf.dtype == want.dtype and torch.equal(buf, want)


def _rebind(trainer):
    p = trainer.optimizer.param_groups[0]["params"][0]
    p.data = p.data.clone()


def _reload_optimizer(trainer):
    # a saved state loads as new tensors (its own state_dict would load as
    # the same tensors, which a graph may go on reading)
    trainer.optimizer.load_state_dict(copy.deepcopy(trainer.optimizer.state_dict()))


@pytest.fixture
def tf32_flag():
    flag = torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cuda.matmul.allow_tf32 = flag


CHANGES = {
    "nothing": (lambda t: None, 8, None, 1),
    "batch_shape": (lambda t: None, 4, None, 2),
    "objective": (lambda t: None, 8, "distillation", 2),
    "rebound_parameter": (_rebind, 8, None, 2),
    "loaded_optimizer_state": (_reload_optimizer, 8, None, 2),
    "matmul_flag": (lambda t: setattr(torch.backends.cuda.matmul, "allow_tf32",
                                      not torch.backends.cuda.matmul.allow_tf32), 8, None, 2),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_the_key_follows_what_a_graph_bakes_in(change, tf32_flag):
    """Two steps on one batch shape make one program (the first launch's
    optimizer state re-files it under the key that includes that state);
    after ``change`` the next step makes a new one, and a step of the
    unchanged kind replays the new key's program."""
    mutate, n, objective, built = CHANGES[change]
    _, enc = _encoders()
    trainer = pt.ColBERTTrainer(enc, learning_rate=LR)
    for i in range(2):
        trainer.train_step(_triples(8, seed=i))
    assert trainer.programs.built == len(trainer.programs) == 1
    mutate(trainer)
    trainer.train_step(_triples(n, seed=5), teacher_scores=_teacher(objective, n, 5))
    trainer.train_step(_triples(n, seed=6), teacher_scores=_teacher(objective, n, 6))
    assert trainer.programs.built == built
    launches = sorted(p.launches for p in trainer.programs.programs())
    assert launches == ([4] if built == 1 else [2, 2])


def test_the_route_refuses_a_non_capturable_optimizer_on_a_card():
    """The route decision as a plain function: a card takes a capturable
    optimizer and refuses one with any non-capturable group, naming it; the
    CPU and a mesh take either."""
    params = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    plain = torch.optim.Adam(params, lr=LR)
    mixed = torch.optim.AdamW([{"params": params[:1], "capturable": True},
                               {"params": params[1:]}], lr=LR)
    for opt, groups in ((plain, r"\[0\]"), (mixed, r"\[1\]")):
        named = groups + r" of \w+ must be built with capturable=True"
        with pytest.raises(ValueError, match=named):
            tp.step_route(cuda, None, opt)
        assert tp.step_route(cpu, None, opt) == "eager"
        assert tp.step_route(cuda, object(), opt) == "mesh"
    assert tp.step_route(cuda, None, torch.optim.Adam(params, lr=LR, capturable=True)) == "graphed"
    _, enc = _encoders()
    pt.ColBERTTrainer(enc, optimizer=lambda p: torch.optim.Adam(p, lr=LR))  # the CPU: eager


@pytest.mark.parametrize("setting", ["warmup_cosine", "warmup_only", "constant"])
def test_a_tensor_lr_follows_lr_multiplier(setting):
    """The card's optimizer form, AdamW with a tensor lr, under
    ``LambdaLR(lr_multiplier)``: the scheduler fills the same tensor in
    place with the multiplier's sequence (its ``initial_lr`` a copy), and
    the parameters stay within 1e-2 x lr of a float lr's AdamW."""
    kw = {"warmup_cosine": SCHEDULE, "warmup_only": dict(warmup_steps=3), "constant": {}}[setting]
    mult = pt.lr_multiplier(**kw)
    rng = np.random.default_rng(0)
    start = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    p1, p2 = torch.nn.Parameter(start.clone()), torch.nn.Parameter(start.clone())
    opt = torch.optim.AdamW([p1], lr=torch.tensor(LR), weight_decay=0.01)
    ref = torch.optim.AdamW([p2], lr=LR, weight_decay=0.01)
    lr = opt.param_groups[0]["lr"]
    scheds = [torch.optim.lr_scheduler.LambdaLR(o, mult) for o in (opt, ref)]
    assert opt.param_groups[0]["initial_lr"] is not lr
    for count in range(8):
        assert opt.param_groups[0]["lr"] is lr
        assert float(lr) == pytest.approx(LR * mult(count), rel=1e-6, abs=1e-12)
        g = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
        p1.grad, p2.grad = g.clone(), g.clone()
        opt.step()
        ref.step()
        for s in scheds:
            s.step()
        torch.testing.assert_close(p1.detach(), p2.detach(), rtol=0, atol=1e-2 * LR)
    assert not torch.equal(p1.detach(), start)


@pytest.mark.parametrize("objective", ["pairwise", "distillation"])
def test_program_route_matches_jax(objective):
    """Three steps of the default optimizer through the program route and
    through the JAX trainer from the same weights. An entry whose gradient
    was ever nonzero but below 1e-6 is held apart: Adam's first update of
    it is +-lr by the gradient's sign, which rounding may flip, so it may
    differ by up to 2 x lr per step since; every other entry within
    1e-2 x lr."""
    jenc, penc = _encoders()
    kw = OBJECTIVES[objective]
    jtr = jt.ColBERTTrainer(jenc, learning_rate=LR, **kw)
    ptr = pt.ColBERTTrainer(penc, learning_rate=LR, **kw)
    apart = None
    for i in range(3):
        triples, teacher = _triples(8, seed=20 + i), _teacher(objective, 8, i)
        jm = jtr.train_step(triples, teacher_scores=teacher)
        pm = ptr.train_step(triples, teacher_scores=teacher)
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-4)
        tiny = [(g.abs() < 1e-6) & (g != 0) for g in (p.grad for p in penc.model.parameters())]
        apart = tiny if apart is None else [a | t for a, t in zip(apart, tiny)]
        jmodel = from_jax_params(to_numpy(jenc.params), penc.model.bert.config)
        for (name, p), q, a in zip(penc.model.named_parameters(), jmodel.parameters(), apart):
            diff = (p - q).detach().abs()
            assert float(torch.where(a, 0, diff).max()) <= 1e-2 * LR, (i, name)
            assert float(torch.where(a, diff, 0).max()) <= 2 * LR * (i + 1), (i, name)
    assert ptr.programs.built == 1 and ptr.programs.programs()[0].launches == 3
