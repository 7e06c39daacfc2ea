"""Training parity: ``colbert_torch.training`` against ``colbert_tpu.training``.

Weights go from the JAX package's tiny ``make_encoder`` (2 layers, hidden
64, 4 heads, dim 32) to the port through ``from_jax_params``; inputs come
from numpy seeds. Tolerances:
- ``colbert_maxsim`` values rtol 1e-5 / atol 1e-6, gradients atol 1e-5;
- the three losses and ``_inbatch_loss``: values and gradients 1e-6;
- the loss closure at fp32 activations: loss 1e-5 relative, each gradient
  tensor within 1e-4 x its max |g| + 1e-7; at bf16, loss 2e-2 relative;
- optimizer steps: each step's loss 1e-4 relative, each parameter within
  1e-2 x the peak lr of the JAX package's after every step; the lr of
  every step equal to optax's schedule within 1e-9;
- checkpoints and weight carry-over: bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from colbert_torch.models.colbert import from_jax_params, to_jax_params
from colbert_torch.training import trainer as pt
from colbert_tpu.training import trainer as jt
from tests._torch_parity import one_torch_thread, port_encoder, to_numpy  # noqa: F401

LR = 1e-3


def _config(dtype: str = "float32"):
    from colbert_tpu.config import ColBERTConfig

    return ColBERTConfig(dim=32, doc_maxlen=64, query_maxlen=16, index_bsize=8,
                         length_bucket=16, activation_dtype=dtype)


def _encoders(dtype: str = "float32", seed: int = 0):
    """(JAX encoder, the port's encoder on the CPU with the same weights)."""
    from colbert_tpu.utils.testing import make_encoder

    jenc = make_encoder(dim=32, seed=seed, config=_config(dtype))
    return jenc, port_encoder(jenc)


def _triples(n, seed=0):
    """Positives share the query's words; negatives come from other docs
    (``tests/test_training.py``'s fixture)."""
    from colbert_torch.utils.testing import synthetic_collection

    rng = np.random.default_rng(seed)
    docs = synthetic_collection(2 * n, seed=seed + 1, words_per_doc=10)
    out = []
    for i in range(n):
        words = docs[i].split()
        q = " ".join(rng.choice(words, size=min(4, len(words)), replace=False))
        out.append((q, docs[i], docs[n + i]))
    return out


def _port_batch(trainer, triples, teacher=None):
    host = trainer._tensorize(triples)
    if teacher is not None:
        host["teacher_scores"] = np.asarray(teacher, np.float32)
    return dict(zip(host, trainer.encoder._put_batch(*host.values())))


def _port_grads(model) -> dict:
    """The model's ``.grad`` tensors in the JAX pytree layout."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(q.grad)
    return to_jax_params(g)


_CAPTURE = {}


def _jax_grads(jenc, triples, *, in_batch=True, teacher=None):
    """The JAX train step's gradient, read exactly: the step runs with an
    optax transform whose state is the gradient and whose update is 0."""
    key = (jenc.config.activation_dtype, in_batch)
    if key not in _CAPTURE:
        capture = optax.GradientTransformation(
            lambda params: jax.tree.map(jnp.zeros_like, params),
            lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))
        _CAPTURE[key] = (capture, jt.make_train_step(
            jenc.bert_config, capture, dtype_name=key[0], in_batch_negatives=in_batch))
    capture, step = _CAPTURE[key]
    host = jt.ColBERTTrainer(jenc, optimizer=capture)._tensorize(triples)
    if teacher is not None:
        host["teacher_scores"] = np.asarray(teacher, np.float32)
    batch = {k: jnp.asarray(v) for k, v in host.items()}
    _, grads, metrics = step(jenc.params, capture.init(jenc.params), batch)
    return to_numpy(grads), {k: float(v) for k, v in metrics.items()}


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _paired(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    return [(p, x, y) for (p, x), (_, y) in zip(la, lb)]


# -- MaxSim and the losses ----------------------------------------------------


def _maxsim_inputs(case):
    rng = np.random.default_rng({"ragged": 0, "empty_doc": 1, "ties": 2}[case])
    Bq, Bd, Lq, Ld, dim = 3, 4, 5, 7, 8
    Q = rng.standard_normal((Bq, Lq, dim)).astype(np.float32)
    D = rng.standard_normal((Bd, Ld, dim)).astype(np.float32)
    dmask = rng.random((Bd, Ld)) > 0.4
    dmask[:, 0] = True
    if case == "empty_doc":
        dmask[2] = False
    if case == "ties":
        D[:, 1] = D[:, 0]      # two kept rows with equal dot products
        D[:, 3] = D[:, 0]
        dmask[:, :4] = True
    W = rng.standard_normal((Bq, Bd)).astype(np.float32)
    return Q, D, dmask, W


@pytest.mark.parametrize("case", ["ragged", "empty_doc", "ties"])
def test_colbert_maxsim_matches_jax(case):
    Q, D, dmask, W = _maxsim_inputs(case)
    want = np.asarray(jt.colbert_maxsim(jnp.asarray(Q), jnp.asarray(D), jnp.asarray(dmask)))
    gq, gd = jax.grad(lambda q, d: jnp.sum(jt.colbert_maxsim(q, d, jnp.asarray(dmask)) * W),
                      argnums=(0, 1))(jnp.asarray(Q), jnp.asarray(D))

    tq = torch.from_numpy(Q).requires_grad_()
    td = torch.from_numpy(D).requires_grad_()
    got = pt.colbert_maxsim(tq, td, torch.from_numpy(dmask))
    (got * torch.from_numpy(W)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd), rtol=0, atol=1e-5)
    assert np.isfinite(td.grad.numpy()).all() and np.isfinite(tq.grad.numpy()).all()
    if case == "empty_doc":
        assert (got.detach().numpy()[:, 2] == 0).all()
        assert (td.grad.numpy()[2] == 0).all()
    if case == "ties":
        # the gradient of a tied max is split evenly among the tied rows
        g = td.grad.numpy()
        np.testing.assert_array_equal(g[:, 0], g[:, 1])
        np.testing.assert_array_equal(g[:, 0], g[:, 3])
        assert np.abs(g[:, 0]).max() > 0


@pytest.mark.parametrize("name", ["pairwise", "distill", "inbatch", "inbatch_ties"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(7)
    B = 6
    a = rng.standard_normal((B, B) if name.startswith("inbatch") else (B,)).astype(np.float32)
    b = rng.standard_normal((B,)).astype(np.float32)
    if name == "inbatch_ties":
        a[:, 0] = b  # hard negatives tied with the first positive
    teacher = rng.standard_normal((B, 2)).astype(np.float32)
    jfn = {"pairwise": jt.pairwise_softmax_loss,
           "distill": lambda x, y: jt.distill_kl_loss(jnp.stack([x, y], -1), teacher),
           "inbatch": jt._inbatch_loss, "inbatch_ties": jt._inbatch_loss}[name]
    pfn = {"pairwise": pt.pairwise_softmax_loss,
           "distill": lambda x, y: pt.distill_kl_loss(torch.stack([x, y], -1),
                                                      torch.from_numpy(teacher)),
           "inbatch": pt._inbatch_loss, "inbatch_ties": pt._inbatch_loss}[name]
    want, (ga, gb) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    got = pfn(ta, tb)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=0, atol=1e-6)


def test_loss_properties():
    """``tests/test_training.py``'s properties, on the port: a right ranking
    scores lower than a wrong one, a tie costs log 2, and distillation is 0
    exactly when the student's gaps match the teacher's."""
    pos, neg = torch.tensor([5.0, 5.0]), torch.tensor([1.0, 1.0])
    assert float(pt.pairwise_softmax_loss(pos, neg)) < float(pt.pairwise_softmax_loss(neg, pos))
    np.testing.assert_allclose(float(pt.pairwise_softmax_loss(pos, pos)), np.log(2), rtol=1e-6)
    logits = torch.tensor([[3.0, 1.0], [0.5, 2.5]])
    np.testing.assert_allclose(float(pt.distill_kl_loss(logits, logits + 7.0)), 0.0, atol=1e-6)
    assert float(pt.distill_kl_loss(logits, -logits)) > 0.1


# -- tensorization and the loss closure ------------------------------------


def test_tensorize_matches_jax():
    jenc, penc = _encoders()
    triples = _triples(8, seed=3) + [("a b", "", "!!! ...")]  # an empty and an all-skip doc
    want = jt.ColBERTTrainer(jenc, optimizer=optax.sgd(0.0))._tensorize(triples)
    got = pt.ColBERTTrainer(penc)._tensorize(triples)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


OBJECTIVES = {"inbatch": (True, None), "pairwise": (False, None),
              "distill": (True, np.tile(np.asarray([[1.0, 3.0]], np.float32), (8, 1)))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
def test_loss_closure_matches_jax(objective, dtype):
    in_batch, teacher = OBJECTIVES[objective]
    jenc, penc = _encoders(dtype)
    triples = _triples(8, seed=3)
    jgrads, jmetrics = _jax_grads(jenc, triples, in_batch=in_batch, teacher=teacher)

    model = penc.model
    batch = _port_batch(pt.ColBERTTrainer(penc), triples, teacher)
    loss, metrics = pt.train_loss(model, batch, dtype_name=dtype,
                                  in_batch_negatives=in_batch, remat=True)
    model.zero_grad()
    loss.backward()
    if dtype == "bfloat16":
        np.testing.assert_allclose(loss.item(), jmetrics["loss"], rtol=2e-2)
        return
    np.testing.assert_allclose(loss.item(), jmetrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["margin"]), jmetrics["margin"], rtol=1e-4,
                               atol=1e-5)
    assert float(metrics["pairwise_acc"]) == jmetrics["pairwise_acc"]
    for path, g, want in _paired(_port_grads(model), jgrads):
        tol = 1e-4 * np.abs(want).max() + 1e-7
        np.testing.assert_allclose(g, want, rtol=0, atol=tol, err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_leaves_loss_and_grads_unchanged(dtype):
    _, penc = _encoders(dtype)
    model = penc.model
    batch = _port_batch(pt.ColBERTTrainer(penc), _triples(8, seed=3))
    out = {}
    for remat in (True, False):
        model.zero_grad()
        loss, _ = pt.train_loss(model, batch, dtype_name=dtype, remat=remat)
        loss.backward()
        out[remat] = (loss.item(), [p.grad.clone() for p in model.parameters()])
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * float(b.abs().max()) + 1e-9)


def test_remat_forward_is_bit_identical():
    """Inference with ``remat`` on gives the same bits as with it off."""
    _, penc = _encoders("bfloat16")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 100, (3, 24)))
    mask = torch.ones((3, 24), dtype=torch.bool)
    mask[1, 17:] = False
    with torch.no_grad():
        a = penc.model.encode_batch(ids, mask, mask, remat=True)
        b = penc.model.encode_batch(ids, mask, mask)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- optimizer steps and schedules ---------------------------------------------

SETTINGS = {
    "adamw_clip_constant": dict(learning_rate=LR),
    "warmup_cosine": dict(learning_rate=LR, warmup_steps=2, total_steps=6),
    "warmup_only": dict(learning_rate=LR, warmup_steps=2),
    "adam": None,
}


def _optax_schedule(kw):
    if kw.get("warmup_steps") and kw.get("total_steps"):
        return optax.warmup_cosine_decay_schedule(0.0, LR, kw["warmup_steps"],
                                                  kw["total_steps"])
    if kw.get("warmup_steps"):
        return optax.linear_schedule(0.0, LR, kw["warmup_steps"])
    return lambda count: LR


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_optimizer_steps_match_jax(setting):
    """Three steps in both packages from the same weights, every entry of
    every parameter held to the bound, near-zero gradients included (Adam
    divides by sqrt(v), so an entry whose gradient is ~1e-7 is the most
    sensitive: none broke the bound here, so none is left out)."""
    kw = SETTINGS[setting]
    jenc, penc = _encoders()
    if kw is None:
        jtr = jt.ColBERTTrainer(jenc, optimizer=optax.adam(LR))
        ptr = pt.ColBERTTrainer(penc, optimizer=lambda p: torch.optim.Adam(p, lr=LR))
    else:
        jtr, ptr = jt.ColBERTTrainer(jenc, **kw), pt.ColBERTTrainer(penc, **kw)
    if kw is not None:
        # optax.adamw's mask=None: one group, every parameter decayed
        (group,) = ptr.optimizer.param_groups
        assert group["weight_decay"] == 0.01
        assert len(group["params"]) == len(list(penc.model.parameters()))
    triples = _triples(8, seed=3)
    before = to_numpy(jenc.params)
    for step in range(3):
        jm = jtr.train_step(triples)
        pm = ptr.train_step(triples)
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-4)
        for path, got, want in _paired(to_jax_params(penc.model), to_numpy(jenc.params)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * LR,
                                       err_msg=f"step {step} {path}")
        if kw is not None:
            want_lr = LR * ptr.scheduler.lr_lambdas[0](step + 1)
            assert ptr.optimizer.param_groups[0]["lr"] == pytest.approx(want_lr, abs=1e-12)
    if kw and kw.get("warmup_steps"):
        # optax reads the schedule before the step: the first step has lr 0
        ptr2 = pt.ColBERTTrainer(port_encoder(_encoders()[0]), **kw)
        start = [p.detach().clone() for p in ptr2.encoder.model.parameters()]
        ptr2.train_step(triples)
        assert all(torch.equal(a, b) for a, b in zip(start, ptr2.encoder.model.parameters()))
    moved = max(float(np.abs(after - b).max()) for (_, after, b)
                in _paired(to_jax_params(penc.model), before))
    assert moved > 1e-2 * LR


def test_zero_gradient_entries_decay():
    """optax.adamw decays every leaf, entries with a zero gradient too: the
    port's step leaves AdamW a gradient tensor for every parameter, so
    token_type row 1 and the unused position rows shrink by 1 - lr * wd."""
    _, penc = _encoders()
    trainer = pt.ColBERTTrainer(penc, learning_rate=LR)
    bert = penc.model.bert
    tt, pos = bert.token_type.weight[1].clone(), bert.position.weight[100:].clone()
    trainer.train_step(_triples(8, seed=3))
    assert all(p.grad is not None for p in penc.model.parameters())
    assert (bert.token_type.weight.grad[1] == 0).all() and (bert.position.weight.grad[100:] == 0).all()
    torch.testing.assert_close(bert.token_type.weight[1].detach(), tt * (1 - LR * 0.01))
    torch.testing.assert_close(bert.position.weight[100:].detach(), pos * (1 - LR * 0.01))
    assert not torch.equal(bert.token_type.weight[1], tt)


@pytest.mark.parametrize("setting", ["warmup_cosine", "warmup_only", "adamw_clip_constant"])
def test_lr_schedule_matches_optax(setting):
    kw = SETTINGS[setting]
    sched = _optax_schedule(kw)
    mult = pt.lr_multiplier(kw.get("warmup_steps", 0), kw.get("total_steps"))
    for count in range(kw.get("total_steps") or 6 + 3):
        assert abs(LR * mult(count) - float(sched(count))) <= 1e-9, count
    assert mult(0) == (0.0 if kw.get("warmup_steps") else 1.0)
    with pytest.raises(ValueError):
        pt.lr_multiplier(5, 5)  # optax refuses a cosine of no steps


def test_train_draws_the_jax_batches():
    """``train(batch_size=6)`` over 12 triples for two epochs: the same
    batches in the same order as the JAX trainer, and the same losses."""
    jenc, penc = _encoders()
    jtr, ptr = jt.ColBERTTrainer(jenc, learning_rate=LR), pt.ColBERTTrainer(penc,
                                                                         learning_rate=LR)
    seen = {"jax": [], "port": []}
    for name, tr in (("jax", jtr), ("port", ptr)):
        step = tr.train_step

        def recording(triples, teacher_scores=None, _step=step, _name=name):
            seen[_name].append(list(triples))
            return _step(triples, teacher_scores)

        tr.train_step = recording
    triples = _triples(13, seed=5)  # 13: the ragged tail of one is dropped
    jh = jtr.train(triples, batch_size=6, epochs=2, seed=4)
    ph = ptr.train(triples, batch_size=6, epochs=2, seed=4)
    assert seen["jax"] == seen["port"] and len(seen["port"]) == 4
    np.testing.assert_allclose([m["loss"] for m in ph], [m["loss"] for m in jh], rtol=1e-4)
    assert ptr.history == ph


# -- the port's counterparts of tests/test_training.py ------------------------


def _adam_trainer(**kw):
    from colbert_torch.utils.testing import make_encoder

    enc = make_encoder(dim=32, seed=0, device="cpu")
    return pt.ColBERTTrainer(enc, optimizer=lambda p: torch.optim.Adam(p, lr=LR), **kw)


@pytest.mark.parametrize("in_batch", [True, False])
def test_training_improves_margin(in_batch):
    trainer = _adam_trainer(in_batch_negatives=in_batch)
    triples = _triples(8, seed=3)
    first = trainer.train_step(triples)
    for _ in range(14):
        last = trainer.train_step(triples)
    assert np.isfinite(last["loss"])
    assert last["loss"] < first["loss"]
    assert last["margin"] > first["margin"]
    assert last["pairwise_acc"] >= 0.75


def test_distillation_follows_teacher_not_labels():
    """Inverted teacher scores (the negative preferred) push the student's
    margin below 0: the step optimizes the teacher's distribution."""
    trainer = _adam_trainer()
    triples = _triples(8, seed=3)
    teacher = np.tile(np.asarray([[0.0, 4.0]], np.float32), (8, 1))
    first = trainer.train_step(triples, teacher_scores=teacher)
    for _ in range(14):
        last = trainer.train_step(triples, teacher_scores=teacher)
    assert last["loss"] < first["loss"]
    assert last["margin"] < 0


def test_trained_params_flow_into_retrieval(tmp_path):
    """The trainer updates the encoder's model in place: an index build and
    a search with the same encoder use the fine-tuned weights, and the
    exported checkpoint loads back bit for bit."""
    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.models.hf_loader import load_checkpoint
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.utils.testing import synthetic_collection

    trainer = _adam_trainer()
    enc = trainer.encoder
    before = enc.model.linear.weight.detach().clone()
    trainer.train(_triples(12, seed=5), batch_size=6, epochs=1)
    assert float((enc.model.linear.weight.detach() - before).abs().max()) > 1e-5
    assert not any(p.grad is None for p in enc.model.parameters())

    passages = synthetic_collection(30, seed=2)
    path = str(tmp_path / "idx")
    Indexer(enc.config, encoder=enc, collection=passages, device="cpu").index(path)
    s = Searcher(path, encoder=enc, device="cpu")
    pids, _ = s.search_batch([passages[4], passages[21]], k=3)
    assert pids[0][0] == 4 and pids[1][0] == 21

    ckpt = str(tmp_path / "ckpt")
    trainer.save_checkpoint(ckpt)
    _, model2, tok2 = load_checkpoint(ckpt, device="cpu")
    sd2 = model2.state_dict()
    for k, v in enc.model.state_dict().items():
        assert torch.equal(v, sd2[k]), k
    assert tok2.vocab == enc.tokenizer.vocab


# -- checkpoints and weight carry-over across the packages ----------------------


def _jax_trained(tmp_path):
    """A JAX encoder after one training step, and its exported checkpoint."""
    from colbert_tpu.utils.testing import make_encoder

    jenc = make_encoder(dim=32, seed=1, config=_config())
    tr = jt.ColBERTTrainer(jenc, optimizer=optax.adam(LR))
    tr.train_step(_triples(8, seed=3))
    ckpt = str(tmp_path / "jax_ckpt")
    tr.save_checkpoint(ckpt)
    return jenc, ckpt


def test_port_checkpoint_loads_in_jax(tmp_path):
    from colbert_tpu.models.hf_loader import load_checkpoint as jax_load

    trainer = _adam_trainer()
    trainer.train_step(_triples(8, seed=3))
    ckpt = str(tmp_path / "ckpt")
    trainer.save_checkpoint(ckpt)
    cfg, params, tok = jax_load(ckpt)
    assert cfg.__dict__ == trainer.encoder.bert_config.__dict__
    assert tok.vocab == trainer.encoder.tokenizer.vocab
    for path, got, want in _paired(to_numpy(params), to_jax_params(trainer.encoder.model)):
        assert got.dtype == want.dtype == np.float32, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_jax_checkpoint_loads_in_port(tmp_path):
    from colbert_torch.models.bert import BertConfig
    from colbert_torch.models.hf_loader import load_checkpoint

    jenc, ckpt = _jax_trained(tmp_path)
    cfg, model, tok = load_checkpoint(ckpt, device="cpu")
    want = from_jax_params(to_numpy(jenc.params), BertConfig(**jenc.bert_config.__dict__))
    assert cfg == want.bert_config
    sd = model.state_dict()
    assert sorted(sd) == sorted(want.state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert tok.vocab == jenc.tokenizer.vocab


def test_safetensors_package_reads_the_port_file(tmp_path):
    from safetensors.numpy import load_file

    from colbert_torch.models.hf_loader import read_safetensors, state_dict_from_model

    trainer = _adam_trainer()
    ckpt = str(tmp_path / "ckpt")
    trainer.save_checkpoint(ckpt)
    got = load_file(f"{ckpt}/model.safetensors")
    want = state_dict_from_model(trainer.encoder.model)
    assert sorted(got) == sorted(want)
    assert "linear.weight" in got and "bert.encoder.layer.1.output.dense.weight" in got
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    with open(f"{ckpt}/model.safetensors", "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert n % 8 == 0
    back = read_safetensors(f"{ckpt}/model.safetensors")
    assert all(torch.equal(back[k], v) for k, v in want.items())


def test_safetensors_round_trip_dtypes(tmp_path):
    from safetensors.numpy import load_file

    from colbert_torch.models.hf_loader import read_safetensors, write_safetensors

    g = torch.Generator().manual_seed(0)
    tensors = {"a_f32": torch.randn((3, 5), generator=g),
               "b_bf16": torch.randn((4,), generator=g).to(torch.bfloat16),
               "c_i64": torch.arange(7, dtype=torch.int64).reshape(7, 1),
               "d_bool": torch.tensor([True, False, True]),
               "e_empty": torch.zeros((0, 3)),
               "f_u8": torch.arange(5, dtype=torch.uint8)}
    path = str(tmp_path / "t.safetensors")
    write_safetensors(path, tensors)
    back = read_safetensors(path)
    assert sorted(back) == sorted(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    # the safetensors package on the same writer (numpy has no bf16)
    numpyable = {k: v for k, v in tensors.items() if k != "b_bf16"}
    write_safetensors(str(tmp_path / "u.safetensors"), numpyable)
    lib = load_file(str(tmp_path / "u.safetensors"))
    assert sorted(lib) == sorted(numpyable)
    for k, v in numpyable.items():
        np.testing.assert_array_equal(lib[k], v.numpy(), err_msg=k)


def test_save_checkpoint_refuses_gapped_vocab(tmp_path):
    from colbert_torch.models.hf_loader import save_checkpoint
    from colbert_torch.tokenization.wordpiece import WordPieceTokenizer

    trainer = _adam_trainer()
    vocab = dict(trainer.encoder.tokenizer.vocab)
    vocab["w_gap"] = len(vocab) + 5
    ckpt = tmp_path / "ckpt"
    with pytest.raises(ValueError, match="contiguous"):
        save_checkpoint(str(ckpt), trainer.encoder.model, WordPieceTokenizer(vocab))
    assert not ckpt.exists()


@pytest.mark.parametrize("linear_bias", [False, True])
def test_jax_params_round_trip(linear_bias):
    from colbert_torch.models.bert import BertConfig
    from colbert_tpu.models.colbert import init_colbert_params
    from colbert_tpu.models.bert import BertConfig as JaxBertConfig

    jcfg = JaxBertConfig(vocab_size=50, hidden_size=32, num_hidden_layers=3,
                         num_attention_heads=2, intermediate_size=64,
                         max_position_embeddings=40)
    params = to_numpy(init_colbert_params(jax.random.PRNGKey(3), jcfg, dim=16,
                                          linear_bias=linear_bias))
    if linear_bias:
        params["linear"]["bias"] = np.arange(16, dtype=np.float32)
    back = to_jax_params(from_jax_params(params, BertConfig(**jcfg.__dict__)))
    for path, got, want in _paired(back, params):
        assert got.dtype == np.float32, path
        np.testing.assert_array_equal(got, want, err_msg=path)
