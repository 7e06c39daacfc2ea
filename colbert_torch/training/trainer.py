"""Contrastive training of the ColBERT encoder (port of ``colbert_tpu.training.trainer``).

The objective is ColBERT's pairwise softmax cross-entropy over the (d+, d-)
MaxSim scores, optionally widened with in-batch negatives (every other
query's positive is an extra negative), or ColBERTv2's KL distillation
against a teacher's (pos, neg) scores. One step is the query forward, one
doc forward over ``[positives; negatives]``, MaxSim, the loss, autograd's
backward through the port's BERT (each layer recomputed, as the JAX step's
``remat=True``), global-norm clipping and the optimizer update.

The JAX trainer's optax chain maps to torch as follows:
- ``optax.adamw(lr, weight_decay)`` -> ``torch.optim.AdamW`` over every
  parameter in one group: optax's ``mask=None`` decays biases, layer-norm
  scales and embeddings too, so the usual HF exclusions are not copied;
- its learning-rate schedule -> a ``LambdaLR`` over :func:`lr_multiplier`
  (optax reads a schedule at the update count before the step, so the
  first step of a warmed-up run has lr 0; ``LambdaLR`` applies
  ``multiplier(0)`` to the first ``optimizer.step()`` as well);
- ``optax.clip_by_global_norm`` -> ``clip_grad_norm_``.

Training runs on the encoder's device, or over the mesh that
``ColBERTEncoder.attach_mesh`` attached (:func:`make_mesh_train_step`:
DP, TP, dp x tp, and meshes that span processes), computing the JAX mesh
step's function: the loss of the whole batch, in-batch negatives across
every shard included. The encoder's own methods hold ``no_grad``; the step
calls ``model.forward_normalized`` directly, as the JAX step calls
``encode_batch`` on the params. Attention is the materialized one: the JAX
step does not route to flash either.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from colbert_torch.models.colbert import ColBERT, skiplist_keep_mask
from colbert_torch.models.encoder import ColBERTEncoder
from colbert_torch.tokenization.tensorize import tensorize_docs, tensorize_queries

__all__ = [
    "colbert_maxsim",
    "pairwise_softmax_loss",
    "distill_kl_loss",
    "embed_batch",
    "loss_on_embeddings",
    "train_loss",
    "lr_multiplier",
    "make_train_step",
    "make_mesh_train_step",
    "ColBERTTrainer",
]


def colbert_maxsim(Q: torch.Tensor, D: torch.Tensor, dmask: torch.Tensor) -> torch.Tensor:
    """Late-interaction scores, all queries x all docs -> ``(Bq, Bd)``: per
    query token the max dot product over the doc's kept tokens, summed.

    ``Q``: (Bq, Lq, dim); ``D``: (Bd, Ld, dim); ``dmask``: (Bd, Ld) bool,
    True on the doc tokens that take part in the max."""
    sim = torch.einsum("qld,bmd->qblm", Q, D)
    sim = sim.masked_fill(~dmask[None, :, None, :], float("-inf"))
    # amax splits the gradient evenly among tied maxima, as jnp.max's VJP
    # does; torch.max(dim) would send all of it to one index
    per_qtok = sim.amax(dim=-1)                 # (Bq, Bd, Lq)
    # a doc with no kept token has -inf maxima: they count as 0, and their
    # gradient is 0 (not NaN)
    per_qtok = torch.where(torch.isfinite(per_qtok), per_qtok, torch.zeros_like(per_qtok))
    return per_qtok.sum(dim=-1)


def pairwise_softmax_loss(scores_pos: torch.Tensor, scores_neg: torch.Tensor) -> torch.Tensor:
    """ColBERT's objective: cross-entropy over the (pos, neg) score pair."""
    logits = torch.stack([scores_pos, scores_neg], dim=-1)  # (B, 2)
    return -F.log_softmax(logits, dim=-1)[..., 0].mean()


def distill_kl_loss(student_logits: torch.Tensor, teacher_scores: torch.Tensor) -> torch.Tensor:
    """ColBERTv2's distillation: KL(softmax(teacher) || softmax(student))
    over each example's candidate scores, 0 exactly when the student
    reproduces the teacher's score gaps."""
    t = torch.softmax(teacher_scores, dim=-1)
    return (t * (torch.log(t.clamp_min(1e-12)) - F.log_softmax(student_logits, dim=-1))
            ).sum(dim=-1).mean()


def _inbatch_loss(S_pos: torch.Tensor, scores_neg: torch.Tensor) -> torch.Tensor:
    """Cross-entropy where query i's positive competes with its hard negative
    and every other query's positive. ``S_pos``: (B, B) query x positive
    scores; ``scores_neg``: (B,) hard-negative scores."""
    logits = torch.cat([S_pos, scores_neg[:, None]], dim=1)  # (B, B+1)
    labels = torch.arange(S_pos.shape[0], device=S_pos.device)
    return -F.log_softmax(logits, dim=-1).gather(1, labels[:, None]).mean()


def embed_batch(
    model: ColBERT,
    batch: dict,
    *,
    dtype_name: str = "bfloat16",
    remat: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step's two forwards -> (Q, D+, D-): the query forward, and one
    doc forward over ``[positives; negatives]``. ``batch`` holds device
    tensors: ``q_ids``/``q_mask`` (B, Lq), ``pos_ids``/``pos_mask``/
    ``pos_keep`` and ``neg_ids``/``neg_mask``/``neg_keep`` (B, Ld)."""
    B = batch["q_ids"].shape[0]
    q_keep = torch.ones_like(batch["q_mask"])  # queries keep every position
    Q = model.forward_normalized(batch["q_ids"], batch["q_mask"], q_keep,
                                 dtype_name=dtype_name, remat=remat)
    d_ids = torch.cat([batch["pos_ids"], batch["neg_ids"]])
    d_mask = torch.cat([batch["pos_mask"], batch["neg_mask"]])
    d_keep = torch.cat([batch["pos_keep"], batch["neg_keep"]])
    D = model.forward_normalized(d_ids, d_mask, d_keep, dtype_name=dtype_name, remat=remat)
    return Q, D[:B], D[B:]


def loss_on_embeddings(
    Q: torch.Tensor,
    Dp: torch.Tensor,
    Dn: torch.Tensor,
    kp: torch.Tensor,
    kn: torch.Tensor,
    *,
    teacher_scores: torch.Tensor | None = None,
    in_batch_negatives: bool = True,
) -> Tuple[torch.Tensor, dict]:
    """The JAX step's loss on the batch's embeddings -> (loss, metrics as
    0-dim tensors). ``kp``/``kn``: the docs' keep masks; ``teacher_scores``
    (B, 2) selects the distillation objective."""
    if teacher_scores is not None:
        s_pos = torch.diagonal(colbert_maxsim(Q, Dp, kp))
        s_neg = torch.diagonal(colbert_maxsim(Q, Dn, kn))
        loss = distill_kl_loss(torch.stack([s_pos, s_neg], dim=-1), teacher_scores)
    elif in_batch_negatives:
        S_pos = colbert_maxsim(Q, Dp, kp)                   # (B, B)
        s_neg = torch.diagonal(colbert_maxsim(Q, Dn, kn))   # (B,)
        loss = _inbatch_loss(S_pos, s_neg)
        s_pos = torch.diagonal(S_pos)
    else:
        s_pos = torch.diagonal(colbert_maxsim(Q, Dp, kp))
        s_neg = torch.diagonal(colbert_maxsim(Q, Dn, kn))
        loss = pairwise_softmax_loss(s_pos, s_neg)
    metrics = {"loss": loss.detach(), "pairwise_acc": (s_pos > s_neg).float().mean(),
               "margin": (s_pos - s_neg).mean().detach()}
    return loss, metrics


def train_loss(
    model: ColBERT,
    batch: dict,
    *,
    dtype_name: str = "bfloat16",
    in_batch_negatives: bool = True,
    remat: bool = True,
) -> Tuple[torch.Tensor, dict]:
    """The JAX step's ``loss_fn`` -> (loss, metrics as 0-dim tensors):
    :func:`embed_batch`, then :func:`loss_on_embeddings`. ``batch`` as
    there, and optionally ``teacher_scores`` (B, 2), which selects the
    distillation objective."""
    Q, Dp, Dn = embed_batch(model, batch, dtype_name=dtype_name, remat=remat)
    return loss_on_embeddings(Q, Dp, Dn, batch["pos_keep"], batch["neg_keep"],
                              teacher_scores=batch.get("teacher_scores"),
                              in_batch_negatives=in_batch_negatives)


def lr_multiplier(warmup_steps: int = 0, total_steps: int | None = None) -> Callable[[int], float]:
    """The default optimizer's schedule as a multiple of the peak lr, by
    update count, with the JAX trainer's precedence: warmup and total give
    ``optax.warmup_cosine_decay_schedule(0, lr, warmup, total)`` (linear to
    the peak, then a cosine to 0 at ``total``, 0 after); warmup alone gives
    ``optax.linear_schedule(0, lr, warmup)``; neither, a constant."""
    if warmup_steps and total_steps:
        decay = total_steps - warmup_steps
        if decay <= 0:  # optax's cosine_decay_schedule refuses it too
            raise ValueError(f"total_steps ({total_steps}) must exceed warmup_steps "
                             f"({warmup_steps})")

        def warmup_cosine(count: int) -> float:
            if count < warmup_steps:
                return count / warmup_steps
            t = min(count - warmup_steps, decay)
            return 0.5 * (1.0 + math.cos(math.pi * t / decay))

        return warmup_cosine
    if warmup_steps:
        return lambda count: min(count, warmup_steps) / warmup_steps
    return lambda count: 1.0


def _update(params, optimizer, scheduler, max_grad_norm, metrics: dict) -> dict:
    """Clip, ``optimizer.step()``, ``scheduler.step()`` -> the metrics as
    Python floats."""
    if max_grad_norm is not None:
        # scales by max_norm / (norm + 1e-6) where optax divides by the
        # norm itself: a relative 1e-6
        torch.nn.utils.clip_grad_norm_(params, max_grad_norm)
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    values = torch.stack(list(metrics.values())).tolist()  # one device sync
    return dict(zip(metrics, values))


def make_train_step(
    model: ColBERT,
    optimizer: torch.optim.Optimizer,
    *,
    dtype_name: str = "bfloat16",
    in_batch_negatives: bool = True,
    scheduler=None,
    max_grad_norm: float | None = None,
) -> Callable[[dict], dict]:
    """-> ``step(batch) -> metrics`` (Python floats ``loss``,
    ``pairwise_acc``, ``margin``): zero the gradients, the loss of
    :func:`train_loss` with each layer recomputed, backward, clip the global
    norm to ``max_grad_norm`` (unless None), ``optimizer.step()``, then
    ``scheduler.step()``. ``model``'s parameters are updated in place."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch: dict) -> dict:
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, metrics = train_loss(model, batch, dtype_name=dtype_name,
                                       in_batch_negatives=in_batch_negatives, remat=True)
            loss.backward()
        # every parameter takes part in both forwards, so autograd gives each
        # a gradient tensor, zeros included (unused vocab and position rows,
        # token_type row 1): AdamW then decays every entry, as optax's adamw
        # does; it would skip a parameter whose grad were None
        return _update(params, optimizer, scheduler, max_grad_norm, metrics)

    return step


def make_mesh_train_step(
    encoder: ColBERTEncoder,
    optimizer: torch.optim.Optimizer,
    *,
    in_batch_negatives: bool = True,
    scheduler=None,
    max_grad_norm: float | None = None,
) -> Callable[[dict], dict]:
    """-> ``step(host batch) -> metrics``: one step of ``optimizer`` (over
    ``encoder.model``'s parameters) over the mesh attached to ``encoder``,
    the JAX mesh step's function. ``host`` holds the whole batch's numpy
    arrays (``ColBERTTrainer._tensorize``, on every process); the batch
    must divide the data axis (pad rows would enter the loss mean).

    Data shard ``s`` takes rows ``[s*B/n, (s+1)*B/n)`` and runs
    :func:`embed_batch` through its replica (or tensor-parallel model) with
    each layer recomputed. Q, D+ and D- gather on the encoder's device in
    shard order, across processes with this process's shards keeping their
    graphs (:func:`colbert_torch.parallel.launch.gather_keeping_grads`), and
    :func:`loss_on_embeddings` computes the loss of the whole batch: its
    (B, B) in-batch matrix spans every shard, which a mean of per-shard
    losses would not. The backward reaches each shard's weights; their
    gradients add into the full parameters in a fixed order
    (:func:`colbert_torch.parallel.tp.reduce_grads`), then over the
    processes (:func:`colbert_torch.parallel.launch.sum_grads`); then clip,
    ``optimizer.step()``, ``scheduler.step()``, and the replicas take the
    updated weights (``encoder.refresh_replicas``)."""
    from colbert_torch.parallel import launch
    from colbert_torch.parallel.tp import reduce_grads

    model = encoder.model
    params = [p for group in optimizer.param_groups for p in group["params"]]
    dtype_name = encoder.config.activation_dtype
    embedded = ("q_ids", "q_mask", "pos_ids", "pos_mask", "pos_keep", "neg_ids",
                "neg_mask", "neg_keep")

    def step(host: dict) -> dict:
        mesh = encoder.mesh
        n = mesh.shape["data"]
        B = host["q_ids"].shape[0]
        if B % n:
            raise ValueError(f"batch size {B} must divide the data axis ({n} devices) "
                             f"for mesh training")
        rows = B // n
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            parts = {"Q": {}, "Dp": {}, "Dn": {}}
            for s, replica in encoder._replicas.items():
                shard = encoder._put_batch(*(host[k][s * rows:(s + 1) * rows] for k in embedded),
                                           device=mesh.data_device(s))
                Q, Dp, Dn = embed_batch(replica, dict(zip(embedded, shard)),
                                        dtype_name=dtype_name, remat=True)
                parts["Q"][s], parts["Dp"][s], parts["Dn"][s] = Q, Dp, Dn
            Q, Dp, Dn = (torch.cat(launch.gather_keeping_grads(parts[k], mesh, encoder.device))
                         for k in ("Q", "Dp", "Dn"))
            kp, kn = encoder._put_batch(host["pos_keep"], host["neg_keep"])
            teacher = host.get("teacher_scores")
            loss, metrics = loss_on_embeddings(
                Q, Dp, Dn, kp, kn, in_batch_negatives=in_batch_negatives,
                teacher_scores=None if teacher is None else encoder._put_batch(teacher)[0])
            loss.backward()
        reduce_grads(model, encoder._replicas)
        launch.sum_grads(list(model.parameters()))
        metrics = _update(params, optimizer, scheduler, max_grad_norm, metrics)
        encoder.refresh_replicas()
        return metrics

    return step


@dataclass
class ColBERTTrainer:
    """Fine-tune a ColBERT encoder on (query, positive, negative) triples.

    Wraps tokenization (query [Q] and doc [D] markers, [MASK] augmentation,
    the skiplist: the same as inference) and the train step. ``optimizer``
    is a factory ``params -> torch.optim.Optimizer`` standing in for an
    optax transform: given, it replaces the default chain whole (no clipping,
    no schedule), as in the JAX trainer; after construction the field holds
    the optimizer built. The default is ``AdamW(learning_rate,
    weight_decay)`` after global-norm clipping to ``max_grad_norm``, under
    :func:`lr_multiplier`'s schedule. The optimizer holds
    ``encoder.model``'s parameters. With a mesh attached to the encoder
    (``encoder.attach_mesh``) each step runs over it
    (:func:`make_mesh_train_step`) and the encoder's replicas take the
    updated weights, so every later encode, checkpoint and index sees the
    trained model."""

    encoder: ColBERTEncoder
    learning_rate: float = 3e-5
    weight_decay: float = 0.01
    in_batch_negatives: bool = True
    warmup_steps: int = 0
    total_steps: int | None = None  # with warmup: cosine decay to 0 at this step
    max_grad_norm: float | None = 1.0
    optimizer: Callable | None = None  # params -> torch.optim.Optimizer

    def __post_init__(self) -> None:
        params = list(self.encoder.model.parameters())
        self.scheduler = None
        max_grad_norm = None
        if self.optimizer is None:
            self.optimizer = torch.optim.AdamW(params, lr=self.learning_rate,
                                               weight_decay=self.weight_decay)
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer, lr_multiplier(self.warmup_steps, self.total_steps))
            max_grad_norm = self.max_grad_norm
        else:
            self.optimizer = self.optimizer(params)
        self._step = make_train_step(
            self.encoder.model, self.optimizer,
            dtype_name=self.encoder.config.activation_dtype,
            in_batch_negatives=self.in_batch_negatives,
            scheduler=self.scheduler, max_grad_norm=max_grad_norm,
        )
        self._mesh_step = make_mesh_train_step(
            self.encoder, self.optimizer, in_batch_negatives=self.in_batch_negatives,
            scheduler=self.scheduler, max_grad_norm=max_grad_norm,
        )
        self.history: list[dict] = []

    def _tensorize(self, triples: Sequence[Tuple[str, str, str]]) -> dict:
        """Triples -> host arrays; docs pad to ``doc_maxlen`` so that
        positives and negatives share one doc forward."""
        enc, cfg = self.encoder, self.encoder.config
        qs, pos, neg = (list(x) for x in zip(*triples))
        q_ids, q_mask = tensorize_queries(
            qs, enc.tokenizer, query_token_id=enc.query_token_id,
            query_maxlen=cfg.query_maxlen,
            attend_to_mask_tokens=cfg.attend_to_mask_tokens,
        )
        batch = {"q_ids": q_ids, "q_mask": q_mask}
        for name, texts in (("pos", pos), ("neg", neg)):
            ids, mask = tensorize_docs(
                (), enc.tokenizer, doc_token_id=enc.doc_token_id,
                doc_maxlen=cfg.doc_maxlen, length_bucket=cfg.doc_maxlen,
                encoded=enc.tokenize_batch(texts),
            )
            batch[f"{name}_ids"] = ids
            batch[f"{name}_mask"] = mask
            batch[f"{name}_keep"] = skiplist_keep_mask(ids, mask, enc.skiplist)
        return batch

    def train_step(
        self,
        triples: Sequence[Tuple[str, str, str]],
        teacher_scores: np.ndarray | None = None,
    ) -> dict:
        """One optimizer step on a batch of (query, pos, neg) -> metrics.

        With ``teacher_scores`` (B, 2), a cross-encoder's (pos, neg) scores,
        the step optimizes ColBERTv2's KL distillation objective instead of
        the contrastive cross-entropy. Over a mesh the batch must divide the
        data axis (``ValueError``, as in the JAX trainer)."""
        host = self._tensorize(triples)
        if teacher_scores is not None:
            host["teacher_scores"] = np.asarray(teacher_scores, np.float32)
        if self.encoder.mesh is not None:
            metrics = self._mesh_step(host)
        else:
            metrics = self._step(dict(zip(host, self.encoder._put_batch(*host.values()))))
        self.history.append(metrics)
        return metrics

    def save_checkpoint(self, directory: str) -> None:
        """Write the fine-tuned weights as an HF-compatible checkpoint
        directory that :func:`colbert_torch.models.hf_loader.load_checkpoint`
        (and the JAX package's loader) read back."""
        from colbert_torch.models.hf_loader import save_checkpoint

        save_checkpoint(directory, self.encoder.model, self.encoder.tokenizer)

    def train(
        self,
        triples: Iterable[Tuple[str, str, str]],
        *,
        batch_size: int = 32,
        epochs: int = 1,
        seed: int = 0,
    ) -> list[dict]:
        """Mini-batch training over a triple list -> per-step metrics. Each
        epoch draws ``np.random.default_rng(seed)``'s permutation and drops
        the ragged tail, so the JAX trainer sees the same batches."""
        triples = list(triples)
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(epochs):
            order = rng.permutation(len(triples))
            for lo in range(0, len(order) - batch_size + 1, batch_size):
                batch = [triples[i] for i in order[lo:lo + batch_size]]
                out.append(self.train_step(batch))
        return out
