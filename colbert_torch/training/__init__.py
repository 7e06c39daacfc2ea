"""Fine-tuning of the ColBERT encoder (port of ``colbert_tpu.training``)."""

from colbert_torch.training.trainer import (
    ColBERTTrainer,
    colbert_maxsim,
    distill_kl_loss,
    make_train_step,
    pairwise_softmax_loss,
)

__all__ = [
    "ColBERTTrainer",
    "colbert_maxsim",
    "distill_kl_loss",
    "make_train_step",
    "pairwise_softmax_loss",
]
