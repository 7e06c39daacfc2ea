"""BERT under ColBERT's linear head: the encoder of both configurations.

The weights are :mod:`benchmark.gen.weights`'s, the reference and its fp8
control :mod:`benchmark.reference.encoder`'s and the FLOP count
:func:`benchmark.roofline.encoder_flops`, each reached unchanged; the
widths are a configuration's ``"bert"`` group (Hugging Face
``BertConfig``'s keys)."""

from __future__ import annotations

from benchmark import roofline
from benchmark.gen import weights
from benchmark.reference import encoder

PROGRAM_CONFIG = "colbert_torch.models.bert:BertConfig"

make_weights = weights.make_weights
encode = encoder.encode
# every layer attends to all of a sequence's true tokens
encoder_flops = roofline.encoder_flops


def vocab_size(widths: dict) -> int:
    return widths["vocab_size"]
