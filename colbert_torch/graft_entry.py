"""The forward-step hook: one forward step of the flagship model, a
bert-base ColBERT doc encode, as a function and its arguments (counterpart
of ``entry`` in the JAX package's ``__graft_entry__.py``).

The multi-device dry run that file also holds needs the sharded modules
and is not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from colbert_torch.models.bert import BertConfig
from colbert_torch.models.colbert import ColBERT, init_colbert
from colbert_torch.utils.build import resolve_device

__all__ = ["entry"]


def entry(*, device: str | torch.device = "cuda", bert_config: BertConfig | None = None,
          dtype: str = "bfloat16"):
    """-> (fn, args): ``fn(*args)`` encodes B=8 documents of L=128 tokens
    (ids and keep mask drawn from ``np.random.default_rng(0)`` as in the
    JAX hook; every position attended) with a ColBERT (dim 128) at
    ``bert_config`` (default bert-base) whose random weights come from
    ``torch.Generator().manual_seed(0)``, activations in ``dtype``,
    under ``torch.no_grad``. ``args`` is (model, ids, mask, keep) on
    ``device``."""
    from colbert_torch.utils.testing import bench_bert_config

    dev = resolve_device(device)
    cfg = bert_config or bench_bert_config()
    model = init_colbert(cfg, 128, generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    rng = np.random.default_rng(0)
    B, L = 8, 128
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L))).to(dev)
    mask = torch.ones((B, L), dtype=torch.bool, device=dev)
    keep = torch.from_numpy(rng.random((B, L)) > 0.1).to(dev)
    fn = torch.no_grad()(functools.partial(ColBERT.encode_batch, dtype_name=dtype))
    return fn, (model, ids, mask, keep)
