"""The public names the port mirrors from the JAX package, each against its
JAX counterpart on the CPU: ``ops.codec.unbinarize``, ``BertConfig.tiny``,
the ``build_ivf`` re-export of ``indexing.builder`` and
``utils.tracing.profile_trace``."""

import dataclasses
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.indexing import builder as jbuilder
from colbert_tpu.models.bert import BertConfig as JBertConfig
from colbert_tpu.ops import codec as jcodec
from colbert_tpu.utils.tracing import profile_trace as jprofile_trace
from colbert_torch.indexing import builder, ivf
from colbert_torch.models.bert import BertConfig
from colbert_torch.ops import codec
from colbert_torch.utils.tracing import profile_trace


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_unbinarize_matches_and_inverts_binarize(rng, nbits):
    """Exact: the same int ids as JAX's on random bits, and the inverse of
    ``binarize`` on random ids."""
    bits = rng.integers(0, 2, size=(37, 128, nbits)).astype(np.int32)
    got = codec.unbinarize(torch.from_numpy(bits))
    assert got.dtype == torch.int32 and got.shape == (37, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcodec.unbinarize(jnp.asarray(bits))))
    ids = torch.from_numpy(rng.integers(0, 2**nbits, size=(37, 128)).astype(np.int32))
    assert torch.equal(codec.unbinarize(codec.binarize(ids, nbits)), ids)
    assert "unbinarize" in codec.__all__


@pytest.mark.parametrize("vocab_size", [None, 2018])
def test_bert_config_tiny_fields(vocab_size):
    kw = {} if vocab_size is None else {"vocab_size": vocab_size}
    assert dataclasses.asdict(BertConfig.tiny(**kw)) == dataclasses.asdict(JBertConfig.tiny(**kw))


def test_builder_reexports_build_ivf():
    assert builder.build_ivf is ivf.build_ivf
    assert "build_ivf" in builder.__all__ and "build_ivf" in jbuilder.__all__


def test_profile_trace(tmp_path):
    """None: a no-op, as JAX's, writing nothing; a directory: a Chrome trace
    file naming the op run inside, where JAX's writes its own trace."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with profile_trace(None), jprofile_trace(None):
            torch.ones(4) @ torch.ones(4)
        assert os.listdir(tmp_path) == []
    finally:
        os.chdir(cwd)
    with profile_trace(str(tmp_path / "port")):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    (trace,) = glob.glob(str(tmp_path / "port" / "*.json"))
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert "aten::mm" in names
    with jprofile_trace(str(tmp_path / "jax")):
        (jnp.ones(8) @ jnp.ones(8)).block_until_ready()
    assert glob.glob(str(tmp_path / "jax" / "**" / "*.trace.json.gz"), recursive=True)
