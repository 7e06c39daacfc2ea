"""The codec training held by itself against the plain reference: the
port's ``train_codec`` and ``benchmark.reference.codec.train`` on the same
sample, weights, initial rows and heldout rows agree (on the CPU, where
the port's sums are deterministic). The build check holds the program's
codec against the reference's own, which starts from other rows."""

import numpy as np
import torch

from benchmark.reference import codec


def test_train_codec_matches_the_plain_reference():
    from colbert_torch.indexing.codec_trainer import train_codec

    g = torch.Generator().manual_seed(4)
    sample = torch.nn.functional.normalize(torch.randn(3000, 16, generator=g), dim=1)
    weights = (torch.rand(3000, generator=g) > 0.1).float()  # padding rows weigh 0
    heldout = torch.nn.functional.normalize(torch.randn(400, 16, generator=g), dim=1)
    valid = np.flatnonzero(weights.numpy())
    init = np.random.default_rng(0).choice(valid, size=64, replace=False)
    got = train_codec(sample, heldout, num_partitions=64, nbits=2, kmeans_niters=10,
                      sample_weights=weights, init_idx=init)
    ref = codec.train(sample, weights, heldout, init, niters=10, nbits=2)
    assert torch.allclose(got[0], ref[0], atol=1e-5)
    assert torch.allclose(got[1], ref[1], atol=1e-6)
    assert torch.allclose(got[2], ref[2], atol=1e-6)
    assert abs(got[3] - ref[3]) < 1e-6
