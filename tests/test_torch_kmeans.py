"""The port's k-means and codec trainer vs the JAX package's on the same data,
weights (zero-weight padding rows included) and initial centroids: centroids
to 1e-5 (fp32 sums taken in another order) with the same iteration count,
and the trained codec to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.indexing.codec_trainer import train_codec as jtrain
from colbert_tpu.ops import kmeans as jkm
from colbert_torch.indexing.codec_trainer import sample_bucket_step, train_codec
from colbert_torch.ops import kmeans as tkm

from _torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-5


def _clustered(rng, n=3000, k=24, dim=16, pad=500):
    """Well-separated clusters (no near-tied assignments) plus ``pad``
    zero-weight rows of junk at the end."""
    centers = rng.standard_normal((k, dim)).astype(np.float32) * 4
    data = centers[rng.integers(0, k, n)] + rng.standard_normal((n, dim)).astype(np.float32)
    junk = rng.standard_normal((pad, dim)).astype(np.float32) * 50
    weights = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return np.concatenate([data, junk]).astype(np.float32), weights


@pytest.mark.parametrize("niters,tol", [(30, 1e-4), (3, 1e-4), (30, 0.5)])
def test_kmeans_matches_reference(rng, niters, tol):
    data, weights = _clustered(rng)
    k = 16
    init_idx = rng.choice(3000, size=k, replace=False)
    want = jkm.kmeans(jnp.asarray(data), k, niters=niters, tol=tol, bsize=256,
                      weights=jnp.asarray(weights), init_idx=jnp.asarray(init_idx))
    got = tkm.kmeans(torch.from_numpy(data), k, niters=niters, tol=tol, bsize=256,
                     weights=torch.from_numpy(weights), init_idx=init_idx)
    assert got.iterations == want.iterations
    if niters == 30:
        assert got.iterations < niters  # the early exit by tol
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(want.assignments))


def test_empty_cluster_keeps_its_centroid(rng):
    data, _ = _clustered(rng, n=600, k=4, dim=8, pad=0)
    far = np.full((1, 8), 1e3, np.float32)       # an initial centroid no row is near
    data = np.concatenate([data, far])
    init_idx = np.array([0, 1, 2, 600])           # row 600 is `far`
    weights = np.ones(601, np.float32)
    weights[600] = 0.0                            # ... and it carries no weight
    want = jkm.kmeans(jnp.asarray(data), 4, niters=5, weights=jnp.asarray(weights),
                      init_idx=jnp.asarray(init_idx))
    got = tkm.kmeans(torch.from_numpy(data), 4, niters=5,
                     weights=torch.from_numpy(weights), init_idx=init_idx)
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(got.centroids[3].numpy(), far[0])


def test_lloyd_step_and_assign_match(rng):
    data, weights = _clustered(rng, n=1000, pad=100)
    c0 = data[:12]
    jnew, jshift = jkm.lloyd_step(jnp.asarray(data), jnp.asarray(c0), k=12, bsize=128,
                                  weights=jnp.asarray(weights))
    tnew, tshift = tkm.lloyd_step(torch.from_numpy(data), torch.from_numpy(c0), k=12,
                                  bsize=128, weights=torch.from_numpy(weights))
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), atol=TOL, rtol=0)
    assert abs(tshift - float(jshift)) <= TOL
    np.testing.assert_array_equal(
        tkm.assign_clusters(torch.from_numpy(data), tnew, bsize=128).numpy(),
        np.asarray(jkm.assign_clusters(jnp.asarray(data), jnew, bsize=128)))
    assert tkm._adaptive_bsize(1 << 15, 1024) == jkm._adaptive_bsize(1 << 15, 1024) == 512


def test_train_codec_matches_reference(rng):
    """Same (padded, weighted) sample, heldout and initial centroids; the
    sample is 4100 rows, so both pad it with zero-weight rows to 8192 (the
    next multiple of the 4096-row bucket step)."""
    data, weights = _clustered(rng, n=4000, k=40, dim=32, pad=100)
    heldout = data[:300] + 0.01
    init_idx = rng.choice(4000, size=32, replace=False)
    jc, jcut, jw, javg = jtrain(jnp.asarray(data), jnp.asarray(heldout), num_partitions=32,
                                nbits=2, kmeans_niters=8, sample_weights=weights,
                                init_idx=jnp.asarray(init_idx))
    tc, tcut, tw, tavg = train_codec(torch.from_numpy(data), torch.from_numpy(heldout),
                                     num_partitions=32, nbits=2, kmeans_niters=8,
                                     sample_weights=torch.from_numpy(weights),
                                     init_idx=init_idx)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL, rtol=0)
    np.testing.assert_allclose(tcut.numpy(), np.asarray(jcut), atol=TOL, rtol=0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=TOL, rtol=0)
    assert abs(tavg - javg) <= TOL
    assert sample_bucket_step(4100) == 4096
    # with a mesh both packages take the sharded trainer (sharded Lloyd,
    # histogram quantiles): 4 virtual JAX devices, the CPU repeated 4 times
    from colbert_tpu.parallel.mesh import make_mesh as j_make_mesh
    from colbert_torch.parallel.mesh import make_mesh

    jc, jcut, jw, javg = jtrain(jnp.asarray(data), jnp.asarray(heldout), num_partitions=32,
                                nbits=2, kmeans_niters=8, sample_weights=weights,
                                init_idx=jnp.asarray(init_idx), mesh=j_make_mesh(4, 1))
    tc, tcut, tw, tavg = train_codec(torch.from_numpy(data), torch.from_numpy(heldout),
                                     num_partitions=32, nbits=2, kmeans_niters=8,
                                     sample_weights=torch.from_numpy(weights),
                                     init_idx=init_idx, mesh=make_mesh(4, 1, device="cpu"))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL, rtol=0)
    np.testing.assert_allclose(tcut.numpy(), np.asarray(jcut), atol=TOL, rtol=0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=TOL, rtol=0)
    assert abs(tavg - javg) <= TOL
