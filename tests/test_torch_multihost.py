"""The port's multi-process path: a real two-process CPU cluster (gloo over
loopback, ``colbert_torch.parallel.launch``) must reproduce the
single-process 4-shard port bit for bit: the sharded search over shards each
process streams from disk itself, sharded k-means and the sharded
quantiles (the port's counterpart of tests/test_multihost.py). The parent
computes the expected results on a single-process 4-shard CPU mesh; each
worker owns 2 of the 4 shards."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from colbert_torch.ops.quantile import sharded_quantiles
from colbert_torch.parallel.kmeans_dist import kmeans_sharded
from colbert_torch.parallel.mesh import make_mesh
from colbert_torch.parallel.sharded_index import ShardedDeviceIndex
from colbert_torch.storage import format as fmt
from colbert_torch.utils.testing import synthesize_index

from _torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_cluster_matches_single_process(tmp_path):
    idx = str(tmp_path / "idx")
    os.makedirs(idx)
    synthesize_index(idx, 256, dim=32, nbits=2, avg_doclen=12, chunksize=64,
                     num_partitions=64, seed=5)

    mesh = make_mesh(4, 1, device="cpu")
    codec = fmt.load_codec(idx)
    doclens = np.asarray(fmt.load_all_doclens(idx), np.int64)
    reads = []
    read = fmt.read_embedding_rows

    def recording(path, lo, hi):
        reads.append((lo, hi))
        return read(path, lo, hi)

    fmt.read_embedding_rows = recording
    try:
        sharded = ShardedDeviceIndex.build(
            mesh, centroids=codec["centroids"], stream_from=idx, doclens=doclens,
            bucket_weights=codec["bucket_weights"], nbits=2, balance_cap=64)
    finally:
        fmt.read_embedding_rows = read
    rng = np.random.default_rng(3)
    Q = rng.normal(size=(4, 8, 32)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    pids, scores = sharded.search_Q_batch(torch.from_numpy(Q), k=5, nprobe=4,
                                          ncandidates=256, cell_cap=128,
                                          max_candidates=1024)
    assert (pids >= 0).all()
    kdata = rng.normal(size=(512, 32)).astype(np.float32)
    kinit = rng.permutation(512)[:16]
    kres = kmeans_sharded(kdata, 16, mesh, niters=4, init_idx=kinit)
    values, mean_abs = sharded_quantiles(torch.from_numpy(kdata), [0.25, 0.5, 0.75], mesh)
    expected = str(tmp_path / "expected.npz")
    np.savez(expected, Q=Q, pids=pids, scores=scores, reads=np.asarray(reads),
             widths=np.asarray([sharded.max_cell_length, sharded.probe_dup_max]),
             kmeans_data=kdata, kmeans_init=kinit,
             kmeans_centroids=kres.centroids.numpy(),
             kmeans_assignments=kres.assignments.numpy(),
             quantiles=values.numpy(), mean_abs=np.float32(mean_abs))

    port = _free_port()
    worker = os.path.join(REPO, "tests", "_torch_multihost_worker.py")
    procs = []
    for rank in range(2):
        env = dict(os.environ, COLBERT_COORDINATOR=f"localhost:{port}",
                   COLBERT_NUM_PROCESSES="2", COLBERT_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, worker, idx, expected], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        # never leak a live worker: it holds the coordinator's port
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK p{rank}" in out, out[-4000:]


def test_initialize_is_a_noop_without_a_cluster(monkeypatch):
    from colbert_torch.parallel import launch

    for var in ("COLBERT_COORDINATOR", "COLBERT_NUM_PROCESSES", "COLBERT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    launch.initialize()
    assert not launch.is_initialized()
    assert launch.process_index() == 0 and launch.process_count() == 1
    monkeypatch.setenv("COLBERT_NUM_PROCESSES", "2")
    monkeypatch.setenv("COLBERT_PROCESS_ID", "0")
    monkeypatch.setenv("COLBERT_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="backend"):
        launch.initialize()  # the backend is never guessed
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl"):
            launch.initialize(backend="nccl")  # no GPU: no NCCL, and no gloo instead
    assert not launch.is_initialized()
