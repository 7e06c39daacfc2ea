"""The port's ShardedDeviceIndex (``colbert_torch.parallel.sharded_index``)
against the JAX package's on one synthesized index, the JAX side on the
8-device virtual CPU mesh, the port on the CPU repeated as often.

Build: the passage bounds (``pid_base``) are equal, and every shard's local
IVF (pid-valued entries, probe offsets and lengths, tombstones left out,
balanced cells) equals the JAX shard's valid rows. Search: pids agree up to
ties at the cut and scores within 1e-4 (the stage-2 contract; the JAX
sharded search scores stage 2 in XLA, the port with its plain stage 2 on
the CPU). ``merge_shard_topk`` is held to the JAX package's own cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.parallel.mesh import make_mesh as j_make_mesh
from colbert_tpu.parallel.sharded_index import ShardedDeviceIndex as JSharded
from colbert_tpu.parallel.sharded_index import merge_shard_topk as j_merge
from colbert_tpu.storage import format as jfmt
from colbert_tpu.utils.testing import synthesize_index
from colbert_torch.parallel import launch
from colbert_torch.parallel.mesh import make_mesh
from colbert_torch.parallel.sharded_index import ShardedDeviceIndex, merge_shard_topk
from colbert_torch.retrieval.device_index import DeviceIndex
from colbert_torch.storage import format as tfmt

from _torch_parity import assert_topk_agree, one_torch_thread  # noqa: F401

TOL = 1e-4
DIM, NBITS = 32, 2


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shidx") / "idx")
    import os

    os.makedirs(path)
    synthesize_index(path, 300, dim=DIM, nbits=NBITS, avg_doclen=12, chunksize=64,
                     num_partitions=48, seed=5)
    codec = jfmt.load_codec(path)
    rng = np.random.default_rng(3)
    Q = rng.normal(size=(5, 8, DIM)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    common = dict(centroids=codec["centroids"], bucket_weights=codec["bucket_weights"],
                  doclens=np.asarray(jfmt.load_all_doclens(path), np.int64), nbits=NBITS)
    return path, common, Q


def _both(ndev, common, **kw):
    return (JSharded.build(j_make_mesh(ndev, 1), **common, **kw),
            ShardedDeviceIndex.build(make_mesh(ndev, 1, device="cpu"), **common, **kw))


def _check_build(j, t, ndev):
    np.testing.assert_array_equal(t.pid_base, j.pid_base)
    assert t.shard_passages == j.shard_passages and t.n_passages == j.n_passages
    assert sorted(t.shards) == list(range(ndev))
    assert t.probe_dup_max == j.probe_dup_max
    assert t.probe_split_mass == pytest.approx(j.probe_split_mass)
    n_cells = np.asarray(j.n_cells)[:, 0]
    j_ivf, j_off, j_len = (np.asarray(a) for a in (j.ivf, j.ivf_offsets, j.ivf_lengths))
    for s, shard in t.shards.items():
        nc = int(n_cells[s])
        assert shard.ivf_lengths.numel() == nc
        np.testing.assert_array_equal(shard.ivf_lengths.numpy(), j_len[s, :nc])
        np.testing.assert_array_equal(shard.ivf_offsets.numpy(), j_off[s, :nc])
        n_emb = int(shard.doclens.sum())
        # pid-valued local IVF entries; the JAX sentinel is the padded width,
        # the port's the shard's own passage count
        t_ivf = shard.ivf[:n_emb].numpy()
        j_loc = j_ivf[s, :n_emb].copy()
        j_loc[j_loc == j.shard_passages] = shard.n_passages
        np.testing.assert_array_equal(t_ivf, j_loc)
        assert t.max_cell_length >= int(shard.ivf_lengths.max())
    assert t.max_cell_length == int(j_len.max())


@pytest.mark.parametrize("ndev,balance_cap", [(4, None), (8, 16), (4, 8)])
def test_sharded_index_matches_jax(index, ndev, balance_cap):
    path, common, Q = index
    j, t = _both(ndev, common, stream_from=path, balance_cap=balance_cap)
    _check_build(j, t, ndev)
    for kw in (dict(nprobe=4, ncandidates=64, cell_cap=64, max_candidates=256),
               dict(nprobe=6, ncandidates=512, cell_cap=64, max_candidates=512,
                    stage1_refine=False)):
        jp, js = j.search_Q_batch(jnp.asarray(Q), k=10, **kw)
        tp, ts = t.search_Q_batch(torch.from_numpy(Q), k=10, **kw)
        assert tp.shape == (5, 10) and tp.dtype == np.int64
        assert_topk_agree(tp, ts, np.asarray(jp), np.asarray(js), TOL)
        assert t.compensated_nprobe(4) == j.compensated_nprobe(4)


def test_sharded_matches_single_device(index):
    """Exhaustive probing: the merged sharded top-k equals one DeviceIndex's."""
    path, common, Q = index
    ivf, ivf_lengths = tfmt.load_ivf(path)
    single = DeviceIndex.build(stream_from=path, ivf=ivf, ivf_lengths=ivf_lengths,
                               device="cpu", **common)
    sharded = ShardedDeviceIndex.build(make_mesh(4, 1, device="cpu"), stream_from=path,
                                       **common)
    kw = dict(k=8, ncandidates=4096, cell_cap=256, max_candidates=4096,
              stage1_refine=False)
    p1, s1 = single.search_Q_batch(torch.from_numpy(Q), nprobe=48, **kw)
    p2, s2 = sharded.search_Q_batch(torch.from_numpy(Q), nprobe=48, **kw)
    assert_topk_agree(p1, s1, p2, s2, TOL)
    assert (p2 >= 0).all() and (p2 < 300).all()


def test_balanced_matches_unbalanced(index):
    path, common, Q = index
    mesh = make_mesh(4, 1, device="cpu")
    plain = ShardedDeviceIndex.build(mesh, stream_from=path, balance_cap=None, **common)
    bal = ShardedDeviceIndex.build(mesh, stream_from=path, balance_cap=16, **common)
    assert bal.max_cell_length <= 16 < plain.max_cell_length
    for s in range(4):  # nothing truncated: every entry stays reachable
        assert int(bal.shards[s].ivf_lengths.sum()) == int(plain.shards[s].ivf_lengths.sum())
    assert bal.probe_dup_max > 1
    kw = dict(k=5, ncandidates=512, max_candidates=2048, stage1_refine=False)
    p1, s1 = plain.search_Q_batch(torch.from_numpy(Q), nprobe=48, cell_cap=256, **kw)
    widest = max(sh.ivf_lengths.numel() for sh in bal.shards.values())
    p2, s2 = bal.search_Q_batch(torch.from_numpy(Q), nprobe=widest, cell_cap=16, **kw)
    assert_topk_agree(p1, s1, p2, s2, TOL)


def test_tombstones_never_returned(index):
    path, common, Q = index
    codes = jfmt.load_all_codes(path)
    residuals = jfmt.load_all_residuals(path)
    exhaustive = dict(nprobe=48, ncandidates=512, cell_cap=256, max_candidates=2048,
                      stage1_refine=False)
    t0 = ShardedDeviceIndex.build(make_mesh(4, 1, device="cpu"), codes=codes,
                                  residuals=residuals, **common)
    p0, _ = t0.search_Q_batch(torch.from_numpy(Q), k=10, **exhaustive)
    deleted = np.unique(p0[:, :3].ravel())
    j, t = _both(4, common, codes=codes, residuals=residuals, deleted_pids=deleted)
    _check_build(j, t, 4)
    # the excluded entries count in no cell
    total = sum(int(sh.ivf_lengths.sum()) for sh in t.shards.values())
    assert total == int(common["doclens"].sum() - common["doclens"][deleted].sum())
    tp, ts = t.search_Q_batch(torch.from_numpy(Q), k=10, **exhaustive)
    jp, js = j.search_Q_batch(jnp.asarray(Q), k=10, **exhaustive)
    assert not np.isin(tp, deleted).any()
    assert_topk_agree(tp, ts, np.asarray(jp), np.asarray(js), TOL)


@pytest.mark.parametrize("nprobe", [2, 6])
def test_pad_probe_rows_unselectable(nprobe):
    """The JAX package pads each shard's probe table to a common width and
    masks the pads; the port's shards keep their own widths and probe at
    most their own cells. Shard A's one mega-cell splits into MAX_CELL_DUP
    sub-cells (7 rows), shard B keeps 4 cells: a query whose top cell is
    cell 0 must still reach shard B's cell-1 docs, and with nprobe above
    shard B's 4 cells both packages return the same."""
    dim, nbits, k = 32, 2, 4
    eye = np.eye(k, dim, dtype=np.float32)
    codes = np.concatenate([np.zeros(32, np.uint32), (np.arange(32) % k).astype(np.uint32)])
    common = dict(centroids=eye, codes=codes,
                  residuals=np.zeros((64, dim // 8 * nbits), np.uint8),
                  doclens=np.ones(64, np.int64),
                  bucket_weights=np.zeros(2 ** nbits, np.float32), nbits=nbits,
                  balance_cap=8)
    j, t = _both(2, common)
    assert [sh.ivf_lengths.numel() for sh in t.shards.values()] == [7, 4]
    assert j.min_ncells == 4
    q = (0.9 * eye[0] + 0.45 * eye[1])[None, None, :]
    kw = dict(k=48, nprobe=nprobe, ncandidates=64, cell_cap=8, max_candidates=128)
    tp, ts = t.search_Q_batch(torch.from_numpy(q), **kw)
    jp, js = j.search_Q_batch(jnp.asarray(q), **kw)
    got = set(tp[0][ts[0] > -np.inf].tolist())
    assert {32 + i for i in range(32) if i % k == 1} <= got
    assert got == set(np.asarray(jp)[0][np.asarray(js)[0] > -np.inf].tolist())
    np.testing.assert_allclose(np.sort(ts[0]), np.sort(np.asarray(js)[0]), atol=TOL)


def test_stream_reads_only_owned_shards(index, monkeypatch):
    """A process builds and reads only the shards its devices hold."""
    path, common, Q = index
    mesh = make_mesh(4, 1, device="cpu")
    reads = []
    read = tfmt.read_embedding_rows

    def recording(p, lo, hi):
        reads.append((lo, hi))
        return read(p, lo, hi)

    monkeypatch.setattr(tfmt, "read_embedding_rows", recording)
    monkeypatch.setattr(launch, "owned_data_shards", lambda m: [1, 2])
    t = ShardedDeviceIndex.build(mesh, stream_from=path, **common)
    full = ShardedDeviceIndex.build(make_mesh(4, 1, device="cpu"), codes=jfmt.load_all_codes(path),
                                    residuals=jfmt.load_all_residuals(path), **common)
    assert sorted(t.shards) == [1, 2]
    offs = np.concatenate([[0], np.cumsum(common["doclens"])])
    b = full.pid_base.tolist() + [300]
    assert reads == [(int(offs[b[1]]), int(offs[b[2]])), (int(offs[b[2]]), int(offs[b[3]]))]
    for s in (1, 2):
        assert torch.equal(t.shards[s].codes, full.shards[s].codes)
        assert torch.equal(t.shards[s].residuals, full.shards[s].residuals)


def test_build_argument_errors():
    mesh = make_mesh(2, 1, device="cpu")
    kw = dict(centroids=np.zeros((4, 16), np.float32), doclens=np.array([4, 4]),
              bucket_weights=np.zeros((4,)), nbits=2)
    with pytest.raises(ValueError, match="together"):
        ShardedDeviceIndex.build(mesh, codes=np.zeros((8,), np.uint32), residuals=None, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        ShardedDeviceIndex.build(mesh, **kw)


# merge_shard_topk: the cases of tests/test_sharded_index.py, on both packages


def _merge_case():
    sentinel = 100
    pid_base = np.array([0, 100, 250], np.int64)
    lp = np.array([[[3, 1], [0, 2]], [[5, sentinel], [sentinel, sentinel]],
                   [[7, 0], [1, 2]]], np.int32)
    ls = np.array([[[0.9, 0.5], [0.1, 0.05]], [[0.7, 123.0], [-9.0, -9.0]],
                   [[1.5, 0.8], [0.3, 0.2]]], np.float32)
    return lp, ls, pid_base, sentinel


@pytest.mark.parametrize("merge", [merge_shard_topk, j_merge], ids=["port", "jax"])
def test_merge_shard_topk_semantics(merge):
    lp, ls, pid_base, sentinel = _merge_case()
    out_p, out_s = merge(lp, ls, pid_base, sentinel, k=4)
    assert out_p[0].tolist() == [257, 3, 250, 105]
    np.testing.assert_allclose(out_s[0], [1.5, 0.9, 0.8, 0.7], rtol=1e-6)
    assert out_p[1].tolist() == [251, 252, 0, 2]
    np.testing.assert_allclose(out_s[1], [0.3, 0.2, 0.1, 0.05], rtol=1e-6)
    banned = {int(b) + sentinel for b in pid_base}
    assert not (set(out_p.ravel().tolist()) & banned)
    assert (out_p >= 0).all()
    jp, js = j_merge(lp, ls, pid_base, sentinel, k=4)
    np.testing.assert_array_equal(out_p, jp)
    np.testing.assert_array_equal(out_s, js)


def test_merge_shard_topk_all_sentinel_query():
    lp = np.full((2, 1, 3), 7, np.int32)
    ls = np.zeros((2, 1, 3), np.float32)
    out_p, out_s = merge_shard_topk(lp, ls, np.array([0, 7]), 7, k=2)
    assert (out_p == -1).all()
    assert not np.isfinite(out_s).any()
