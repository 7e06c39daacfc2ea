"""The port's ``IndexUpdater`` vs the JAX package's on copies of one
reference-built index (fp32 activations, the reference encoder's weights
carried over), through add (splitting into chunks), remove and compact:

- plan, doclens, ``deleted.npy`` (int64) and the compact's pid map are
  identical;
- codes agree up to near-ties (the rule of ``test_torch_indexer.py``: a
  differing code scores within 2^-6 of the reference's), residual bytes
  wherever codes agree;
- the IVF is what ``build_ivf_excluding`` gives for the port's own codes
  and tombstones, and ``build_ivf_excluding`` equals the reference's
  exactly on both its native and numpy paths;
- each package's ``Searcher`` answers over the other's result with top-k
  agreeing up to ties at 1e-4.

Then the reference's own updater cases on the port: crash mid-publish
recovery, the torn-update warning, ``remove`` validation and idempotence,
removed pids never surfacing on either backend, and ``reload``."""

import logging
import os
import shutil

import numpy as np
import pytest

from colbert_tpu.indexing import updater as jupdater
from colbert_tpu.retrieval.searcher import Searcher as JSearcher
from colbert_tpu.utils.testing import synthetic_collection
from colbert_torch.indexing import updater as tupdater
from colbert_torch.indexing.updater import IndexUpdater, build_ivf_excluding
from colbert_torch.retrieval.searcher import Searcher
from colbert_torch.storage import format as fmt

from _torch_parity import assert_topk_agree, build_reference_index, port_encoder

NEAR_TIE = 2.0 ** -6
N_BASE = 48
STAGES = ["added", "removed", "compacted"]
VICTIMS = [3, 17, 40, 50, 60]  # two of them added by the update


@pytest.fixture(scope="module")
def updated(tmp_path_factory):
    """Both packages' updaters run add -> remove -> compact on copies of one
    reference index; each stage is snapshotted."""
    root = tmp_path_factory.mktemp("tupdate")
    cfg, jenc, passages, base = build_reference_index(
        str(root / "base"), activation_dtype="float32", n_passages=N_BASE, chunksize=24)
    tenc = port_encoder(jenc)
    extra = synthetic_collection(30, seed=9)  # 30 > the plan's chunksize of 24
    out = {"passages": passages + extra, "jenc": jenc, "tenc": tenc, "base": base}
    for name, Updater, enc in (("jax", jupdater.IndexUpdater, jenc),
                               ("port", IndexUpdater, tenc)):
        path = str(root / name)
        shutil.copytree(base, path)
        up = Updater(path, enc)
        out[name, "new_pids"] = up.add(extra)
        shutil.copytree(path, str(root / f"{name}_added"))
        up.remove(VICTIMS)
        shutil.copytree(path, str(root / f"{name}_removed"))
        out[name, "pid_map"] = up.compact()
        shutil.copytree(path, str(root / f"{name}_compacted"))
        for stage in STAGES:
            out[name, stage] = str(root / f"{name}_{stage}")
    return out


@pytest.mark.parametrize("native", [True, False])
def test_build_ivf_excluding_matches_reference(rng, monkeypatch, native):
    if not native:  # both packages take their numpy path
        monkeypatch.setattr(tupdater, "build_ivf_native", lambda codes, k: None)
        import colbert_tpu.indexing.native_ivf as jnative

        monkeypatch.setattr(jnative, "build_ivf_native", lambda codes, k: None)
    k = 37
    codes = rng.integers(0, k, 5000).astype(np.uint32)
    doclens = rng.integers(1, 9, 5000 // 4)
    doclens[-1] += 5000 - doclens.sum()
    for deleted in (None, np.zeros(0, np.int64),
                    tupdater.deleted_eids_from_pids(np.asarray([0, 7, 100]), doclens)):
        ivf, lengths = build_ivf_excluding(codes, k, deleted)
        jivf, jlengths = jupdater.build_ivf_excluding(codes, k, deleted)
        assert ivf.dtype == jivf.dtype == np.int32 and lengths.dtype == np.int32
        np.testing.assert_array_equal(ivf, jivf)
        np.testing.assert_array_equal(lengths, jlengths)
        n_del = 0 if deleted is None else len(deleted)
        assert int(lengths.sum()) == 5000 - n_del
        assert not np.isin(ivf[:lengths.sum()], deleted if n_del else []).any()


def test_deleted_eids_from_pids_matches_reference():
    doclens = np.asarray([4, 0, 3, 5, 2])
    for pids in ([], [1], [0, 3], [4, 2]):
        got = tupdater.deleted_eids_from_pids(np.asarray(pids, np.int64), doclens)
        want = jupdater.deleted_eids_from_pids(np.asarray(pids, np.int64), doclens)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def _assert_codes_agree(jpath, tpath, jenc, passages):
    codes_j, codes_t = fmt.load_all_codes(jpath), fmt.load_all_codes(tpath)
    assert codes_j.shape == codes_t.shape
    same = codes_j == codes_t
    if not same.all():  # a differing code must be a near-tie
        flat, _ = jenc.encode_passages(passages)
        cent = fmt.load_codec(tpath)["centroids"]
        rows = np.nonzero(~same)[0]
        gap = np.abs((flat[rows] * (cent[codes_t[rows]] - cent[codes_j[rows]])).sum(axis=1))
        assert (gap <= NEAR_TIE).all(), gap
    res_j, res_t = fmt.load_all_residuals(jpath), fmt.load_all_residuals(tpath)
    np.testing.assert_array_equal(res_t[same], res_j[same])


@pytest.mark.parametrize("stage", STAGES)
def test_update_artifacts_match_reference(updated, stage):
    jpath, tpath = updated["jax", stage], updated["port", stage]
    assert fmt.check_all_files_saved(tpath) == []
    assert fmt.load_plan(tpath) == fmt.load_plan(jpath)
    np.testing.assert_array_equal(fmt.load_all_doclens(tpath), fmt.load_all_doclens(jpath))
    for ci in range(fmt.num_chunks(tpath)):
        assert fmt.load_chunk(tpath, ci)["metadata"] == fmt.load_chunk(jpath, ci)["metadata"]
    dj = np.load(os.path.join(jpath, "deleted.npy")) if stage != "added" else None
    if dj is not None:
        dt = np.load(os.path.join(tpath, "deleted.npy"))
        assert dt.dtype == dj.dtype == np.int64
        np.testing.assert_array_equal(dt, dj)
    else:
        assert not os.path.exists(os.path.join(tpath, "deleted.npy"))
    passages = updated["passages"]
    if stage == "compacted":
        np.testing.assert_array_equal(updated["port", "pid_map"], updated["jax", "pid_map"])
        passages = [p for i, p in enumerate(passages) if i not in VICTIMS]
    _assert_codes_agree(jpath, tpath, updated["jenc"], passages)
    plan = fmt.load_plan(tpath)
    deleted = fmt.load_deleted(tpath)
    eids = (tupdater.deleted_eids_from_pids(deleted, fmt.load_all_doclens(tpath))
            if len(deleted) else None)
    ivf, lengths = build_ivf_excluding(fmt.load_all_codes(tpath), plan["num_partitions"], eids)
    tivf, tlengths = fmt.load_ivf(tpath)
    np.testing.assert_array_equal(tivf, ivf)
    np.testing.assert_array_equal(tlengths, lengths)
    # byte for byte wherever the codes agree
    names = ["plan.json"] + (["deleted.npy"] if stage != "added" else [])
    if (fmt.load_all_codes(tpath) == fmt.load_all_codes(jpath)).all():
        names += ["ivf.npy", "ivf_lengths.npy"]
        for ci in range(fmt.num_chunks(tpath)):
            names += fmt.chunk_file_names(ci)
    for name in names:
        with open(os.path.join(tpath, name), "rb") as ft, open(os.path.join(jpath, name), "rb") as fj:
            assert ft.read() == fj.read(), name


def test_add_assigns_pids_and_splits_into_chunks(updated):
    for name in ("jax", "port"):
        np.testing.assert_array_equal(updated[name, "new_pids"], np.arange(N_BASE, N_BASE + 30))
    base, added = fmt.load_plan(updated["base"]), fmt.load_plan(updated["port", "added"])
    assert added["num_chunks"] == base["num_chunks"] + 2  # 24 + 6 at chunksize 24
    assert added["num_documents"] == N_BASE + 30
    assert added["num_embeddings"] == int(fmt.load_all_doclens(updated["port", "added"]).sum())
    pid_map = updated["port", "pid_map"]
    assert (pid_map[VICTIMS] == -1).all()
    np.testing.assert_array_equal(pid_map[pid_map >= 0], np.arange(N_BASE + 30 - len(VICTIMS)))


@pytest.mark.parametrize("stage", STAGES)
def test_each_searcher_loads_the_others_result(updated, stage):
    passages = updated["passages"]
    queries = [passages[i] for i in (2, 17, 30, 55, 70)]
    js = JSearcher(updated["port", stage], encoder=updated["jenc"])
    ts = Searcher(updated["jax", stage], encoder=updated["tenc"], device="cpu")
    pj, sj = js.search_batch(queries, k=5)
    pt, st = ts.search_batch(queries, k=5)
    assert_topk_agree(pt, st, pj, sj, 1e-4)
    if stage == "removed":  # tombstoned pids never surface
        assert not np.isin(pt, VICTIMS).any() and not np.isin(pj, VICTIMS).any()


# -- the reference's updater cases, on the port -------------------------------


@pytest.fixture()
def port_index(updated, tmp_path):
    path = str(tmp_path / "idx")
    shutil.copytree(updated["base"], path)
    return path, updated["tenc"], updated["passages"][:N_BASE]


def test_add_empty_and_searchable(port_index):
    path, enc, passages = port_index
    up = IndexUpdater(path, enc)
    assert up.add([]).shape == (0,)
    extra = synthetic_collection(5, seed=11)
    new_pids = up.add(extra)
    s = Searcher(path, encoder=enc, device="cpu")
    pids, _ = s.search_batch(extra, k=3)
    np.testing.assert_array_equal(pids[:, 0], new_pids)
    pids_old, _ = s.search_batch([passages[3], passages[40]], k=3)
    assert pids_old[0][0] == 3 and pids_old[1][0] == 40


@pytest.mark.parametrize("backend", ["device", "host"])
def test_remove_pids_never_surfaced(port_index, backend):
    path, enc, passages = port_index
    victims = [5, 17, 40]
    IndexUpdater(path, enc).remove(victims)
    s = Searcher(path, encoder=enc, device="cpu", backend=backend)
    pids, _ = s.search_batch([passages[v] for v in victims], k=10)
    assert not np.isin(pids, victims).any()
    pids_ok, _ = s.search_batch([passages[2], passages[30]], k=3)
    assert pids_ok[0][0] == 2 and pids_ok[1][0] == 30


def test_remove_validates_and_merges(port_index):
    path, enc, _ = port_index
    up = IndexUpdater(path, enc)
    with pytest.raises(ValueError, match="out of range"):
        up.remove([999])
    with pytest.raises(ValueError, match="out of range"):
        up.remove([-1])
    up.remove([])
    assert not os.path.exists(os.path.join(path, "deleted.npy"))
    up.remove([1])
    up.remove([2, 1])  # idempotent merge
    np.testing.assert_array_equal(fmt.load_deleted(path), [1, 2])
    assert fmt.load_deleted(path).dtype == np.int64


def test_compact_without_tombstones_is_the_identity(port_index):
    path, enc, _ = port_index
    before = {n: open(os.path.join(path, n), "rb").read() for n in ("plan.json", "ivf.npy")}
    np.testing.assert_array_equal(IndexUpdater(path, enc).compact(), np.arange(N_BASE))
    for n, data in before.items():
        assert open(os.path.join(path, n), "rb").read() == data


def test_compact_crash_mid_publish_recovers(port_index, monkeypatch):
    """A crash during compact()'s publish (journal written, only chunk 0
    renamed, old plan and tombstones on disk) is refused by Searcher and
    repaired by finish_pending_compact(): results equal a clean compact."""
    path, enc, passages = port_index
    up = IndexUpdater(path, enc)
    victims = [1, 5, 25, 40]
    up.remove(victims)
    q = [passages[3], passages[30]]
    p_before, sc_before = Searcher(path, encoder=enc, device="cpu").search_batch(q, k=5)

    def dying_replay(self):
        tmp_dir = os.path.join(path, "compact_tmp")
        for name in fmt.chunk_file_names(0):
            os.replace(os.path.join(tmp_dir, name), os.path.join(path, name))
        raise RuntimeError("simulated crash mid-publish")

    monkeypatch.setattr(IndexUpdater, "_replay_compact_journal", dying_replay)
    with pytest.raises(RuntimeError, match="simulated crash"):
        up.compact()
    monkeypatch.undo()

    assert os.path.exists(os.path.join(path, IndexUpdater.COMPACT_JOURNAL))
    with pytest.raises(RuntimeError, match="interrupted mid-commit"):
        Searcher(path, encoder=enc, device="cpu")
    up2 = IndexUpdater(path, enc)
    assert up2.finish_pending_compact() is True
    assert not os.path.exists(os.path.join(path, IndexUpdater.COMPACT_JOURNAL))
    assert not os.path.exists(os.path.join(path, "compact_tmp"))
    assert fmt.check_all_files_saved(path) == []
    assert len(fmt.load_deleted(path)) == 0
    plan = fmt.load_plan(path)
    assert plan["num_documents"] == N_BASE - 4
    assert plan["num_embeddings"] == int(fmt.load_all_doclens(path).sum())
    assert up2.finish_pending_compact() is False

    pid_map = np.full(N_BASE, -1, np.int64)
    pid_map[np.setdiff1d(np.arange(N_BASE), victims)] = np.arange(N_BASE - 4)
    p_after, sc_after = Searcher(path, encoder=enc, device="cpu").search_batch(q, k=5)
    np.testing.assert_array_equal(p_after, np.where(p_before >= 0, pid_map[p_before], -1))
    np.testing.assert_allclose(sc_after, sc_before, rtol=1e-5, atol=1e-5)


def test_torn_update_detected(port_index, caplog):
    """A crash between the plan write and the IVF rebuild leaves a stale IVF:
    Searcher warns, and any updater operation repairs it."""
    path, enc, _ = port_index
    shutil.copy(f"{path}/ivf.npy", f"{path}/ivf.stale.npy")
    shutil.copy(f"{path}/ivf_lengths.npy", f"{path}/ivf_lengths.stale.npy")
    IndexUpdater(path, enc).add(["science history cooking travel"])
    shutil.move(f"{path}/ivf.stale.npy", f"{path}/ivf.npy")
    shutil.move(f"{path}/ivf_lengths.stale.npy", f"{path}/ivf_lengths.npy")
    with caplog.at_level(logging.WARNING):
        Searcher(path, encoder=enc, device="cpu")
    assert any("torn mid-update" in r.message for r in caplog.records)
    IndexUpdater(path, enc).remove([0])
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        Searcher(path, encoder=enc, device="cpu")
    assert not any("torn mid-update" in r.message for r in caplog.records)


def test_searcher_reload_sees_updates(port_index):
    path, enc, _ = port_index
    s = Searcher(path, encoder=enc, device="cpu")
    fresh = "science history cooking travel music mountain"
    new_pids = IndexUpdater(path, enc).add([fresh])
    assert len(s.doclens) == N_BASE  # the live snapshot is untouched
    s2 = s.reload()
    assert s2.encoder is s.encoder and len(s2.doclens) == N_BASE + 1
    assert s2.search(fresh, k=2)[0][0] == new_pids[0]


def test_updater_refuses_an_incomplete_index(port_index):
    path, enc, _ = port_index
    os.remove(os.path.join(path, "ivf.npy"))
    with pytest.raises(FileNotFoundError, match="ivf.npy"):
        IndexUpdater(path, enc)
