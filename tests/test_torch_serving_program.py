"""The port's serving program on the CPU: the static stage 1 and the program
cache around the funnel.

Stage 1 (``device_index._stage1``) is the JAX package's static formulation:
every entry kept, a (pid, q, score descending) sort, per-pid sums as
differences of a per-query fp32 cumsum. On indexes built by the JAX
``Indexer`` it is held against a float64 numpy re-derivation of the per-pid
bound on the same probe results: the same pids, the same ``n_unique``, and
every per-pid score within 1e-6 of the query's stage-1 total (a cumsum
difference is taken at the magnitude of the running sum, so its rounding
scales with that total, not with the pid's own score). Both sort routes
(one packed int64 key, two stable sorts) give the same answer. Against the
JAX package's ``search_Q_batch`` the stage-1 cut selects the same candidates
up to near-ties and counts the same overflow. The whole funnel runs under
``FakeTensorMode``: no output shape depends on the data.

The program cache: on the CPU a :class:`~colbert_torch.retrieval.program.Program`
runs the funnel eagerly on its static buffers at every launch (capture and
replay are on the card only, ``tests/test_torch_cuda.py``). Programs key on
the batch shape, the knobs and the tensors they read; ``rebalance``, a
replaced tensor and re-bound encoder parameters give new programs, in-place
updates do not; two launches in flight keep their own results; the cache
holds at most ``MAX_PROGRAMS``; the public route runs eagerly on the CPU,
with a tracer and with a mesh-attached encoder, and launches a program
otherwise, whether spans record or not.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.retrieval.device_index import DeviceIndex as JDeviceIndex
from colbert_tpu.storage import format as jfmt
from colbert_torch.retrieval import device_index as tdi
from colbert_torch.retrieval import program as tprog
from colbert_torch.retrieval.device_index import DeviceIndex

from _torch_parity import (assert_topk_agree, build_reference_index,  # noqa: F401
                           one_torch_thread, port_encoder)

TOL = 1e-4
STAGE1_REL = 1e-6
SEARCH = dict(k=8, nprobe=4, ncandidates=16, cell_cap=64, max_candidates=64,
              stage1_refine=True, refine_width=2)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sprog") / "idx")
    cfg, encoder, passages, path = build_reference_index(path, nbits=2)
    queries = [passages[5], passages[33], "the dog runs fast", passages[59],
               "blue river city music"]
    return cfg, encoder, passages, path, queries, encoder.encode_queries(queries)


def _indexes(path, cfg, balance_cap=1024):
    codec = jfmt.load_codec(path)
    ivf, ivf_lengths = jfmt.load_ivf(path)
    kw = dict(centroids=codec["centroids"], ivf=ivf, ivf_lengths=ivf_lengths,
              doclens=np.asarray(jfmt.load_all_doclens(path), np.int64),
              bucket_weights=codec["bucket_weights"], nbits=cfg.nbits,
              balance_cap=balance_cap, stream_from=path)
    return JDeviceIndex.build(**kw), DeviceIndex.build(device="cpu", **kw)


def _stage1_reference(t, probe_scores, cells, cell_cap, threshold):
    """Per query {pid: stage-1 bound} in float64, and the query's stage-1
    total, from the probe results: per (pid, q) the best adjusted entry
    score, clamped at 0, plus half the token's imputation score, summed per
    pid."""
    ps = probe_scores.numpy().astype(np.float64)
    cells = cells.numpy()
    off, lens, ivf = t.ivf_offsets.numpy(), t.ivf_lengths.numpy(), t.ivf.numpy()
    out = []
    for b in range(ps.shape[0]):
        impute = ps[b, :, -1]
        best = {}
        for q in range(ps.shape[1]):
            for j in range(ps.shape[2]):
                if threshold is not None and j > 0 and ps[b, q, j] < threshold:
                    continue
                c = cells[b, q, j]
                for pid in ivf[off[c]:off[c] + min(lens[c], cell_cap)]:
                    a = ps[b, q, j] - impute[q]
                    best[int(pid), q] = max(best.get((int(pid), q), -np.inf), a)
        per_pid = {}
        for (pid, q), a in best.items():
            per_pid[pid] = per_pid.get(pid, 0.0) + max(a, 0.0) + impute[q] * 0.5
        total = sum(max(a, 0.0) + abs(impute[q]) * 0.5 for (_, q), a in best.items())
        out.append((per_pid, total))
    return out


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("threshold", [None, 0.45])
@pytest.mark.parametrize("balance_cap", [1024, 4])
def test_stage1_matches_a_numpy_rederivation(ref, monkeypatch, packed, threshold, balance_cap):
    cfg, _, _, path, _, Q = ref
    _, t = _indexes(path, cfg, balance_cap)
    if not packed:  # force the two-stable-sort route
        monkeypatch.setattr(tdi, "PACKED_KEY_BITS", 0)
    nprobe, cap = t.compensated_nprobe(4), 64
    with torch.no_grad():
        ps, cells = tdi._probe_topk(t, torch.from_numpy(Q), nprobe)
        stage1, p2, n_unique = tdi._stage1(t, ps, cells, cell_cap=cap,
                                           centroid_threshold=threshold)
    B, Lq = Q.shape[:2]
    E = Lq * nprobe * cap
    assert stage1.shape == p2.shape == (B, E) and n_unique.shape == (B,)
    assert (p2.diff(dim=1) >= 0).all()  # sorted by pid, sentinels last
    for b, (want, total) in enumerate(_stage1_reference(t, ps, cells, cap, threshold)):
        heads = stage1[b] > tdi.NEG / 2
        got = dict(zip(p2[b][heads].tolist(), stage1[b][heads].double().tolist()))
        assert int(n_unique[b]) == len(want) == len(got) == int(heads.sum())
        assert got.keys() == want.keys()
        worst = max(abs(got[p] - want[p]) for p in want)
        assert worst <= STAGE1_REL * total, (b, worst, total)
        assert (stage1[b][~heads] == tdi.NEG).all()


def test_stage1_sort_routes_agree(ref, monkeypatch):
    """The packed int64 key and the two stable sorts order entries the same
    way, so stage 1 is identical bit for bit."""
    cfg, _, _, path, _, Q = ref
    _, t = _indexes(path, cfg, 4)
    with torch.no_grad():
        ps, cells = tdi._probe_topk(t, torch.from_numpy(Q), t.compensated_nprobe(4))
        packed = tdi._stage1(t, ps, cells, cell_cap=64, centroid_threshold=None)
        monkeypatch.setattr(tdi, "PACKED_KEY_BITS", 0)
        two = tdi._stage1(t, ps, cells, cell_cap=64, centroid_threshold=None)
    for a, b in zip(packed, two):
        assert torch.equal(a, b)


@pytest.mark.parametrize("threshold", [None, 0.45])
def test_stage1_cut_and_overflow_match_jax(ref, threshold):
    """A stage-1 cut of 12 below the unique count, no refine, k = the cut:
    the candidates that reach stage 2 (every returned pid) are the JAX
    package's up to near-ties at the cut, with the same overflow count."""
    cfg, _, _, path, _, Q = ref
    j, t = _indexes(path, cfg)
    kw = dict(k=12, nprobe=4, ncandidates=12, cell_cap=64, max_candidates=64,
              centroid_threshold=threshold, stage1_refine=False)
    pj, sj = j.search_Q_batch(jnp.asarray(Q), **kw)
    pt, st = t.search_Q_batch(torch.from_numpy(Q), **kw)
    assert t.overflow_candidates == j.overflow_candidates > 0
    with torch.no_grad():
        ps, cells = tdi._probe_topk(t, torch.from_numpy(Q), 4)
    for b, (s1, total) in enumerate(_stage1_reference(t, ps, cells, 64, threshold)):
        a, c = set(pt[b][pt[b] >= 0].tolist()), set(pj[b][pj[b] >= 0].tolist())
        assert len(a) == len(c) == 12
        cut = min(s1[p] for p in a | c)
        for pid in a ^ c:  # either side may keep either of two near-tied pids
            assert s1[pid] - cut <= 10 * STAGE1_REL * total, (b, pid, s1[pid], cut)
        shared = {int(p): float(s) for p, s in zip(pt[b], st[b]) if p in c}
        for p, s in zip(pj[b], sj[b]):
            if int(p) in shared:
                assert abs(shared[int(p)] - float(s)) <= TOL


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("refine", [True, False])
def test_search_runs_under_fake_tensors(ref, monkeypatch, packed, refine):
    """Every op of the funnel (probe, stage 1, refine, stage 2, top-k) runs
    under FakeTensorMode, which refuses any op whose output shape depends on
    the data: the funnel is one static program."""
    from torch._subclasses.fake_tensor import DynamicOutputShapeException, FakeTensorMode

    cfg, _, _, path, _, _ = ref
    _, t = _indexes(path, cfg, 4)
    if not packed:
        monkeypatch.setattr(tdi, "PACKED_KEY_BITS", 0)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode, torch.no_grad():
        x = torch.randn(6)
        with pytest.raises(DynamicOutputShapeException):
            x[x > 0]  # the mode refuses a data-dependent shape
        Q = torch.randn(3, 16, 32)
        out = tdi._search(t, Q, k=5, nprobe=t.compensated_nprobe(4), ncandidates=8,
                          cell_cap=64, max_candidates=64, centroid_threshold=0.3,
                          stage1_refine=refine, refine_width=4, tracer=None)
    assert [tuple(o.shape) for o in out] == [(3, 5), (3, 5), (3,)]
    assert [o.dtype for o in out] == [torch.int64, torch.float32, torch.int64]


# --- the program cache ------------------------------------------------------


def _equal(a, b):
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_programs_key_on_batch_shape_and_knobs(ref):
    cfg, _, _, path, _, Q = ref
    _, t = _indexes(path, cfg)
    Qt = torch.from_numpy(Q)
    for B in (1, 4, 5):  # the Searcher pads to buckets; the index keys on B itself
        got = t.finalize(t._program_search_Q(Qt[:B], **SEARCH))
        want = t.finalize(t._search_Q_eager(Qt[:B], **SEARCH))
        assert _equal(got, want)
    assert t.programs.built == len(t.programs) == 3
    t.finalize(t._program_search_Q(Qt[:4], **SEARCH))  # the same key: no new program
    assert t.programs.built == 3
    for change in (dict(nprobe=2), dict(ncandidates=8), dict(centroid_threshold=0.4),
                   dict(stage1_refine=False), dict(k=3)):
        got = t.finalize(t._program_search_Q(Qt, **(SEARCH | change)))
        assert _equal(got, t.finalize(t._search_Q_eager(Qt, **(SEARCH | change))))
    assert t.programs.built == 8


def test_tokens_program_matches_the_eager_entry(ref):
    cfg, jenc, _, path, queries, _ = ref
    _, t = _indexes(path, cfg)
    enc = port_encoder(jenc)
    ids, mask = enc.tensorize_queries(queries)
    got = t.finalize(t._program_search_tokens(enc, ids, mask, **SEARCH))
    want = t.finalize(t._search_tokens_eager(enc, ids, mask, **SEARCH))
    assert _equal(got, want)
    assert t.programs.built == 1
    elsewhere = types.SimpleNamespace(model=torch.nn.Linear(1, 1, device="meta"))
    with pytest.raises(ValueError, match="encoder is on"):
        t._program_search_tokens(elsewhere, ids, mask, **SEARCH)


def test_stale_programs_are_never_replayed(ref):
    """``rebalance`` drops the programs; a replaced index tensor or re-bound
    encoder parameters give a new key; an in-place update (an optimizer
    step) keeps the program, which reads the new values."""
    cfg, jenc, _, path, queries, _ = ref
    _, t = _indexes(path, cfg)
    enc = port_encoder(jenc)
    ids, mask = enc.tensorize_queries(queries)
    launch = lambda: t.finalize(t._program_search_tokens(enc, ids, mask, **SEARCH))  # noqa: E731
    launch()
    assert t.programs.built == 1
    t.rebalance(jfmt.load_ivf(path)[1], 4)
    assert len(t.programs) == 0
    _, t4 = _indexes(path, cfg, 4)
    assert _equal(launch(), t4.finalize(t4._search_tokens_eager(enc, ids, mask, **SEARCH)))
    assert t.programs.built == 2
    t.doclens = t.doclens.clone()  # a replaced tensor: a new address
    launch()
    assert t.programs.built == 3
    enc.model.load_state_dict({k: v.clone() for k, v in enc.model.state_dict().items()},
                              assign=True)  # re-bound parameters
    launch()
    assert t.programs.built == 4
    before = launch()
    with torch.no_grad():  # an in-place step keeps every address
        for p in enc.model.parameters():
            p.mul_(1.01).add_(0.001)
    after = launch()
    assert t.programs.built == 4
    assert _equal(after, t.finalize(t._search_tokens_eager(enc, ids, mask, **SEARCH)))
    assert not np.array_equal(before[1], after[1])


def test_two_launches_in_flight_keep_their_own_results(ref):
    cfg, _, _, path, _, Q = ref
    _, t = _indexes(path, cfg)
    Qt = torch.from_numpy(Q)
    first = t._program_search_Q(Qt, **SEARCH)
    second = t._program_search_Q(Qt.flip(0), **SEARCH)  # the same program
    assert t.programs.built == 1
    got2, got1 = t.finalize(second), t.finalize(first)
    assert _equal(got1, t.finalize(t._search_Q_eager(Qt, **SEARCH)))
    assert _equal(got2, t.finalize(t._search_Q_eager(Qt.flip(0), **SEARCH)))


def test_an_updater_swap_serves_the_new_index(ref, tmp_path):
    """``IndexUpdater.add`` then ``Searcher.reload``: the reloaded index has
    programs of its own, its results equal a fresh Searcher's, and the old
    snapshot's programs still serve the old index."""
    import shutil

    from colbert_torch.indexing.updater import IndexUpdater
    from colbert_torch.retrieval.searcher import Searcher

    cfg, jenc, passages, path, queries, _ = ref
    work = str(tmp_path / "idx")
    shutil.copytree(path, work)
    enc = port_encoder(jenc)
    old = Searcher(work, encoder=enc, device="cpu")
    ids, mask = enc.tensorize_queries(queries)
    kw = old._search_kwargs(5)
    before = old.device_index.finalize(
        old.device_index._program_search_tokens(enc, ids, mask, **kw))
    IndexUpdater(work, enc).add([passages[5] + " added", passages[33] + " again"])
    new = old.reload()
    assert new.device_index is not old.device_index and len(new.device_index.programs) == 0
    fresh = Searcher(work, encoder=enc, device="cpu")
    kw = new._search_kwargs(5)
    got = new.device_index.finalize(
        new.device_index._program_search_tokens(enc, ids, mask, **kw))
    assert _equal(got, fresh.device_index.finalize(
        fresh.device_index._search_tokens_eager(enc, ids, mask, **kw)))
    assert (got[0] >= len(passages)).any()  # the added passages are found
    still = old.device_index.finalize(
        old.device_index._program_search_tokens(enc, ids, mask, **old._search_kwargs(5)))
    assert _equal(still, before) and old.device_index.programs.built == 1


def test_the_cache_holds_at_most_max_programs(ref):
    cfg, _, _, path, _, Q = ref
    _, t = _indexes(path, cfg)
    Qt = torch.from_numpy(Q)
    for k in range(1, tprog.MAX_PROGRAMS + 3):
        t.finalize(t._program_search_Q(Qt, **(SEARCH | dict(k=k))))
    assert len(t.programs) == tprog.MAX_PROGRAMS
    assert t.programs.built == tprog.MAX_PROGRAMS + 2
    t.finalize(t._program_search_Q(Qt, **(SEARCH | dict(k=1))))  # evicted: built anew
    assert t.programs.built == tprog.MAX_PROGRAMS + 3
    stats = t.programs.stats()
    assert stats["held"] == tprog.MAX_PROGRAMS and stats["pool_bytes"] == 0


def test_the_route_is_eager_only_for_cpu_tracer_and_mesh(ref, monkeypatch):
    """The public entries on the CPU build no program; on a card (the
    device faked here, the launches recorded) the program route is taken
    unless a tracer is given or the encoder has a mesh attached."""
    from colbert_torch.utils.tracing import Tracer

    cfg, jenc, _, path, queries, Q = ref
    _, t = _indexes(path, cfg)
    enc = port_encoder(jenc)
    ids, mask = enc.tensorize_queries(queries)
    t.finalize(t.search_tokens_batch_async(enc, ids, mask, **SEARCH))
    t.search_Q_batch(torch.from_numpy(Q), **SEARCH)
    assert t.programs.built == 0

    routes = []
    for name in ("_program_search_Q", "_program_search_tokens", "_search_Q_eager",
                 "_search_tokens_eager"):
        monkeypatch.setattr(DeviceIndex, name,
                            lambda self, *a, _n=name, **kw: routes.append(_n))
    monkeypatch.setattr(DeviceIndex, "device", property(lambda self: torch.device("cuda")))
    t.search_Q_batch_async(Q, **SEARCH)
    t.search_Q_batch_async(Q, tracer=Tracer(), **SEARCH)
    t.search_tokens_batch_async(enc, ids, mask, **SEARCH)
    t.search_tokens_batch_async(enc, ids, mask, tracer=Tracer(), **SEARCH)
    enc.mesh = object()
    t.search_tokens_batch_async(enc, ids, mask, **SEARCH)
    assert routes == ["_program_search_Q", "_search_Q_eager", "_program_search_tokens",
                      "_search_tokens_eager", "_search_tokens_eager"]


def test_recording_keeps_the_program_route(ref, monkeypatch):
    """With spans and counters recording (an operator's ``recording()``, or
    ``torch.profiler`` running on the thread), a card (faked as above) still
    takes the program route: recording never moves serving to the eager
    route."""
    from colbert_torch.utils import tracing

    cfg, jenc, _, path, queries, Q = ref
    _, t = _indexes(path, cfg)
    enc = port_encoder(jenc)
    ids, mask = enc.tensorize_queries(queries)
    routes = []
    for name in ("_program_search_Q", "_program_search_tokens", "_search_Q_eager",
                 "_search_tokens_eager"):
        monkeypatch.setattr(DeviceIndex, name,
                            lambda self, *a, _n=name, **kw: routes.append(_n))
    monkeypatch.setattr(DeviceIndex, "device", property(lambda self: torch.device("cuda")))
    with tracing.recording():
        assert tracing.active()
        t.search_Q_batch_async(Q, **SEARCH)
        t.search_tokens_batch_async(enc, ids, mask, **SEARCH)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.active()
        t.search_Q_batch_async(Q, **SEARCH)
        t.search_tokens_batch_async(enc, ids, mask, **SEARCH)
    tracing.take()
    assert routes == ["_program_search_Q", "_program_search_tokens"] * 2


def test_a_cpu_launch_can_keep_its_outputs_on_the_device():
    """On the CPU a launch runs the function on its static buffers:
    ``to_host`` gives the launch its own copies, ``to_host=False`` the
    function's outputs themselves; both count the launch, neither a
    replay."""
    seen = []

    def fn(x, y):
        out = x * 2 + y
        seen.append(out)
        return (out,)

    prog = tprog.Program(fn, [(3,), (3,)], [torch.float32, torch.float32], torch.device("cpu"))
    (a,), ready, timing = prog.launch(np.ones(3, np.float32), np.arange(3, dtype=np.float32))
    assert ready is None and timing is None and a is not seen[-1]
    np.testing.assert_array_equal(a.numpy(), [2.0, 3.0, 4.0])
    (b,), ready, _ = prog.launch(np.zeros(3, np.float32), np.ones(3, np.float32),
                                 to_host=False)
    assert ready is None and b is seen[-1]
    np.testing.assert_array_equal(b.numpy(), [1.0, 1.0, 1.0])
    assert prog.launches == 2 and prog.replays == 0 and prog.graph is None
    assert tprog.input_dtype(np.zeros((2, 2), np.int32)) == torch.int64
    assert tprog.input_dtype(np.zeros((2, 2), bool)) == torch.bool
