"""The port's serving layer (``BatchingSearcher`` and the HTTP front) on a
port-built index on the CPU: the cases of ``tests/test_serving.py``, each
held against direct ``Searcher`` calls of the port. Coalescing,
pipelining, the host-backend branch, mixed k with error recovery, the HTTP
round trip and a concurrent burst, swap after an update, and a batcher
thread whose results equal direct search."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from colbert_torch.config import ColBERTConfig
from colbert_torch.indexing.builder import Indexer
from colbert_torch.indexing.updater import IndexUpdater
from colbert_torch.retrieval.searcher import Searcher
from colbert_torch.serving import BatchingSearcher
from colbert_torch.serving.http import make_server
from colbert_torch.utils.testing import make_encoder, synthetic_collection


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cfg = ColBERTConfig(dim=32, doc_maxlen=64, query_maxlen=16, index_bsize=8,
                        length_bucket=16, chunksize=32, nbits=2, kmeans_niters=5, nprobe=4)
    encoder = make_encoder(dim=32, seed=0, config=cfg, device="cpu")
    passages = synthetic_collection(40, seed=2)
    path = str(tmp_path_factory.mktemp("tserve") / "idx")
    Indexer(cfg, encoder=encoder, collection=passages, device="cpu").index(path)
    return passages, Searcher(path, encoder=encoder, device="cpu")


def test_batcher_matches_direct(served):
    passages, s = served
    b = BatchingSearcher(s, max_batch=8, max_wait_ms=20)
    try:
        queries = [passages[3], passages[17], "the dog runs", passages[29]]
        direct_p, direct_s = s.search_batch(queries, k=5)
        got = b.search_many(queries, k=5)
        for i, (p, sc) in enumerate(got):
            np.testing.assert_array_equal(p, direct_p[i])
            np.testing.assert_allclose(sc, direct_s[i])
    finally:
        b.close()


def test_batcher_thread_ignores_the_callers_grad_mode(served):
    """The loop thread holds its own no_grad: a caller with grad enabled
    gets plain (no autograd graph) results equal to direct search."""
    passages, s = served
    queries = [passages[i] for i in range(0, 40, 5)]
    direct_p, direct_s = s.search_batch(queries, k=4)
    with torch.enable_grad(), BatchingSearcher(s, max_batch=8, max_wait_ms=50) as b:
        got = [f.result(timeout=120) for f in [b.submit(q, k=4) for q in queries]]
    for i, (p, sc) in enumerate(got):
        assert isinstance(p, np.ndarray) and isinstance(sc, np.ndarray)
        np.testing.assert_array_equal(p, direct_p[i])
        np.testing.assert_array_equal(sc, direct_s[i])


def test_batcher_coalesces_concurrent_requests(served):
    passages, s = served
    b = BatchingSearcher(s, max_batch=64, max_wait_ms=200)
    try:
        results = {}

        def worker(i):
            results[i] = b.search(passages[i], k=3)[0]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        for i in range(12):
            assert results[i][0] == i
        assert b.stats["queries"] == 12
        assert b.stats["max_batch_seen"] > 1
    finally:
        b.close()


def test_batcher_concurrent_submit_stress(served):
    """More submitting threads than cores, with a short interpreter switch
    interval: every future resolves to its own query's result and the
    stats count every query once."""
    import sys

    passages, s = served
    n_threads, per_thread = 24, 8
    direct_p, _ = s.search_batch(passages, k=3)
    got, errors = {}, []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with BatchingSearcher(s, max_batch=64, max_wait_ms=2) as b:
            def client(t):
                idx = [(t * per_thread + j) % 40 for j in range(per_thread)]
                futs = [(i, b.submit(passages[i], k=3)) for i in idx]
                for i, f in futs:
                    try:
                        got[t, i] = f.result(timeout=300)[0]
                    except Exception as e:  # pragma: no cover - failure detail
                        errors.append(repr(e))

            threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            assert not any(th.is_alive() for th in threads)
            stats = dict(b.stats)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    assert len(got) == n_threads * per_thread
    for (t, i), p in got.items():
        np.testing.assert_array_equal(p, direct_p[i])
    assert stats["queries"] == n_threads * per_thread and stats["max_batch_seen"] <= 64


def test_batcher_pipelines_multiple_batches(served):
    """max_batch=4 with 16 queued requests: at least 4 launches through the
    launch/finish pipeline (max_inflight=2), each request its own result."""
    passages, s = served
    b = BatchingSearcher(s, max_batch=4, max_wait_ms=5, max_inflight=2)
    try:
        futs = [b.submit(passages[i], k=3) for i in range(16)]
        direct_p, direct_s = s.search_batch(passages[:16], k=3)
        for i, f in enumerate(futs):
            p, sc = f.result(timeout=120)
            assert p[0] == i
            np.testing.assert_array_equal(p, direct_p[i])
            np.testing.assert_allclose(sc, direct_s[i], atol=1e-6)
        assert b.stats["batches"] >= 4 and b.stats["queries"] == 16
        assert b.stats["max_batch_seen"] <= 4
    finally:
        b.close()


def test_batcher_host_backend_branch(served):
    """The host backend takes the synchronous branch of the loop."""
    passages, s = served
    host = Searcher(s.index_path, encoder=s.encoder, device="cpu", backend="host")
    with BatchingSearcher(host, max_batch=4, max_wait_ms=5) as b:
        futs = [b.submit(passages[i], k=2) for i in (5, 9)]
        direct_p, direct_s = host.search_batch([passages[5], passages[9]], k=2)
        for j, f in enumerate(futs):
            p, sc = f.result(timeout=120)
            np.testing.assert_array_equal(p, direct_p[j])
            np.testing.assert_allclose(sc, direct_s[j], atol=1e-6)
        assert futs[0].result()[0][0] == 5 and futs[1].result()[0][0] == 9


def test_batcher_context_manager(served):
    passages, s = served
    with BatchingSearcher(s, max_batch=4, max_wait_ms=10) as b:
        assert b.search(passages[6], k=2)[0][0] == 6
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("closed on exit")


def test_batcher_mixed_k_and_error_recovery(served):
    passages, s = served
    b = BatchingSearcher(s, max_batch=8, max_wait_ms=20)
    try:
        f1, f2 = b.submit(passages[1], k=2), b.submit(passages[2], k=7)
        p1, _ = f1.result(timeout=60)
        p2, _ = f2.result(timeout=60)
        assert len(p1) == 2 and len(p2) == 7 and p1[0] == 1 and p2[0] == 2
        # a failing launch sets its exception on every waiter; serving goes on
        launch = s.launch_search
        s.launch_search = lambda *a, **k: (_ for _ in ()).throw(ValueError("boom"))
        try:
            bad = b.submit(passages[3], k=2)
            with pytest.raises(ValueError, match="boom"):
                bad.result(timeout=60)
        finally:
            del s.launch_search
        assert s.launch_search == launch
        assert b.search(passages[4], k=2)[0][0] == 4
    finally:
        b.close()
    with pytest.raises(RuntimeError):
        b.submit("after close")


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def test_http_concurrent_burst(served):
    """A burst of concurrent clients is served in full (the accept backlog
    is 1024) and coalesced."""
    passages, s = served
    server = make_server(s, port=0, max_batch=64, max_wait_ms=30)
    assert server.request_queue_size == 1024
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    results, errors = {}, []

    def client(i):
        try:
            results[i] = _post(port, "/search", {"query": passages[i % 40], "k": 2})
        except Exception as e:  # pragma: no cover - failure detail
            errors.append((i, repr(e)))

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(64)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors[:3]
        assert len(results) == 64
        direct_p, direct_s = s.search_batch(passages, k=2)
        for i in range(64):
            np.testing.assert_array_equal(results[i]["pids"], direct_p[i % 40])
            np.testing.assert_allclose(results[i]["scores"], direct_s[i % 40], atol=1e-6)
        assert server.batcher.stats["max_batch_seen"] > 1
    finally:
        server.shutdown()
        server.batcher.close()


def test_http_server_roundtrip(served):
    passages, s = served
    server = make_server(s, port=0, max_batch=8, max_wait_ms=20)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        health = _get(port, "/health")
        assert health == {"ok": True, "n_passages": 40}
        out = _post(port, "/search", {"query": passages[7], "k": 3})
        direct_p, direct_s = s.search(passages[7], k=3)
        np.testing.assert_array_equal(out["pids"], direct_p)
        np.testing.assert_allclose(out["scores"], direct_s, rtol=1e-6)
        assert out["pids"][0] == 7
        outb = _post(port, "/search_batch", {"queries": [passages[4], passages[9]], "k": 2})
        bp, bs = s.search_batch([passages[4], passages[9]], k=2)
        np.testing.assert_array_equal(outb["pids"], bp)
        np.testing.assert_allclose(outb["scores"], bs, rtol=1e-6)
        with pytest.raises(urllib.error.HTTPError) as e:  # missing field -> 400
            _post(port, "/search", {"k": 3})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nope")
        assert e.value.code == 404
        assert _post(port, "/search", {"query": passages[5], "k": 1})["pids"][0] == 5
        stats = _get(port, "/stats")
        assert stats["queries"] >= 4 and set(stats) == {"queries", "batches", "max_batch_seen"}
    finally:
        server.shutdown()
        server.batcher.close()


def test_swap_serves_updated_index(served, tmp_path):
    """Zero-downtime update: IndexUpdater changes the artifacts, reload()
    loads them, swap() switches serving over without dropping requests."""
    import shutil

    passages, s0 = served
    path = str(tmp_path / "idx")
    shutil.copytree(s0.index_path, path)
    s = Searcher(path, encoder=s0.encoder, device="cpu")
    b = BatchingSearcher(s, max_batch=8, max_wait_ms=20)
    try:
        assert b.search(passages[3], k=2)[0][0] == 3
        fresh = "science history cooking travel music mountain river city"
        up = IndexUpdater(path, s.encoder)
        new_pids = up.add([fresh])
        assert b.search(passages[3], k=2)[0][0] == 3  # the old snapshot keeps serving
        b.swap(s.reload())
        assert b.search(fresh, k=2)[0][0] == new_pids[0]
        up.remove([3])
        b.swap(b.searcher.reload())
        p, _ = b.search(passages[3], k=10)
        assert 3 not in p.tolist()
    finally:
        b.close()
