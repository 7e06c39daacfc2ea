"""A run of the build cell on the CPU at a tiny size, past the look for a
card: sound, it comes out correct; with the timed path broken underneath,
it does not. Faults: a code altered where it is produced (by the
small-collection compress and by the chunk pass), half of the collection
left out, k-means that never iterates, cutoffs at the wrong quantiles."""

import numpy as np
import pytest

CELL = "index-build.large"


@pytest.fixture
def chunk_pass(monkeypatch):
    """The builder samples all but one passage, so it encodes and compresses
    every passage again in its chunk pass, as it does for a collection
    larger than its sample."""
    from colbert_torch.indexing import builder

    sample = builder.sample_pids
    monkeypatch.setattr(builder, "sample_pids", lambda n, rng: sample(n, rng)[1:])


def _altered(compress, at):
    """``compress`` with every 7th code moved on by one; its centroids are
    positional argument ``at``."""
    def altered(self, *a, **kw):
        codes, residuals, *rest = compress(self, *a, **kw)
        codes[::7] = (codes[::7] + 1) % a[at].shape[0]
        return (codes, residuals, *rest)
    return altered


@pytest.mark.parametrize("path", ["sample", "chunks"])
def test_sound_run_is_correct(path, tiny_run, request):
    if path == "chunks":
        request.getfixturevalue("chunk_pass")
    res = tiny_run(CELL, 23)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res["metrics"]) == ["index_passages_per_s", "setup_s"]
    assert res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("path,method,at", [("sample", "compress_sample_to_host", 3),
                                            ("chunks", "encode_passages_compressed", 1)])
def test_altered_code_is_caught(path, method, at, tiny_run, monkeypatch, request):
    from colbert_torch.models.encoder import ColBERTEncoder

    if path == "chunks":
        request.getfixturevalue("chunk_pass")
    monkeypatch.setattr(ColBERTEncoder, method, _altered(getattr(ColBERTEncoder, method), at))
    res = tiny_run(CELL, 23)
    assert not res["correct"]
    assert res["checks"]["code_miss_share"]["value"] > res["checks"]["code_miss_share"]["limit"]


def test_half_the_collection_left_out_is_caught(tiny_run, monkeypatch):
    from colbert_torch.indexing import builder

    build = builder._build
    monkeypatch.setattr(builder, "_build",
                        lambda cfg, enc, passages, path: build(cfg, enc,
                                                               passages[:len(passages) // 2],
                                                               path))
    assert not tiny_run(CELL, 23)["correct"]


def test_kmeans_that_never_iterates_is_caught(tiny_run, monkeypatch):
    from colbert_torch.ops import kmeans

    fit = kmeans.kmeans
    monkeypatch.setattr(kmeans, "kmeans", lambda data, k, **kw: fit(data, k, **{**kw, "niters": 0}))
    res = tiny_run(CELL, 23)
    assert not res["correct"]
    assert any(res["checks"][n]["value"] > res["checks"][n]["limit"]
               for n in ("kmeans_gap", "cutoff_gap"))


def test_cutoffs_at_the_wrong_quantiles_are_caught(tiny_run, monkeypatch):
    from colbert_torch.ops import codec

    quantiles = codec.bucket_cutoffs_and_weights

    def shifted(nbits, residuals):
        # eighths where quarters are due: 1/8, 2/8, 3/8 in place of 1/4, 2/4, 3/4
        cutoffs, weights, avg = quantiles(nbits + 1, residuals)
        return cutoffs[:(1 << nbits) - 1], weights[:1 << nbits], avg

    monkeypatch.setattr(codec, "bucket_cutoffs_and_weights", shifted)
    res = tiny_run(CELL, 23)
    assert not res["correct"]
    assert res["checks"]["cutoff_gap"]["value"] > res["checks"]["cutoff_gap"]["limit"]
    assert np.isfinite(res["checks"]["cutoff_gap"]["value"])
