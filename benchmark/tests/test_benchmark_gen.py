"""Every generator gives the same output for the same seed, and another for
another seed; large seeds are accepted."""

import numpy as np
import torch

from benchmark.gen import index, queries, vocab, weights

BIG = 2**31 + 12345
BERT = {"vocab_size": 128, "hidden_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 32, "max_position_embeddings": 64, "type_vocab_size": 2}


def test_vocab_is_published_size_and_fixed():
    v = vocab.make_vocab(30522)
    assert len(v) == 30522 and v["[PAD]"] == 0 and v["[MASK]"] == 4
    assert vocab.filler_words(30522) == 30522 - vocab.N_FIXED
    assert v == vocab.make_vocab(30522)


def test_queries_by_seed():
    a, b = queries.query_pool(BIG, 50, 1000), queries.query_pool(BIG, 50, 1000)
    assert a == b and a != queries.query_pool(BIG + 1, 50, 1000)
    assert all(4 <= len(q.split()) <= 19 for q in a)


def _ix(seed):
    return index.synthesize(seed, 500, dim=32, nbits=2, avg_doclen=40, num_partitions=64,
                            chunksize=200)


def test_index_by_seed(tmp_path):
    a, b, c = _ix(BIG), _ix(BIG), _ix(BIG + 1)
    for f in ("centroids", "codes", "residuals", "doclens"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.codes, c.codes)
    assert a.chunk_passages == [200, 200, 100] and len(a.codes) == a.doclens.sum()
    assert a.residuals.shape == (len(a.codes), 8)
    index.write_index(str(tmp_path), a, {"dim": 32, "nbits": 2})
    ivf, lengths = np.load(tmp_path / "ivf.npy"), np.load(tmp_path / "ivf_lengths.npy")
    assert lengths.sum() == len(ivf) and np.all(np.diff(a.codes[ivf].astype(np.int64)) >= 0)


def test_weights_by_seed():
    a = weights.make_weights(BIG, BERT, 8, "cpu")
    b = weights.make_weights(BIG, BERT, 8, "cpu")
    c = weights.make_weights(BIG + 1, BERT, 8, "cpu")
    assert a.keys() == b.keys() == weights.shapes(BERT, 8).keys()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["linear.weight"], c["linear.weight"])
    assert torch.equal(a["bert.emb_ln.scale"], torch.ones(16))
    assert abs(float(a["bert.word.weight"].std()) - 0.02) < 0.002
