"""The plain reference against itself at tiny sizes (its funnel at full
width is exhaustive MaxSim; chunking changes nothing) and against the
port's documented semantics on the CPU (tokenization, the residual layout,
the fp32 encoder)."""

import numpy as np
import pytest
import torch

from benchmark.gen import index, queries, vocab, weights
from benchmark.reference import encoder, funnel, tokenize

BERT = {"vocab_size": 256, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 64, "max_position_embeddings": 64, "type_vocab_size": 2,
        "layer_norm_eps": 1e-12, "hidden_act": "gelu"}
SEARCH = {"nprobe": 2, "ncandidates": 8192, "centroid_score_threshold": 0.45,
          "plaid_stage2_docs": None, "plaid_stage1_refine": True, "refine_width_factor": 4}


@pytest.fixture(scope="module")
def ix():
    return index.synthesize(5, 400, dim=16, nbits=2, avg_doclen=40, num_partitions=32,
                            chunksize=200)


def _queries(n, seed=3):
    return torch.nn.functional.normalize(
        torch.randn(n, 8, 16, generator=torch.Generator().manual_seed(seed)), dim=-1)


def test_full_width_funnel_is_exhaustive_maxsim(ix):
    rix = funnel.load_index(ix, "cpu")
    p = dict(nprobe=32, threshold=None, budget=400, width=400, refine=False, k=10)
    every = torch.arange(400)
    for Q in _queries(4):
        got = funnel.search(rix, Q, p)
        exact = funnel.maxsim(rix, Q, every)
        top = exact.topk(10)
        assert torch.equal(got["pids"], top.indices)
        assert torch.allclose(got["scores"], top.values)
        assert got["work"]["candidates"] == 400


def test_chunking_changes_nothing(ix):
    rix = funnel.load_index(ix, "cpu")
    pids = torch.arange(0, 400, 3)
    Q = _queries(1)[0]
    assert torch.allclose(funnel.maxsim(rix, Q, pids, chunk=7), funnel.maxsim(rix, Q, pids))
    assert torch.allclose(funnel.refine_scores(rix, Q, pids, chunk=5),
                          funnel.refine_scores(rix, Q, pids))


def test_default_params_follow_the_documented_rules(ix):
    rix = funnel.load_index(ix, "cpu")
    p = funnel.params(SEARCH, rix, Lq=8, k=10)
    largest = -(-int(rix.ivf_lengths.max()) // 32) * 32
    cap = min(8192, 512, 8 * 2 * largest)
    assert p["budget"] == min(1024, cap) and p["refine"] == (p["budget"] < cap)
    assert p["k"] == 10 and p["threshold"] == 0.45


def test_decompress_matches_the_port(ix):
    from colbert_torch.ops import codec

    rix = funnel.load_index(ix, "cpu")
    rows = torch.arange(0, 300, 7)
    ours = funnel.decompress(rix, rows)
    port = codec.decompress(torch.from_numpy(ix.codes[rows.numpy()].astype(np.int64)),
                            torch.from_numpy(ix.residuals[rows.numpy()]),
                            torch.from_numpy(ix.centroids), torch.from_numpy(ix.bucket_weights),
                            nbits=2)
    assert torch.allclose(ours, port, atol=1e-6)


def test_tokenization_matches_the_port():
    from colbert_torch.tokenization.tensorize import tensorize_queries
    from colbert_torch.tokenization.wordpiece import WordPieceTokenizer

    v = vocab.make_vocab(2048)
    texts = queries.query_pool(1, 64, vocab.filler_words(2048)) + ["", "The dog, runs!"]
    ids, mask = tokenize.tensorize_queries(texts, v, 32)
    tok = WordPieceTokenizer(v)
    pids, pmask = tensorize_queries(texts, tok, query_token_id=v["[unused0]"], query_maxlen=32)
    assert np.array_equal(ids, pids) and np.array_equal(mask, pmask)


def test_fp32_encoder_matches_the_port_at_fp32():
    from colbert_torch.models.bert import BertConfig
    from colbert_torch.models.colbert import ColBERT

    w = weights.make_weights(9, BERT, 8, "cpu")
    with torch.device("meta"):
        model = ColBERT(BertConfig(**BERT), 8)
    model.load_state_dict(w, assign=True)
    ids = torch.randint(5, 256, (3, 12), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(3, 12, dtype=torch.bool)
    mask[1, 7:] = False
    keep = torch.ones_like(mask)
    ours = encoder.encode(w, BERT, ids, mask, keep)
    port = model.forward_normalized(ids, mask, keep, dtype_name="float32")
    assert torch.allclose(ours, port, atol=1e-5)
    fp8 = encoder.encode(w, BERT, ids, mask, keep, precision="fp8")
    assert (fp8 - ours).abs().max() > 100 * (port - ours).abs().max()
