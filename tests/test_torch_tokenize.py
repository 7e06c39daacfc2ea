"""Host-side copies in the port (config, tokenizer, tensorize, storage
format, planner, IVF build) vs the JAX package: identical ids, masks, files
and plans; each package loads the other's config.json."""

import dataclasses

import numpy as np
import pytest

from colbert_tpu.config import ColBERTConfig as JCfg
from colbert_tpu.indexing.builder import build_ivf as jbuild_ivf
from colbert_tpu.indexing.planner import setup_plan as jsetup_plan
from colbert_tpu.storage import format as jfmt
from colbert_tpu.tokenization import tensorize as jtz
from colbert_tpu.tokenization.wordpiece import WordPieceTokenizer as JTok
from colbert_tpu.utils import testing as jtesting
from colbert_torch.config import ColBERTConfig
from colbert_torch.indexing.ivf import build_ivf
from colbert_torch.indexing.planner import setup_plan
from colbert_torch.storage import format as fmt
from colbert_torch.tokenization import tensorize as tz
from colbert_torch.tokenization.native import NativeWordPiece
from colbert_torch.tokenization.wordpiece import WordPieceTokenizer
from colbert_torch.utils import testing as ttesting

TEXTS = ["the dog runs fast!", "", "A big, blue river (and) a w3 mountain?",
         "unknownword cat", "the " * 40, "naïve café"]


@pytest.mark.parametrize("maxlen,attend", [(16, False), (8, True), (32, False)])
def test_tensorize_queries_identical(maxlen, attend):
    vocab = ttesting.make_vocab()
    jt, tt = JTok(dict(vocab)), WordPieceTokenizer(dict(vocab))
    kw = dict(query_token_id=5, query_maxlen=maxlen, attend_to_mask_tokens=attend)
    ji, jm = jtz.tensorize_queries(TEXTS, jt, **kw)
    ti, tm = tz.tensorize_queries(TEXTS, tt, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)


def test_tensorize_docs_and_skiplist_identical():
    vocab = ttesting.make_vocab()
    jt, tt = JTok(dict(vocab)), WordPieceTokenizer(dict(vocab))
    kw = dict(doc_token_id=6, doc_maxlen=20, length_bucket=8)
    for a, b in zip(jtz.tensorize_docs(TEXTS, jt, **kw), tz.tensorize_docs(TEXTS, tt, **kw)):
        np.testing.assert_array_equal(b, a)
    assert tz.build_skiplist(tt) == jtz.build_skiplist(jt)


def test_native_tokenizer_matches_python():
    tok = WordPieceTokenizer(ttesting.make_vocab())
    native = NativeWordPiece(tok)
    assert native.encode_batch(TEXTS) == JTok(ttesting.make_vocab()).encode_batch(TEXTS)


def test_reference_config_json_loads(tmp_path):
    ref = JCfg(dim=64, nbits=4, nprobe=7, ivf_balance_cap=256,
               centroid_score_threshold=None, activation_dtype="float32")
    ref.save(str(tmp_path / "config.json"))
    ours = ColBERTConfig.load(str(tmp_path / "config.json"))
    assert ours.to_dict() == ref.to_dict()
    ours.save(str(tmp_path / "back.json"))
    assert JCfg.load(str(tmp_path / "back.json")).to_dict() == ref.to_dict()
    assert [f.name for f in dataclasses.fields(ColBERTConfig)] == [
        f.name for f in dataclasses.fields(JCfg)]


def test_config_rejects_zero_saturation():
    with pytest.raises(ValueError, match="probe_comp_saturation"):
        ColBERTConfig(probe_comp_saturation=0)


@pytest.mark.parametrize("n,chunksize", [(1000, None), (141_431, 25_000), (7, 3)])
def test_setup_plan_identical(n, chunksize):
    assert setup_plan(n, 110.0, 10**9, chunksize, 1) == jsetup_plan(n, 110.0, 10**9, chunksize, 1)


def test_build_ivf_identical(rng):
    codes = rng.integers(0, 50, 5000).astype(np.uint32)
    for a, b in zip(build_ivf(codes, 50), jbuild_ivf(codes, 50)):
        np.testing.assert_array_equal(np.asarray(a, np.int64), np.asarray(b, np.int64))


def test_synthesize_index_identical_files(tmp_path):
    """The same seed writes byte-identical index files in both packages,
    and each package's format module reads them the same way."""
    import os

    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(dim=32, nbits=2, avg_doclen=20, chunksize=40, seed=3)
    assert ttesting.synthesize_index(b, 100, **kw) == jtesting.synthesize_index(a, 100, **kw)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    assert fmt.check_all_files_saved(b) == jfmt.check_all_files_saved(a) == []
    np.testing.assert_array_equal(fmt.load_all_residuals(b), jfmt.load_all_residuals(a))
    np.testing.assert_array_equal(fmt.read_embedding_rows(b, 5, 77)[0],
                                  jfmt.read_embedding_rows(a, 5, 77)[0])


# --- the encoder's native query path against the JAX package --------------

QUERY_CASES = {
    "bench_pool": None,  # the serving cell's query pool, filled in below
    "mixed_case_punct": ["The DOG runs, FAST!", "hello...world", "(a) b-c; d:e 'f' \"g\"",
                         "  spaces   everywhere  ", "W12 w13?w14", "music" * 40],
    "non_ascii": ["naïve café", "普通 text", "dog cat", "Ünïcödé w1", "w2   w3"],
    "empty": ["", "dog", "", ""],
    "long": ["w1 " * 40, "music science history " * 12, "the dog"],
    "overflow": ["w5 " * 600, "w6 w7", "w8 " * 513],
    "lone_surrogate": ["dog \ud800 cat", "w1 w2"],  # no UTF-8 form: the batch goes to Python
}


def _bench_pool(n=256):
    from benchmark.gen.queries import query_pool
    from benchmark.gen.vocab import filler_words

    return query_pool(2**31 + 11, n, filler_words(30522))


def _query_encoder(attend, native=True, monkeypatch=None):
    from colbert_torch.models.bert import BertConfig
    from colbert_torch.tokenization import native as native_mod

    if not native:
        monkeypatch.setattr(native_mod, "load_library", lambda: None)
    vocab = ttesting.make_vocab(30522 - 52)
    cfg = ColBERTConfig(dim=16, query_maxlen=32, attend_to_mask_tokens=attend)
    bert = BertConfig(vocab_size=len(vocab), hidden_size=16, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=32)
    return ttesting.make_encoder(dim=16, config=cfg, bert_config=bert, vocab=vocab,
                                 device="cpu")


def _reference_tensorize(enc, texts):
    """The JAX package's ``tensorize_queries`` with the encoder's vocabulary
    and settings."""
    return jtz.tensorize_queries(texts, JTok(dict(enc.tokenizer.vocab)),
                                 query_token_id=enc.query_token_id,
                                 query_maxlen=enc.config.query_maxlen,
                                 attend_to_mask_tokens=enc.config.attend_to_mask_tokens)


def _python_tensorize(enc, texts):
    return tz.tensorize_queries(texts, enc.tokenizer, query_token_id=enc.query_token_id,
                                query_maxlen=enc.config.query_maxlen,
                                attend_to_mask_tokens=enc.config.attend_to_mask_tokens)


def _assert_same_bytes(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("attend", [False, True])
@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_encoder_tensorize_queries_matches_reference(case, attend):
    """``ColBERTEncoder.tensorize_queries`` (native WordPiece) and the
    port's Python ``tensorize_queries`` give the JAX package's ids and mask
    byte for byte."""
    enc = _query_encoder(attend)
    assert enc._native_tok.available
    texts = QUERY_CASES[case] or _bench_pool()
    want = _reference_tensorize(enc, texts)
    _assert_same_bytes(enc.tensorize_queries(texts), want)
    _assert_same_bytes(_python_tensorize(enc, texts), want)


@pytest.mark.parametrize("attend", [False, True])
def test_encoder_tensorize_queries_without_the_library(attend, monkeypatch):
    """Where the native library cannot be loaded every text goes to the
    Python tokenizer and is counted as a fallback."""
    from colbert_torch.utils import tracing

    enc = _query_encoder(attend, native=False, monkeypatch=monkeypatch)
    assert not enc._native_tok.available
    texts = QUERY_CASES["mixed_case_punct"] + QUERY_CASES["non_ascii"] + [""]
    with tracing.recording() as rec:
        got = enc.tensorize_queries(texts)
    _assert_same_bytes(got, _reference_tensorize(enc, texts))
    assert rec.counters["query_tokenize_native"] == 0
    assert rec.counters["query_tokenize_fallback"] == len(texts)


@pytest.mark.parametrize("texts,fallback", [
    (QUERY_CASES["mixed_case_punct"] + QUERY_CASES["empty"], 0),
    (QUERY_CASES["non_ascii"], 4),
    (QUERY_CASES["overflow"] + ["dog"], 2),
    (QUERY_CASES["lone_surrogate"], 2),
])
def test_query_tokenize_counters(texts, fallback):
    """The two counters add up to the texts tokenized: 0 fallbacks on ASCII
    input, one per non-ASCII text and per text over the library's
    ``max_tokens_per_text``, every text of a batch with no UTF-8 form."""
    from colbert_torch.utils import tracing

    enc = _query_encoder(False)
    with tracing.recording() as rec:
        enc.tensorize_queries(texts)
        enc.tensorize_queries(texts)
    assert rec.counters["query_tokenize_fallback"] == 2 * fallback
    assert rec.counters["query_tokenize_native"] == 2 * (len(texts) - fallback)


@pytest.mark.parametrize("width", [4, 29, 512, 700])
def test_encode_array_matches_encode_batch(width):
    """``NativeWordPiece.encode_array`` holds each text's first ``width``
    tokens and its full count, as ``encode_batch`` gives them, at widths
    below and above the library's ``max_tokens_per_text``."""
    tok = WordPieceTokenizer(ttesting.make_vocab(30522 - 52))
    native = NativeWordPiece(tok)
    texts = [t for c in sorted(QUERY_CASES) if c != "lone_surrogate"
             for t in (QUERY_CASES[c] or _bench_pool(64))]
    want = tok.encode_batch(texts)
    ids, lens, n_fallback = native.encode_array(texts, width)
    assert ids.shape == (len(texts), width) and ids.dtype == np.int32
    assert lens.tolist() == [len(w) for w in want]
    assert n_fallback == 4 + (2 if width <= native.max_tokens else 0)  # the two overflows
    for row, toks in zip(ids, want):
        assert row[:min(len(toks), width)].tolist() == toks[:width]
