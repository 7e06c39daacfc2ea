"""The benchmark's own tests (run them with ``python -m pytest
benchmark/tests -q`` from the repository root). Tests that need a card use
the ``card`` fixture, which skips on a machine without one; the decision
is made when the test runs, never when a module is imported."""

import copy
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# a configuration small enough for the CPU: every width cut, the index too
TINY = {
    "config": {
        "bert": {"vocab_size": 2048, "hidden_size": 64, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "intermediate_size": 128,
                 "max_position_embeddings": 512, "type_vocab_size": 2,
                 "layer_norm_eps": 1e-12, "hidden_act": "gelu"},
        "index": {"n_passages": 3000, "avg_doclen": 40, "num_partitions": 256,
                  "chunksize": 1000, "code_locality": True},
        # a 32-passage stage-2 budget: the CPU's plain stage 2 is slow
        "search": {"nprobe": 2, "ncandidates": 32, "centroid_score_threshold": 0.45,
                   "plaid_stage2_docs": 32, "plaid_stage1_refine": True,
                   "refine_width_factor": 4, "search_cell_cap": None,
                   "search_max_candidates": None, "ivf_balance_cap": None,
                   "probe_dup_compensation": True, "probe_comp_saturation": 0.05},
        "indexing": {"index_bsize": 64, "kmeans_niters": 4, "length_bucket": 64,
                     "use_pallas": True, "flash_min_seqlen": 2048, "transfer_dtype": "bfloat16"},
        "collection_passages": 300,
    },
    # serving and build cells each read their own keys
    "cell": {"pool_batches": 4, "warmup_batches": 2, "check_queries": 16, "batch": 8,
             "min_words": 10, "max_words": 30, "warmup_passages": 100, "warmup_chunk": 16,
             "check_passages": 64},
}


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """Overrides for a tiny run, its work directory under ``tmp_path``."""
    import torch

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    torch.set_num_threads(2)
    return copy.deepcopy(TINY)


# limits at the tiny size, between tiny sound runs and the tiny control and
# faults (a cell's own limits are set at its size on the card: PERF.md)
TINY_LIMITS = {
    "serve-stream.base": {"score_gap": 0.05, "miss_share": 0.16},
    "index-build.large": {"kmeans_gap": 0.05, "cutoff_gap": 0.1, "doclen_errors": 0,
                          "ivf_errors": 0, "code_miss_share": 0.07, "bucket_miss_share": 0.08},
}


@pytest.fixture
def tiny_run(tiny):
    """``go(cell, seed, seconds, **cell_keys)`` runs ``cell`` once at the
    tiny size on the CPU, judged by its tiny limits."""
    from benchmark import run

    def go(cell, seed, seconds=1.0, **cell_keys):
        o = copy.deepcopy(tiny)
        o["cell"].update(cell_keys, limits=TINY_LIMITS[cell])
        return run.execute(cell, seed, seconds, False, "cpu", overrides=o)

    return go
