"""A run of the serving cell on the CPU at a tiny size, past the look for
a card: sound, it comes out correct; with the timed path broken
underneath, it does not. Faults: an answer altered where it is produced,
half of a batch left out."""

import numpy as np
import pytest

CELLS = ["serve-stream.base"]




@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny_run):
    res = tiny_run(cell, 17, 2.0)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res["checks"]) == ["score_gap", "miss_share"]
    assert res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_caught(cell, tiny_run, monkeypatch):
    from colbert_torch.retrieval.device_index import DeviceIndex

    post = DeviceIndex._postprocess

    def altered(self, pids, scores, overflow, k):
        p, s = post(self, pids, scores, overflow, k)
        p[:, 0] = (p[:, 0] + 1) % self.n_passages
        return p, s

    monkeypatch.setattr(DeviceIndex, "_postprocess", altered)
    res = tiny_run(cell, 17, 2.0)
    assert not res["correct"] and res["failed"] == 0
    assert res["checks"]["score_gap"]["value"] > res["checks"]["score_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_a_batch_left_out_is_caught(cell, tiny_run, monkeypatch):
    from colbert_torch.retrieval.searcher import Searcher

    finish = Searcher.finish_search

    def half(self, parts, k=10):
        p, s = finish(self, parts, k)
        p[len(p) // 2:] = -1
        s[len(s) // 2:] = -np.inf
        return p, s

    monkeypatch.setattr(Searcher, "finish_search", half)
    res = tiny_run(cell, 17, 2.0)
    assert not res["correct"] and res["failed"] > 0
