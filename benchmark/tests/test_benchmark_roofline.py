"""The work counts against hand counts at small shapes, and a share that
cannot pass 100% for a kernel doing the least work the rule allows."""

import pytest

from benchmark import roofline

H100 = "NVIDIA H100 80GB HBM3"


def test_encoder_flops_by_hand():
    bert = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2}
    # per layer 2*(4*16 + 2*4*8) + 4*3*4 = 2*128 + 48 = 304; head 2*4*2 = 16
    assert roofline.encoder_flops(bert, 2, 5, 3) == 5 * (2 * 304 + 16)


def test_stage2_by_hand():
    flops, nbytes = roofline.stage2_work(Lq=2, dim=8, nbits=2, K=100, queries=1, passages=3,
                                         tokens=10)
    assert flops == 2 * 2 * 8 * 10
    # Q 2*8*4 + tokens 10*(4+2) + 10 centroid rows 10*8*4 + weights 4*4 + 3*(8+4+4)
    assert nbytes == 64 + 60 + 320 + 16 + 48


def test_refine_takes_the_fewer_products():
    table, _ = roofline.refine_work(Lq=2, dim=8, K=4, queries=1, passages=3, tokens=10)
    assert table == 2 * 2 * 8 * 4 + 2 * 10          # the table over K=4 centroids
    gather, nbytes = roofline.refine_work(Lq=2, dim=8, K=1000, queries=1, passages=3, tokens=10)
    assert gather == 2 * 2 * 8 * 10 + 2 * 10       # a product per token
    assert nbytes == 64 + 40 + 10 * 8 * 4 + 48


@pytest.mark.parametrize("tokens", [10, 10**6, 10**9])
def test_least_work_at_peak_reads_100_percent(tokens):
    flops, nbytes = roofline.stage2_work(32, 128, 2, 32768, 32, tokens / 57, tokens)
    p = roofline.PEAKS[H100]
    fastest = max(flops / p["flops"], nbytes / p["bytes"])
    share, bound = roofline.share(flops, nbytes, fastest, H100)
    assert share == pytest.approx(100.0) and bound in ("flops", "bytes")
    assert roofline.share(flops, nbytes, fastest * 2, H100)[0] == pytest.approx(50.0)


def test_unknown_card_has_no_share():
    assert roofline.share(1.0, 1.0, 1.0, "cpu") is None
    assert roofline.mfu(1.0, 1.0, "cpu") is None
    assert roofline.mfu(989e12, 1.0, H100) == pytest.approx(100.0)
