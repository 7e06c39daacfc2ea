"""Work counts and published peaks: the yardstick of every roofline share
and MFU the benchmark reports.

Every count is of the work that a call's inputs need, each operation and
each byte counted once, whatever an implementation does more:

- stage 2 (decompress + MaxSim of the stage-2 candidates): ``2 * Lq * dim``
  FLOPs per (query token, valid candidate token) pair; bytes: the queries,
  each valid token's code and packed residual, the centroid rows those
  tokens can name (at most K), the bucket weights, each candidate's offset
  and doclen, and one fp32 score per candidate;
- refine (centroid-only MaxSim of the refine window): the fewer FLOPs of
  its two formulations, a per-query table over all K centroids
  (``2 * Lq * dim * K``) or a product per (query token, valid candidate
  token) (``2 * Lq * dim`` each), plus one max per pair; bytes as for stage
  2 without residuals and bucket weights;
- model FLOPs of a BERT encode: per token and layer the q, k, v and output
  projections (``4 h^2`` MACs) and the MLP (``2 h f``), the two attention
  products against the keys the token attends to (``2 S h``), and the
  linear head (``h * dim``); 2 FLOPs a MAC.

The time bound of a kernel is the larger of FLOPs over the fastest dense
float rate of the card and bytes over its memory bandwidth; the share is
that bound over the measured time, and names which of the two bound it.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense, at the 700 W limit: bf16/fp16 tensor
# rate (the fastest dense rate of any float product) and HBM3 bandwidth
PEAKS = {"NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes": 3.35e12}}


def peak(card: str) -> dict | None:
    return PEAKS.get(card)


def encoder_flops(bert: dict, dim: int, tokens: int, keys_per_token: float) -> float:
    """Forward FLOPs of ``tokens`` positions, each attending to
    ``keys_per_token`` keys on average."""
    h, f, L = bert["hidden_size"], bert["intermediate_size"], bert["num_hidden_layers"]
    per_token = L * (2 * (4 * h * h + 2 * h * f) + 4 * keys_per_token * h) + 2 * h * dim
    return tokens * per_token


def probe_flops(Lq: int, dim: int, K: int, queries: int) -> float:
    return 2.0 * Lq * dim * K * queries


def stage2_work(Lq: int, dim: int, nbits: int, K: int, queries: int, passages: float,
                tokens: float) -> tuple[float, float]:
    """-> (FLOPs, bytes) of stage 2 over ``queries`` queries holding
    ``passages`` candidates of ``tokens`` valid tokens in all."""
    flops = 2.0 * Lq * dim * tokens
    nbytes = (queries * Lq * dim * 4 + tokens * (4 + dim * nbits / 8)
              + min(K, tokens) * dim * 4 + (2 ** nbits) * 4 + passages * (8 + 4 + 4))
    return flops, nbytes


def refine_work(Lq: int, dim: int, K: int, queries: int, passages: float,
                tokens: float) -> tuple[float, float]:
    """-> (FLOPs, bytes) of the refine, as :func:`stage2_work`."""
    flops = min(2.0 * Lq * dim * K * queries, 2.0 * Lq * dim * tokens) + Lq * tokens
    nbytes = (queries * Lq * dim * 4 + tokens * 4 + min(K, tokens) * dim * 4
              + passages * (8 + 4 + 4))
    return flops, nbytes


def share(flops: float, nbytes: float, seconds: float, card: str) -> tuple[float, str] | None:
    """-> (percent of the roofline, "flops" or "bytes": what bound it), or
    None for a card with no published peak or no measured time."""
    p = peak(card)
    if p is None or not seconds > 0:
        return None
    t_flops, t_bytes = flops / p["flops"], nbytes / p["bytes"]
    bound = max(t_flops, t_bytes)
    return 100.0 * bound / seconds, "flops" if t_flops >= t_bytes else "bytes"


def mfu(flops: float, seconds: float, card: str) -> float | None:
    """Percent of the card's peak FLOP rate."""
    p = peak(card)
    if p is None or not seconds > 0:
        return None
    return 100.0 * flops / seconds / p["flops"]
