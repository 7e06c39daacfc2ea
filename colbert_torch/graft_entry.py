"""Driver hooks (counterpart of the JAX package's ``__graft_entry__.py``):

- :func:`entry`: one forward step of the flagship model, a bert-base
  ColBERT doc encode, as a function and its arguments;
- :func:`dryrun_multichip`: the sharded index-build step, the sharded
  exhaustive scorer, the sharded index against the single-device one, the
  tensor-parallel encode and a dp x tp training step over an n-device
  mesh, on tiny shapes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from colbert_torch.models.bert import BertConfig
from colbert_torch.models.colbert import ColBERT, init_colbert
from colbert_torch.utils.build import resolve_device

__all__ = ["entry", "dryrun_multichip"]


def entry(*, device: str | torch.device = "cuda", bert_config: BertConfig | None = None,
          dtype: str = "bfloat16"):
    """-> (fn, args): ``fn(*args)`` encodes B=8 documents of L=128 tokens
    (ids and keep mask drawn from ``np.random.default_rng(0)`` as in the
    JAX hook; every position attended) with a ColBERT (dim 128) at
    ``bert_config`` (default bert-base) whose random weights come from
    ``torch.Generator().manual_seed(0)``, activations in ``dtype``,
    under ``torch.no_grad``. ``args`` is (model, ids, mask, keep) on
    ``device``."""
    from colbert_torch.utils.testing import bench_bert_config

    dev = resolve_device(device)
    cfg = bert_config or bench_bert_config()
    model = init_colbert(cfg, 128, generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    rng = np.random.default_rng(0)
    B, L = 8, 128
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L))).to(dev)
    mask = torch.ones((B, L), dtype=torch.bool, device=dev)
    keep = torch.from_numpy(rng.random((B, L)) > 0.1).to(dev)
    fn = torch.no_grad()(functools.partial(ColBERT.encode_batch, dtype_name=dtype))
    return fn, (model, ids, mask, keep)


def dryrun_multichip(n_devices: int, *, device: str | torch.device = "cuda") -> str:
    """Run the sharded programs once over an ``n_devices`` mesh on tiny
    shapes (BERT of 2 layers at width 64, dim 32, nbits 2, 16 centroids)
    and check them -> the summary line (also printed):

    - the index-build step (DP encode, Lloyd statistics summed over the
      shards, compression) gives codes, residuals and centroids of the
      expected shapes and a finite shift;
    - the sharded exhaustive scorer returns finite top-3 scores;
    - a :class:`ShardedDeviceIndex` over the step's artifacts returns the
      single-device :class:`DeviceIndex`'s top-k (exhaustive probing) up
      to ties, scores within 1e-4;
    - with ``n_devices >= 2``, the tensor-parallel encode over a
      ``(n/2, 2)`` mesh equals the single-device fp32 encode within 1e-4;
      then one training step over that mesh (``torch.optim.Adam(lr=1e-3)``,
      fp32, ``n_devices`` triples of the tiny tensors, as the JAX hook's)
      has a finite loss and moves some parameter, and equals the same step
      on one device: loss 1e-5 relative, each gradient within 1e-4 x its
      max |g| + 1e-7, each updated parameter within 1e-5 (entries whose
      one-device gradient is nonzero and below 1e-6, where Adam's first
      update lr * g / (|g| + 1e-8) follows the gradient's rounding, within
      the lr).

    With fewer cards than ``n_devices`` the mesh repeats the first card
    (on ``device="cpu"``: the CPU), so every shard still runs."""
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.parallel.index_step import make_index_train_step
    from colbert_torch.parallel.mesh import make_mesh
    from colbert_torch.parallel.search_dist import score_full_sharded_topk
    from colbert_torch.parallel.sharded_index import ShardedDeviceIndex
    from colbert_torch.retrieval.device_index import DeviceIndex
    from colbert_torch.utils.testing import make_encoder

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    devices = ([torch.device("cuda", i) for i in range(n_devices)] if cards >= n_devices
               else [dev] * n_devices)
    mesh = make_mesh(n_devices, 1, devices=devices)
    cfg = BertConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=64)
    dim, nbits, k = 32, 2, 16
    model = init_colbert(cfg, dim, generator=torch.Generator().manual_seed(0)).to(dev).eval()

    rng = np.random.default_rng(0)
    B, L = 2 * n_devices, 16
    ids = rng.integers(0, 256, (B, L))
    mask = np.ones((B, L), bool)
    keep = rng.random((B, L)) > 0.2
    centroids = torch.as_tensor(rng.standard_normal((k, dim)), dtype=torch.float32).to(dev)
    cutoffs = torch.as_tensor(np.sort(rng.standard_normal(3)), dtype=torch.float32).to(dev)
    weights = torch.as_tensor(np.sort(rng.standard_normal(4)), dtype=torch.float32).to(dev)

    step = make_index_train_step(mesh, cfg, nbits=nbits, num_partitions=k)
    codes, residuals, new_centroids, shift = step(model, ids, mask, keep, centroids, cutoffs)
    _check(tuple(codes.shape) == (B * L,), f"codes {tuple(codes.shape)}")
    _check(tuple(residuals.shape) == (B * L, dim // 8 * nbits),
           f"residuals {tuple(residuals.shape)}")
    _check(tuple(new_centroids.shape) == (k, dim), f"centroids {tuple(new_centroids.shape)}")
    _check(np.isfinite(shift), f"shift {shift}")

    P_rows, Ld = 4 * n_devices, 8
    codes_g = codes.cpu().numpy().view(np.uint32)[:P_rows * Ld].reshape(P_rows, Ld)
    res_g = residuals.cpu().numpy()[:P_rows * Ld].reshape(P_rows, Ld, -1)
    Q = torch.as_tensor(rng.standard_normal((2, 4, dim)), dtype=torch.float32).to(dev)
    scores, _ = score_full_sharded_topk(Q, codes_g, res_g, np.ones((P_rows, Ld), bool),
                                        new_centroids, weights, mesh, nbits=nbits, k=3)
    _check(scores.shape == (2, 3) and bool(np.isfinite(scores).all()), f"scores {scores}")

    flat_codes = codes_g.reshape(-1)
    common = dict(centroids=new_centroids.cpu().numpy(), codes=flat_codes,
                  residuals=res_g.reshape(-1, res_g.shape[-1]),
                  doclens=np.full(P_rows, Ld, np.int64),
                  bucket_weights=weights.cpu().numpy(), nbits=nbits)
    sharded = ShardedDeviceIndex.build(mesh, balance_cap=8, **common)
    single = DeviceIndex.build(
        ivf=np.argsort(flat_codes, kind="stable").astype(np.int32),
        ivf_lengths=np.bincount(flat_codes.astype(np.int64), minlength=k),
        device=dev, **common)
    kw = dict(k=3, ncandidates=P_rows, cell_cap=P_rows * Ld, max_candidates=4 * P_rows)
    nprobe = max(sh.ivf_lengths.numel() for sh in sharded.shards.values())
    p_sh, s_sh = sharded.search_Q_batch(Q, nprobe=nprobe, **kw)
    p_1, s_1 = single.search_Q_batch(Q, nprobe=single.ivf_lengths.numel(), **kw)
    _check(np.allclose(s_sh, s_1, rtol=1e-4, atol=1e-4), f"sharded {s_sh} vs {s_1}")
    _check(bool((p_sh == p_1).all()) or np.allclose(np.sort(s_sh), np.sort(s_1),
                                                    rtol=1e-4, atol=1e-4),
           f"sharded pids {p_sh} vs {p_1}")

    tp_err = tp_loss = None
    if n_devices >= 2:
        from colbert_torch.config import ColBERTConfig

        ccfg = ColBERTConfig(dim=dim, doc_maxlen=L, activation_dtype="float32")
        enc = make_encoder(dim=dim, config=ccfg, bert_config=cfg, device=dev)
        tp_enc = ColBERTEncoder(enc.model, enc.tokenizer, ccfg, device=dev)
        tp_enc.attach_mesh(make_mesh(n_devices // 2, 2, devices=devices))
        with torch.no_grad():
            ref = enc.model.encode_batch(*enc._put_batch(ids, mask, keep),
                                         dtype_name="float32")
            out = tp_enc._shard_forward(ids, mask, keep, dtype_name="float32")[:B]
        tp_err = float((out - ref).abs().max())
        _check(tp_err <= 1e-4, f"tensor-parallel encode differs by {tp_err}")
        tp_loss = _dp_tp_train_step(tp_enc, ids, mask, keep, n_devices)

    line = (f"dryrun_multichip OK: mesh={mesh.shape} on {[str(d) for d in devices]}, "
            f"codes={tuple(codes.shape)}, shift={shift:.4f}, sharded serving top-k == "
            f"single-device top-k"
            + (f", tp encode max err={tp_err:.2e}" if tp_err is not None else "")
            + (f", dp x tp train step loss={tp_loss:.4f}" if tp_loss is not None else ""))
    print(line)
    return line


def _dp_tp_train_step(enc, ids, mask, keep, n: int) -> float:
    """One Adam step over ``enc``'s mesh on ``n`` triples (queries: the
    first 8 tokens of rows ``[0, n)``; positives those rows, negatives rows
    ``[n, 2n)``), checked against the same step on one device -> its loss."""
    import copy

    from colbert_torch.training.trainer import make_mesh_train_step, make_train_step

    one = copy.deepcopy(enc.model)
    host = {"q_ids": ids[:n, :8], "q_mask": mask[:n, :8], "pos_ids": ids[:n],
            "pos_mask": mask[:n], "pos_keep": keep[:n], "neg_ids": ids[n:2 * n],
            "neg_mask": mask[n:2 * n], "neg_keep": keep[n:2 * n]}
    before = [p.detach().clone() for p in enc.model.parameters()]
    loss = make_mesh_train_step(
        enc, torch.optim.Adam(enc.model.parameters(), lr=1e-3))(host)["loss"]
    want = make_train_step(one, torch.optim.Adam(one.parameters(), lr=1e-3),
                           dtype_name="float32")(dict(zip(host, enc._put_batch(*host.values()))))
    _check(np.isfinite(loss), f"train step loss {loss}")
    rel = abs(loss - want["loss"]) / abs(want["loss"])
    _check(rel <= 1e-5, f"train step loss {loss} vs one device {want['loss']}")
    with torch.no_grad():
        moved = max(float((p - b).abs().max()) for p, b in zip(enc.model.parameters(), before))
        _check(moved > 0, "training step did not update any parameter")
        for (name, p), q in zip(enc.model.named_parameters(), one.parameters()):
            g = q.grad.abs()
            grad_err = float((p.grad - q.grad).abs().max())
            _check(grad_err <= 1e-4 * float(g.max()) + 1e-7, f"train step gradient {name}")
            apart = (g < 1e-6) & (g != 0)
            diff = (p - q).abs()
            _check(bool((diff[~apart] <= 1e-5).all() and (diff[apart] <= 1e-3).all()),
                   f"train step parameter {name} differs by {float(diff.max())}")
    return loss


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")
