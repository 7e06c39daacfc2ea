"""The build driver's check: the index the window built last, held against
the plain reference.

The reference builds its own codec as ColBERT's indexer does: the
planner's sample of passages, encoded again by the configuration's
architecture's reference (fp32, TF32 off), a heldout split and initial
rows drawn from the seed, k-means and the residuals' quantiles
(:mod:`benchmark.reference.codec`). It takes nothing from the index but
what it judges. Compared:

- ``kmeans_gap``: how much larger k-means' objective (the mean squared
  distance of the reference's sample embeddings to their nearest centroid)
  is under the index's centroids than under the reference's, as a share of
  the latter;
- ``cutoff_gap``: the largest gap between the index's residual bucket
  cutoffs and the reference's, over the reference's mean absolute residual;
- ``doclen_errors``: checked passages whose stored doclen differs from the
  reference's count of kept tokens (exact: limit 0);
- ``ivf_errors``: IVF entries and cell lengths that differ from a stable
  grouping of the stored codes by code, and cells more or fewer than the
  reference's partitions (exact: limit 0);
- ``code_miss_share``: the share of the checked passages' embeddings whose
  stored code is not the index centroid of largest inner product with the
  reference embedding;
- ``bucket_miss_share``: over the embeddings whose codes agree, the share
  of dimensions whose stored residual bucket differs from the bucket of
  the reference residual under the index's cutoffs (the count of cutoffs
  strictly below it).

The checked passages are a seeded sample of the codec's sample; every
passage of a collection larger than the sample is encoded and compressed
again by the build's chunk pass, so they are the chunk pass's output.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from benchmark.gen.vocab import make_vocab
from benchmark.reference import codec as ref_codec
from benchmark.reference.tokenize import tensorize_docs


def read_index(path: str) -> dict:
    """The index files, read with numpy alone."""
    def load(name):
        return np.load(os.path.join(path, name))

    with open(os.path.join(path, "plan.json")) as f:
        plan = json.load(f)
    n = plan["num_chunks"]
    return {"plan": plan, "centroids": load("centroids.npy"),
            "cutoffs": load("bucket_cutoffs.npy"),
            "codes": np.concatenate([load(f"{i}.codes.npy") for i in range(n)]),
            "residuals": np.concatenate([load(f"{i}.residuals.npy") for i in range(n)]),
            "doclens": np.concatenate([load(f"doclens.{i}.npy") for i in range(n)]),
            "ivf": load("ivf.npy"), "ivf_lengths": load("ivf_lengths.npy")}


def buckets(packed: np.ndarray, nbits: int) -> np.ndarray:
    """Packed residual bytes (n, nbytes) -> bucket indices (n, dim): dim
    ``d`` is bits ``d*nbits ..`` of the bytes, least significant first."""
    per_byte = 8 // nbits
    shifts = np.arange(per_byte) * nbits
    return ((packed[..., None].astype(np.int64) >> shifts) & ((1 << nbits) - 1)).reshape(
        packed.shape[0], -1)


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the reference's products."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


@torch.no_grad()
def reference_embeddings(r, texts: list[str], precision: str = "float32",
                         batch: int = 128) -> list[torch.Tensor]:
    """Each passage's kept-token embeddings (fp32 unit rows) by run ``r``'s
    architecture, in token order; encoded in batches of passages of like
    word counts."""
    cfg, device = r.config, r.device
    with exact_fp32():
        w = r.arch.make_weights(r.seed, r.widths, cfg["dim"], device)
        vocab = make_vocab(r.arch.vocab_size(r.widths))
        order = np.argsort([t.count(" ") for t in texts], kind="stable")
        out = [None] * len(texts)
        for s in range(0, len(texts), batch):
            pick = order[s:s + batch]
            ids, mask, keep = tensorize_docs([texts[i] for i in pick], vocab, cfg["doc_maxlen"])
            t = [torch.from_numpy(a).to(device) for a in (ids, mask, keep)]
            emb = r.arch.encode(w, r.widths, *t, precision=precision)
            for i, e, k in zip(pick, emb, t[2]):
                out[i] = e[k]
        return out


@torch.no_grad()
def reference_codec(r, passages: list[str], precision: str = "float32",
                    stream: int = 7) -> dict:
    """Run ``r``'s reference codec for ``passages``: its sample's embeddings
    at ``precision`` (``"fp8"`` is the control) flattened in passage order
    (``flat``, with each sampled passage's ``offsets``), the centroids, the
    cutoffs and the mean absolute residual. The heldout split and the
    initial rows are drawn from ``[seed, stream]``."""
    cfg, seed = r.config, r.seed
    pids = ref_codec.sample_pids(len(passages), np.random.default_rng(0))
    embs = reference_embeddings(r, [passages[p] for p in pids], precision)
    offsets = np.concatenate([[0], np.cumsum([len(e) for e in embs])])
    flat = torch.cat(embs)
    del embs
    with exact_fp32():
        rng = np.random.default_rng([seed, stream])
        perm = torch.as_tensor(rng.permutation(len(flat)), device=flat.device)
        held = ref_codec.num_heldout(len(flat))
        k = ref_codec.num_partitions(len(passages), len(flat) / len(pids), len(flat) - held)
        init = rng.choice(len(flat) - held, size=k, replace=False)
        train = flat[perm[held:]]
        C, cut, _, avg = ref_codec.train(train, torch.ones(len(train), device=flat.device),
                                         flat[perm[:held]], init,
                                         niters=cfg["indexing"]["kmeans_niters"],
                                         nbits=cfg["nbits"])
    return {"pids": pids, "offsets": offsets, "flat": flat, "centroids": C, "cutoffs": cut,
            "avg_residual": avg}


@torch.no_grad()
def codec_readings(centroids: np.ndarray, cutoffs: np.ndarray, ref: dict) -> dict:
    """``kmeans_gap`` and ``cutoff_gap`` of a codec against the reference's."""
    with exact_fp32():
        C = torch.from_numpy(centroids).to(ref["flat"].device).float()
        j_ref = ref_codec.objective(ref["flat"], ref["centroids"])
        gap = (ref_codec.objective(ref["flat"], C) - j_ref) / j_ref
    cut_ref = ref["cutoffs"].cpu().numpy().astype(np.float64)
    cut = np.asarray(cutoffs, np.float64)
    cutoff_gap = (float(np.abs(cut - cut_ref).max()) / ref["avg_residual"]
                  if cut.shape == cut_ref.shape else float("inf"))
    return {"kmeans_gap": gap, "cutoff_gap": cutoff_gap}


def readings(ix: dict, pids: np.ndarray, embs: list[torch.Tensor], nbits: int,
             partitions: int) -> dict:
    """The numbers compared under the index's own codec: stored index ``ix``
    against reference embeddings ``embs`` of passages ``pids``, and the
    reference's count of ``partitions``."""
    dl = ix["doclens"].astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(dl)])
    order = np.argsort(ix["codes"], kind="stable")
    lengths = np.bincount(ix["codes"], minlength=len(ix["centroids"]))
    ivf_errors = (int((ix["ivf"] != order).sum()) + int((ix["ivf_lengths"] != lengths).sum())
                  if len(ix["ivf"]) == len(order) else len(order))
    ivf_errors += abs(len(ix["ivf_lengths"]) - partitions)
    dev = embs[0].device if embs else "cpu"
    C = torch.from_numpy(ix["centroids"]).to(dev).float()
    cut = torch.from_numpy(ix["cutoffs"]).to(dev).float()
    doclen_errors = codes_total = codes_missed = dims_total = dims_missed = 0
    for pid, e in zip(pids, embs):
        if dl[pid] != len(e):
            doclen_errors += 1
            continue
        rows = slice(offsets[pid], offsets[pid + 1])
        stored = torch.from_numpy(ix["codes"][rows].astype(np.int64)).to(dev)
        ref = (e @ C.T).argmax(dim=1)
        same = ref == stored
        codes_total += len(e)
        codes_missed += int((~same).sum())
        res = e[same] - C[stored[same]]
        b_ref = (res[..., None] > cut).sum(-1).cpu().numpy()
        b_got = buckets(ix["residuals"][rows][same.cpu().numpy()], nbits)
        dims_total += b_ref.size
        dims_missed += int((b_ref != b_got).sum())
    return {"doclen_errors": doclen_errors, "ivf_errors": ivf_errors,
            "code_miss_share": codes_missed / max(1, codes_total),
            "bucket_miss_share": dims_missed / max(1, dims_total), "failed": 0}


def pack(idx: np.ndarray, nbits: int) -> np.ndarray:
    """Inverse of :func:`buckets`."""
    per_byte = 8 // nbits
    shifts = np.arange(per_byte) * nbits
    return (idx.reshape(idx.shape[0], -1, per_byte).astype(np.int64) << shifts).sum(-1).astype(
        np.uint8)


def compressed_by(ix: dict, pids: np.ndarray, embs: list[torch.Tensor], nbits: int) -> dict:
    """A copy of ``ix`` whose sampled passages hold the codes and residuals
    that ``embs`` give under the index's own centroids and cutoffs, and the
    IVF of those codes."""
    out = dict(ix, codes=ix["codes"].copy(), residuals=ix["residuals"].copy())
    offsets = np.concatenate([[0], np.cumsum(ix["doclens"].astype(np.int64))])
    C = torch.from_numpy(ix["centroids"]).to(embs[0].device).float()
    cut = torch.from_numpy(ix["cutoffs"]).to(C.device).float()
    for pid, e in zip(pids, embs):
        rows = slice(offsets[pid], offsets[pid] + len(e))
        code = (e @ C.T).argmax(dim=1)
        out["codes"][rows] = code.cpu().numpy()
        out["residuals"][rows] = pack(((e - C[code])[..., None] > cut).sum(-1).cpu().numpy(),
                                      nbits)
    out["ivf"] = np.argsort(out["codes"], kind="stable")
    out["ivf_lengths"] = np.bincount(out["codes"], minlength=len(ix["centroids"]))
    return out


def judge(r, path: str, passages: list[str], control: bool = False
          ) -> tuple[dict, dict | None]:
    """-> (the readings of the index under ``path``, and with ``control``
    the control's: the reference put in the program's place with its
    encoder in fp8, its codec trained from those embeddings and the checked
    passages compressed under it)."""
    with exact_fp32():
        return _judge(r, path, passages, control)


def _judge(r, path, passages, control):
    t = time.perf_counter()
    ix = read_index(path)
    if len(ix["doclens"]) != len(passages):
        return {"kmeans_gap": 1.0, "cutoff_gap": 1.0,
                "doclen_errors": abs(len(ix["doclens"]) - len(passages)), "ivf_errors": 0,
                "code_miss_share": 1.0, "bucket_miss_share": 1.0, "failed": len(passages)}, None
    ref = reference_codec(r, passages)
    nbits, k = r.config["nbits"], len(ref["centroids"])
    rng = np.random.default_rng([r.seed, 6])
    pos = np.sort(rng.choice(len(ref["pids"]), size=min(r.cell["check_passages"],
                                                        len(ref["pids"])), replace=False))

    def rows(codec, i):
        return codec["flat"][codec["offsets"][i]:codec["offsets"][i + 1]]

    pids, embs = ref["pids"][pos], [rows(ref, i) for i in pos]
    found = {**codec_readings(ix["centroids"], ix["cutoffs"], ref),
             **readings(ix, pids, embs, nbits, k)}
    r.notes["reference_s"] = time.perf_counter() - t
    if not control:
        return found, None
    # its own initial rows, as a program's are its own
    ctl = reference_codec(r, passages, "fp8", stream=8)
    ctl_ix = compressed_by(dict(ix, centroids=ctl["centroids"].cpu().numpy(),
                                cutoffs=ctl["cutoffs"].cpu().numpy()),
                           pids, [rows(ctl, i) for i in pos], nbits)
    return found, {**codec_readings(ctl_ix["centroids"], ctl_ix["cutoffs"], ref),
                   **readings(ctl_ix, pids, embs, nbits, k)}
