"""The index build's inner step over a mesh (port of
``colbert_tpu.parallel.index_step``).

Each data shard encodes its slice of a token batch with its replica of the
encoder, flattens the kept token embeddings, computes its Lloyd statistics
under the current centroids (added over the shards in shard order) and
compresses its embeddings against the current centroids. Used by the
multi-device dry run (:func:`colbert_torch.graft_entry.dryrun_multichip`)
and as the template of a sharded build step.
"""

from __future__ import annotations

import torch

from colbert_torch.models.bert import BertConfig
from colbert_torch.models.colbert import DTYPES
from colbert_torch.ops import codec as codec_ops
from colbert_torch.ops import kmeans as kmeans_ops

__all__ = ["make_index_train_step"]


def make_index_train_step(mesh, cfg: BertConfig, *, nbits: int, num_partitions: int,
                          dtype_name: str = "bfloat16"):
    """-> ``step(model, input_ids (B, L), attention_mask, keep_mask,
    centroids (k, dim), bucket_cutoffs)`` returning (codes (B*L,) int32,
    packed residuals (B*L, nbytes) uint8, new centroids (k, dim), shift),
    the first two in batch order on shard 0's device. ``B`` must divide the
    data-axis size. The model is replicated per shard device (its model
    axis is not used, as in the JAX step)."""
    from colbert_torch.parallel import launch
    from colbert_torch.parallel.tp import replicate

    dtype = DTYPES[dtype_name]

    @torch.no_grad()
    def step(model, ids, mask, keep, centroids, cutoffs):
        ids_sh = launch.put_data_sharded(torch.as_tensor(ids, dtype=torch.int64), mesh)
        mask_sh = launch.put_data_sharded(torch.as_tensor(mask), mesh)
        keep_sh = launch.put_data_sharded(torch.as_tensor(keep), mesh)
        stats, out = {}, {}
        for s in ids_sh:
            dev = mesh.data_device(s)
            replica = replicate(model, dev)
            cents, cuts = centroids.to(dev), cutoffs.to(dev)
            hidden = replica.bert(ids_sh[s], mask_sh[s], dtype)
            emb = torch.matmul(hidden.float(), replica.linear.weight.float().t())
            if replica.linear.bias is not None:
                emb = emb + replica.linear.bias
            emb = emb * keep_sh[s][..., None].to(emb.dtype)
            emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True),
                                    min=1e-12)
            Bl, L, dim = emb.shape
            flat = emb.reshape(Bl * L, dim)
            w = keep_sh[s].reshape(Bl * L).to(torch.float32)
            bsize = max(128, Bl * L)
            sums, counts = kmeans_ops.lloyd_stats(flat, cents, k=num_partitions,
                                                  bsize=bsize, weights=w)
            stats[s] = torch.cat([sums, counts[:, None]], dim=1)
            codes = codec_ops.compress_into_codes(flat, cents, bsize=bsize)
            res = codec_ops.compress_residuals(flat, cents[codes.long()], cuts, nbits=nbits)
            out[s] = (codes, res)
        total, dev = launch.sum_shards(stats, mesh)
        old = centroids.to(dev)
        new = kmeans_ops.centroids_from_stats(total[:, :-1], total[:, -1], old)
        shift = float((new - old.float()).abs().max())
        codes_g, _ = launch.gather_shards({s: c for s, (c, _) in out.items()}, mesh)
        res_g, _ = launch.gather_shards({s: r for s, (_, r) in out.items()}, mesh)
        return torch.cat(codes_g), torch.cat(res_g), new, shift

    return step
