"""Worker of tests/test_torch_multihost.py: one process of a two-process
gloo cluster whose 4-shard CPU mesh gives it 2 shards. It streams only its
own shards' rows from disk, runs the sharded search, the sharded k-means and
the sharded quantiles over the whole mesh, and checks each against the
single-process results the parent saved, bit for bit; then one training
step over the mesh, whose loss and parameters it holds to the parent's
within 1e-6. Not a pytest module."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def train_encoder():
    """The tiny fp32 encoder both sides train, from seed 0, on the CPU."""
    from colbert_torch.config import ColBERTConfig
    from colbert_torch.utils.testing import make_encoder

    return make_encoder(dim=32, seed=0, device="cpu", config=ColBERTConfig(
        dim=32, doc_maxlen=64, query_maxlen=16, activation_dtype="float32"))


def main() -> None:
    idx_path, expected_npz = sys.argv[1], sys.argv[2]
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from colbert_torch.ops.quantile import sharded_quantiles
    from colbert_torch.parallel import launch
    from colbert_torch.parallel.kmeans_dist import kmeans_sharded
    from colbert_torch.parallel.mesh import make_mesh
    from colbert_torch.parallel.sharded_index import ShardedDeviceIndex
    from colbert_torch.storage import format as fmt

    launch.initialize(backend="gloo")  # COLBERT_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID
    me = launch.process_index()
    assert launch.process_count() == 2, launch.process_count()
    exp = np.load(expected_npz)
    mesh = make_mesh(4, 1, device="cpu")
    assert launch.owned_data_shards(mesh) == [2 * me, 2 * me + 1]

    reads = []
    read = fmt.read_embedding_rows

    def recording(path, lo, hi):
        reads.append((lo, hi))
        return read(path, lo, hi)

    fmt.read_embedding_rows = recording
    codec = fmt.load_codec(idx_path)
    sharded = ShardedDeviceIndex.build(
        mesh, centroids=codec["centroids"], stream_from=idx_path,
        doclens=np.asarray(fmt.load_all_doclens(idx_path), np.int64),
        bucket_weights=codec["bucket_weights"], nbits=2, balance_cap=64)
    fmt.read_embedding_rows = read
    assert sorted(sharded.shards) == [2 * me, 2 * me + 1]
    np.testing.assert_array_equal(reads, exp["reads"][2 * me:2 * me + 2])
    assert sharded.max_cell_length == int(exp["widths"][0])
    assert sharded.probe_dup_max == int(exp["widths"][1])
    pids, scores = sharded.search_Q_batch(
        torch.from_numpy(exp["Q"]), k=5, nprobe=4, ncandidates=256, cell_cap=128,
        max_candidates=1024)
    np.testing.assert_array_equal(pids, exp["pids"])
    np.testing.assert_array_equal(scores, exp["scores"])

    res = kmeans_sharded(exp["kmeans_data"], 16, mesh, niters=4,
                         init_idx=exp["kmeans_init"])
    np.testing.assert_array_equal(res.centroids.numpy(), exp["kmeans_centroids"])
    np.testing.assert_array_equal(res.assignments.numpy(), exp["kmeans_assignments"])

    values, mean_abs = sharded_quantiles(torch.from_numpy(exp["kmeans_data"]),
                                         [0.25, 0.5, 0.75], mesh)
    np.testing.assert_array_equal(values.numpy(), exp["quantiles"])
    assert float(mean_abs) == float(exp["mean_abs"])

    from colbert_torch.training import ColBERTTrainer

    enc = train_encoder()
    enc.attach_mesh(mesh)  # spans both processes: it trains, it does not encode
    try:
        enc.encode_queries(["a query"])
        raise AssertionError("a mesh encode across processes did not raise")
    except ValueError as e:
        assert "every data shard" in str(e), e
    triples = [tuple(t) for t in exp["train_triples"]]
    loss = ColBERTTrainer(enc, learning_rate=1e-3).train_step(triples)["loss"]
    np.testing.assert_allclose(loss, float(exp["train_loss"]), rtol=1e-6)
    worst = 0.0
    for k, v in enc.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), exp[f"train_param.{k}"], rtol=0, atol=1e-6,
                                   err_msg=k)
        worst = max(worst, float(np.abs(v.numpy() - exp[f"train_param.{k}"]).max()))
    print(f"train step: loss {loss!r} vs {float(exp['train_loss'])!r}, max |param diff| "
          f"{worst:.3e}", flush=True)

    torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK p{me}", flush=True)


if __name__ == "__main__":
    main()
