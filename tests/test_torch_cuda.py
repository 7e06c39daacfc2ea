"""Tests that need an NVIDIA GPU: the stage-2 CUDA kernels vs their plain
PyTorch version (TF32 off, tolerance 1e-4) on the cases of the CPU parity
tests, each case through the kernel its shapes select (tensor-core ``mma``
for dim 128 and Lq <= 32, ``simt`` otherwise); the flash-attention kernel vs its plain version (fp32 inputs to
1e-4; bf16 inputs within 8e-3 * max(1, |plain|), one bf16 rounding step of
the output, against the plain version on the fp32 upcast of the same
inputs), each case through the kernel its dtype and head dim select
(tensor-core ``mma`` for bf16/fp16 at hd 32/64/128, ``simt`` otherwise);
the device and alignment rules of the wrappers; and the life of a live index
on the card against the port on the CPU: ``IndexUpdater.add`` (codes equal up
to near-ties), the exact oracle (within 1e-4) and a ``BatchingSearcher``
whose loop thread launches and finishes the searches (the same pids and
scores as direct ``search_batch`` of the same batches); and the
``searching`` and ``evaluate`` entry points at their default device, every
stage-2 launch through the ``mma`` kernel; a 4-shard sharded index on one
card (one ``mma`` stage-2 launch per shard, equal to the CPU's up to ties)
and a tensor-parallel encode over two model shards (flash per shard, cosine
0.999 in bf16, 1e-4 in fp32); a 2-layer fp32 training step over a DP and
a dp x tp mesh of the card repeated against the one-device step (loss
1e-5 relative, gradients within 1e-4 x their max + 1e-7). Every test skips
without a GPU. This file imports no JAX; on a machine without JAX run it as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from colbert_torch.ops import flash_attention as fa
from colbert_torch.ops import fused_maxsim as fm

from _torch_stage2_cases import CASES, port_args, stage2_case

TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nbits,word,Lq,Ld,zeros",
                         CASES + [(8, "uint32", 32, 160, True), (2, "uint32", 45, 160, True),
                                  (8, "uint8", 32, 48, "last"), (1, "uint32", 32, 160, "full")])
def test_kernel_matches_plain(cuda_device, nbits, word, Lq, Ld, zeros):
    x = stage2_case(nbits * 7 + Lq, nbits, word, Lq, Ld, zeros, NC=300, K=500,
                    n_tokens=20_000)
    args, kw = port_args(x, cuda_device)
    variant = fm._variant(Lq, 128)
    before = fm.stage2_maxsim.launches
    by_variant = dict(fm.stage2_maxsim.variant_launches)
    got = fm.stage2_maxsim(*args, **kw)
    want = fm.stage2_maxsim_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fm.stage2_maxsim.launches == before + 1
    by_variant[variant] += 1
    assert fm.stage2_maxsim.variant_launches == by_variant
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=TOL, rtol=0)
    assert (got.cpu().numpy()[x["dls"] == 0] == 0).all()


@pytest.mark.cuda
def test_stage2_routes_by_shape_and_never_retries(cuda_device):
    # past the mma kernel's limits (Lq > 32, dim != 128): the simt kernel
    for Lq, dim in ((33, 128), (8, 64)):
        x = stage2_case(Lq + dim, 2, "uint32", Lq, 40, True, dim=dim, NC=64, K=100,
                        n_tokens=5_000)
        args, kw = port_args(x, cuda_device)
        by_variant = dict(fm.stage2_maxsim.variant_launches)
        got = fm.stage2_maxsim(*args, **kw)
        want = fm.stage2_maxsim_plain(*args, **kw)
        torch.cuda.synchronize()
        by_variant["simt"] += 1
        assert fm.stage2_maxsim.variant_launches == by_variant
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=TOL, rtol=0)
    # byte residuals one byte past 4-byte alignment: the mma kernel refuses
    # them and nothing runs the simt kernel in its place
    x = stage2_case(5, 2, "uint8", 32, 40, False, NC=64, K=100, n_tokens=5_000)
    args, kw = port_args(x, cuda_device)
    res = args[4]
    flat = torch.zeros(res.numel() + 1, dtype=res.dtype, device=cuda_device)
    shifted = flat[1:]
    shifted.copy_(res)
    before = fm.stage2_maxsim.launches
    by_variant = dict(fm.stage2_maxsim.variant_launches)
    with pytest.raises(ValueError, match="aligned"):
        fm.stage2_maxsim(*args[:4], shifted, *args[5:], **kw)
    assert fm.stage2_maxsim.launches == before
    assert fm.stage2_maxsim.variant_launches == by_variant


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices(cuda_device):
    x = stage2_case(0, 2, "uint32", 8, 16, False)
    args, kw = port_args(x, cuda_device)
    with pytest.raises(ValueError, match="cpu"):
        fm.stage2_maxsim(args[0], args[1].cpu(), *args[2:], **kw)


@pytest.mark.cuda
def test_device_index_search_runs_the_kernel(cuda_device, tmp_path):
    from colbert_torch.retrieval.device_index import DeviceIndex
    from colbert_torch.storage import format as fmt
    from colbert_torch.utils.testing import synthesize_index

    path = str(tmp_path / "idx")
    synthesize_index(path, 500, dim=128, nbits=2, avg_doclen=40, seed=1)
    codec = fmt.load_codec(path)
    ivf, ivf_lengths = fmt.load_ivf(path)
    kw = dict(centroids=codec["centroids"], ivf=ivf, ivf_lengths=ivf_lengths,
              doclens=np.asarray(fmt.load_all_doclens(path), np.int64),
              bucket_weights=codec["bucket_weights"], nbits=2, stream_from=path)
    gpu = DeviceIndex.build(device="cuda", **kw)
    cpu = DeviceIndex.build(device="cpu", **kw)
    Q = torch.nn.functional.normalize(
        torch.randn(4, 32, 128, generator=torch.Generator().manual_seed(0)), dim=-1)
    search = dict(k=10, nprobe=2, ncandidates=512, cell_cap=64, max_candidates=512,
                  stage1_refine=False)
    before = fm.stage2_maxsim.launches
    mma = fm.stage2_maxsim.variant_launches["mma"]
    pg, sg = gpu.search_Q_batch(Q, **search)
    assert fm.stage2_maxsim.launches == before + 1
    assert fm.stage2_maxsim.variant_launches["mma"] == mma + 1
    pc, sc = cpu.search_Q_batch(Q, **search)
    np.testing.assert_allclose(sg, sc, atol=TOL, rtol=0)


def _flash_case(seed, B, H, S, hd, dtype, device):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B * H, S, hd)).astype(np.float32))
               .to(device, dtype) for _ in range(3))
    mask = np.ones((B, S), bool)
    mask[1, S // 2:] = False
    if S > 128:
        mask[0, S - 128:] = False
    bias = np.where(mask, 0.0, np.finfo(np.float32).min).astype(np.float32)
    return q, k, v, torch.from_numpy(bias).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd,dtype", [
    (2, 3, 128, 32, torch.float32), (2, 3, 256, 32, torch.float32),
    (4, 12, 512, 64, torch.float32), (4, 12, 512, 64, torch.bfloat16),
    (2, 2, 256, 8, torch.float32), (2, 2, 256, 128, torch.bfloat16),
    (2, 3, 128, 32, torch.bfloat16), (2, 3, 256, 64, torch.bfloat16),
    (2, 2, 512, 128, torch.bfloat16), (2, 3, 128, 64, torch.float16),
    (2, 3, 512, 32, torch.float16), (2, 2, 256, 128, torch.float16),
    (2, 2, 128, 40, torch.bfloat16), (2, 2, 256, 96, torch.float16),
])
def test_flash_kernel_matches_plain(cuda_device, B, H, S, hd, dtype):
    q, k, v, bias = _flash_case(S + hd, B, H, S, hd, dtype, cuda_device)
    variant = fa._variant(dtype, hd)
    before = fa.flash_attention.launches
    by_variant = dict(fa.flash_attention.variant_launches)
    got = fa.flash_attention(q, k, v, bias, num_heads=H)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, num_heads=H)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    by_variant[variant] += 1
    assert fa.flash_attention.variant_launches == by_variant
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= TOL
    else:
        assert bool((err <= 8e-3 * want.abs().clamp(min=1.0)).all())


@pytest.mark.cuda
def test_flash_bsh_reads_the_same_kernel(cuda_device):
    B, H, S, hd = 2, 3, 256, 32
    q, k, v, bias = _flash_case(1, B, H, S, hd, torch.float32, cuda_device)

    def to_bsh(x):
        return x.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd).contiguous()

    before = fa.flash_attention.launches
    got = fa.flash_attention_bsh(to_bsh(q), to_bsh(k), to_bsh(v), bias, num_heads=H)
    want = to_bsh(fa.flash_attention(q, k, v, bias, num_heads=H))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_attention(q[:, :100], k[:, :100], v[:, :100], bias[:, :100], num_heads=H)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bsh_takes_the_mma_kernel(cuda_device, dtype):
    B, H, S, hd = 2, 3, 256, 64
    q, k, v, bias = _flash_case(2, B, H, S, hd, dtype, cuda_device)

    def to_bsh(x):
        return x.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd).contiguous()

    mma = fa.flash_attention.variant_launches["mma"]
    got = fa.flash_attention_bsh(to_bsh(q), to_bsh(k), to_bsh(v), bias, num_heads=H)
    want = to_bsh(fa.flash_attention(q, k, v, bias, num_heads=H))
    torch.cuda.synchronize()
    assert fa.flash_attention.variant_launches["mma"] == mma + 2
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_mma_rejects_misaligned_inputs(cuda_device):
    B, H, S, hd = 2, 3, 128, 64
    q, k, v, bias = _flash_case(3, B, H, S, hd, torch.bfloat16, cuda_device)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    shifted = flat[1:].view(q.shape)  # contiguous, but 2 bytes past 16-byte alignment
    shifted.copy_(q)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(shifted, k, v, bias, num_heads=H)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(q, k, shifted, bias, num_heads=H)
    assert fa.flash_attention.launches == before


# -- the life of a live index on the card --------------------------------------


def _live_index(tmp_path, n=300):
    from colbert_torch.config import ColBERTConfig
    from colbert_torch.utils.testing import make_encoder, synthesize_index

    path = str(tmp_path / "idx")
    synthesize_index(path, n, dim=128, nbits=2, avg_doclen=40, chunksize=128, seed=3)
    cfg = ColBERTConfig(dim=128, nbits=2, doc_maxlen=64, query_maxlen=32, index_bsize=16,
                        length_bucket=16, activation_dtype="float32")
    return path, lambda device: make_encoder(dim=128, seed=0, config=cfg, device=device)


@pytest.mark.cuda
def test_updater_add_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    import shutil

    from colbert_torch.indexing.updater import IndexUpdater
    from colbert_torch.storage import format as fmt
    from colbert_torch.utils.testing import synthetic_collection

    path, make = _live_index(tmp_path)
    cpu_path = str(tmp_path / "cpu")
    shutil.copytree(path, cpu_path)
    passages = synthetic_collection(150, seed=4, words_per_doc=30)
    enc_gpu, enc_cpu = make(cuda_device), make("cpu")
    new_gpu = IndexUpdater(path, enc_gpu).add(passages)
    new_cpu = IndexUpdater(cpu_path, enc_cpu).add(passages)
    np.testing.assert_array_equal(new_gpu, np.arange(300, 450))
    np.testing.assert_array_equal(new_gpu, new_cpu)
    assert fmt.load_plan(path) == fmt.load_plan(cpu_path)
    np.testing.assert_array_equal(fmt.load_all_doclens(path), fmt.load_all_doclens(cpu_path))
    codes_g, codes_c = fmt.load_all_codes(path), fmt.load_all_codes(cpu_path)
    same = codes_g == codes_c
    assert same.mean() >= 0.99
    if not same.all():  # a differing code is a near-tie of the CPU's embeddings
        flat, _ = enc_cpu.encode_passages(passages)
        n_old = int(fmt.load_all_doclens(path)[:300].sum())
        cent = fmt.load_codec(path)["centroids"]
        rows = np.nonzero(~same)[0]
        assert (rows >= n_old).all()
        e = flat[rows - n_old]
        gap = np.abs((e * (cent[codes_g[rows]] - cent[codes_c[rows]])).sum(axis=1))
        assert (gap <= 2.0 ** -6).all(), gap
    np.testing.assert_array_equal(fmt.load_ivf(path)[1].sum(), fmt.load_all_doclens(path).sum())


@pytest.mark.cuda
def test_exhaustive_scores_on_the_card_match_the_cpu(cuda_device, tmp_path):
    from colbert_torch.evaluation.oracle import exhaustive_scores
    from colbert_torch.retrieval.searcher import Searcher

    path, make = _live_index(tmp_path)
    Q = torch.nn.functional.normalize(
        torch.randn(4, 32, 128, generator=torch.Generator().manual_seed(1)), dim=-1)
    gpu = Searcher(path, encoder=make(cuda_device), device=cuda_device)
    cpu = Searcher(path, encoder=make("cpu"), device="cpu")
    got = exhaustive_scores(gpu, Q, block=100)
    want = exhaustive_scores(cpu, Q, block=100)
    assert got.shape == (4, 300)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the funnel's stage-2 (the mma kernel) scores its pids as the oracle does
    mma = fm.stage2_maxsim.variant_launches["mma"]
    pids, scores = gpu.device_index.search_Q_batch(Q, **gpu._search_kwargs(10))
    assert fm.stage2_maxsim.variant_launches["mma"] == mma + 1
    valid = pids >= 0
    np.testing.assert_allclose(scores[valid], np.take_along_axis(got, np.maximum(pids, 0), 1)[valid],
                               atol=TOL, rtol=0)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="fp32"):
            exhaustive_scores(gpu, Q)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_batcher_thread_matches_direct_search(cuda_device, tmp_path):
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.serving import BatchingSearcher
    from colbert_torch.utils.testing import synthetic_collection

    path, make = _live_index(tmp_path)
    s = Searcher(path, encoder=make(cuda_device), device=cuda_device)
    queries = synthetic_collection(40, seed=8)
    batches = []
    launch = s.launch_search

    def recording(qs, k):
        batches.append(list(qs))
        return launch(qs, k)

    s.launch_search = recording
    try:
        with torch.enable_grad(), BatchingSearcher(s, max_batch=8, max_wait_ms=5) as b:
            futs = [b.submit(q, k=5) for q in queries]
            got = {q: f.result(timeout=120) for q, f in zip(queries, futs)}
    finally:
        del s.launch_search
    assert sum(len(bt) for bt in batches) == 40 and max(len(bt) for bt in batches) <= 8
    for bt in batches:
        direct_p, direct_s = s.search_batch(bt, k=5)
        for i, q in enumerate(bt):
            np.testing.assert_array_equal(got[q][0], direct_p[i])
            np.testing.assert_array_equal(got[q][1], direct_s[i])


@pytest.mark.cuda
def test_search_and_evaluate_examples_run_the_kernel(cuda_device, tmp_path):
    """``searching.main`` and ``evaluate.main`` at their default device on
    a synthetic index, with the seeded bert-base bench encoder: every
    stage-2 launch is the tensor-core ``mma`` kernel."""
    from colbert_torch.examples import evaluate, searching
    from colbert_torch.utils.testing import synthesize_index, synthetic_queries

    path = str(tmp_path / "idx")
    synthesize_index(path, 2000, dim=128, nbits=2, avg_doclen=40, seed=1)
    queries = synthetic_queries(8)
    (tmp_path / "queries.tsv").write_text("".join(f"q{i}\t{q}\n" for i, q in enumerate(queries)))
    (tmp_path / "qrels.txt").write_text("".join(f"q{i} 0 {7 * i} 1\n" for i in range(8)))
    before = fm.stage2_maxsim.launches
    mma = fm.stage2_maxsim.variant_launches["mma"]
    [(pids, scores)] = searching.main([path, queries[0], "-k", "5", "--random-weights"])
    assert pids.shape == scores.shape == (5,) and ((pids >= 0) & (pids < 2000)).all()
    assert np.isfinite(scores).all() and (np.diff(scores) <= 1e-6).all()
    report = evaluate.main([path, str(tmp_path / "queries.tsv"), str(tmp_path / "qrels.txt"),
                            "--random-weights"])
    assert report["num_queries"] == 8 and report["qps"] > 0
    launches = fm.stage2_maxsim.launches - before
    assert launches == 2 and fm.stage2_maxsim.variant_launches["mma"] - mma == launches


@pytest.mark.cuda
def test_sharded_index_on_the_card_runs_the_kernel_per_shard(cuda_device, tmp_path):
    """Four data shards on one card (a repeated device list): every shard's
    stage 2 is one ``mma`` launch, and the merged result equals the same
    sharded search on the CPU up to ties, scores within 1e-4."""
    from colbert_torch.parallel.mesh import make_mesh
    from colbert_torch.parallel.sharded_index import ShardedDeviceIndex
    from colbert_torch.storage import format as fmt
    from colbert_torch.utils.testing import synthesize_index

    path = str(tmp_path / "idx")
    synthesize_index(path, 600, dim=128, nbits=2, avg_doclen=40, seed=2)
    codec = fmt.load_codec(path)
    kw = dict(centroids=codec["centroids"], stream_from=path,
              doclens=np.asarray(fmt.load_all_doclens(path), np.int64),
              bucket_weights=codec["bucket_weights"], nbits=2, balance_cap=64)
    gpu = ShardedDeviceIndex.build(make_mesh(4, 1, devices=["cuda:0"] * 4), **kw)
    cpu = ShardedDeviceIndex.build(make_mesh(4, 1, device="cpu"), **kw)
    Q = torch.nn.functional.normalize(
        torch.randn(8, 32, 128, generator=torch.Generator().manual_seed(1)), dim=-1)
    search = dict(k=10, nprobe=4, ncandidates=256, cell_cap=64, max_candidates=1024)
    before = dict(fm.stage2_maxsim.variant_launches)
    pg, sg = gpu.search_Q_batch(Q.to(cuda_device), **search)
    assert fm.stage2_maxsim.variant_launches["mma"] == before["mma"] + 4
    assert fm.stage2_maxsim.variant_launches["simt"] == before["simt"]
    pc, sc = cpu.search_Q_batch(Q, **search)
    np.testing.assert_allclose(sg, sc, atol=TOL, rtol=0)
    for r in range(8):
        shared = set(pg[r]) & set(pc[r])
        assert len(shared) >= 8, (pg[r], pc[r])


@pytest.mark.cuda
def test_tensor_parallel_encode_on_the_card(cuda_device):
    """A 1x2 tensor-parallel bert encode on one card (two model shards of
    6 heads at S=512) runs the flash ``mma`` kernel once per shard and layer
    and keeps every kept token within cosine 0.999 of the one-device bf16
    encode; in fp32 with TF32 off it is within 1e-4."""
    from colbert_torch.config import ColBERTConfig
    from colbert_torch.models.bert import BertConfig
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.parallel.mesh import make_mesh
    from colbert_torch.utils.testing import make_encoder

    cfg = BertConfig(vocab_size=512, num_hidden_layers=2)
    ccfg = ColBERTConfig(dim=128, doc_maxlen=512, use_pallas=True, flash_min_seqlen=512)
    one = make_encoder(dim=128, config=ccfg, bert_config=cfg, device=cuda_device)
    tp = ColBERTEncoder(one.model, one.tokenizer, ccfg, device=cuda_device)
    tp.attach_mesh(make_mesh(1, 2, devices=["cuda:0", "cuda:0"]))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (4, 512))
    mask = np.ones((4, 512), bool)
    mask[1, 300:] = False
    keep = mask.copy()
    with torch.no_grad():
        before = dict(fa.flash_attention.variant_launches)
        a = tp._forward("encode_batch", ids, mask, keep, dtype_name="bfloat16", use_flash=True)
        assert fa.flash_attention.variant_launches["mma"] == before["mma"] + 2 * 2
        b = one._forward("encode_batch", ids, mask, keep, dtype_name="bfloat16",
                         use_flash=True)
        k = torch.from_numpy(keep).to(cuda_device)
        assert float((a * b).sum(-1)[k].min()) >= 0.999
        a32 = tp._forward("encode_batch", ids, mask, keep, dtype_name="float32")
        b32 = one._forward("encode_batch", ids, mask, keep, dtype_name="float32")
        assert float((a32 - b32).abs()[k].max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_mesh_training_step_on_the_card(cuda_device, shape):
    """One AdamW step of a 2-layer bert-base-width model in fp32 over a
    mesh of the card repeated, against the same step on one device: loss
    1e-5 relative, every gradient entry within 1e-4 x its tensor's max |g|
    + 1e-7, every parameter within 1e-2 x lr (entries whose one-device
    gradient is nonzero and below 1e-6, where Adam's first update follows
    the gradient's rounding: within the lr, as chip_smoke.py holds them)."""
    from colbert_torch.config import ColBERTConfig
    from colbert_torch.models.bert import BertConfig
    from colbert_torch.parallel.mesh import make_mesh
    from colbert_torch.training import ColBERTTrainer
    from colbert_torch.utils.testing import make_encoder, make_vocab, synthetic_collection

    lr = 1e-3
    cfg = BertConfig(vocab_size=len(make_vocab()), num_hidden_layers=2)
    ccfg = ColBERTConfig(dim=128, doc_maxlen=64, query_maxlen=16, activation_dtype="float32")
    docs = synthetic_collection(16, seed=1, words_per_doc=10)
    triples = [(" ".join(docs[i].split()[:4]), docs[i], docs[8 + i]) for i in range(8)]
    out = {}
    for mesh in (None, shape):
        enc = make_encoder(dim=128, config=ccfg, bert_config=cfg, device=cuda_device)
        if mesh is not None:
            enc.attach_mesh(make_mesh(*mesh, devices=["cuda:0"] * (mesh[0] * mesh[1])))
        loss = ColBERTTrainer(enc, learning_rate=lr).train_step(triples)["loss"]
        params = list(enc.model.parameters())
        out[mesh] = (loss, [p.grad.clone() for p in params], [p.detach().clone() for p in params])
    (loss, grads, params), (loss1, grads1, params1) = out[shape], out[None]
    assert abs(loss - loss1) <= 1e-5 * abs(loss1), (loss, loss1)
    for i, (g, g1, p, p1) in enumerate(zip(grads, grads1, params, params1)):
        grad_err = float((g - g1).abs().max())
        assert grad_err <= 1e-4 * float(g1.abs().max()) + 1e-7, (i, grad_err)
        apart = (g1.abs() < 1e-6) & (g1 != 0)
        diff = (p - p1).abs()
        strict = float(diff[~apart].max()) if (~apart).any() else 0.0
        loose = float(diff[apart].max()) if apart.any() else 0.0
        assert strict <= 1e-2 * lr and loose <= lr, (i, strict, loose)
