"""Tests that need an NVIDIA GPU: the stage-2 CUDA kernels vs their plain
PyTorch version (TF32 off, tolerance 1e-4) on the cases of the CPU parity
tests, each case through the kernel its shapes select (tensor-core ``mma``
for dim 128 and Lq <= 32, ``simt`` otherwise); the flash-attention kernel vs its plain version (fp32 inputs to
1e-4; bf16 inputs within 8e-3 * max(1, |plain|), one bf16 rounding step of
the output, against the plain version on the fp32 upcast of the same
inputs), each case through the kernel its dtype and head dim select
(tensor-core ``mma`` for bf16/fp16 at hd 32/64/128, ``simt`` otherwise);
the windowed kernel (ModernBERT's local layers: bf16, hd 64, window 64,
S 1,024 and 8,192 with ragged pads) against the plain version, a window
of S bit for bit the unwindowed kernel, a small ModernBERT's flash route
against its materialized one, and a small ModernBERT index built through
the kernels and searched by the captured serving program;
the device and alignment rules of the wrappers; and the life of a live index
on the card against the port on the CPU: ``IndexUpdater.add`` (codes equal up
to near-ties), the exact oracle (within 1e-4) and a ``BatchingSearcher``
whose loop thread launches and finishes the searches (the same pids and
scores as direct ``search_batch`` of the same batches); the refine on the
card against the CPU (1e-4); the refine kernel against its plain version
(1e-4) over the CPU tests' grid and at the serving shape, under
``set_sync_debug_mode("error")``, and one counted refine launch per search
batch, eager and replayed; BERT's materialized attention on bf16/fp16
operands with fp32 products against the upcast formulation (one bf16 step,
gradients within 1e-2 x their max); and the
``searching`` and ``evaluate`` entry points at their default device, every
stage-2 launch through the ``mma`` kernel; a 4-shard sharded index on one
card (one ``mma`` stage-2 launch and one refine launch per shard, equal to
the CPU's up to ties)
and a tensor-parallel encode over two model shards (flash per shard, cosine
0.999 in bf16, 1e-4 in fp32); a 2-layer fp32 training step over a DP and
a dp x tp mesh of the card repeated against the one-device step (loss
1e-5 relative, gradients within 1e-4 x their max + 1e-7); and the captured
serving program: graphed ``search_batch`` against the eager entry up to
ties (1e-4, fp32 and bf16 activations), one stage-2 count per launch, a
launch under ``set_sync_debug_mode("error")``, the same with spans and
counters recording (no capture, each replay timed by its CUDA events),
launches in flight reading
back their own results, the same results for a batch tokenized natively
and in Python, programs after ``set_balance_cap``, an updater add
and in-place training steps (eager and graphed), and a failed capture that
raises; and the captured training step: four fp32 steps graphed against
the same optimizer's eager steps (loss 1e-5 relative, gradients 1e-4 x
their max, parameters 1e-2 x lr, the lr the schedule's), the bf16 step and
its replays under ``set_sync_debug_mode("error")``, a failed capture that
raises, and a non-capturable optimizer refused; and the captured doc
encode: each of the three doc encodes through its replayed programs bit for
bit its op-by-op route, a build's chunks through the programs bit for bit
the same chunks encoded op by op against the build's own codec, a replay
under ``set_sync_debug_mode("error")``, and a flash-routed 64 x 512 batch
replayed to the eager result with the same flash launch count; and
k-means' nearest-centroid kernel against the plain fp32 ``addmm`` +
``argmax`` on bf16 and fp32 rows (K 1 to 16,384, every width, ragged n;
planted exact ties to the lower index, any other disagreement a near tie
within 1e-5 relative), a Lloyd step through it against the plain version
on the CPU (1e-5), no score tile in device memory and no host sync, and
its launch and tracing counts (one launch a pass); and DeepSeek-V3's
expert layer: the grouped route (``torch._grouped_mm``) against the plain
loop (within 2^-7 of the largest output, an empty expert among them, no
host sync), a small DeepSeek-V3 encoder's doc batches replayed bit for bit
as op by op (the expert layer inside the captured program, a replay under
sync debug mode, its MoE counters per replay), its index built and served
through the captured serving program against the eager entry, and the
grouped-product kernels under the profiler equal to the launches counted,
eager and replayed. Every test skips
without a GPU. This file imports no JAX; on a machine without JAX run it as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from colbert_torch.ops import approx_maxsim as am
from colbert_torch.ops import flash_attention as fa
from colbert_torch.ops import fused_maxsim as fm
from colbert_torch.ops import kmeans as km
from colbert_torch.ops import nearest_centroid as nc

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


def _ragged_case(seed, B, H, S, hd, device, dtype=torch.bfloat16):
    """q, k, v and a pad bias whose rows end at ragged lengths (one row
    whole, the others cut inside a 64-key tile)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B * H, S, hd)).astype(np.float32))
               .to(device, dtype) for _ in range(3))
    mask = np.zeros((B, S), bool)
    for b, n in enumerate([S, S - 37, S // 2 + 5, 70][:B]):
        mask[b, :n] = True
    bias = np.where(mask, 0.0, np.finfo(np.float32).min).astype(np.float32)
    return q, k, v, torch.from_numpy(bias).to(device), torch.from_numpy(mask).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("S,B,hd,dtype", [(1024, 4, 64, torch.bfloat16),
                                          (8192, 2, 64, torch.bfloat16),
                                          (1024, 4, 64, torch.float32),
                                          (1024, 4, 40, torch.bfloat16)])
def test_windowed_flash_kernel_matches_plain(cuda_device, S, B, hd, dtype):
    # ModernBERT's window of 64: bf16 at hd 64 through flash_mma_window_kernel,
    # fp32 and hd 40 through flash_kernel with the window, against the plain
    # version on the fp32 upcast of the same inputs; rows past a sequence's
    # end (pads) are left out of the comparison
    from colbert_torch.utils import tracing

    H = 3
    q, k, v, bias, mask = _ragged_case(S + B, B, H, S, hd, cuda_device, dtype)
    variant = fa._variant(dtype, hd)
    before = (fa.flash_attention.launches, fa.flash_attention.window_launches,
              fa.flash_attention.variant_launches[variant])
    with tracing.recording() as t:
        got = fa.flash_attention(q, k, v, bias, num_heads=H, window=64)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, num_heads=H,
                                    window=64)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention.window_launches,
            fa.flash_attention.variant_launches[variant]) == tuple(x + 1 for x in before)
    assert t.counters == {"attn_window_tile_pairs": B * H * fa.window_tile_pairs(S, 64)}
    real = mask.repeat_interleave(H, dim=0)
    err = (got.float() - want).abs()[real]
    if dtype == torch.float32:
        assert float(err.max()) <= TOL
    else:
        assert bool((err <= 8e-3 * want[real].abs().clamp(min=1.0)).all())
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [256, 1024])
def test_no_window_route_is_the_unwindowed_kernel_bit_for_bit(cuda_device, S):
    # a window of S leaves no key out: the windowed kernel then runs the
    # unwindowed kernel's arithmetic row for row (its 64-row q tiles only
    # regroup the rows), so the two agree bit for bit; the unwindowed route
    # (window None) is flash_mma_kernel as before, held to the plain
    # version by test_flash_kernel_matches_plain
    B, H, hd = 2, 3, 64
    q, k, v, bias, _ = _ragged_case(S, B, H, S, hd, cuda_device)
    plain = fa.flash_attention(q, k, v, bias, num_heads=H)
    wide = fa.flash_attention(q, k, v, bias, num_heads=H, window=S)
    torch.cuda.synchronize()
    assert torch.equal(plain, wide)


@pytest.mark.cuda
def test_modernbert_flash_route_on_the_card(cuda_device):
    # a 3-layer ModernBERT at hd 64 (global, local, local) in bf16 at S=1024:
    # both layer kinds through the kernels against the materialized route
    # with the band (cosine 0.999 per real position), one launch per layer
    from colbert_torch.models.colbert import ColBERT, init_colbert
    from colbert_torch.models.modernbert import ModernBertConfig
    from colbert_torch.utils import tracing

    cfg = ModernBertConfig(vocab_size=512, hidden_size=128, num_hidden_layers=3,
                           num_attention_heads=2, intermediate_size=192,
                           max_position_embeddings=2048)
    model = init_colbert(cfg, 32, generator=torch.Generator().manual_seed(0))
    model = model.to(cuda_device).eval()
    ids = torch.randint(5, 512, (2, 1024), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 1024, dtype=torch.bool)
    mask[1, 700:] = False
    ids, mask = ids.to(cuda_device), mask.to(cuda_device)
    with torch.no_grad(), tracing.recording() as t:
        got = model.forward_normalized(ids, mask, mask, use_flash=True)
        want = model.forward_normalized(ids, mask, mask)
    torch.cuda.synchronize()
    assert t.counters == {"attn_global_launches": 1, "attn_window_launches": 2,
                          "attn_materialized_launches": 3,
                          "attn_window_tile_pairs": 2 * 2 * 2 * fa.window_tile_pairs(1024, 64)}
    cos = (got * want).sum(-1)[mask]
    assert float(cos.min()) > 0.999


@pytest.mark.cuda
def test_modernbert_index_and_captured_search_on_the_card(cuda_device, tmp_path):
    # a small ModernBERT (hd 64) indexes 48 passages of 150-400 words on the
    # card, every doc batch through the kernels (flash_min_seqlen 256: one
    # global and two windowed launches a batch, none materialized), and the
    # captured serving program finds each of 8 passages from its opening
    # words
    from colbert_torch.config import ColBERTConfig
    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.models.colbert import init_colbert
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.models.modernbert import ModernBertConfig
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.tokenization.wordpiece import WordPieceTokenizer
    from colbert_torch.utils import tracing
    from colbert_torch.utils.testing import make_vocab

    cfg = ModernBertConfig(vocab_size=2048, hidden_size=128, num_hidden_layers=3,
                           num_attention_heads=2, intermediate_size=192,
                           max_position_embeddings=1024)
    model = init_colbert(cfg, 32, generator=torch.Generator().manual_seed(2))
    ccfg = ColBERTConfig(dim=32, nbits=2, doc_maxlen=1024, query_maxlen=32, kmeans_niters=2,
                         index_bsize=16, flash_min_seqlen=256)
    enc = ColBERTEncoder(model, WordPieceTokenizer(make_vocab(cfg.vocab_size - 52)), ccfg,
                         device=cuda_device)
    rng = np.random.default_rng(4)
    passages = [" ".join(f"w{j}" for j in rng.integers(0, 1900, n))
                for n in rng.integers(150, 400, 48)]
    path = str(tmp_path / "index")
    with tracing.recording() as t:
        Indexer(ccfg, encoder=enc, collection=passages, device=cuda_device).index(path)
    batches = t.counters["doc_batches"]
    assert t.counters["attn_global_launches"] == batches
    assert t.counters["attn_window_launches"] == 2 * batches
    assert "attn_materialized_launches" not in t.counters
    searcher = Searcher(path, encoder=enc, config=ccfg, device=cuda_device)
    queries = [" ".join(p.split()[:25]) for p in passages[:8]]
    pids, _ = searcher.search_batch(queries, k=5)
    assert pids[:, 0].tolist() == list(range(8))


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


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_bytes", [None, 1 << 16])
def test_refine_on_the_card_matches_the_cpu(cuda_device, tmp_path, chunk_bytes):
    """The refine on the card (the table product and the kernel) against
    the CPU's chunk passes, in one chunk (the default cap) and in many, with
    sentinel pids; then a search through the refine, every pid both return
    scored within 1e-4. On the card ``chunk_bytes`` is read by the plain
    version only, so the two cases differ on the CPU's side alone."""
    from colbert_torch.retrieval import device_index as di
    from colbert_torch.storage import format as fmt
    from colbert_torch.utils.testing import synthesize_index

    path = str(tmp_path / "idx")
    synthesize_index(path, 500, dim=128, nbits=2, avg_doclen=40, seed=2)
    codec = fmt.load_codec(path)
    ivf, ivf_lengths = fmt.load_ivf(path)
    kw = dict(centroids=codec["centroids"], ivf=ivf, ivf_lengths=ivf_lengths,
              doclens=np.asarray(fmt.load_all_doclens(path), np.int64),
              bucket_weights=codec["bucket_weights"], nbits=2, stream_from=path)
    gpu = di.DeviceIndex.build(device="cuda", **kw)
    cpu = di.DeviceIndex.build(device="cpu", **kw)
    g = torch.Generator().manual_seed(1)
    Q = torch.nn.functional.normalize(torch.randn(4, 32, 128, generator=g), dim=-1)
    pids = torch.randint(0, 500, (4, 300), generator=g)
    pids[:, ::29] = 500  # the sentinel
    cap = {} if chunk_bytes is None else {"chunk_bytes": chunk_bytes}
    got = di._approx_maxsim(gpu, Q.to(cuda_device), pids.to(cuda_device), **cap).cpu()
    want = di._approx_maxsim(cpu, Q, pids, **cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    assert (got[:, ::29] == 0).all()
    search = dict(k=10, nprobe=2, ncandidates=32, cell_cap=64, max_candidates=256,
                  stage1_refine=True)
    pg, sg = gpu.search_Q_batch(Q, **search)
    pc, sc = cpu.search_Q_batch(Q, **search)
    shared = 0
    for r in range(4):
        a = dict(zip(pg[r].tolist(), sg[r].tolist()))
        b = dict(zip(pc[r].tolist(), sc[r].tolist()))
        for pid in a.keys() & b.keys():
            assert abs(a[pid] - b[pid]) <= TOL
        shared += len(a.keys() & b.keys())
    assert shared >= 0.8 * pg.size


def _refine_case(seed, device, *, B, W, Lq, Ld, K, n_tokens):
    """Refine inputs made from a seed: unit queries and centroids, codes
    over ``n_tokens`` rows plus Ld zero rows of padding (what the device
    index holds), doclens in [1, Ld] with a tenth 0, sentinel columns
    (offset ``n_tokens``, doclen 0) and a last candidate that ends on the
    last real code row -> (Q, offs, dls, codes, centroids) on ``device``."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((B, Lq, 128)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    cent = rng.standard_normal((K, 128)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    codes = np.zeros(n_tokens + Ld, np.int32)
    codes[:n_tokens] = rng.integers(0, K, n_tokens)
    dls = rng.integers(1, Ld + 1, (B, W)).astype(np.int32)
    dls[rng.random((B, W)) < 0.1] = 0
    offs = rng.integers(0, n_tokens - Ld, (B, W)).astype(np.int64)
    offs[:, ::29], dls[:, ::29] = n_tokens, 0          # the sentinel pid
    offs[-1, -1], dls[-1, -1] = n_tokens - Ld, Ld      # ends on the last code row
    return tuple(torch.from_numpy(x).to(device) for x in (Q, offs, dls, codes, cent))


@pytest.mark.cuda
@pytest.mark.parametrize("columns", [1, 7, None])
@pytest.mark.parametrize("Ld", [32, 160])
@pytest.mark.parametrize("Lq", [1, 17, 32, 40])
def test_refine_kernel_matches_plain(cuda_device, Lq, Ld, columns):
    """The refine kernel against its plain version on the card (1e-4) at
    the CPU tests' grid, one counted launch each; zero doclens and
    sentinels score 0; with the codes cut right after the last real row
    (no padding) the kernel returns the same scores: it reads no code past
    a candidate's doclen."""
    Q, offs, dls, codes, cent = _refine_case(Lq * 7 + Ld, cuda_device, B=3, W=257, Lq=Lq,
                                             Ld=Ld, K=500, n_tokens=20_000)
    cap = {} if columns is None else {
        "chunk_bytes": columns * am.refine_column_bytes(3, Ld, Lq)}
    before = am.approx_maxsim.launches
    got = am.approx_maxsim(Q, offs, dls, codes, cent, max_doclen=Ld, **cap)
    want = am.approx_maxsim_plain(Q, offs, dls, codes, cent, max_doclen=Ld, **cap)
    cut = am.approx_maxsim(Q, offs, dls, codes[:20_000], cent, max_doclen=Ld)
    torch.cuda.synchronize()
    assert am.approx_maxsim.launches == before + 2
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=TOL, rtol=0)
    assert torch.equal(cut, got)
    zero = (dls == 0).cpu().numpy()
    assert (got.cpu().numpy()[zero] == 0).all() and (got.cpu().numpy()[~zero] != 0).all()


@pytest.mark.cuda
def test_refine_kernel_at_the_serving_shape(cuda_device):
    """One served batch's refine shape (B=32 queries x W=4,096 candidates,
    Ld 160, Lq 32, K 32,768 centroids): the kernel against its plain
    version on the card within 1e-4."""
    Q, offs, dls, codes, cent = _refine_case(11, cuda_device, B=32, W=4096, Lq=32, Ld=160,
                                             K=32768, n_tokens=2_000_000)
    got = am.approx_maxsim(Q, offs, dls, codes, cent, max_doclen=160)
    want = am.approx_maxsim_plain(Q, offs, dls, codes, cent, max_doclen=160)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=TOL, rtol=0)


@pytest.mark.cuda
def test_refine_launch_makes_no_host_synchronization(cuda_device):
    """The table product and the kernel launch pass under
    ``torch.cuda.set_sync_debug_mode("error")`` (after a first launch that
    builds the library), with the same scores."""
    Q, offs, dls, codes, cent = _refine_case(3, cuda_device, B=4, W=300, Lq=32, Ld=160,
                                             K=500, n_tokens=20_000)
    want = am.approx_maxsim(Q, offs, dls, codes, cent, max_doclen=160)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = am.approx_maxsim(Q, offs, dls, codes, cent, max_doclen=160)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_search_counts_one_refine_launch_per_batch(cuda_device, tmp_path):
    """With the refine on, every ``search_batch`` (the program's eager
    warm-up, its capture, then replays) and every eager-entry search makes
    exactly one counted launch of the refine kernel beside one ``mma``
    stage-2 launch, and the two routes agree up to ties."""
    s, queries, _ = _served(tmp_path, cuda_device)
    s.config.plaid_stage2_docs = 128  # below the 640-wide stage-1 budget: the refine runs
    batch = queries[:32]
    for route in ("graphed", "graphed", "graphed", "eager"):
        before = (am.approx_maxsim.launches, dict(am.approx_maxsim.variant_launches),
                  fm.stage2_maxsim.variant_launches["mma"])
        got = s.search_batch(batch, k=10) if route == "graphed" else _eager(s, batch)
        assert am.approx_maxsim.launches == before[0] + 1, route
        assert am.approx_maxsim.variant_launches == {"table": before[1]["table"] + 1}
        assert fm.stage2_maxsim.variant_launches["mma"] == before[2] + 1
        _agree_up_to_ties(*got, *_eager(s, batch))
    assert s.device_index.programs.stats()["replays"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("S", [128, 160, 512])
def test_attention_products_on_the_card(cuda_device, dtype, S):
    """BERT's materialized attention on the card: bf16 and fp16 activations
    multiply in their dtype into fp32, within one bf16 step of the upcast
    formulation, gradients within 1e-2 x their max; fp32 activations take
    the upcast formulation itself (1e-4)."""
    from colbert_torch.models.bert import _attention, upcast_attention

    rng = np.random.default_rng(S)
    B = 4
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, 768)).astype(np.float32))
               .to(cuda_device, dtype).requires_grad_(True) for _ in range(3))
    mask = np.arange(S)[None] < np.array([S, S // 2, S - 3, 1])[:, None]
    bias = torch.from_numpy(np.where(mask, 0.0, np.finfo(np.float32).min)
                            .astype(np.float32)).to(cuda_device)[:, None, None, :]
    w = torch.randn(B, S, 768, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    got = _attention(q, k, v, bias, 12)
    want = upcast_attention(q, k, v, bias, 12)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().detach()
    if dtype == torch.float32:
        assert float(err.max()) <= TOL
    else:
        assert bool((err <= 8e-3 * want.float().abs().clamp(min=1.0)).all())
    g_got = torch.autograd.grad((got.float() * w).sum(), (q, k, v))
    g_want = torch.autograd.grad((want.float() * w).sum(), (q, k, v))
    for a, b in zip(g_got, g_want):
        assert a.dtype == dtype
        assert float((a - b).float().abs().max()) <= 1e-2 * float(b.float().abs().max())


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
    stage 2 is one ``mma`` launch and its refine one launch of the refine
    kernel, and the merged result equals the same
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
    refine_before = am.approx_maxsim.launches
    pg, sg = gpu.search_Q_batch(Q.to(cuda_device), **search)
    assert fm.stage2_maxsim.variant_launches["mma"] == before["mma"] + 4
    assert fm.stage2_maxsim.variant_launches["simt"] == before["simt"]
    assert am.approx_maxsim.launches == refine_before + 4  # one refine per shard
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
        a = tp._shard_forward(ids, mask, keep, dtype_name="bfloat16", use_flash=True)
        assert fa.flash_attention.variant_launches["mma"] == before["mma"] + 2 * 2
        b = one.model.encode_batch(*one._put_batch(ids, mask, keep), dtype_name="bfloat16",
                                   use_flash=True)
        k = torch.from_numpy(keep).to(cuda_device)
        assert float((a * b).sum(-1)[k].min()) >= 0.999
        a32 = tp._shard_forward(ids, mask, keep, dtype_name="float32")
        b32 = one.model.encode_batch(*one._put_batch(ids, mask, keep), dtype_name="float32")
        assert float((a32 - b32).abs()[k].max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_mesh_training_step_on_the_card(cuda_device, shape):
    """One AdamW step of a 2-layer bert-base-width model in fp32 over a
    mesh of the card repeated, against the same step on one device: loss
    1e-5 relative, every gradient entry within 1e-4 x its tensor's max |g|
    + 1e-7, every parameter within 1e-2 x lr (entries whose gradient is
    below 1e-6 on both sides and nonzero on at least one, where Adam's
    first update follows the gradient's rounding or sign: within the lr,
    as chip_smoke.py holds them)."""
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
        # below 1e-6 on both sides and nonzero on at least one (ROADMAP C1)
        apart = (g1.abs() < 1e-6) & (g.abs() < 1e-6) & ((g1 != 0) | (g != 0))
        diff = (p - p1).abs()
        strict = float(diff[~apart].max()) if (~apart).any() else 0.0
        loose = float(diff[apart].max()) if apart.any() else 0.0
        assert strict <= 1e-2 * lr and loose <= lr, (i, strict, loose)


# --- the captured serving program -----------------------------------------


def _agree_up_to_ties(p1, s1, p2, s2, tol=TOL):
    """Two top-k results agree: scores within ``tol`` position by position,
    shared pids within ``tol``, a pid in one result only within ``tol`` of
    the row's k-th score (a tie at the cut)."""
    np.testing.assert_allclose(s1, s2, atol=tol, rtol=0)
    for r in range(p1.shape[0]):
        a, b = dict(zip(p1[r].tolist(), s1[r].tolist())), dict(zip(p2[r].tolist(), s2[r].tolist()))
        for pid in a.keys() & b.keys():
            assert abs(a[pid] - b[pid]) <= tol, (r, pid)
        cut = min(s1[r].min(), s2[r].min())
        for pid in a.keys() ^ b.keys():
            assert a.get(pid, b.get(pid)) - cut <= tol, (r, pid)


def _served(tmp_path, device, dtype="float32", n=600):
    """A Searcher over a synthetic index on ``device``, its encoder at
    ``dtype`` activations, and 48 short queries."""
    from colbert_torch.config import ColBERTConfig
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.utils.testing import make_encoder, synthesize_index, synthetic_collection

    path = str(tmp_path / "idx")
    if not (tmp_path / "idx").exists():
        synthesize_index(path, n, dim=128, nbits=2, avg_doclen=40, chunksize=256, seed=5)
    cfg = ColBERTConfig(dim=128, nbits=2, doc_maxlen=64, query_maxlen=32, index_bsize=16,
                        length_bucket=16, activation_dtype=dtype)
    enc = make_encoder(dim=128, seed=0, config=cfg, device=device)
    queries = [" ".join(p.split()[:8]) for p in synthetic_collection(48, seed=9)]
    return Searcher(path, encoder=enc, device=device), queries, path


def _eager(s, queries, k=10):
    """``queries`` through the eager entry, padded to the Searcher's bucket
    as ``launch_search`` pads them."""
    B = len(queries)
    padded = next(b for b in s.QUERY_BATCH_BUCKETS if b >= B)
    ids, mask = s.encoder.tensorize_queries(list(queries) + [""] * (padded - B))
    p, sc = s.device_index.finalize(s.device_index._search_tokens_eager(
        s.encoder, ids, mask, **s._search_kwargs(k)))
    return p[:B], sc[:B]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_search_matches_the_eager_entry(cuda_device, tmp_path, dtype):
    """``search_batch`` through the captured program (its first launch, the
    warm-up, and replays) at buckets 32 and 8 equals the eager entry up to
    ties at 1e-4; the stage-2 count rises by one per launch, all ``mma``."""
    s, queries, _ = _served(tmp_path, cuda_device, dtype)
    for batch in (queries[:32], queries[32:37]):
        for _ in range(3):
            before = dict(fm.stage2_maxsim.variant_launches)
            got = s.search_batch(batch, k=10)
            assert fm.stage2_maxsim.variant_launches == dict(before, mma=before["mma"] + 1)
            _agree_up_to_ties(*got, *_eager(s, batch))
    stats = s.device_index.programs.stats()
    assert stats["built"] == stats["held"] == 2 and stats["replays"] == 4
    assert stats["pool_bytes"] > 0 and stats["capture_s"] > 0


@pytest.mark.cuda
def test_serving_launch_makes_no_host_synchronization(cuda_device, tmp_path):
    """After the capture, a launch (token copy-in, replay, result copy-out)
    passes under ``torch.cuda.set_sync_debug_mode("error")``."""
    s, queries, _ = _served(tmp_path, cuda_device, "bfloat16")
    want = s.search_batch(queries[:32], k=10)  # captures the B=32 program
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        parts = s.launch_search(queries[:32], k=10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = s.finish_search(parts, k=10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.cuda
def test_recording_keeps_the_captured_route_and_times_replays(cuda_device, tmp_path):
    """With spans and counters recording, launches replay the captured
    program (no capture, launched under ``set_sync_debug_mode("error")``),
    each replay is timed by two CUDA events read at ``finalize``, and the
    results equal an unrecorded search's."""
    from colbert_torch.utils import tracing

    s, queries, _ = _served(tmp_path, cuda_device, "bfloat16")
    want = s.search_batch(queries[:32], k=10)  # captures the B=32 program
    torch.cuda.synchronize()
    with tracing.recording() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            parts = [s.launch_search(queries[:32], k=10) for _ in range(3)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = [s.finish_search(p, k=10) for p in parts]
    for p, sc in got:
        np.testing.assert_array_equal(p, want[0])
        np.testing.assert_array_equal(sc, want[1])
    c = rec.counters
    assert "program_captures" not in c and c["program_replays"] == 3
    assert c["program_replays_timed"] == 3 and c["program_replay_device_ns"] > 0
    names = [sp.name for sp in rec.spans]
    assert names.count("replay") == 3 and names.count("capture") == 0


@pytest.mark.cuda
def test_captured_search_is_the_same_for_either_tokenizer(cuda_device, tmp_path, monkeypatch):
    """A batch tokenized by the native WordPiece and by the Python one
    gives byte-identical ids, and ``launch_search``/``finish_search`` on
    the captured route return the same pids and scores for both, through
    one program; the native pass counts every text, pad rows included."""
    from colbert_torch.tokenization import native as native_mod
    from colbert_torch.utils import tracing

    s, queries, _ = _served(tmp_path, cuda_device, "bfloat16")
    batch = queries[:30] + ["Naïve café w1"]
    with tracing.recording() as rec:
        native = s.finish_search(s.launch_search(batch, k=10), k=10)
    assert rec.counters["query_tokenize_native"] == 31
    assert rec.counters["query_tokenize_fallback"] == 1
    ids = s.encoder.tensorize_queries(batch)
    monkeypatch.setattr(native_mod, "load_library", lambda: None)
    monkeypatch.setattr(s.encoder, "_native_tok", native_mod.NativeWordPiece(s.encoder.tokenizer))
    assert not s.encoder._native_tok.available
    for a, b in zip(s.encoder.tensorize_queries(batch), ids):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    python = s.finish_search(s.launch_search(batch, k=10), k=10)
    np.testing.assert_array_equal(python[0], native[0])
    np.testing.assert_array_equal(python[1], native[1])
    assert s.device_index.programs.built == 1


@pytest.mark.cuda
def test_launches_in_flight_keep_their_own_results(cuda_device, tmp_path):
    """Three batches launched through one program before any is read back,
    and ``search_stream`` with two in flight: each batch reads back its own
    results, equal to its own ``search_batch``."""
    s, queries, _ = _served(tmp_path, cuda_device)
    batches = [queries[i:i + 8] for i in range(0, 48, 8)]
    want = [s.search_batch(b, k=10) for b in batches]
    parts = [s.launch_search(b, k=10) for b in batches[:3]]
    for part, (wp, ws) in zip(parts, want):
        p, sc = s.finish_search(part, k=10)
        np.testing.assert_array_equal(p, wp)
        np.testing.assert_array_equal(sc, ws)
    for (p, sc), (wp, ws) in zip(s.search_stream(batches, k=10, max_inflight=2), want):
        np.testing.assert_array_equal(p, wp)
        np.testing.assert_array_equal(sc, ws)
    assert s.device_index.programs.built == 1


@pytest.mark.cuda
def test_programs_follow_rebalance_updates_and_training(cuda_device, tmp_path):
    """After ``set_balance_cap`` (the probe tables replaced) and after
    ``IndexUpdater.add`` + ``reload`` the results equal a fresh Searcher's;
    after an in-place AdamW step the same program serves the trained
    weights (equal to the eager entry)."""
    from colbert_torch.config import ColBERTConfig
    from colbert_torch.indexing.updater import IndexUpdater
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.training import ColBERTTrainer
    from colbert_torch.utils.testing import synthetic_collection

    s, queries, path = _served(tmp_path, cuda_device)
    batch = queries[:16]
    s.search_batch(batch, k=10)
    s.set_balance_cap(16)
    assert len(s.device_index.programs) == 0
    cfg = ColBERTConfig.load(f"{path}/config.json")
    cfg.ivf_balance_cap = 16
    fresh = Searcher(path, encoder=s.encoder, config=cfg, device=cuda_device)
    _agree_up_to_ties(*s.search_batch(batch, k=10), *fresh.search_batch(batch, k=10))

    old = s.search_batch(batch, k=10)
    added = synthetic_collection(64, seed=12, words_per_doc=30)
    IndexUpdater(path, s.encoder).add(added)
    new = s.reload()
    got = new.search_batch(batch, k=10)
    _agree_up_to_ties(*got, *Searcher(path, encoder=s.encoder, device=cuda_device)
                      .search_batch(batch, k=10))
    np.testing.assert_array_equal(s.search_batch(batch, k=10)[0], old[0])  # the old snapshot

    built = new.device_index.programs.built
    docs = synthetic_collection(16, seed=13, words_per_doc=12)
    triples = [(" ".join(docs[i].split()[:4]), docs[i], docs[8 + i]) for i in range(8)]
    trainer = ColBERTTrainer(new.encoder, learning_rate=1e-2)
    trainer.train_step(triples)  # the training key's warm-up: an eager step
    trained = new.search_batch(batch, k=10)
    assert new.device_index.programs.built == built
    _agree_up_to_ties(*trained, *_eager(new, batch))
    assert not np.array_equal(trained[1], got[1])
    # graphed training: the capture, then replays; the serving program
    # replayed after each serves the weights of that step
    for replays in (1, 2):
        trainer.train_step(triples)
        assert trainer.programs.programs()[0].replays == replays
        served = new.search_batch(batch, k=10)
        assert new.device_index.programs.built == built
        _agree_up_to_ties(*served, *_eager(new, batch))
        assert not np.array_equal(served[1], trained[1])
        trained = served


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda_device, tmp_path, monkeypatch):
    """A funnel that synchronizes cannot be captured: the launch raises, and
    nothing runs the eager route in its place (every later launch of the key
    raises too)."""
    from colbert_torch.retrieval import device_index as tdi

    s, queries, _ = _served(tmp_path, cuda_device)
    search = tdi._search

    def syncing(*a, **kw):
        out = search(*a, **kw)
        out[2].sum().item()
        return out

    monkeypatch.setattr(tdi, "_search", syncing)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            s.search_batch(queries[:4], k=10)
    torch.cuda.synchronize()
    assert s.device_index.programs.stats()["replays"] == 0


# --- the captured training step -------------------------------------------


def _train_setup(device, dtype="float32", n_batches=4):
    """A 2-layer bert-base-width encoder on ``device`` at ``dtype``
    activations and ``n_batches`` batches of 8 triples."""
    from colbert_torch.config import ColBERTConfig
    from colbert_torch.models.bert import BertConfig
    from colbert_torch.utils.testing import make_encoder, make_vocab, synthetic_collection

    cfg = BertConfig(vocab_size=len(make_vocab()), num_hidden_layers=2)
    ccfg = ColBERTConfig(dim=128, doc_maxlen=64, query_maxlen=16, activation_dtype=dtype)
    enc = make_encoder(dim=128, config=ccfg, bert_config=cfg, device=device)
    docs = synthetic_collection(16 * n_batches, seed=1, words_per_doc=10)
    batches = [[(" ".join(docs[16 * b + i].split()[:4]), docs[16 * b + i], docs[16 * b + 8 + i])
                for i in range(8)] for b in range(n_batches)]
    return enc, batches


@pytest.mark.cuda
def test_graphed_training_matches_eager(cuda_device):
    """Four steps (warm-up 2, cosine to step 4, clipping at 1.0) of the
    trainer's graphed route (step 1 the eager warm-up, step 2 the capture and
    its replay, then replays) against ``make_train_step`` over a twin with
    the same optimizer (capturable AdamW, its lr a device tensor) under the
    same schedule, run op by op, fp32, TF32 off: loss 1e-5 relative per
    step; ``p.grad`` readable after every step and within 1e-4 x its max
    |g| + 1e-7; every parameter within
    1e-2 x lr, entries whose gradient is nonzero but below 1e-6 apart (Adam
    moves them +-lr by a sign that rounding may flip: 2 x lr per step); the
    lr after step n equal to ``lr_multiplier(n)`` x peak (1e-6 relative: an
    fp32 tensor)."""
    import copy

    from colbert_torch.training import trainer as pt

    lr, sched = 1e-3, dict(warmup_steps=2, total_steps=4)
    enc, batches = _train_setup(cuda_device)
    twin = copy.deepcopy(enc.model)
    trainer = pt.ColBERTTrainer(enc, learning_rate=lr, **sched)
    opt = pt.default_optimizer(twin.parameters(), lr, 0.01, cuda_device)
    eager = pt.make_train_step(twin, opt, dtype_name="float32", max_grad_norm=1.0,
                               scheduler=torch.optim.lr_scheduler.LambdaLR(
                                   opt, pt.lr_multiplier(**sched)))
    mult = pt.lr_multiplier(**sched)
    lr_tensor = trainer.optimizer.param_groups[0]["lr"]
    for step, triples in enumerate(batches):
        host = trainer._tensorize(triples)
        got = trainer.train_step(triples)
        want = eager(dict(zip(host, enc._put_batch(*host.values()))))
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (step, got, want)
        assert trainer.optimizer.param_groups[0]["lr"] is lr_tensor  # filled in place
        now = float(lr_tensor)
        assert now == pytest.approx(lr * mult(step + 1), rel=1e-6, abs=1e-12), step
        for (name, p), q in zip(enc.model.named_parameters(), twin.parameters()):
            g = q.grad.abs()
            assert p.grad is not None, (step, name)
            assert float((p.grad - q.grad).abs().max()) <= 1e-4 * float(g.max()) + 1e-7, name
            apart = (g < 1e-6) & (g != 0)
            diff = (p - q).detach().abs()
            assert float(torch.where(apart, 0, diff).max()) <= 1e-2 * lr, (step, name)
            assert float(torch.where(apart, diff, 0).max()) <= 2 * lr * (step + 1), (step, name)
    (prog,) = trainer.programs.programs()
    assert prog.graph is not None and prog.replays == 3 and prog.pool_bytes > 0


@pytest.mark.cuda
def test_training_replays_make_no_host_synchronization(cuda_device):
    """The bf16 device step (remat, the attention products' own backward,
    clipping, capturable AdamW) runs eagerly under
    ``set_sync_debug_mode("error")`` before any capture; after the capture,
    two launches (copy-in, replay, metrics copy-out, the schedule's step)
    pass under it too, and their metrics read back finite."""
    import copy

    from colbert_torch.training import trainer as pt

    enc, batches = _train_setup(cuda_device, "bfloat16", n_batches=2)
    twin = copy.deepcopy(enc.model)
    opt = pt.default_optimizer(twin.parameters(), 1e-3, 0.01, cuda_device)
    step = pt.make_device_step(twin, opt, dtype_name="bfloat16", max_grad_norm=1.0)
    trainer = pt.ColBERTTrainer(enc, learning_rate=1e-3, warmup_steps=2, total_steps=10)
    host = trainer._tensorize(batches[0])
    batch = dict(zip(host, enc._put_batch(*host.values())))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.zero_grad(set_to_none=True)
        step(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for triples in batches:
        trainer.train_step(triples)  # the warm-up, then the capture and a replay
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [trainer._launch(trainer._tensorize(t)) for t in batches]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for values, ready in pending:
        ready.synchronize()
        assert np.isfinite(values.numpy()).all()
    assert trainer.programs.programs()[0].replays == 3


@pytest.mark.cuda
def test_a_failed_training_capture_raises(cuda_device, monkeypatch):
    """A step that reads a value back cannot be captured: the key's second
    launch raises, and so does the next; nothing runs the eager step in
    their place (the parameters stay as the warm-up left them)."""
    from colbert_torch.training import trainer as pt

    enc, batches = _train_setup(cuda_device, n_batches=1)
    loss_on_embeddings = pt.loss_on_embeddings

    def syncing(*a, **kw):
        loss, metrics = loss_on_embeddings(*a, **kw)
        loss.item()
        return loss, metrics

    monkeypatch.setattr(pt, "loss_on_embeddings", syncing)
    trainer = pt.ColBERTTrainer(enc, learning_rate=1e-3)
    trainer.train_step(batches[0])  # the warm-up is eager: a read-back is allowed there
    before = [p.detach().clone() for p in enc.model.parameters()]
    for _ in range(2):
        with pytest.raises(RuntimeError):
            trainer.train_step(batches[0])
    torch.cuda.synchronize()
    assert all(torch.equal(a, p) for a, p in zip(before, enc.model.parameters()))
    (prog,) = trainer.programs.programs()
    assert prog.graph is None and prog.replays == 0


@pytest.mark.cuda
def test_a_non_capturable_optimizer_is_refused_on_the_card(cuda_device):
    """A factory optimizer that is not capturable is refused at
    construction, naming ``capturable=True``; built capturable, it trains
    through the captured step as given."""
    from colbert_torch.training import ColBERTTrainer

    enc, batches = _train_setup(cuda_device, n_batches=3)
    before = [p.detach().clone() for p in enc.model.parameters()]
    with pytest.raises(ValueError, match="capturable=True"):
        ColBERTTrainer(enc, optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))
    assert all(torch.equal(a, p) for a, p in zip(before, enc.model.parameters()))
    trainer = ColBERTTrainer(enc, optimizer=lambda p: torch.optim.Adam(p, lr=1e-3,
                                                                        capturable=True))
    losses = [trainer.train_step(t)["loss"] for t in batches]
    assert np.isfinite(losses).all()
    assert trainer.programs.programs()[0].replays == 2


# --- the captured doc encode ------------------------------------------------


def _doc_encoder(device, *, layers=2, **kw):
    """A bert-base-wide encoder of ``layers`` layers over the tiny
    vocabulary, full batches of 64 (bf16 activations, bf16 transfer)."""
    from colbert_torch.config import ColBERTConfig
    from colbert_torch.models.bert import BertConfig
    from colbert_torch.utils.testing import make_encoder, make_vocab

    cfg = dict(dim=128, nbits=2, doc_maxlen=128, index_bsize=64, length_bucket=32,
               kmeans_niters=4)
    cfg.update(kw)
    return make_encoder(dim=128, config=ColBERTConfig(**cfg),
                        bert_config=BertConfig(vocab_size=len(make_vocab()),
                                               num_hidden_layers=layers), device=device)


def _bytes_of(out) -> list:
    """Every array of a doc encode's result, as (dtype, shape, bytes)."""
    if isinstance(out, torch.Tensor):
        t = out.cpu()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return [(str(out.dtype), tuple(t.shape), t.numpy().tobytes())]
    if isinstance(out, (tuple, list)):
        return [b for o in out for b in _bytes_of(o)]
    a = np.asarray(out)
    return [(str(a.dtype), a.shape, a.tobytes())]


def _doc_encodes(enc, passages, cent, cutoffs):
    return {
        "encode_passages": enc.encode_passages(passages),
        "encode_passages_compressed": enc.encode_passages_compressed(passages, cent, cutoffs,
                                                                     nbits=2),
        "encode_passages_to_device": enc.encode_passages_to_device(passages,
                                                                   return_layout=True),
    }


def _codec_of(enc, passages, device, k=256):
    """Unit centroids near the collection's embeddings and quartile cutoffs."""
    flat, _ = enc.encode_passages(passages)
    cent = flat[:: max(1, len(flat) // k)][:k]
    cent = cent / np.linalg.norm(cent, axis=1, keepdims=True)
    codes = np.argmax(flat @ cent.T, axis=1)
    cutoffs = np.quantile(flat - cent[codes], [0.25, 0.5, 0.75]).astype(np.float32)
    return torch.from_numpy(cent.astype(np.float32)).to(device), torch.from_numpy(cutoffs).to(device)


@pytest.mark.cuda
def test_replayed_doc_encodes_equal_the_eager_route(cuda_device, monkeypatch):
    """600 passages (nine full batches of 64, a partial one of 24): each
    doc encode's second pass, every full batch a replay, gives the same
    bytes as every batch op by op (``MAX_GRAPH_TOKENS`` 0): the same
    kernels on the same inputs, cuBLAS keeping its algorithm under
    capture."""
    from colbert_torch.models import encoder as enc_mod
    from colbert_torch.utils import tracing
    from colbert_torch.utils.testing import synthetic_collection

    enc = _doc_encoder(cuda_device)
    passages = synthetic_collection(600, seed=7, words_per_doc=60)
    cent, cutoffs = _codec_of(enc, passages, cuda_device)
    _doc_encodes(enc, passages, cent, cutoffs)  # the keys' warm-ups and captures
    with tracing.recording() as rec:
        got = _doc_encodes(enc, passages, cent, cutoffs)
    torch.cuda.synchronize()
    c = rec.counters
    assert "doc_captures" not in c and c["doc_replays"] == 3 * 9
    assert c["doc_eager_batches"] == 3 and c["doc_batches"] == 3 * 10
    assert all(p.graph is not None for p in enc.programs.programs())
    stats = enc.programs.stats()
    assert stats["held"] == stats["built"] > 0 and stats["pool_bytes"] > 0
    monkeypatch.setattr(enc_mod, "MAX_GRAPH_TOKENS", 0)
    want = _doc_encodes(enc, passages, cent, cutoffs)
    for name in got:
        assert _bytes_of(got[name]) == _bytes_of(want[name]), name


@pytest.mark.cuda
def test_captured_build_chunks_equal_the_eager_chunks(cuda_device, tmp_path, monkeypatch):
    """A 3,000-passage ``Indexer.index`` in 3 chunks (the small-collection
    path off, so the chunks are encoded again after the sample), every full
    doc batch replayed, then the same index's chunks encoded again op by op
    against the codec it saved (a resumed build: k-means' atomic sums are
    not repeatable, so a second codec would differ): doclens, codes,
    residuals and the IVF are the same bytes."""
    import os
    import shutil

    from colbert_torch.indexing import builder
    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.models import encoder as enc_mod
    from colbert_torch.storage import format as fmt
    from colbert_torch.utils import tracing
    from colbert_torch.utils.testing import synthetic_collection

    monkeypatch.setattr(builder, "FAST_PATH_MAX_ROWS", 0)
    enc = _doc_encoder(cuda_device, chunksize=1000)
    passages = synthetic_collection(3000, seed=8, words_per_doc=60)
    captured, eager = str(tmp_path / "captured"), str(tmp_path / "eager")
    with tracing.recording() as rec:
        Indexer(enc.config, encoder=enc, collection=passages, device=cuda_device).index(captured)
    c = rec.counters
    assert c["doc_replays"] + c["doc_eager_batches"] == c["doc_batches"]
    assert c["doc_replays"] >= 0.8 * c["doc_batches"]
    plan = fmt.load_plan(captured)
    assert plan["num_chunks"] == 3
    shutil.copytree(captured, eager)
    for i in range(plan["num_chunks"]):
        for name in (f"{i}.codes.npy", f"{i}.residuals.npy", f"doclens.{i}.npy",
                     f"{i}.metadata.json"):
            os.remove(os.path.join(eager, name))
    for name in ("ivf.npy", "ivf_lengths.npy"):
        os.remove(os.path.join(eager, name))
    monkeypatch.setattr(enc_mod, "MAX_GRAPH_TOKENS", 0)
    with tracing.recording() as rec:
        Indexer(enc.config, encoder=enc, collection=passages, device=cuda_device).index(eager)
    assert "doc_replays" not in rec.counters and "sample_encode" not in {
        s.name for s in rec.spans}
    for i in range(plan["num_chunks"]):
        a, b = fmt.load_chunk(captured, i), fmt.load_chunk(eager, i)
        for key in ("codes", "residuals", "doclens"):
            assert np.asarray(a[key]).tobytes() == np.asarray(b[key]).tobytes(), (i, key)
    for x, y in zip(fmt.load_ivf(captured), fmt.load_ivf(eager)):
        np.testing.assert_array_equal(x, y)
    codes = fmt.load_all_codes(captured)
    np.testing.assert_array_equal(fmt.load_ivf(captured)[0], np.argsort(codes, kind="stable"))


@pytest.mark.cuda
def test_a_doc_replay_makes_no_host_synchronization(cuda_device):
    """After a key's capture, a doc batch's step (copy-in from pinned
    staging, replay, device outputs) and the host copy an encode starts from
    them pass under ``torch.cuda.set_sync_debug_mode("error")``, and read
    back the eager warm-up's bytes: the bf16 rows of ``encode_passages``
    and the fp32 rows the codec reads."""
    from colbert_torch.models.encoder import _start_host_copy
    from colbert_torch.utils.testing import synthetic_collection

    enc = _doc_encoder(cuda_device)
    assert enc.config.activation_dtype == "bfloat16" and not enc._flash_for(128)
    passages = synthetic_collection(64, seed=9, words_per_doc=60)
    ((_, ids, mask, keep),) = list(enc._doc_batches(passages))
    cast = enc._doc_step(compact=True, out_dtype_name="bfloat16")
    rows = enc._doc_step(compact=True)
    with torch.no_grad():
        first, ready = _start_host_copy(cast(ids, mask, keep)[0])
        ready.synchronize()
        want = first.clone()
        dev, _ = rows(ids, mask, keep)
        want_dev = dev.clone()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, ready = _start_host_copy(cast(ids, mask, keep)[0])
            dev, _ = rows(ids, mask, keep)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ready.synchronize()
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(dev, want_dev)
    assert [p.replays for p in enc.programs.programs()] == [1, 1]


@pytest.mark.cuda
def test_a_flash_routed_batch_replays_to_the_eager_result(cuda_device, monkeypatch):
    """Two full batches of 64 x 512 through the flash kernel (bf16, hd 64,
    ``flash_min_seqlen`` 512): the captured route (the first batch its
    warm-up and capture, the second a replay) gives the eager route's bytes
    and counts the same ``mma`` launches, one per layer and batch."""
    from colbert_torch.models import encoder as enc_mod
    from colbert_torch.utils.testing import synthetic_collection

    enc = _doc_encoder(cuda_device, doc_maxlen=512, use_pallas=True, flash_min_seqlen=512,
                       length_bucket=128)
    passages = synthetic_collection(128, seed=10, words_per_doc=1400)
    assert [ids.shape for _, ids, _, _ in enc._doc_batches(passages)] == [(64, 512)] * 2
    launches = {}
    outs = {}
    for route in ("captured", "eager"):
        if route == "eager":
            monkeypatch.setattr(enc_mod, "MAX_GRAPH_TOKENS", 0)
        before = dict(fa.flash_attention.variant_launches)
        outs[route] = enc.encode_passages(passages)
        torch.cuda.synchronize()
        launches[route] = {v: fa.flash_attention.variant_launches[v] - before[v]
                           for v in before}
    assert launches["captured"] == launches["eager"] == {"mma": 2 * 2, "simt": 0}
    (prog,) = enc.programs.programs()
    assert prog.graph is not None and prog.replays == 1
    assert _bytes_of(outs["captured"]) == _bytes_of(outs["eager"])


# --- k-means' assignment: the nearest-centroid kernel ---

# exactly tied centroid pairs (the second a copy of the first): in one n8
# tile, across a quad's lanes, across the tile's two warps, across tiles
KMEANS_TIES = [(0, 1), (2, 4), (5, 40), (6, 700), (8, 16383)]


def _kmeans_case(device, n, k, dim, seed):
    """Unit centroids and rows each near one of them (noise of norm ~0.3),
    with the pairs of ``KMEANS_TIES`` below k made exact copies and row i
    of the i-th pair placed on it -> (rows fp32, centroids, pairs)."""
    g = torch.Generator(device=device).manual_seed(seed)
    cent = torch.nn.functional.normalize(torch.randn((k, dim), generator=g, device=device), dim=-1)
    noise = torch.randn((n, dim), generator=g, device=device) * (0.3 / dim ** 0.5)
    rows = cent[torch.randint(0, k, (n,), generator=g, device=device)] + noise
    rows = torch.nn.functional.normalize(rows, dim=-1)
    pairs = [(a, b) for a, b in KMEANS_TIES if b < k][:n]
    for i, (a, b) in enumerate(pairs):
        cent[b] = cent[a]
        rows[i] = cent[a]
    return rows, cent, pairs


def _plain_scores(rows, cent):
    """The plain version's scores on the card: fp32 ``addmm``, TF32 off."""
    ct, neg_c_sq = km._centroid_terms(cent)
    return torch.addmm(neg_c_sq, rows.float(), ct, alpha=2.0)


def _check_against_plain(rows, cent, pairs, got):
    scores = _plain_scores(rows, cent)
    want = scores.argmax(dim=-1)
    for i, (a, _) in enumerate(pairs):
        assert int(got[i]) == int(want[i]) == a, (i, a, int(got[i]), int(want[i]))
    off = (got != want).nonzero().flatten()
    sa, sb = scores[off, want[off]], scores[off, got[off]]
    near = (sa - sb).abs() <= 1e-5 * torch.maximum(sa.abs(), sb.abs())
    assert bool(near.all()), (off[~near][:5], sa[~near][:5], sb[~near][:5])
    return int(off.numel())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [32, 128])
@pytest.mark.parametrize("k", [1, 7, 1000, 16384])
def test_nearest_centroid_kernel_matches_plain(cuda_device, dtype, dim, k):
    """One launch assigns 3,001 rows (not a multiple of any tile) against
    the plain version's argmax: planted exact ties go to the lower index,
    and every other disagreement is a near tie of the plain scores (1e-5
    relative)."""
    from colbert_torch.utils import tracing

    rows, cent, pairs = _kmeans_case(cuda_device, 3001, k, dim, seed=k + dim)
    rows = rows.to(dtype)
    with tracing.recording() as rec:
        got = km.assign_clusters(rows, cent)
    torch.cuda.synchronize()
    assert rec.counters["kmeans_assign_launches"] == 1
    assert got.dtype == torch.int64 and got.shape == (3001,)
    _check_against_plain(rows, cent, pairs, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim,n", [(16, 1), (48, 255), (96, 257), (256, 700), (128, 64)])
def test_nearest_centroid_kernel_takes_every_width(cuda_device, dtype, dim, n):
    """Every width up to 256 in steps of 16 reaches the kernel (fp32 rows at
    256 take its 64-row tile), against the plain version as above."""
    rows, cent, pairs = _kmeans_case(cuda_device, n, 300, dim, seed=dim * 3 + n)
    rows = rows.to(dtype)
    _check_against_plain(rows, cent, pairs, km.assign_clusters(rows, cent))


@pytest.mark.cuda
def test_nearest_centroid_refusals(cuda_device):
    rows = torch.zeros((8, 40), device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 16"):
        km.assign_clusters(rows, rows[:2])
    with pytest.raises(ValueError, match="multiples of 16"):
        km.assign_clusters(torch.zeros((8, 272), device=cuda_device),
                           torch.zeros((2, 272), device=cuda_device))
    with pytest.raises(ValueError, match="centroids are on"):
        km.assign_clusters(torch.zeros((8, 32), device=cuda_device), torch.zeros((2, 32)))
    assert km.assign_clusters(torch.zeros((0, 32), device=cuda_device),
                              torch.zeros((2, 32), device=cuda_device)).shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lloyd_step_through_the_kernel_matches_plain(cuda_device, dtype):
    """256 separated clusters at dim 128, each centroid starting near its
    cluster's center, a tenth of the rows at weight 0: one Lloyd step on
    the card (the kernel, then the scatter) against the plain version's on
    the CPU, the same assignments, centroids within 1e-5, the shift too."""
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((256, 128)).astype(np.float32)
    data = centers[rng.integers(0, 256, 60_001)] + 0.1 * rng.standard_normal(
        (60_001, 128)).astype(np.float32)
    w = (rng.random(60_001) > 0.1).astype(np.float32)
    c0 = centers + 0.05 * rng.standard_normal((256, 128)).astype(np.float32)
    x = torch.from_numpy(data).to(dtype)
    assign = km.assign_clusters(x.to(cuda_device), torch.from_numpy(c0).to(cuda_device)).cpu()
    assert torch.equal(assign, km.assign_clusters(x, torch.from_numpy(c0)))
    got, gshift = km.lloyd_step(x.to(cuda_device), torch.from_numpy(c0).to(cuda_device), k=256,
                                weights=torch.from_numpy(w).to(cuda_device))
    want, wshift = km.lloyd_step(x, torch.from_numpy(c0), k=256, weights=torch.from_numpy(w))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert abs(gshift - wshift) <= 1e-5


@pytest.mark.cuda
def test_assign_clusters_writes_no_score_tile(cuda_device):
    """2^21 bf16 rows against 4,096 centroids: the device memory that
    ``assign_clusters`` adds at its peak stays under n x 16 bytes plus the
    centroid terms (the scores would take 32 GB; the plain version's
    chunks 64 MB), and the launch makes no host synchronization."""
    n, k = 1 << 21, 4096
    rows, cent, _ = _kmeans_case(cuda_device, n, k, 128, seed=3)
    rows = rows.to(torch.bfloat16)
    km.assign_clusters(rows[:1024], cent)  # builds the library
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = km.assign_clusters(rows, cent)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    terms = k * 128 * nc.TERMS * 2 + k * 4
    assert rise < n * 16 + terms, (rise, n * 16 + terms)
    assert out.shape == (n,)
    sample = torch.arange(0, n, 997, device=cuda_device)
    _check_against_plain(rows[sample], cent, [], out[sample])


@pytest.mark.cuda
def test_assign_counters_add_up(cuda_device):
    """One launch a Lloyd pass, as the tracing counters count it: rows =
    the padded sample's rows, pairs = rows x K; a codec training over 5,000
    rows (padded to 8,192) for 3 iterations counts 3."""
    from colbert_torch.indexing.codec_trainer import sample_bucket_step, train_codec
    from colbert_torch.utils import tracing

    rows, cent, _ = _kmeans_case(cuda_device, 5000, 300, 128, seed=8)
    rows = rows.to(torch.bfloat16)
    w = torch.ones(5000, device=cuda_device)
    with tracing.recording() as rec:
        km.lloyd_step(rows, cent, k=300, weights=w)
    assert rec.counters == {"kmeans_assign_launches": 1, "kmeans_assign_rows": 5000,
                            "kmeans_assign_pairs": 5000 * 300}
    padded = -(-5000 // sample_bucket_step(5000)) * sample_bucket_step(5000)
    with tracing.recording() as rec:
        train_codec(rows, rows[:200], num_partitions=300, nbits=2, kmeans_niters=3, tol=0.0,
                    sample_weights=w, init_idx=np.arange(300))
    c = rec.counters
    assert c["kmeans_iters"] == 3 and c["kmeans_assign_launches"] == 3
    assert c["kmeans_assign_rows"] == 3 * padded == 3 * 8192
    assert c["kmeans_assign_pairs"] == 3 * padded * 300


# --- the expert layer (DeepSeek-V3's MoE) ---


def _moe_case(device, T, seed=0, H=256, I=128, E=16, k=4):
    """Rows, routing and bf16 expert stacks; expert 3 gets no row."""
    from colbert_torch.ops import moe

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(T, H, generator=g, device=device).to(torch.bfloat16)
    gate_up = (torch.randn(E, 2 * I, H, generator=g, device=device) * 0.05).to(torch.bfloat16)
    down = (torch.randn(E, H, I, generator=g, device=device) * 0.05).to(torch.bfloat16)
    gate = torch.randn(E, H, generator=g, device=device) * 0.05
    choice, w = moe.route(x, gate, torch.randn(E, generator=g, device=device) * 0.02, k, 2.446)
    choice = torch.where(choice == 3, torch.full_like(choice, E), choice)
    # a row that chose 3 takes an expert it has not chosen
    for t, j in (choice == E).nonzero().tolist():
        free = sorted(set(range(E)) - {3} - set(choice[t].tolist()))
        choice[t, j] = free[0]
    return x, choice, w, gate_up, down


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 1000, 4096])
def test_moe_grouped_route_matches_the_loop_on_the_card(cuda_device, T):
    """The grouped route (``torch._grouped_mm`` over the slots sorted by
    expert, an empty group among them) against the plain loop on the card:
    within one bf16 rounding step of the expert outputs (2^-7 of the
    largest), with no host synchronization."""
    from colbert_torch.ops import moe

    x, choice, w, gate_up, down = _moe_case(cuda_device, T)
    want = moe.experts_loop(x, choice, w, gate_up, down)
    moe.experts_grouped(x, choice, w, gate_up, down)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.experts_grouped(x, choice, w, gate_up, down)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2 ** -7 * float(want.abs().max())


def _moe_encoder(device, **kw):
    """A small DeepSeek-V3 encoder (3 layers: dense, then two MoE layers of
    16 experts, top-4, 2 shared; MLA 64/32/16/32) with bf16 matrices, full
    doc batches of 16, bf16 activations."""
    from colbert_torch.config import ColBERTConfig
    from colbert_torch.models.colbert import init_colbert
    from colbert_torch.models.deepseek_v3 import DeepseekV3Config
    from colbert_torch.models.encoder import ColBERTEncoder
    from colbert_torch.tokenization.wordpiece import WordPieceTokenizer
    from colbert_torch.utils.testing import make_vocab

    vocab = make_vocab(2000)
    arch = DeepseekV3Config(vocab_size=len(vocab), hidden_size=256, intermediate_size=512,
                            moe_intermediate_size=128, num_hidden_layers=3,
                            num_attention_heads=4, num_key_value_heads=4, n_routed_experts=16,
                            num_experts_per_tok=4, kv_lora_rank=64, qk_nope_head_dim=32,
                            qk_rope_head_dim=16, v_head_dim=32, max_position_embeddings=512)
    model = init_colbert(arch, 128, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith("scale"):
                p.data = p.data.to(torch.bfloat16)
        for layer in model.bert.layers[1:]:
            layer.mlp.router_bias.normal_(0, 0.02, generator=torch.Generator().manual_seed(4))
    cfg = dict(dim=128, nbits=2, doc_maxlen=256, index_bsize=16, length_bucket=32,
               kmeans_niters=2)
    cfg.update(kw)
    return ColBERTEncoder(model, WordPieceTokenizer(vocab), ColBERTConfig(**cfg), device=device)


@pytest.mark.cuda
def test_a_moe_doc_batch_replays_to_the_eager_result(cuda_device, monkeypatch):
    """Full batches of 16 through the small DeepSeek-V3 encoder: the second
    pass of each doc encode, every full batch a replay of a captured
    program (the expert layer inside it), gives the same bytes as every
    batch op by op; a replay under ``set_sync_debug_mode("error")``; the
    captured program counts its MoE work on each replay."""
    from colbert_torch.models import encoder as enc_mod
    from colbert_torch.utils import tracing
    from colbert_torch.utils.testing import synthetic_collection

    enc = _moe_encoder(cuda_device)
    passages = synthetic_collection(40, seed=7, words_per_doc=60)
    cent, cutoffs = _codec_of(enc, passages, cuda_device, k=64)
    _doc_encodes(enc, passages, cent, cutoffs)  # the keys' warm-ups and captures
    with tracing.recording() as rec:
        got = _doc_encodes(enc, passages, cent, cutoffs)
    torch.cuda.synchronize()
    c = rec.counters
    assert "doc_captures" not in c and c["doc_replays"] == 3 * 2
    assert c["moe_layer_calls"] == 2 * c["doc_batches"] == 2 * 3 * 3
    assert c["moe_grouped_launches"] == 2 * c["moe_layer_calls"]
    assert c["attn_mla_calls"] == 3 * c["doc_batches"]
    ((_, ids, mask, keep), *_) = list(enc._doc_batches(passages))
    step = enc._doc_step(compact=True)
    with torch.no_grad():
        want, _ = step(ids, mask, keep)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again, _ = step(ids, mask, keep)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(again, want)
    monkeypatch.setattr(enc_mod, "MAX_GRAPH_TOKENS", 0)
    eager = _doc_encodes(enc, passages, cent, cutoffs)
    for name in got:
        assert _bytes_of(got[name]) == _bytes_of(eager[name]), name


@pytest.mark.cuda
def test_a_moe_encoder_indexes_and_serves_captured_queries(cuda_device, tmp_path):
    """The small DeepSeek-V3 encoder indexes 48 passages through
    ``Indexer.index`` on the card and serves query batches through the
    captured serving program (its query encode runs the expert layer):
    the graphed ``search_batch``, warm-up then replays, equals the eager
    entry up to ties at 1e-4."""
    from colbert_torch.indexing.builder import Indexer
    from colbert_torch.retrieval.searcher import Searcher
    from colbert_torch.utils import tracing
    from colbert_torch.utils.testing import synthetic_collection

    enc = _moe_encoder(cuda_device)
    passages = synthetic_collection(48, seed=8, words_per_doc=80)
    path = str(tmp_path / "index")
    Indexer(enc.config, encoder=enc, collection=passages, device=cuda_device).index(path)
    s = Searcher(path, encoder=enc, config=enc.config, device=cuda_device)
    queries = [" ".join(p.split()[:10]) for p in passages[:12]]
    for _ in range(3):
        with tracing.recording() as rec:
            got = s.search_batch(queries, k=5)
        _agree_up_to_ties(*got, *_eager(s, queries, k=5))
    assert rec.counters["program_replays"] == 1
    assert rec.counters["moe_grouped_launches"] == 2 * 2
    stats = s.device_index.programs.stats()
    assert stats["built"] == stats["held"] == 1 and stats["replays"] == 2


@pytest.mark.cuda
def test_expert_kernel_launches_match_the_counters(cuda_device, monkeypatch):
    """Under the profiler, one doc batch op by op and one replayed launch
    exactly ``moe_grouped_launches`` device operations that the benchmark's
    ``moe.expert_roofline.build`` takes for grouped products, and the
    counters count them: two per MoE layer and batch."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import registry
    from colbert_torch.models import encoder as enc_mod
    from colbert_torch.utils import tracing
    from colbert_torch.utils.testing import synthetic_collection

    is_expert = registry.metric("moe.expert_roofline.build").is_expert_product
    enc = _moe_encoder(cuda_device)
    ((_, ids, mask, keep),) = list(enc._doc_batches(synthetic_collection(16, seed=9,
                                                                         words_per_doc=60)))
    step = enc._doc_step(compact=True)

    def profiled():
        tracing.take()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(ids, mask, keep)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() != torch.autograd.DeviceType.CPU]
        return tracing.take().counters, names

    with torch.no_grad():
        with monkeypatch.context() as m:
            m.setattr(enc_mod, "MAX_GRAPH_TOKENS", 0)
            eager = profiled()
        step(ids, mask, keep)  # the key's warm-up and capture
        replayed = profiled()
    assert replayed[0]["doc_replays"] == 1 and "doc_replays" not in eager[0]
    for c, names in (eager, replayed):
        assert c["moe_grouped_launches"] == 2 * 2
        assert sum(map(is_expert, names)) == c["moe_grouped_launches"], names
