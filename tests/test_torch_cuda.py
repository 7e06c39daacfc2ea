"""Tests that need an NVIDIA GPU: the stage-2 CUDA kernels vs their plain
PyTorch version (TF32 off, tolerance 1e-4) on the cases of the CPU parity
tests, each case through the kernel its shapes select (tensor-core ``mma``
for dim 128 and Lq <= 32, ``simt`` otherwise); the flash-attention kernel vs its plain version (fp32 inputs to
1e-4; bf16 inputs within 8e-3 * max(1, |plain|), one bf16 rounding step of
the output, against the plain version on the fp32 upcast of the same
inputs), each case through the kernel its dtype and head dim select
(tensor-core ``mma`` for bf16/fp16 at hd 32/64/128, ``simt`` otherwise);
and the device and alignment rules of the wrappers. Every test skips without a
GPU. This file imports no JAX; on a machine without JAX run it as

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
