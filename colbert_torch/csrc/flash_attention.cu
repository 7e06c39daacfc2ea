// Non-causal multi-head attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel colbert_tpu/ops/flash_attention.py::_flash_kernel
// (wrapped by flash_attention). Contract, per (batch b, head h):
//   out[b,h] = softmax(q[b,h] k[b,h]^T / sqrt(hd) + bias[b]) v[b,h]
// with bias (B, S) additive over the keys: 0 for real tokens, a very large
// negative value (BERT passes finfo(float32).min) for pads. q, k, v and out
// are fp32, bf16 or fp16, addressed through (batch, head, row) strides with
// the head dim contiguous, so one kernel reads both the (B*H, S, hd) layout
// of the public function and the (B, S, H*hd) projections of BertLayer
// without a head transpose. All arithmetic is fp32: q is scaled by
// 1/sqrt(hd) as it is loaded (as the Pallas kernel does), the running max
// starts at -1e30, the running sum and the output accumulator are fp32, and
// the output is cast once at the end (round to nearest even).
//
// S must be a multiple of 128 (the reference's check, kept: the encoder's
// strict length buckets guarantee it where attention is routed here); hd is
// a multiple of 8 up to 128.
//
// What bounds it on the H100: at S=512, hd=64 in bf16 the work is 4*S*S*hd
// FLOPs per (b, h) against 4*S*hd*2 bytes of q, k, v and out, 256 FLOPs per
// byte, just under the card's 295 (989 TFLOP/s bf16 over 3.35 TB/s): the
// least time is set by the bytes, with the bf16 tensor-core time 14% below
// it, so a fast kernel has to run its products on the tensor cores and read
// each byte once. This first version reaches for neither: it runs its FMAs
// on the fp32 cores and reads K and V once per 64-row q tile. One
// block of 256 threads takes one (b*h, 64-row tile of q); q's tile sits in
// shared memory transposed, and 64-row tiles of K (transposed) and V are
// staged through shared memory in turn, so the (S, S) scores never reach
// device memory. Each thread holds a 4x4 block of scores (4 q rows, 4 keys)
// and a 4 x hd/16 block of the output in registers; the 16 threads that
// share a q row reduce its max and sum with shuffles. A 64-key tile of pads
// contributes exp(bias - m) = 0. mma.sync/wgmma, TMA and a pipelined K/V
// ring are left for a later change.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kStride = kBlockQ + 4;  // floats per row of a transposed tile
constexpr int kMaxJ = 8;              // head-dim columns per thread: hd <= 128
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ bias,
             T* __restrict__ out, int H, int S, int hd, float scale,
             int64_t sb, int64_t sh, int64_t ss,
             int64_t ob, int64_t oh, int64_t os) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                      // hd x kStride, q tile transposed
  float* kT = qT + hd * kStride;         // hd x kStride, K tile transposed
  float* vS = kT + hd * kStride;         // kBlockK x hd, V tile
  float* pT = vS + kBlockK * hd;         // kBlockK x kStride, probabilities
  float* bS = pT + kBlockK * kStride;    // kBlockK bias values

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t base = b * sb + h * sh;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;
  const float* biasb = bias + static_cast<int64_t>(b) * S;

  for (int i = tid; i < kBlockQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    qT[d * kStride + r] = to_float(qb[static_cast<int64_t>(q0 + r) * ss + d]) * scale;
  }

  float m[4], l[4], acc[4][kMaxJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done (and qT is in)
    for (int i = tid; i < kBlockK * hd; i += kThreads) {
      const int c = i / hd, d = i - c * hd;
      const int64_t off = static_cast<int64_t>(k0 + c) * ss + d;
      kT[d * kStride + c] = to_float(kb[off]);
      vS[c * hd + d] = to_float(vb[off]);
    }
    if (tid < kBlockK) bS[tid] = biasb[k0 + tid];
    __syncthreads();

    // scores for q rows ty*4+i and keys tx*4+c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * kStride + ty * 4);
      const float4 kk = *reinterpret_cast<const float4*>(kT + d * kStride + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(av[i], kv[c], s[i][c]);
    }

    // online softmax: the 16 lanes with the same ty share these 4 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rm = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] += bS[tx * 4 + c];
        rm = fmaxf(rm, s[i][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rm = fmaxf(rm, __shfl_xor_sync(0xffffffffu, rm, o));
      const float m_new = fmaxf(m[i], rm);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        rs += s[i][c];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pT + (tx * 4 + c) * kStride + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc[i][j] += sum_c p[row ty*4+i, c] * v[c, tx + 16j]
    for (int c = 0; c < kBlockK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(pT + c * kStride + ty * 4);
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vv = vS[c * hd + d];
          acc[0][j] = fmaf(p.x, vv, acc[0][j]);
          acc[1][j] = fmaf(p.y, vv, acc[1][j]);
          acc[2][j] = fmaf(p.z, vv, acc[2][j]);
          acc[3][j] = fmaf(p.w, vv, acc[3][j]);
        }
      }
    }
  }

  T* ob_ = out + b * ob + h * oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* row = ob_ + static_cast<int64_t>(q0 + ty * 4 + i) * os;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(row + d, acc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int B, int H, int S, int hd, float scale, int64_t sb,
           int64_t sh, int64_t ss, int64_t ob, int64_t oh, int64_t os,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(2 * hd + kBlockK) * kStride + kBlockK * hd + kBlockK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>(S / kBlockQ));
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<T*>(out), H, S, hd, scale, sb, sh, ss, ob, oh, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 fp32, 1 bf16, 2 fp16.
// Strides are in elements: (sb, sh, ss) for q, k and v, (ob, oh, os) for
// out. Returns 0 on success, the CUDA error code of a refused launch, or -1
// for arguments the kernel does not take (the Python wrapper checks first).
extern "C" int colbert_flash_attention(
    const void* q, const void* k, const void* v, const float* bias, void* out,
    int dtype, int B, int H, int S, int hd, float scale, int64_t sb,
    int64_t sh, int64_t ss, int64_t ob, int64_t oh, int64_t os, void* stream) {
  if (hd <= 0 || hd % 8 != 0 || hd > 16 * kMaxJ || S % 128 != 0) return -1;
  if (B < 0 || H <= 0) return -1;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, bias, out, B, H, S, hd, scale, sb, sh, ss, ob, oh, os, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, bias, out, B, H, S, hd, scale, sb, sh, ss, ob,
                                   oh, os, st);
    case 2:
      return launch<__half>(q, k, v, bias, out, B, H, S, hd, scale, sb, sh, ss, ob, oh, os,
                            st);
    default:
      return -1;
  }
}
