// Non-causal multi-head attention with an online softmax, for Hopper (sm_90a).
//
// Both kernels below replace the TPU kernel
// colbert_tpu/ops/flash_attention.py::_flash_kernel (wrapped by
// flash_attention). Contract, per (batch b, head h):
//   out[b,h] = softmax(q[b,h] k[b,h]^T / sqrt(hd) + bias[b]) v[b,h]
// with bias (B, S) additive over the keys: 0 for real tokens, a very large
// negative value (BERT passes finfo(float32).min) for pads. q, k, v and out
// are addressed through (batch, head, row) strides with the head dim
// contiguous, so one kernel reads both the (B*H, S, hd) layout of the public
// function and the (B, S, H*hd) projections of BertLayer without a head
// transpose. The softmax statistics and the output accumulator are fp32,
// the running max starts at -1e30, the output is divided by max(l, 1e-30)
// (a row whose every key is a pad writes 0) and cast once at the end (round
// to nearest even). S must be a multiple of 128 (the reference's check,
// kept: the encoder's strict length buckets guarantee it where attention is
// routed here). The Python wrapper picks the kernel from the dtype and the
// head dim alone (ops/flash_attention.py::_variant).
//
// What bounds both on the H100: at S=512, hd=64 in bf16 the work is
// 4*S*S*hd FLOPs per (b, h) against 4*S*hd*2 bytes of q, k, v and out, 256
// FLOPs per byte, just under the card's 295 (989 TFLOP/s bf16 over
// 3.35 TB/s): the least time is set by the bytes, 0.1203 ms at the build
// path's B=128, H=12 (the tensor-core time is 14% below it), so a fast
// kernel has to run its products on the tensor cores and read each byte of
// K and V from device memory about once.
//
// flash_mma_kernel<T, HD> (bf16 and fp16 at hd 32, 64, 128): both products
// on the tensor cores with warp-level mma.sync.m16n8k16 (fp32 accumulate).
// One block of 4 warps takes one (b*h, q tile); each warp owns whole 16-row
// slices of the tile (two at hd <= 64, a 128-row tile, so every K or V
// fragment read from shared memory feeds two products; one at hd 128, a
// 64-row tile, for the registers) and all 64 keys of the current K/V tile.
// Its scores (16 x 64 per slice, 32 floats a lane) stay in registers and a
// row's max and sum reduce over the 4 lanes of a quad with two shuffles: no
// shared memory and no barrier in the softmax. Q is copied once with
// cp.async and held in registers as A fragments (ldmatrix); 64-key tiles of
// K and V (and their 64 bias values) move through a two-stage cp.async ring,
// tile j+1 in flight while tile j is computed. Shared-memory rows are padded
// by 16 bytes so ldmatrix reads are free of bank conflicts. Scores are
// scaled by 1/sqrt(hd) and biased in fp32 (not q in bf16: 1/sqrt(hd) is a
// power of two only for some hd); the exponentials are ex2.approx.ftz of
// (s - m) * log2(e), the product taken after the subtraction so that
// finfo(float32).min never meets log2(e) alone and m stays finite (exp2f's
// range fix-ups for denormal results cost more than they are worth here:
// a probability below 2^-126 adds nothing to a bf16 output). P is rounded
// to T (as BertLayer's materialized attention rounds its probabilities) and
// reused in registers as the A operand of P*V: the C layout of two adjacent
// n8 tiles equals the A layout of one k16 slice. V is the B operand through
// ldmatrix.trans. Blocks are numbered with the q tiles of one (b, h)
// fastest, so the blocks that share K and V run together and read them from
// L2: per (b, h), K and V come from device memory about once. Each warp
// still runs its products and its softmax one after the other; if the
// kernel stays under half its bound, overlapping them (and wgmma with TMA
// and a warp-specialised producer) is the next step.
//
// flash_mma_window_kernel<T, HD> is the same body with a window w (a
// window >= 0 at the entry points): query i attends to keys j with |i - j| <= w,
// ModernBERT's local layers at w = 64. Each block takes a 64-row q tile
// (one 16-row slice per warp) and its key loop visits only the 64-key tiles
// that meet [q0 - w, q0 + 63 + w]: three at w = 64, where a 128-row tile
// would visit four for twice the rows. Inside a tile that holds keys beyond
// some row's window, those scores are set to -inf after the scale and the
// bias, so they weigh exactly 0. At w = 64 and hd = 64 the window's work is
// ~64 FLOPs per byte of q, k, v and out (96 over the visited tiles), far
// under the card's 295: the bytes bound it. With no window
// (flash_mma_kernel) the body is the unwindowed code step for step: its
// output is bit for bit what it was before the window existed.
//
// flash_kernel<T> (fp32 inputs, and bf16/fp16 at any other hd, a multiple
// of 8 up to 128): fp32 FMAs on the CUDA cores. One block of 256 threads
// takes one (b*h, 64-row tile of q); q's tile sits in shared memory
// transposed and pre-scaled by 1/sqrt(hd) (as the Pallas kernel does), and
// 64-row tiles of K (transposed) and V are staged through shared memory in
// turn, so the (S, S) scores never reach device memory. Each thread holds
// a 4x4 block of scores (4 q rows, 4 keys) and a 4 x hd/16 block of the
// output in registers; the 16 threads that share a q row reduce its max and
// sum with shuffles. A 64-key tile of pads contributes exp(bias - m) = 0.
// It reads K and V once per 64-row q tile and is bound by its fp32 FMAs.
// Given a window (window >= 0) it visits and masks as the windowed mma
// kernel does.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

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
             T* __restrict__ out, int H, int S, int hd, float scale, int window,
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

  // with a window, only the key tiles that meet [q0 - window, q0 + 63 + window]
  int k_lo = 0, k_hi = S;
  if (window >= 0) {
    k_lo = max(q0 - window, 0) / kBlockK * kBlockK;
    k_hi = min(S, ((q0 + kBlockQ - 1 + window) / kBlockK + 1) * kBlockK);
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += kBlockK) {
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
        if (window >= 0 && abs(q0 + ty * 4 + i - (k0 + tx * 4 + c)) > window) s[i][c] = -INFINITY;
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
           void* out, int B, int H, int S, int hd, float scale, int window, int64_t sb,
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
      bias, static_cast<T*>(out), H, S, hd, scale, window, sb, sh, ss, ob, oh, os);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// flash_mma_kernel: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kMmaBlockK = 64;  // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (inputs and outputs below 2^-126 flush
// to 0; ex2(-inf) = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of lane l holds (row l/4, columns 2(l%4), 2(l%4)+1) of it
// (of its transpose with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for a 16x16 (row-major) A, a 16x8 (column-major) B and a 16x8
// fp32 C/D. With g = lane/4 and t = lane%4: a = {(g, 2t..2t+1),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}, b = {(k 2t..2t+1, n g),
// (k 2t+8.., n g)}, d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // lo in the low half (the lower column), rounded to nearest even
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Block shape per head dim: kWarps warps, each owning kSlices 16-row slices
// of the q tile (a K or V fragment read from shared memory feeds kSlices
// products), and the blocks per SM the register budget is set for. The
// defaults are the fastest of tune_flash.py's shapes on the H100; that
// script rebuilds this file with -DFLASH_MMA_HD=<hd> -DFLASH_MMA_WARPS=<w>
// -DFLASH_MMA_SLICES=<n> -DFLASH_MMA_MINB=<b> to time others at one hd.
// A windowed launch (WIN) takes 64-row q tiles, one slice a warp: its key
// loop covers the tiles that meet [q0 - w, q0 + 63 + w], three 64-key tiles
// at w = 64 where a 128-row tile would need four for twice the rows.
template <int HD, bool WIN = false>
struct MmaShape {
#if defined(FLASH_MMA_WARPS)
  static constexpr bool kTuned = HD == FLASH_MMA_HD && !WIN;
  static constexpr int kWarps = kTuned ? FLASH_MMA_WARPS : 4;
  static constexpr int kSlices = kTuned ? FLASH_MMA_SLICES : (HD <= 64 && !WIN ? 2 : 1);
  static constexpr int kMinBlocks = kTuned ? FLASH_MMA_MINB : 1;
#else
  static constexpr int kWarps = 4;
  static constexpr int kSlices = HD <= 64 && !WIN ? 2 : 1;
  static constexpr int kMinBlocks = 1;
#endif
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockQ = 16 * kSlices * kWarps;
  static_assert(128 % kBlockQ == 0 && kThreads >= kMmaBlockK, "q tile must divide S");
  // q tile and two stages of K and V tiles (rows padded by 8 elements), two
  // stages of bias
  static constexpr size_t smem_bytes(size_t elem) {
    return elem * (kBlockQ + 4 * kMmaBlockK) * (HD + 8) + sizeof(float) * 2 * kMmaBlockK;
  }
};

// The body of flash_mma_kernel (WIN false) and of flash_mma_window_kernel
// (WIN true: keys farther than `window` from the query are left out). With
// WIN false it is the unwindowed kernel's code, step for step.
template <typename T, int HD, bool WIN>
__device__ __forceinline__ void flash_mma_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int H, int S, float scale,
    int window, int64_t sb, int64_t sh, int64_t ss, int64_t ob, int64_t oh, int64_t os) {
  using Shape = MmaShape<HD, WIN>;
  constexpr int kThreads = Shape::kThreads;
  constexpr int kBlockQ = Shape::kBlockQ;
  constexpr int kM = Shape::kSlices;
  constexpr int kRow = HD + 8;               // elements per padded row
  constexpr int kChunks = HD / 8;            // 16-byte copies per row
  constexpr int kTile = kMmaBlockK * kRow;   // elements per K or V tile
  constexpr int kNT = kMmaBlockK / 8;        // n8 tiles of scores
  constexpr int kDT = HD / 8;                // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qS = reinterpret_cast<T*>(smem_raw);    // kBlockQ x kRow
  T* kS = qS + kBlockQ * kRow;               // 2 stages x kTile
  T* vS = kS + 2 * kTile;                    // 2 stages x kTile
  float* bS = reinterpret_cast<float*>(vS + 2 * kTile);  // 2 stages x kMmaBlockK

  // the q tiles of one (b, h) are consecutive blocks: they share K and V
  const int nq = S / kBlockQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * kBlockQ;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = b * sb + h * sh;
  const float* biasb = bias + static_cast<int64_t>(b) * S;

  auto load_rows = [&](T* dst, const T* src, int rows) {
    for (int i = tid; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      cp_async16(smem_addr(dst + r * kRow + c * 8), src + r * ss + c * 8);
    }
  };
  auto load_tile = [&](int j, int st) {
    const int64_t off = base + static_cast<int64_t>(j) * kMmaBlockK * ss;
    load_rows(kS + st * kTile, k + off, kMmaBlockK);
    load_rows(vS + st * kTile, v + off, kMmaBlockK);
    if (tid < kMmaBlockK)
      cp_async4(smem_addr(bS + st * kMmaBlockK + tid), biasb + j * kMmaBlockK + tid);
  };

  // the key tiles this q tile visits: all of them, or those that meet the
  // window around its rows
  const int nk = S / kMmaBlockK;
  int j0 = 0, j1 = nk;
  if (WIN) {
    j0 = max(q0 - window, 0) / kMmaBlockK;
    j1 = min(nk, (q0 + kBlockQ - 1 + window) / kMmaBlockK + 1);
  }

  load_rows(qS, q + base + static_cast<int64_t>(q0) * ss, kBlockQ);
  load_tile(j0, 0);
  cp_async_commit();

  // slice i of this warp: q rows r0 + 16 i + g (index 0) and + 8 (index 1)
  const int r0 = warp * 16 * kM;
  uint32_t qf[kM][HD / 16][4];
  float o[kM][kDT][4];
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    m[i][0] = m[i][1] = kNeg;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int d = 0; d < kDT; ++d) o[i][d][0] = o[i][d][1] = o[i][d][2] = o[i][d][3] = 0.f;
  }

  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    if (j + 1 < j1) load_tile(j + 1, st ^ 1);  // that stage was freed by the last barrier
    cp_async_commit();
    cp_async_wait<1>();  // everything but tile j + 1 has landed
    __syncthreads();
    if (j == j0) {
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks)
          ldsm_x4(qf[i][ks], smem_addr(qS + (r0 + 16 * i + (lane & 15)) * kRow + ks * 16 +
                                       (lane >> 4) * 8));
    }
    const T* kt = kS + st * kTile;
    const T* vt = vS + st * kTile;
    const float* bt = bS + st * kMmaBlockK;
    // an edge tile holds keys outside some row's window: those scores are -inf
    const int k0 = j * kMmaBlockK;
    const bool edge = WIN && (k0 < q0 + kBlockQ - 1 - window ||
                              k0 + kMmaBlockK - 1 > q0 + window);

    // s = q k^T: 16 kM rows x 64 keys per warp
    float s[kM][kNT][4];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n) s[i][n][0] = s[i][n][1] = s[i][n][2] = s[i][n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        // matrices: keys +0..7 / +8..15 (bit 1 of lane/8) x dims +0..7 / +8..15 (bit 0)
        uint32_t kb[4];
        const int mi = lane >> 3;
        ldsm_x4(kb, smem_addr(kt + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * kRow + ks * 16 +
                              (mi & 1) * 8));
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          Mma<T>::run(s[i][2 * np], qf[i][ks], kb[0], kb[1]);
          Mma<T>::run(s[i][2 * np + 1], qf[i][ks], kb[2], kb[3]);
        }
      }
    }

    // online softmax on the lane's rows, reduced over its quad; P in T, laid
    // out as the A fragments of the four k16 key slices
    uint32_t pf[kM][kNT / 2][4];
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      float mx0 = m[i][0], mx1 = m[i][1];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + n * 8 + 2 * t);
        s[i][n][0] = fmaf(s[i][n][0], scale, bb.x);
        s[i][n][1] = fmaf(s[i][n][1], scale, bb.y);
        s[i][n][2] = fmaf(s[i][n][2], scale, bb.x);
        s[i][n][3] = fmaf(s[i][n][3], scale, bb.y);
        if (edge) {
          const int c = k0 + n * 8 + 2 * t, ra = q0 + r0 + 16 * i + g, rb = ra + 8;
          if (abs(ra - c) > window) s[i][n][0] = -INFINITY;
          if (abs(ra - c - 1) > window) s[i][n][1] = -INFINITY;
          if (abs(rb - c) > window) s[i][n][2] = -INFINITY;
          if (abs(rb - c - 1) > window) s[i][n][3] = -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(s[i][n][0], s[i][n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[i][n][2], s[i][n][3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float a0 = ex2((m[i][0] - mx0) * kLog2e);
      const float a1 = ex2((m[i][1] - mx1) * kLog2e);
      m[i][0] = mx0;
      m[i][1] = mx1;
      l[i][0] *= a0;
      l[i][1] *= a1;
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        o[i][d][0] *= a0;
        o[i][d][1] *= a0;
        o[i][d][2] *= a1;
        o[i][d][3] *= a1;
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float p0 = ex2((s[i][n][0] - mx0) * kLog2e);
        const float p1 = ex2((s[i][n][1] - mx0) * kLog2e);
        const float p2 = ex2((s[i][n][2] - mx1) * kLog2e);
        const float p3 = ex2((s[i][n][3] - mx1) * kLog2e);
        l[i][0] += p0 + p1;
        l[i][1] += p2 + p3;
        pf[i][n >> 1][(n & 1) * 2] = Mma<T>::pack(p0, p1);
        pf[i][n >> 1][(n & 1) * 2 + 1] = Mma<T>::pack(p2, p3);
      }
    }

    // o += p v
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        // matrices: keys +0..7 / +8..15 (bit 0 of lane/8) x dims +0..7 / +8..15 (bit 1)
        uint32_t vb[4];
        const int mi = lane >> 3;
        ldsm_x4_trans(vb, smem_addr(vt + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * kRow +
                                    dp * 16 + (mi >> 1) * 8));
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          Mma<T>::run(o[i][2 * dp], pf[i][kk], vb[0], vb[1]);
          Mma<T>::run(o[i][2 * dp + 1], pf[i][kk], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // stage st is read by all warps before it is refilled
  }

#pragma unroll
  for (int i = 0; i < kM; ++i) {
    float l0 = l[i][0], l1 = l[i][1];
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    T* row0 = out + b * ob + h * oh + static_cast<int64_t>(q0 + r0 + 16 * i + g) * os;
    T* row1 = row0 + 8 * os;
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      *reinterpret_cast<uint32_t*>(row0 + d * 8 + 2 * t) =
          Mma<T>::pack(o[i][d][0] / d0, o[i][d][1] / d0);
      *reinterpret_cast<uint32_t*>(row1 + d * 8 + 2 * t) =
          Mma<T>::pack(o[i][d][2] / d1, o[i][d][3] / d1);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(MmaShape<HD>::kThreads, MmaShape<HD>::kMinBlocks)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, int H, int S, float scale,
                 int64_t sb, int64_t sh, int64_t ss,
                 int64_t ob, int64_t oh, int64_t os) {
  flash_mma_body<T, HD, false>(q, k, v, bias, out, H, S, scale, 0, sb, sh, ss, ob, oh, os);
}

// Sliding-window attention: query i attends to keys j with |i - j| <= window
// (and the bias); a name of its own, so the device trace tells its launches
// from the unwindowed kernel's.
template <typename T, int HD>
__global__ void __launch_bounds__(MmaShape<HD, true>::kThreads, MmaShape<HD, true>::kMinBlocks)
flash_mma_window_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        T* __restrict__ out, int H, int S, float scale, int window,
                        int64_t sb, int64_t sh, int64_t ss,
                        int64_t ob, int64_t oh, int64_t os) {
  flash_mma_body<T, HD, true>(q, k, v, bias, out, H, S, scale, window, sb, sh, ss, ob, oh,
                              os);
}

// window < 0: flash_mma_kernel; else flash_mma_window_kernel.
template <typename T, int HD>
int launch_mma(const void* q, const void* k, const void* v, const float* bias, void* out,
               int B, int H, int S, float scale, int window, int64_t sb, int64_t sh,
               int64_t ss, int64_t ob, int64_t oh, int64_t os, cudaStream_t stream) {
  const bool win = window >= 0;
  const size_t smem = win ? MmaShape<HD, true>::smem_bytes(sizeof(T))
                          : MmaShape<HD>::smem_bytes(sizeof(T));
  const int block_q = win ? MmaShape<HD, true>::kBlockQ : MmaShape<HD>::kBlockQ;
  const int threads = win ? MmaShape<HD, true>::kThreads : MmaShape<HD>::kThreads;
  const void* fn = win ? reinterpret_cast<const void*>(flash_mma_window_kernel<T, HD>)
                       : reinterpret_cast<const void*>(flash_mma_kernel<T, HD>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>(B) * H * (S / block_q);
  if (blocks > 0x7fffffff) return -1;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (win)
    flash_mma_window_kernel<T, HD><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
        qt, kt, vt, bias, ot, H, S, scale, window, sb, sh, ss, ob, oh, os);
  else
    flash_mma_kernel<T, HD><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
        qt, kt, vt, bias, ot, H, S, scale, sb, sh, ss, ob, oh, os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mma_hd(const void* q, const void* k, const void* v, const float* bias, void* out,
                  int B, int H, int S, int hd, float scale, int window, int64_t sb,
                  int64_t sh, int64_t ss, int64_t ob, int64_t oh, int64_t os,
                  cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_mma<T, 32>(q, k, v, bias, out, B, H, S, scale, window, sb, sh, ss, ob,
                               oh, os, stream);
    case 64:
      return launch_mma<T, 64>(q, k, v, bias, out, B, H, S, scale, window, sb, sh, ss, ob,
                               oh, os, stream);
    case 128:
      return launch_mma<T, 128>(q, k, v, bias, out, B, H, S, scale, window, sb, sh, ss, ob,
                                oh, os, stream);
    default:
      return -1;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). dtype: 0 fp32, 1 bf16, 2 fp16.
// Strides are in elements: (sb, sh, ss) for q, k and v, (ob, oh, os) for
// out. window: -1 for none, else a half-width >= 0 (a window of S or more
// leaves no key out, and is clamped to S). Each returns 0 on success, the
// CUDA error code of a refused launch, or -1 for arguments its kernel does
// not take (the Python wrapper checks first).

// flash_kernel: fp32, bf16 or fp16; hd a multiple of 8 up to 128.
extern "C" int colbert_flash_attention(
    const void* q, const void* k, const void* v, const float* bias, void* out,
    int dtype, int B, int H, int S, int hd, float scale, int window, int64_t sb,
    int64_t sh, int64_t ss, int64_t ob, int64_t oh, int64_t os, void* stream) {
  if (hd <= 0 || hd % 8 != 0 || hd > 16 * kMaxJ || S % 128 != 0) return -1;
  if (B < 0 || H <= 0 || window < -1) return -1;
  if (B == 0 || S == 0) return 0;
  if (window > S) window = S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, bias, out, B, H, S, hd, scale, window, sb, sh, ss, ob, oh,
                           os, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, bias, out, B, H, S, hd, scale, window, sb, sh, ss,
                                   ob, oh, os, st);
    case 2:
      return launch<__half>(q, k, v, bias, out, B, H, S, hd, scale, window, sb, sh, ss, ob, oh,
                            os, st);
    default:
      return -1;
  }
}

// flash_mma_kernel (window -1) / flash_mma_window_kernel: bf16 or fp16; hd
// 32, 64 or 128; every pointer 16-byte aligned and every stride a multiple
// of 8 elements (16-byte cp.async).
extern "C" int colbert_flash_attention_mma(
    const void* q, const void* k, const void* v, const float* bias, void* out,
    int dtype, int B, int H, int S, int hd, float scale, int window, int64_t sb,
    int64_t sh, int64_t ss, int64_t ob, int64_t oh, int64_t os, void* stream) {
  if (S % 128 != 0 || B < 0 || H <= 0 || window < -1) return -1;
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return -1;
  for (int64_t st : {sb, sh, ss, ob, oh, os})
    if (st % 8 != 0) return -1;
  if (B == 0 || S == 0) return 0;
  if (window > S) window = S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_mma_hd<__nv_bfloat16>(q, k, v, bias, out, B, H, S, hd, scale, window, sb,
                                          sh, ss, ob, oh, os, st);
    case 2:
      return launch_mma_hd<__half>(q, k, v, bias, out, B, H, S, hd, scale, window, sb, sh, ss,
                                   ob, oh, os, st);
    default:
      return -1;
  }
}
