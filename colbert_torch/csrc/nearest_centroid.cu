// Nearest centroid per row, k-means' assignment step, for Hopper (sm_90a).
//
// Replaces no TPU kernel: colbert_tpu/ops/kmeans.py:_assign_chunk leaves
// the step to XLA (jnp.dot, then jnp.argmax over the (rows, K) scores).
// On the H100 that step ran as an fp32 SIMT GEMM into an (n, K) score tile
// and a separate argmax reading it back; this kernel computes the same
// scores on the tensor cores and folds the argmax into the product, so no
// score ever reaches device memory.
//
// Contract, for n rows x (n, D) bf16 and a prepared stream of centroid
// terms and biases (colbert_torch/ops/nearest_centroid.py):
//   out[i] = argmax_j (2 * sum_t <x_i, c_t[j]> + bias[j]),
// the lowest j among exact ties, as torch.argmax takes it. k-means passes
// bias = -|c|^2, so the scores are those of the fp32 product it replaces.
//
// Precision: each fp32 centroid is the sum of three bf16 terms c1 + c2 +
// c3 (each the bf16 rounding of what the earlier ones leave), which keeps
// it to ~2^-27 relative; a bf16 row is exact, so each product x * c_t is
// exact in fp32 and only the fp32 accumulation rounds, as in an fp32
// GEMM. fp32 rows arrive split the same way, as D = 3 dim columns [x1 |
// x2 | x3] against terms whose blocks pair x_i with c_t only where
// i + t <= 2 (the wrapper writes zeros elsewhere): six products of the
// nine, the dropped ones below 2^-27.
//
// What bounds it: the products. At the build's shape (1.8 M rows, K =
// 16,384, dim 128) one pass is 7.5 TFLOP of model work, 22.6 TFLOP of
// bf16 tensor-core work over three terms; rows are read once and nothing
// but one int64 per row is written. The centroid terms (12 MB at that
// shape) are read by every block from L2, so a block takes a tall tile of
// rows (kBM = 256) to halve that traffic against 128-row tiles.
//
// Design: a block keeps its kBM rows in shared memory for the whole pass
// (one 32-byte slab per row and 16 dims, the two 16-byte halves swapped
// on rows with bit 2 set, so ldmatrix reads are free of bank conflicts)
// and walks all centroid tiles of kBN = 64 in order. The centroid stream
// is laid out by the wrapper in exactly the order and swizzle the block
// reads it: one 6 KB stage per (tile, 16-dim slab) holding the three
// terms' 64 x 16 values. One producer thread moves the stages into a ring
// with cp.async.bulk, completing on an mbarrier per stage; the consumer
// warps (2 across the tile's columns, kWarpsM down its rows, each 64 rows
// x 32 centroids) wait on it, take the A fragments once per slab and
// multiply them by the three terms' B fragments with mma.sync.m16n8k16
// (bf16 in, fp32 accumulate), then release the stage to the producer.
// After a tile's last slab each thread folds 2 acc + bias into its rows'
// running (max, index) in registers, its columns visited in increasing
// order with a strict >, so the lowest index of a tie stays. At the end
// the four lanes sharing a row and the two warps sharing it merge by
// (larger score, then smaller index), and one lane writes the row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTerms = 3;                      // bf16 terms of each centroid
constexpr int kBN = 64;                        // centroids per tile
constexpr int kWarpsN = 2;                     // warps across a tile's columns
constexpr int kWN = kBN / kWarpsN;             // a warp's centroids per tile
constexpr int kNT = kWN / 8;                   // its n8 tiles
constexpr int kMT = 4;                         // its m16 tiles: 64 rows
constexpr int kSlab = 32;                      // bytes of one row's 16 dims
constexpr int kStageBytes = kTerms * kBN * kSlab;
constexpr int kMaxStages = 16;
constexpr int kMinStages = 4;
constexpr int kMaxDim = 768;                   // D: 3 x 256 for fp32 rows
constexpr int kBarBytes = 2 * kMaxStages * 8;  // full and empty barriers
static_assert(kStageBytes % 128 == 0, "stages stay 128-byte aligned");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the barrier's phase of this parity has completed. A stage
// that never completes (a fault in the ring's bookkeeping) traps after
// ~2^36 cycles (~35 s), so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 36)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// global -> shared, completing `bytes` on the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: A 16x16 row-major, B 16x8 column-major, bf16 in, fp32 out.
// With g = lane/4, t = lane%4: a = {(g, 2t..), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..)}, b = {(k 2t.., n g), (k 2t+8.., n g)}, d = {(g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (v, i) takes (ov, oi) where it scores higher, or as high at a lower index
__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int WARPS_M>
__global__ void __launch_bounds__(32 * (WARPS_M * kWarpsN + 1), 1)
nearest_centroid_kernel(const __nv_bfloat16* __restrict__ rows,
                        const uint8_t* __restrict__ terms, const float* __restrict__ bias,
                        int64_t* __restrict__ out, int n, int dim, int ntiles, int stages) {
  constexpr int kBM = 64 * WARPS_M;
  constexpr int kConsumerWarps = WARPS_M * kWarpsN;
  constexpr int kConsumers = 32 * kConsumerWarps;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint8_t* ring = smem + kBarBytes;
  const int slabs = dim / 16;
  uint8_t* a_s = ring + stages * kStageBytes;
  float* best_s = reinterpret_cast<float*>(a_s + slabs * kBM * kSlab);
  int* idx_s = reinterpret_cast<int*>(best_s + kBM);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // the producer: stage q is tile q / slabs, slab q % slabs, at q * 6 KB
    if (lane == 0) {
      const int nq = ntiles * slabs;
      int st = 0;
      uint32_t phase = 0;
      for (int q = 0; q < nq; ++q) {
        if (q >= stages) mbar_wait(smem_u32(empty + st), phase ^ 1);
        mbar_expect_tx(smem_u32(full + st), kStageBytes);
        bulk_load(smem_u32(ring + st * kStageBytes),
                  terms + static_cast<int64_t>(q) * kStageBytes, kStageBytes,
                  smem_u32(full + st));
        if (++st == stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the block's rows, zeros past n: row r, dims 16 s .. 16 s + 15 at
  // (s kBM + r) 32 bytes, half h at 16 (h ^ bit 2 of r)
  const int chunks = dim / 8;  // 16-byte chunks of a row
  for (int i = tid; i < kBM * chunks; i += kConsumers) {
    const int r = i / chunks, c = i - r * chunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = __ldg(reinterpret_cast<const uint4*>(rows + (row0 + r) * dim) + c);
    const int h = (c & 1) ^ ((r >> 2) & 1);
    *reinterpret_cast<uint4*>(a_s + ((c >> 1) * kBM + r) * kSlab + h * 16) = v;
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(kConsumers) : "memory");

  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // the 8x8 matrix this lane addresses, and its row
  const int swz = ((r8 >> 2) & 1) * 16;
  // A: matrix mi of an m16 tile holds rows + 8 (mi & 1), dims + 8 (mi >> 1)
  uint32_t a_addr[kMT];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int r = wm * 64 + mt * 16 + (mi & 1) * 8 + r8;
    a_addr[mt] = smem_u32(a_s) + r * kSlab + (((mi >> 1) * 16) ^ swz);
  }
  // B: matrix mi of n8 tiles 2p, 2p + 1 holds centroids + 8 (mi >> 1), dims + 8 (mi & 1)
  uint32_t b_off[kNT / 2];
#pragma unroll
  for (int p = 0; p < kNT / 2; ++p) {
    const int c = wn * kWN + p * 16 + (mi >> 1) * 8 + r8;
    b_off[p] = c * kSlab + (((mi & 1) * 16) ^ swz);
  }
  const uint32_t ring_u = smem_u32(ring), full_u = smem_u32(full), empty_u = smem_u32(empty);

  float best[kMT][2];
  int bidx[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    best[mt][0] = best[mt][1] = -INFINITY;
    bidx[mt][0] = bidx[mt][1] = 0;
  }
  int st = 0;
  uint32_t phase = 0;
  for (int j = 0; j < ntiles; ++j) {
    const int col0 = j * kBN + wn * kWN + 2 * t;
    float2 bj[kNT];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      bj[nt] = __ldg(reinterpret_cast<const float2*>(bias + col0 + nt * 8));
    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
          acc[mt][nt][3] = 0.f;

    for (int s = 0; s < slabs; ++s) {
      mbar_wait(full_u + st * 8, phase);
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) ldsm_x4(a[mt], a_addr[mt] + s * (kBM * kSlab));
      const uint32_t stage = ring_u + st * kStageBytes;
      // the smallest term first
#pragma unroll
      for (int tm = kTerms - 1; tm >= 0; --tm) {
        uint32_t b[kNT][2];
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p) {
          uint32_t r[4];
          ldsm_x4(r, stage + tm * (kBN * kSlab) + b_off[p]);
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_u + st * 8);
      if (++st == stages) {
        st = 0;
        phase ^= 1;
      }
    }

    // the tile's scores into each row's running best, columns ascending
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float s0 = fmaf(2.f, acc[mt][nt][2 * h], bj[nt].x);
          const float s1 = fmaf(2.f, acc[mt][nt][2 * h + 1], bj[nt].y);
          if (s0 > best[mt][h]) {
            best[mt][h] = s0;
            bidx[mt][h] = col0 + nt * 8;
          }
          if (s1 > best[mt][h]) {
            best[mt][h] = s1;
            bidx[mt][h] = col0 + nt * 8 + 1;
          }
        }
  }

  // merge over the quad's lanes, then over the two warps sharing the rows
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        merge(best[mt][h], bidx[mt][h], __shfl_xor_sync(0xffffffffu, best[mt][h], o),
              __shfl_xor_sync(0xffffffffu, bidx[mt][h], o));
  if (wn == 1 && t == 0) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + mt * 16 + g + 8 * h;
        best_s[r] = best[mt][h];
        idx_s[r] = bidx[mt][h];
      }
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(kConsumers) : "memory");
  if (wn == 0 && t == 0) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + mt * 16 + g + 8 * h;
        merge(best[mt][h], bidx[mt][h], best_s[r], idx_s[r]);
        if (row0 + r < n) out[row0 + r] = bidx[mt][h];
      }
  }
}

size_t smem_bytes(int bm, int dim, int stages) {
  return kBarBytes + static_cast<size_t>(stages) * kStageBytes +
         static_cast<size_t>(dim / 16) * bm * kSlab + static_cast<size_t>(bm) * 8;
}

// the most stages (up to kMaxStages) that fit beside a kBM-row tile, or 0
// where fewer than kMinStages do
int stages_for(int bm, int dim, int optin) {
  const int64_t room = static_cast<int64_t>(optin) - static_cast<int64_t>(smem_bytes(bm, dim, 0));
  const int64_t s = room < 0 ? 0 : room / kStageBytes;
  return s < kMinStages ? 0 : static_cast<int>(s < kMaxStages ? s : kMaxStages);
}

template <int WARPS_M>
int launch(const void* rows, const void* terms, const float* bias, int64_t* out, int n,
           int dim, int ntiles, int stages, cudaStream_t stream) {
  constexpr int kBM = 64 * WARPS_M;
  const size_t smem = smem_bytes(kBM, dim, stages);
  cudaError_t err = cudaFuncSetAttribute(nearest_centroid_kernel<WARPS_M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (static_cast<int64_t>(n) + kBM - 1) / kBM;
  nearest_centroid_kernel<WARPS_M><<<static_cast<unsigned>(blocks),
                                     32 * (WARPS_M * kWarpsN + 1), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(rows), static_cast<const uint8_t*>(terms), bias, out, n,
      dim, ntiles, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). rows: (n, dim) bf16, 16-byte
// aligned; terms: the wrapper's stream of k_padded / tile tiles x dim / 16
// slabs x 3 terms x tile x 16 bf16; bias: k_padded fp32 (-inf on padding);
// out: n int64. Returns 0 on success, the CUDA error of a refused launch,
// or -1 for arguments the kernel does not take (the wrapper checks first).
// The tile of rows is the tallest (256, else 64) whose rows fit in shared
// memory beside at least kMinStages stages.
extern "C" int colbert_nearest_centroid(const void* rows, const void* terms, const float* bias,
                                        void* out, int n, int dim, int k_padded, int tile,
                                        void* stream) {
  if (tile != kBN || dim <= 0 || dim % 16 != 0 || dim > kMaxDim) return -1;
  if (k_padded <= 0 || k_padded % kBN != 0 || n < 0) return -1;
  if (n == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* o = static_cast<int64_t*>(out);
  const int ntiles = k_padded / kBN;
  if (const int st = stages_for(256, dim, optin))
    return launch<4>(rows, terms, bias, o, n, dim, ntiles, st, s);
  if (const int st = stages_for(64, dim, optin))
    return launch<1>(rows, terms, bias, o, n, dim, ntiles, st, s);
  return -1;
}
