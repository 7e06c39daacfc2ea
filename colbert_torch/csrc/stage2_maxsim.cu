// Stage-2 fused decompress + MaxSim for Hopper (sm_90a).
//
// Replaces the TPU kernel colbert_tpu/ops/fused_maxsim.py::_kernel (wrapped
// by stage2_maxsim_pallas) together with the XLA code around it in
// colbert_tpu/retrieval/device_index.py::_stage2_scores: the per-candidate
// slice reads, the centroid gather, the masking and the sum over query
// tokens all happen here.
//
// Contract, for a batch of B queries with NC candidates each:
//   scores[b, c] = sum_q max_{t < dls[b,c]} <Q[b,q], normalize(cent[code_t] + res_t)>
// with token t of candidate (b, c) at flat row offs[b,c] + t of `codes`
// and of the packed residual words, and 0 for a candidate whose doclen is 0.
// Residual words are uint8 bytes or little-endian 32-bit words; bucket index
// of dim d = (word[d / per_word] >> ((d % per_word) * nbits)) & (2^nbits - 1).
//
// What bounds it on the H100: the dot products. Per candidate token it reads
// 4 bytes of code + dim*nbits/8 bytes of residual (+ a centroid row that is
// mostly L2-resident) and does 2*Lq*dim FLOPs: at Lq=32, dim=128, nbits=2
// that is 8192 FLOPs per 36 bytes, far above the card's fp32 FLOP:byte
// ratio (67 TFLOP/s over 3.35 TB/s = 20), so it is bound by operations.
// The Python wrapper picks one of two kernels from the shapes alone
// (ops/fused_maxsim.py::_variant); both keep the decompressed embeddings
// out of device memory.
//
// stage2_mma_kernel<NBITS> (dim 128, Lq <= 32, any nbits and word width;
// the serving path's kernel): the dots on the tensor cores with
// mma.sync.m16n8k8 in 3xTF32, which keeps fp32 accuracy. Each fp32 operand
// x is split into hi = tf32(x) and lo = tf32(x - hi) (round to nearest,
// as cvt.rna rounds) and one fp32 accumulator takes lo*hi, then hi*lo, then
// hi*hi; the product error stays near 2^-22 relative, where one TF32
// product leaves ~2^-11 (enough to move a sum of 32 maxima by ~4e-4). Doc
// tokens are the M rows (16-row slices), query tokens the N columns (four
// n8 tiles, Lq padded with zero rows and left out of the sum), dim is K.
// The dot and the norm do not change when the dims are permuted, so the
// k8 steps walk the dims in an order that fits the fragments: lane
// (g = lane/4, t = lane%4) holds rows g and g+8 at columns t and t+4 of
// each A fragment, and logical column t + 4 h of step kk is physical dim
// 16 (kk/2) + 4 t + 2 (kk%2) + h. Two k8 steps thus take one float4 of
// each row per lane, and the quad's four float4s are 64 contiguous bytes
// of the centroid row: each warp-wide load touches 8 cache lines (with a
// lane owning a contiguous quarter of the row it touched 32).
// With the float4 the lane loads the chunk's 4*nbits residual bits (one
// byte, half word or word: dim d sits at bit d*nbits of the row for bytes
// and little-endian words alike) and decodes e = cent + w[b] straight into
// its A fragments; no embedding touches shared memory. At nbits 1 and 2
// the weights of two elements come from one 8-byte read of a table of
// (w[b0], w[b1]). Each row's sum of squares accumulates beside the
// products, reduces over the quad with two shuffles, and scales the row's
// scores after the products by 1 / max(sqrt(ss), 1e-12) (exact sqrt and
// divide), as the TPU kernel does; there is no normalise pass. Q[b] is
// loaded once per block, permuted the same way, split into hi and lo and
// stored in B-fragment order (one conflict-free 16-byte read per lane per
// n8 tile and k8 step). Warps work alone after the block's one barrier:
// each takes the block's candidates from a shared counter and walks them
// one 16-row slice at a time, its running max per query column in
// registers (rows at or past the doclen never enter it), reduced over the
// 8 row groups and summed over the valid columns when the candidate ends.
// The next kPrefetch chunks of every row, and the next slice's codes, are
// in flight while a chunk is in the products (a register ring that runs
// across slice and candidate boundaries). A row at or past min(dl,
// max_doclen) reads the candidate's first row instead, so nothing past the
// data is read. What limits it: 16 warps per SM need <= 128 registers,
// which leaves room for one 16-row slice per Q fragment read (two needed
// ~165 registers and were slower), so each fragment feeds 3 products and
// the shared-memory reads of Q are about as many as the tensor cores'
// issue slots; mma.sync peaks near 0.65 m16n8k8 per SM per clock on the
// H100, about 300 TFLOP/s of TF32 (PERF.md), so the products alone take
// ~0.3 ms of the serving batch. Blocks are sized so the grid holds
// ~kBlocksPerSm blocks per SM at the serving batch and still fills the
// card at B=1.
//
// stage2_kernel<W> (every other shape): fp32 FMAs. One block per (query,
// candidate) decodes the candidate's tokens a tile at a time into shared
// memory; the query's Lq rows sit in shared memory with a padded stride
// (conflict-free float4 reads, one query token per lane) and each warp
// blocks 4 doc rows in registers, so the inner loop issues 5 shared loads
// per 16 FMAs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // doc tokens decoded per pass
constexpr int kRows = 4;   // doc rows per warp step (register blocking)

template <typename W>
__global__ void __launch_bounds__(kThreads)
stage2_kernel(const float* __restrict__ Q, const int64_t* __restrict__ offs,
              const int32_t* __restrict__ dls, const int32_t* __restrict__ codes,
              const W* __restrict__ words, const float* __restrict__ centroids,
              const float* __restrict__ bucket_weights, float* __restrict__ out,
              int NC, int Lq, int dim, int nbits, int max_doclen) {
  extern __shared__ __align__(16) float smem[];
  const int stride = dim + 4;                // floats; keeps rows 16B-aligned
  float* q_s = smem;                         // Lq x stride
  float* e_s = q_s + Lq * stride;            // kTile x stride
  float* red = e_s + kTile * stride;         // kWarps x Lq running maxima
  float* bw_s = red + kWarps * Lq;           // 2^nbits bucket weights

  const int64_t cand = blockIdx.x;           // b * NC + c
  const int64_t b = cand / NC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int dl = dls[cand];
  if (dl > max_doclen) dl = max_doclen;
  if (dl <= 0) {                             // uniform across the block
    if (tid == 0) out[cand] = 0.f;
    return;
  }
  const int64_t off = offs[cand];

  const float* qb = Q + b * Lq * dim;
  for (int i = tid; i < Lq * dim; i += kThreads) {
    const int q = i / dim, d = i - q * dim;
    q_s[q * stride + d] = qb[i];
  }
  for (int i = tid; i < kWarps * Lq; i += kThreads) red[i] = -INFINITY;
  for (int i = tid; i < (1 << nbits); i += kThreads) bw_s[i] = bucket_weights[i];

  const int per_word = 8 * static_cast<int>(sizeof(W)) / nbits;
  const int nwords = dim / per_word;
  const uint32_t mask = (1u << nbits) - 1u;

  for (int t0 = 0; t0 < dl; t0 += kTile) {
    const int rows = min(kTile, dl - t0);
    __syncthreads();  // the previous tile's readers are done with e_s
    for (int i = tid; i < rows * dim; i += kThreads) {
      const int r = i / dim, d = i - r * dim;
      const int64_t tok = off + t0 + r;
      const int64_t code = codes[tok];
      const uint32_t w = static_cast<uint32_t>(words[tok * nwords + d / per_word]);
      const uint32_t bidx = (w >> ((d % per_word) * nbits)) & mask;
      e_s[r * stride + d] = centroids[code * dim + d] + bw_s[bidx];
    }
    __syncthreads();
    // renormalize each row (exact sqrt and divide): one warp per row
    for (int r = warp; r < rows; r += kWarps) {
      float ss = 0.f;
      for (int d = lane; d < dim; d += 32) {
        const float v = e_s[r * stride + d];
        ss = fmaf(v, v, ss);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float nrm = fmaxf(sqrtf(ss), 1e-12f);
      for (int d = lane; d < dim; d += 32) e_s[r * stride + d] = e_s[r * stride + d] / nrm;
    }
    __syncthreads();
    // dots: each warp takes kRows doc rows at a time, each lane a query token
    for (int r0 = warp * kRows; r0 < rows; r0 += kWarps * kRows) {
      for (int q = lane; q < Lq; q += 32) {
        float acc[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
        const float4* qv = reinterpret_cast<const float4*>(q_s + q * stride);
        for (int d4 = 0; d4 < dim / 4; ++d4) {
          const float4 a = qv[d4];
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            // rows at or past `rows` hold stale values and are never used
            const float4 e = reinterpret_cast<const float4*>(e_s + (r0 + j) * stride)[d4];
            acc[j] = fmaf(a.x, e.x, acc[j]);
            acc[j] = fmaf(a.y, e.y, acc[j]);
            acc[j] = fmaf(a.z, e.z, acc[j]);
            acc[j] = fmaf(a.w, e.w, acc[j]);
          }
        }
        float m = red[warp * Lq + q];
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (r0 + j < rows) m = fmaxf(m, acc[j]);
        red[warp * Lq + q] = m;
      }
    }
  }
  __syncthreads();
  // max over warps for each query token, then the sum over query tokens
  float s = 0.f;
  for (int q = tid; q < Lq; q += kThreads) {
    float m = red[q];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w * Lq + q]);
    s += m;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) e_s[warp] = s;  // e_s is free after the last tile
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += e_s[w];
    out[cand] = tot;
  }
}

template <typename W>
int launch(const float* Q, const int64_t* offs, const int32_t* dls,
           const int32_t* codes, const void* words, const float* centroids,
           const float* bucket_weights, float* out, int B, int NC, int Lq,
           int dim, int nbits, int max_doclen, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(Lq + kTile) * (dim + 4) + kWarps * Lq + (1 << nbits));
  cudaError_t err = cudaFuncSetAttribute(
      stage2_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(static_cast<int64_t>(B) * NC);
  stage2_kernel<W><<<grid, kThreads, smem, stream>>>(
      Q, offs, dls, codes, static_cast<const W*>(words), centroids,
      bucket_weights, out, NC, Lq, dim, nbits, max_doclen);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// stage2_mma_kernel: 3xTF32 on the tensor cores through mma.sync
// ---------------------------------------------------------------------------

// Block shape: warps per block, the blocks per SM the grid aims at, the
// blocks per SM the registers are budgeted for, and the chunks in flight
// ahead of the one in the products. The defaults are the fastest of
// tune_stage2.py's shapes on the H100 (16 warps per SM at <= 128
// registers); that script rebuilds this file with -DSTAGE2_MMA_<NAME>
// overrides to time others.
#ifndef STAGE2_MMA_WARPS
#define STAGE2_MMA_WARPS 4
#endif
#ifndef STAGE2_MMA_BLOCKS_PER_SM
#define STAGE2_MMA_BLOCKS_PER_SM 8
#endif
#ifndef STAGE2_MMA_MINB
#define STAGE2_MMA_MINB 4
#endif
#ifndef STAGE2_MMA_PREFETCH
#define STAGE2_MMA_PREFETCH 3
#endif

constexpr int kMmaDim = 128;               // the only dim the kernel takes
constexpr int kMmaLq = 32;                 // the most query tokens
constexpr int kNT = kMmaLq / 8;            // n8 tiles of query tokens
constexpr int kKS = kMmaDim / 8;           // k8 steps
constexpr int kChunks = kKS / 2;           // 16-dim chunks: a float4 per lane and row
constexpr int kMmaWarps = STAGE2_MMA_WARPS;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kBlocksPerSm = STAGE2_MMA_BLOCKS_PER_SM;
constexpr int kMaxPerWarp = 8;  // candidates a warp is given at most
constexpr int kMaxCandidates = kMmaWarps * kMaxPerWarp;  // per block
constexpr int kPrefetch = STAGE2_MMA_PREFETCH;  // chunks in flight beside the one in use
constexpr int kRing = kPrefetch + 1;
static_assert(kChunks % kRing == 0, "a slice's chunk j and the next one's use the same slot");

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 relative, both tf32 (Q, once per block)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The same split for the A operand in the main loop, in two integer ops:
// cvt.rna on a finite x is (bits + 0x1000) & ~0x1fff (ties away from
// zero), which ptxas expands with an infinity test and a select as well.
// The tensor cores read only the top 19 bits of a tf32 operand, so lo
// keeps its low bits once the half ulp is added. (The same integer form
// for Q as well left the kernel 9% slower in tune_stage2.py: ptxas
// scheduled the main loop differently.)
__device__ __forceinline__ void split_tf32_finite(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d += a b for a 16x8 (row-major) A, an 8x8 (column-major) B and a 16x8
// fp32 C/D, tf32 inputs. With g = lane/4 and t = lane%4: a = {(g, t),
// (g+8, t), (g, t+4), (g+8, t+4)}, b = {(k t, n g), (k t+4, n g)},
// d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's residual bits of one chunk (its 4 dims 16 j + 4 t .. + 3 of a
// row): 4*NBITS bits at bit (16 j + 4 t)*NBITS of the row's bit string,
// read as a byte, half word or word (a nibble of a byte at nbits 1).
template <int NBITS>
__device__ __forceinline__ uint32_t load_bits(const uint8_t* p) {
  if constexpr (NBITS <= 2) return __ldg(p);
  else if constexpr (NBITS == 4) return __ldg(reinterpret_cast<const unsigned short*>(p));
  else return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Bucket weight of element e (0..3) of a chunk whose bits are v (nbits 4
// and 8; nbits 1 and 2 look up pairs, see weights2 in the kernel).
template <int NBITS>
__device__ __forceinline__ float bucket_weight(const float* bw_s, uint32_t v, int e) {
  constexpr uint32_t kMask = ((1u << NBITS) - 1u) << 2;  // a byte offset into bw_s
  const int sh = e * NBITS;
  const uint32_t off = sh >= 2 ? (v >> (sh - 2)) & kMask : (v << (2 - sh)) & kMask;
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(bw_s) + off);
}

// A warp's place in its work: candidate c of the block (-1 when there is
// none left), its token offset and clamped doclen, and the first row of
// the current 16-row slice.
struct Cursor {
  int64_t off;
  int c, dl, s0;
};

template <int NBITS>
__global__ void __launch_bounds__(kMmaThreads, STAGE2_MMA_MINB)
stage2_mma_kernel(const float* __restrict__ Q, const int64_t* __restrict__ offs,
                  const int32_t* __restrict__ dls, const int32_t* __restrict__ codes,
                  const uint8_t* __restrict__ res, const float* __restrict__ centroids,
                  const float* __restrict__ bucket_weights, float* __restrict__ out, int NC,
                  int Lq, int max_doclen, int cpb) {
  __shared__ uint4 qf_s[kNT * kKS * 32];  // {hi(b0), hi(b1), lo(b0), lo(b1)} per lane
  __shared__ float bw_s[1 << NBITS];
  constexpr bool kPairs = NBITS <= 2;  // weights of two elements in one 8-byte read
  __shared__ float2 pair_s[kPairs ? 1 << (2 * NBITS) : 1];
  __shared__ int64_t off_s[kMaxCandidates];
  __shared__ int dl_s[kMaxCandidates];
  __shared__ int next_s;

  // the blocks of one query are consecutive: they read its Q from L2
  const int nblk = (NC + cpb - 1) / cpb;
  const int b = blockIdx.x / nblk;
  const int c0 = (blockIdx.x - b * nblk) * cpb;
  const int n = min(cpb, NC - c0);
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = static_cast<int64_t>(b) * NC + c0;

  // Q[b]: entry (nt, kk, l) holds query token 8 nt + l/4 at the dims of
  // b0 and b1 of lane l, 16 (kk/2) + 4 (l%4) + 2 (kk%2) and + 1 (zero past Lq)
  const float* qb = Q + static_cast<int64_t>(b) * Lq * kMmaDim;
  for (int i = tid; i < kNT * kKS * 32; i += kMmaThreads) {
    const int l = i & 31, kk = (i >> 5) % kKS, nt = (i >> 5) / kKS;
    const int row = nt * 8 + (l >> 2);
    float2 x = make_float2(0.f, 0.f);
    if (row < Lq)
      x = *reinterpret_cast<const float2*>(qb + row * kMmaDim + 16 * (kk >> 1) + 4 * (l & 3) +
                                           2 * (kk & 1));
    uint32_t h0, l0, h1, l1;
    split_tf32(x.x, h0, l0);
    split_tf32(x.y, h1, l1);
    qf_s[i] = make_uint4(h0, h1, l0, l1);
  }
  for (int i = tid; i < (1 << NBITS); i += kMmaThreads) bw_s[i] = bucket_weights[i];
  if constexpr (kPairs)
    for (int i = tid; i < (1 << (2 * NBITS)); i += kMmaThreads)
      pair_s[i] = make_float2(bucket_weights[i & ((1 << NBITS) - 1)], bucket_weights[i >> NBITS]);
  // weights of chunk elements 2 sub and 2 sub + 1 of bits v: at nbits 1
  // and 2 one entry of a table of (w[b0], w[b1]) indexed by both buckets
  auto weights2 = [&](uint32_t v, int sub) -> float2 {
    if constexpr (kPairs) {
      constexpr uint32_t kMask = ((1u << (2 * NBITS)) - 1u) << 3;  // a byte offset into pair_s
      const int sh = 2 * sub * NBITS;
      const uint32_t off = sh >= 3 ? (v >> (sh - 3)) & kMask : (v << (3 - sh)) & kMask;
      return *reinterpret_cast<const float2*>(reinterpret_cast<const char*>(pair_s) + off);
    } else {
      return make_float2(bucket_weight<NBITS>(bw_s, v, 2 * sub),
                         bucket_weight<NBITS>(bw_s, v, 2 * sub + 1));
    }
  };
  for (int i = tid; i < n; i += kMmaThreads) {
    const int dl = min(dls[base + i], max_doclen);
    dl_s[i] = dl;
    off_s[i] = offs[base + i];
    if (dl <= 0) out[base + i] = 0.f;
  }
  if (tid == 0) next_s = 0;
  __syncthreads();  // the block's only barrier

  // the block's next candidate with a token, or c = -1
  auto fetch = [&](Cursor& cu) {
    int c;
    do {
      c = 0;
      if (lane == 0) c = atomicAdd(&next_s, 1);
      c = __shfl_sync(0xffffffffu, c, 0);
    } while (c < n && dl_s[c] <= 0);
    cu.s0 = 0;
    if (c < n) {
      cu.c = c;
      cu.dl = dl_s[c];
      cu.off = off_s[c];
    } else {
      cu.c = -1;
      cu.dl = 0;
      cu.off = 0;
    }
  };

  // The slice's rows that the lane holds are s0 + g + 8 h. A row at or
  // past dl reads the candidate's first row instead, so nothing past the
  // data is read, and never enters the max. Per row: its code (loaded one
  // slice ahead), then a pointer to the lane's float4s of its centroid row
  // (chunk j at + 4 j) and to its chunk bits (chunk j at + 2 NBITS j bytes).
  const float4* cent4 = reinterpret_cast<const float4*>(centroids) + t;
  const int bit_off = t * NBITS / 2;  // bytes; at nbits 1, lanes 2s and 2s+1 share a byte
  const int bit_sh = NBITS == 1 ? 4 * (t & 1) : 0;
  auto load_codes = [&](const Cursor& cu, int (&code)[2], const uint8_t* (&bp)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = cu.s0 + g + 8 * h;
      const int64_t tok = cu.off + (row < cu.dl ? row : 0);
      code[h] = __ldg(codes + tok);
      bp[h] = res + tok * (16 * NBITS) + bit_off;
    }
  };
  auto rows_of = [&](const int (&code)[2], const float4* (&rp)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) rp[h] = cent4 + static_cast<int64_t>(code[h]) * (kMmaDim / 4);
  };
  auto load_chunk = [&](const float4* (&rp)[2], const uint8_t* (&bp)[2], int j, float4 (&cv)[2],
                        uint32_t (&bv)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cv[h] = __ldg(rp[h] + 4 * j);
      bv[h] = load_bits<NBITS>(bp[h] + 2 * NBITS * j);
    }
  };

  Cursor cur;
  fetch(cur);
  if (cur.c < 0) return;
  int code[2];
  const uint8_t* bp[2];
  const float4* rp[2];
  load_codes(cur, code, bp);
  rows_of(code, rp);
  float4 cv[kRing][2];
  uint32_t bv[kRing][2];
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) load_chunk(rp, bp, j, cv[j], bv[j]);
  float mx[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) mx[nt][0] = mx[nt][1] = -INFINITY;

  while (true) {
    // the next slice: its codes now, its first chunks with our last
    Cursor nx = cur;
    if (cur.s0 + 16 < cur.dl)
      nx.s0 += 16;
    else
      fetch(nx);
    int ncode[2];
    const uint8_t* nbp[2];
    const float4* nrp[2];
    if (nx.c >= 0) load_codes(nx, ncode, nbp);

    float acc[kNT][4];
    float ss[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int jt = j + kPrefetch;  // the chunk to start loading
      if (jt < kChunks) {
        load_chunk(rp, bp, jt, cv[jt % kRing], bv[jt % kRing]);
      } else if (nx.c >= 0) {
        if (jt == kChunks) rows_of(ncode, nrp);
        load_chunk(nrp, nbp, jt - kChunks, cv[jt % kRing], bv[jt % kRing]);
      }
      const int st = j % kRing;
#pragma unroll
      for (int h = 0; h < 2; ++h) bv[st][h] >>= bit_sh;
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
        const int kk = 2 * j + sub;
        uint4 bq[kNT];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) bq[nt] = qf_s[(nt * kKS + kk) * 32 + lane];
        // A slice always has a row here, but ptxas cannot tell: this branch
        // keeps it from hoisting later loads above the step's products. On
        // the H100 the nbits-2 instantiation without it spills 12 bytes at
        // 128 registers and takes 0.66 ms, not 0.62 (tune_stage2.py inputs).
        if (cur.s0 < cur.dl) {
          const float4 ca = cv[st][0], cb = cv[st][1];
          const float2 wa = weights2(bv[st][0], sub), wb = weights2(bv[st][1], sub);
          // a = {(g, h 0), (g+8, h 0), (g, h 1), (g+8, h 1)}: chunk elements 2 sub + h
          const float e0 = (sub ? ca.z : ca.x) + wa.x;
          const float e1 = (sub ? cb.z : cb.x) + wb.x;
          const float e2 = (sub ? ca.w : ca.y) + wa.y;
          const float e3 = (sub ? cb.w : cb.y) + wb.y;
          ss[0] = fmaf(e2, e2, fmaf(e0, e0, ss[0]));
          ss[1] = fmaf(e3, e3, fmaf(e1, e1, ss[1]));
          uint32_t ahi[4], alo[4];
          split_tf32_finite(e0, ahi[0], alo[0]);
          split_tf32_finite(e1, ahi[1], alo[1]);
          split_tf32_finite(e2, ahi[2], alo[2]);
          split_tf32_finite(e3, ahi[3], alo[3]);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            mma_tf32(acc[nt], alo, bq[nt].x, bq[nt].y);
            mma_tf32(acc[nt], ahi, bq[nt].z, bq[nt].w);
            mma_tf32(acc[nt], ahi, bq[nt].x, bq[nt].y);
          }
        }
      }
    }

    // scale each row by 1 / max(|e|, 1e-12) and fold the valid rows into
    // the running max of each query column
    float s0 = ss[0], s1 = ss[1];
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    const float inv0 = 1.f / fmaxf(sqrtf(s0), 1e-12f);
    const float inv1 = 1.f / fmaxf(sqrtf(s1), 1e-12f);
    const bool v0 = cur.s0 + g < cur.dl, v1 = cur.s0 + g + 8 < cur.dl;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (v0) {
        mx[nt][0] = fmaxf(mx[nt][0], acc[nt][0] * inv0);
        mx[nt][1] = fmaxf(mx[nt][1], acc[nt][1] * inv0);
      }
      if (v1) {
        mx[nt][0] = fmaxf(mx[nt][0], acc[nt][2] * inv1);
        mx[nt][1] = fmaxf(mx[nt][1], acc[nt][3] * inv1);
      }
    }

    if (cur.s0 + 16 >= cur.dl) {
      // the candidate's last slice: max over the 8 row groups, sum over
      // the query columns (8 nt + 2 t + h) below Lq
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = mx[nt][h];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
          if (nt * 8 + 2 * t + h < Lq) s += m;
          mx[nt][h] = -INFINITY;
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (lane == 0) out[base + cur.c] = s;
    }
    if (nx.c < 0) break;
    cur = nx;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rp[h] = nrp[h];
      bp[h] = nbp[h];
    }
  }
}

template <int NBITS>
int launch_mma(const float* Q, const int64_t* offs, const int32_t* dls, const int32_t* codes,
               const void* words, const float* centroids, const float* bucket_weights,
               float* out, int B, int NC, int Lq, int max_doclen, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // candidates per warp: enough for ~kBlocksPerSm blocks per SM, at least
  // one (B=1 still gives NC/kMmaWarps blocks), at most kMaxPerWarp
  const int64_t total = static_cast<int64_t>(B) * NC;
  const int64_t per = static_cast<int64_t>(kMmaWarps) * kBlocksPerSm * sms;
  const int per_warp =
      static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(kMaxPerWarp, (total + per - 1) / per)));
  const int cpb = kMmaWarps * per_warp;
  const int64_t blocks = static_cast<int64_t>(B) * ((NC + cpb - 1) / cpb);
  if (blocks > 0x7fffffff) return -1;
  stage2_mma_kernel<NBITS><<<static_cast<unsigned>(blocks), kMmaThreads, 0, stream>>>(
      Q, offs, dls, codes, static_cast<const uint8_t*>(words), centroids, bucket_weights, out,
      NC, Lq, max_doclen, cpb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns 0 on success, the CUDA
// error code of a refused launch, or -1 for arguments the kernel does not
// take (the Python wrapper checks them first).
extern "C" int colbert_stage2_maxsim(
    const float* Q, const int64_t* offs, const int32_t* dls, const int32_t* codes,
    const void* words, int word_bytes, const float* centroids,
    const float* bucket_weights, float* out, int B, int NC, int Lq, int dim,
    int nbits, int max_doclen, void* stream) {
  if (!(nbits == 1 || nbits == 2 || nbits == 4 || nbits == 8)) return -1;
  if (!(word_bytes == 1 || word_bytes == 4) || dim % 8 != 0 || Lq <= 0) return -1;
  const int per_word = 8 * word_bytes / nbits;
  if (dim % per_word != 0) return -1;
  if (static_cast<int64_t>(B) * NC == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (word_bytes == 1)
    return launch<uint8_t>(Q, offs, dls, codes, words, centroids, bucket_weights,
                           out, B, NC, Lq, dim, nbits, max_doclen, s);
  return launch<uint32_t>(Q, offs, dls, codes, words, centroids, bucket_weights,
                          out, B, NC, Lq, dim, nbits, max_doclen, s);
}

// stage2_mma_kernel: dim 128, 1 <= Lq <= 32, nbits 1/2/4/8, bytes or 32-bit
// words, the residual pointer 4-byte aligned; the same arguments.
extern "C" int colbert_stage2_maxsim_mma(
    const float* Q, const int64_t* offs, const int32_t* dls, const int32_t* codes,
    const void* words, int word_bytes, const float* centroids,
    const float* bucket_weights, float* out, int B, int NC, int Lq, int dim,
    int nbits, int max_doclen, void* stream) {
  if (dim != kMmaDim || Lq <= 0 || Lq > kMmaLq) return -1;
  if (!(word_bytes == 1 || word_bytes == 4)) return -1;
  if (reinterpret_cast<uintptr_t>(words) % 4 != 0) return -1;
  if (static_cast<int64_t>(B) * NC == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1:
      return launch_mma<1>(Q, offs, dls, codes, words, centroids, bucket_weights, out, B, NC,
                           Lq, max_doclen, s);
    case 2:
      return launch_mma<2>(Q, offs, dls, codes, words, centroids, bucket_weights, out, B, NC,
                           Lq, max_doclen, s);
    case 4:
      return launch_mma<4>(Q, offs, dls, codes, words, centroids, bucket_weights, out, B, NC,
                           Lq, max_doclen, s);
    case 8:
      return launch_mma<8>(Q, offs, dls, codes, words, centroids, bucket_weights, out, B, NC,
                           Lq, max_doclen, s);
    default:
      return -1;
  }
}
