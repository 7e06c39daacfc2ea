// The refine's centroid-interaction approximation for Hopper (sm_90a).
//
// Replaces colbert_tpu/retrieval/device_index.py::_approx_maxsim, which the
// JAX package leaves to XLA (a fused chain, not a Pallas kernel): a slice of
// each candidate's token codes, a gather of bf16 centroid rows, a bf16
// product into fp32 against Q, a masked max over the doclen and a sum over
// the query tokens. This is the port's own kernel for that chain.
//
// Contract, for a batch of B queries with W candidates each:
//   out[b, c] = sum_{q < Lq} max_{t < dls[b,c]} table[b, codes[offs[b,c] + t], q]
// where table (B, K, Lq) fp32 holds <bf16(Q[b,q]), bf16(centroids[k])> with
// the products summed in fp32 (the wrapper takes that product on the tensor
// cores); 0 for a candidate whose doclen is 0 (the sentinel pid's too).
// Only the codes [offs, offs + dls) are read, so a candidate that ends on
// the last code row reads nothing past it, and Ld never enters the kernel.
//
// What bounds it on the H100: memory. A valid token costs a 4-byte code and
// one Lq-wide table row (128 bytes at Lq 32) and no arithmetic beyond a max
// per query token. The design keeps the row reads in L2: the table is laid
// out query-major, one query's (K, Lq) slice (4 MiB at K 32,768 and Lq 32)
// contiguous, and the grid is ordered query-major (pair = b * W + c), so
// the blocks resident at any moment walk one or two queries' slices, which
// stay in the 50 MB L2 while device memory serves the codes once.
//
// One warp per (query, candidate): lane q keeps the running max of query
// token q (lanes stride over q for Lq > 32, one pass over the codes per 32
// query tokens). The warp reads the candidate's codes as one contiguous run,
// 32 codes per coalesced load, and broadcasts them with shuffles; each token
// is then one coalesced Lq-float row read, eight rows in flight per lane
// before their maxima. A butterfly of shuffles sums the lanes' maxima. The
// kernel launches on the caller's stream, allocates nothing and never
// synchronizes, so a serving program captures it as it is.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;   // warps (candidates) per block
constexpr int kInFlight = 8;  // table rows loaded before their maxima

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
approx_maxsim_kernel(const float* __restrict__ table, const int64_t* __restrict__ offs,
                     const int32_t* __restrict__ dls, const int32_t* __restrict__ codes,
                     float* __restrict__ out, int64_t pairs, int W, int K, int Lq) {
  const int lane = threadIdx.x & 31;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (pair >= pairs) return;  // the whole warp: pair is warp-uniform
  const int64_t b = pair / W;
  const int dl = dls[pair];
  const int32_t* tok = codes + offs[pair];
  const float* slice = table + b * K * Lq;
  float sum = 0.f;
  for (int q0 = 0; q0 < Lq && dl > 0; q0 += 32) {
    const int q = q0 + lane;
    const bool live = q < Lq;
    float m = -INFINITY;
    for (int t0 = 0; t0 < dl; t0 += 32) {
      const int n = min(32, dl - t0);
      const int code = lane < n ? __ldg(tok + t0 + lane) : 0;
      for (int i = 0; i < n; i += kInFlight) {
        float v[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          const int c = __shfl_sync(kFull, code, (i + j) & 31);
          v[j] = (live && i + j < n) ? __ldg(slice + static_cast<int64_t>(c) * Lq + q)
                                     : -INFINITY;
        }
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) m = fmaxf(m, v[j]);
      }
    }
    if (live) sum += m;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(kFull, sum, s);
  if (lane == 0) out[pair] = sum;
}

}  // namespace

// table (B, K, Lq) fp32 query-major, offs (B, W) int64, dls (B, W) int32,
// codes int32 (every offs + dls within it), out (B, W) fp32; all on the
// device, launched on `stream`. Returns the launch's cudaError_t (0: ok).
extern "C" int colbert_approx_maxsim(const float* table, const int64_t* offs,
                                     const int32_t* dls, const int32_t* codes, float* out,
                                     int B, int W, int K, int Lq, void* stream) {
  if (B < 0 || W < 0 || K <= 0 || Lq <= 0) return -1;
  const int64_t pairs = static_cast<int64_t>(B) * W;
  if (pairs == 0) return 0;
  const int64_t blocks = (pairs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return -1;
  approx_maxsim_kernel<kWarps><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      table, offs, dls, codes, out, pairs, W, K, Lq);
  return static_cast<int>(cudaGetLastError());
}
