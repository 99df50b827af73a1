// K3: segment reduction of per-pair gradient rows, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel gaussiansplat_tpu/ops/pallas/segreduce.py
// (_segreduce_kernel, launched by segment_reduce_pairs), unpacked form.
//
// What it computes: out[r, c] = sum of rows[p, c] over p in
// [seg[r], seg[r+1]), for every depth rank r < n and channel c < 16. `rows`
// is the (P, 16) f32 pair gradient block in pre-sort order, where each
// rank's pairs are contiguous (ops/binning.py); `seg` is the (n + 1,)
// non-decreasing int32 segment offsets. Empty segments give zero rows; rows
// past seg[n] are never read.
//
// What bounds it on this card: bytes. One add per input element; the least
// traffic is num_pairs x 64 B read plus n x 64 B written (and the offsets).
//
// What the design does about that: a block of 256 threads takes 64 ranks,
// four threads a rank, each with a 16-byte quarter of the row (float4), so
// a warp holds 8 ranks and every load is 16 bytes wide.
//   * A segment of at most kLongRows rows is summed by its four threads in
//     row order, from +0, with kAhead rows loaded before their adds: the
//     same bits as a sequential sum (and as the CPU `index_add_`).
//   * A longer segment (a gaussian over many tiles: up to
//     max_tiles_per_gaussian rows) would hold its warp for hundreds of
//     dependent steps. The block sums it together after its short ones: the
//     64 thread groups take 64 contiguous pieces of it (piece i is rows
//     [s + len i / 64, s + len (i + 1) / 64)), each in row order; the 8
//     pieces of a warp are added by a fixed shuffle tree (lanes 16, 8, 4
//     apart) and the 8 warps' sums in warp order. The order is fixed and
//     there are no atomics, so two runs give the same bits; only the split
//     segments differ in bits from a sequential sum.
// ops/kernels/segreduce.py holds the plain twin of this order
// (`segment_reduce_pairs_split`), bit for bit. The TPU kernel's one-hot MXU
// matmul and bf16 splits are not carried over.
//
// Timing variant (ops/kernels/ablate.py), the TPU kernel's `ablate=` on this
// kernel's structure; with no define this source is the production kernel.
//   GS_ABLATE_DMAONLY: the same float4 loads of every segment's rows, with
//     no sums kept: the bits of every loaded value are folded by XOR into
//     one register (a float4 sum would hold four) and the row's first
//     channel holds the fold's lowest bit as a float (0 or 1.4e-45), so
//     nvcc keeps every load. The TPU variant `stacked` is the production
//     kernel; its other variants price the one-hot MXU matmul and its bf16
//     splits.

#include <cuda_runtime.h>

namespace {

constexpr int kNch = 16;
constexpr int kThreads = 256;
constexpr int kQuarters = kNch / 4;                  // threads per rank
constexpr int kRanksPerBlock = kThreads / kQuarters;  // 64 thread groups
constexpr int kWarps = kThreads / 32;
constexpr int kLongRows = 32;  // longer segments are split over the block
constexpr int kAhead = 4;      // rows loaded before their adds

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int mask) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, mask),
                     __shfl_xor_sync(0xffffffffu, v.y, mask),
                     __shfl_xor_sync(0xffffffffu, v.z, mask),
                     __shfl_xor_sync(0xffffffffu, v.w, mask));
}

// Quarter q of the sum of rows [s, e), in row order from +0. The rows past
// e of the last load group are not read and add +0, which leaves every sum
// unchanged (a sum that starts at +0 is never -0).
__device__ __forceinline__ float4 sum_rows(const float4* __restrict__ rows4,
                                           long long s, long long e, int q) {
#if defined(GS_ABLATE_DMAONLY)
  unsigned fold = 0u;
#else
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#endif
  for (long long p = s; p < e; p += kAhead) {
    float4 v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      v[u] = p + u < e ? __ldg(rows4 + (p + u) * kQuarters + q)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#if defined(GS_ABLATE_DMAONLY)
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      fold ^= __float_as_uint(v[u].x) ^ __float_as_uint(v[u].y) ^
              __float_as_uint(v[u].z) ^ __float_as_uint(v[u].w);
    }
#else
#pragma unroll
    for (int u = 0; u < kAhead; ++u) acc = add4(acc, v[u]);
#endif
  }
#if defined(GS_ABLATE_DMAONLY)
  return make_float4(__uint_as_float(fold & 1u), 0.f, 0.f, 0.f);
#else
  return acc;
#endif
}

__global__ void __launch_bounds__(kThreads) segreduce_kernel(
    const float* __restrict__ rows, const int* __restrict__ seg, int n,
    float* __restrict__ out) {
  __shared__ unsigned int s_long[kWarps];
  __shared__ float4 s_part[2][kWarps][kQuarters];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q = t % kQuarters;
  const int group = t / kQuarters;
  const int r0 = blockIdx.x * kRanksPerBlock;
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  float4* out4 = reinterpret_cast<float4*>(out);

  bool is_long = false;
  if (r0 + group < n) {
    const int s = __ldg(seg + r0 + group), e = __ldg(seg + r0 + group + 1);
    is_long = e - s > kLongRows;
    if (!is_long) {
      out4[static_cast<size_t>(r0 + group) * kQuarters + q] =
          sum_rows(rows4, s, e, q);
    }
  }
  // Bit 4 j of a warp's mask: its j-th rank is long.
  const unsigned int m = __ballot_sync(0xffffffffu, is_long && q == 0);
  if (lane == 0) s_long[warp] = m;
  if (!__syncthreads_or(m != 0u)) return;

  int buf = 0;
  for (int w = 0; w < kWarps; ++w) {
    for (unsigned int bits = s_long[w]; bits != 0u; bits &= bits - 1u) {
      const int r = r0 + w * 8 + (__ffs(bits) - 1) / kQuarters;
      const long long s = __ldg(seg + r);
      const long long len = __ldg(seg + r + 1) - s;
      float4 v = sum_rows(rows4, s + len * group / kRanksPerBlock,
                          s + len * (group + 1) / kRanksPerBlock, q);
      v = add4(v, shfl_xor4(v, 16));
      v = add4(v, shfl_xor4(v, 8));
      v = add4(v, shfl_xor4(v, 4));
      if (lane < kQuarters) s_part[buf][warp][lane] = v;
      __syncthreads();
      if (t < kQuarters) {
        float4 acc = s_part[buf][0][t];
#pragma unroll
        for (int k = 1; k < kWarps; ++k) acc = add4(acc, s_part[buf][k][t]);
        out4[static_cast<size_t>(r) * kQuarters + t] = acc;
      }
      buf ^= 1;  // the next rank's partials go to the other buffer
    }
  }
}

}  // namespace

extern "C" int gs_segment_reduce(const void* rows, const void* seg, int n,
                                 void* out, void* stream) {
  const int blocks = (n + kRanksPerBlock - 1) / kRanksPerBlock;
  segreduce_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(seg), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
