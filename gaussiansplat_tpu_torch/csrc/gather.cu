// The pair gather, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference gathers the payload into sorted pair
// order with two XLA gathers, payload[depth_order][sorted_ranks]
// (gaussiansplat_tpu/ops/binning.py:358, `_gather_sorted`). The port first
// did the same with two `index_select`s, and those ran over every slot of
// the fixed pair capacity (8 x N), most of which hold no pair. This kernel
// copies only the binned pairs.
//
// What it computes, for each pair slot i < num_pairs:
//   out[i, :] = payload[depth_order[sorted_ranks[i]], :]
// over the 16 f32 channels of a row. num_pairs is read from device memory,
// so the host never waits for it. Rows at or past num_pairs are not
// written: the raster kernels read only the tile segments, which end at
// num_pairs, and the backward zeroes the cotangent rows past it. The payload
// may have other rows than depth_order (a gaussian shard's received rows):
// the kernel indexes it with what depth_order holds.
//
// What bounds it on this card: bytes. It does no arithmetic; the least
// traffic is 136 B a pair: the rank (4 B), the depth-order entry (4 B), the
// payload row read (64 B) and the row written (64 B).
//
// What the design does about that: four threads a row, each moving one
// 16-byte quarter, so a warp's loads and stores cover 8 whole rows and the
// stores of neighbouring output rows coalesce into 512-byte runs. Each
// thread takes kUnroll rows 64 apart, and loads all their ranks, then all
// their depth-order entries, then all their rows before it stores, so the
// two dependent index loads of kUnroll rows are in flight together. The
// intermediate depth-ordered table of the two-gather form is never made:
// depth_order (4 B a gaussian) is read through L2. A persistent grid of
// kBlocksPerSm blocks a multiprocessor walks the pairs in strides, so no
// block is launched for the empty slots past num_pairs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQuarters = 4;                          // threads a row
constexpr int kRowsPerPass = kThreads / kQuarters;    // 64
constexpr int kUnroll = 4;                            // rows a thread
constexpr int kRowsPerBlock = kRowsPerPass * kUnroll;  // 256
constexpr int kBlocksPerSm = 8;                       // 2048 threads an SM

__global__ void __launch_bounds__(kThreads) gather_pairs_kernel(
    const float4* __restrict__ payload, const int* __restrict__ depth_order,
    const int* __restrict__ sorted_ranks, const int* __restrict__ num_pairs_ptr,
    int capacity, float4* __restrict__ out) {
  // The binning clips num_pairs to the capacity; a larger value would write
  // past the output.
  const long long num_pairs = min(__ldg(num_pairs_ptr), capacity);
  const int q = threadIdx.x % kQuarters;
  const int row = threadIdx.x / kQuarters;
  const long long stride = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  for (long long base = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
       base < num_pairs; base += stride) {
    long long i[kUnroll];
    int g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      i[u] = base + u * kRowsPerPass + row;
      g[u] = i[u] < num_pairs ? __ldg(sorted_ranks + i[u]) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i[u] < num_pairs) g[u] = __ldg(depth_order + g[u]);
    }
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i[u] < num_pairs) {
        v[u] = __ldg(payload + static_cast<size_t>(g[u]) * kQuarters + q);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i[u] < num_pairs) out[i[u] * kQuarters + q] = v[u];
    }
  }
}

}  // namespace

extern "C" int gs_gather_pairs(const void* payload, const void* depth_order,
                               const void* sorted_ranks, const void* num_pairs,
                               int capacity, void* out, void* stream) {
  if (capacity <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed =
      (static_cast<long long>(capacity) + kRowsPerBlock - 1) / kRowsPerBlock;
  const int most = sms * kBlocksPerSm;
  const int blocks = needed < most ? static_cast<int>(needed) : most;
  gather_pairs_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(payload), static_cast<const int*>(depth_order),
      static_cast<const int*>(sorted_ranks), static_cast<const int*>(num_pairs),
      capacity, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
