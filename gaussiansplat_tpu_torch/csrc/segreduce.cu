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
// non-decreasing int32 segment offsets. Empty segments give zero rows.
//
// What bounds it on this card: bytes. One add per input element; the least
// traffic is num_pairs x 64 B read plus n x 64 B written (and the offsets).
//
// What the design does about that: 16 threads per rank, one per channel,
// so each row of 64 B is read by 16 neighbouring threads in one coalesced
// transaction. Each thread sums its rank's rows in row order: the order is
// fixed and there are no atomics, so two runs give the same bits. A long
// segment (up to max_tiles_per_gaussian rows) costs its 16 threads a longer
// loop and needs no special case. The TPU kernel's one-hot MXU matmul and
// bf16 splits are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kNch = 16;

__global__ void segreduce_kernel(const float* __restrict__ rows,
                                 const int* __restrict__ seg, int n,
                                 float* __restrict__ out) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = gid / kNch;
  const int ch = gid % kNch;
  if (r >= n) return;
  const int s = __ldg(seg + r);
  const int e = __ldg(seg + r + 1);
  float acc = 0.f;
  for (int p = s; p < e; ++p) {
    acc = __fadd_rn(acc, __ldg(rows + static_cast<size_t>(p) * kNch + ch));
  }
  out[static_cast<size_t>(r) * kNch + ch] = acc;
}

}  // namespace

extern "C" int gs_segment_reduce(const void* rows, const void* seg, int n,
                                 void* out, void* stream) {
  constexpr int kThreads = 256;
  const long long total = static_cast<long long>(n) * kNch;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  segreduce_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(seg), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
