// K4: pair expansion for tile binning, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussiansplat_tpu/ops/pallas/expand.py
// (_expand_kernel, launched by expand_pairs_pallas).
//
// What it computes, for each pair slot p < capacity:
//   owner g  = the last depth rank with off[g] <= p (off is the compacted,
//              capacity-clipped exclusive prefix sum: non-decreasing, off[0] = 0);
//   k        = p - off[g], or the index of the k-th set bit of g's survivor
//              mask when that mask is non-zero;
//   tile     = (ymin + k / tw) * tiles_x + xmin + k % tw, with (xmin, ymin,
//              tw) decoded from g's packed rect by the (by, bw, bh) widths;
//   packed   : key[p] = (tile << rank_bits) | g, or `sentinel` for p >= num_pairs;
//   separate : tile[p] (= `sentinel` for p >= num_pairs) and rank[p] = g.
//
// What bounds it on this card: bytes. The work is a few integer operations
// per slot; the least traffic is capacity x 4 B (or 8 B) written plus the
// three N-sized descriptor arrays read once.
//
// What the design does about that: one thread per slot, so the stores are
// fully coalesced. The owner comes from a binary search over `off`; the
// descriptors (12 B per gaussian, 12 MB at 1M) stay in the 50 MB L2, and
// neighbouring threads walk nearly the same search path, so the repeated
// reads hit cache rather than device memory. num_pairs is read from device
// memory, so the host never waits for it. The TPU kernel's one-hot MXU
// extraction was a matrix-unit device and is not carried over.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int kth_set_bit(unsigned int m, int k) {
  if (k >= 32) return 0;
  for (int i = 0; i < k; ++i) m &= m - 1u;  // clear the k lowest set bits
  return m ? __ffs(m) - 1 : 0;
}

__global__ void expand_pairs_kernel(
    const int* __restrict__ off, const int* __restrict__ rect,
    const int* __restrict__ mask, const int* __restrict__ num_pairs_ptr,
    int n, int capacity, int tiles_x, int rank_bits, int sentinel,
    int by, int bw, int bh, int packed,
    int* __restrict__ out_a, int* __restrict__ out_b) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= capacity) return;
  const int num_pairs = __ldg(num_pairs_ptr);

  // First index with off[idx] > p; the owner is the one before it.
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(off + mid) <= p) lo = mid + 1; else hi = mid;
  }
  const int g = lo > 0 ? lo - 1 : 0;

  const bool valid = p < num_pairs;
  int tile = sentinel;
  if (valid) {
    const int r = __ldg(rect + g);
    const unsigned int m = static_cast<unsigned int>(__ldg(mask + g));
    const int xm = r >> (by + bw + bh);
    const int ym = (r >> (bw + bh)) & ((1 << by) - 1);
    const int tw = max((r >> bh) & ((1 << bw) - 1), 1);
    int k = p - __ldg(off + g);
    if (m != 0u) k = kth_set_bit(m, k);
    tile = (ym + k / tw) * tiles_x + xm + k % tw;
  }
  if (packed) {
    out_a[p] = valid ? ((tile << rank_bits) | g) : sentinel;
  } else {
    out_a[p] = tile;
    out_b[p] = g;
  }
}

}  // namespace

extern "C" int gs_expand_pairs(
    const void* off, const void* rect, const void* mask, const void* num_pairs,
    int n, int capacity, int tiles_x, int rank_bits, int sentinel,
    int by, int bw, int bh, int packed, void* out_a, void* out_b,
    void* stream) {
  const int threads = 256;
  const int blocks = (capacity + threads - 1) / threads;
  expand_pairs_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(off), static_cast<const int*>(rect),
      static_cast<const int*>(mask), static_cast<const int*>(num_pairs),
      n, capacity, tiles_x, rank_bits, sentinel, by, bw, bh, packed,
      static_cast<int*>(out_a), static_cast<int*>(out_b));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
