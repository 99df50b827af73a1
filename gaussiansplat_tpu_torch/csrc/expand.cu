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
//              the rect is int32 where its four fields fit 31 bits and int64
//              on larger tile grids (one body, two instantiations:
//              gs_expand_pairs and gs_expand_pairs_i64);
//   packed   : key[p] = (tile << rank_bits) | g, or `sentinel` for p >= num_pairs;
//   separate : tile[p] (= `sentinel` for p >= num_pairs) and rank[p] = g.
//
// What bounds it on this card: bytes. The work is a few integer operations
// per slot; the least traffic is capacity x 4 B (or 8 B) written plus the
// three N-sized descriptor arrays read once.
//
// What the design does about that: each block writes 1024 consecutive
// slots, four a thread as one 16-byte store.
//   * Slots past num_pairs search nothing. Every off[g] <= num_pairs (the
//     offsets are clipped to the pairs binned), so the owner there is n - 1
//     and the tile the sentinel. A block wholly past num_pairs (most of the
//     capacity) only stores.
//   * One search per block, not one per slot (the TPU kernel's own idea).
//     Every rank below num_pairs owns at least one slot, so the owners of
//     the block's valid slots are the ranks [g0, g0 + 1024), g0 the owner of
//     its first slot. One warp finds g0 by a 32-way search over `off` (32
//     probes a step, five dependent loads at n = 1M); the block copies that
//     window of `off` into shared memory, coalesced; each thread then finds
//     the owner of its first slot there by bisection and steps to the next
//     rank where a later slot of its four starts one.
//   * The k-th set bit of a survivor mask by a branch-free select over
//     halves (five population counts), not a loop over the bits.
// num_pairs is read from device memory, so the host never waits for it. The
// TPU kernel's one-hot MXU extraction was a matrix-unit device and is not
// carried over. ops/kernels/expand.py holds plain twins of the 32-way search
// and of the window (`warp_count_le`, `block_owners`) for the CPU tests.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kSlotsPerBlock = kThreads * kSlotsPerThread;

// The number of entries of off[0, n) that are <= key (off non-decreasing),
// found by one warp: each step probes 32 evenly spaced entries of the
// remaining range [lo, hi] at once and keeps the gap the key falls in.
__device__ int warp_count_le(const int* __restrict__ off, int n, int key,
                             int lane) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const long long len = hi - lo;
    // Lane i probes lo + floor(len (i + 1) / 32) - 1; lane 31 probes hi - 1.
    // A probe below lo is known to hold.
    const int q = lo + static_cast<int>((len * (lane + 1)) >> 5) - 1;
    const bool le = q < lo || __ldg(off + q) <= key;
    // The probes are non-decreasing, so the lanes that hold are a prefix.
    const int j = __popc(__ballot_sync(0xffffffffu, le));
    const int new_lo = lo + static_cast<int>((len * j) >> 5);
    if (j < 32) hi = lo + static_cast<int>((len * (j + 1)) >> 5) - 1;
    lo = new_lo;
  }
  return lo;
}

// Index of the k-th (0-based) set bit of m; 0 if m has no such bit.
__device__ __forceinline__ int kth_set_bit(unsigned int m, int k) {
  if (k >= __popc(m)) return 0;
  int pos = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const unsigned int low = m & ((1u << w) - 1u);
    const int c = __popc(low);
    const bool up = k >= c;
    k -= up ? c : 0;
    pos += up ? w : 0;
    m = up ? (m >> w) : low;
  }
  return pos;
}

template <typename Rect>
__global__ void __launch_bounds__(kThreads) expand_pairs_kernel(
    const int* __restrict__ off, const Rect* __restrict__ rect,
    const int* __restrict__ mask, const int* __restrict__ num_pairs_ptr,
    int n, int capacity, int tiles_x, int rank_bits, int sentinel,
    int by, int bw, int bh, int packed,
    int* __restrict__ out_a, int* __restrict__ out_b) {
  __shared__ int s_off[kSlotsPerBlock];
  __shared__ int s_g0;
  const int num_pairs = __ldg(num_pairs_ptr);
  const int base = blockIdx.x * kSlotsPerBlock;
  const int p0 = base + threadIdx.x * kSlotsPerThread;

  // What a slot past num_pairs holds.
  int a[kSlotsPerThread], b[kSlotsPerThread];
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    a[u] = sentinel;
    b[u] = n - 1;
  }

  if (base < num_pairs) {  // the same for the whole block
    if (threadIdx.x < 32) {
      const int c = warp_count_le(off, n, base, threadIdx.x);
      if (threadIdx.x == 0) s_g0 = c > 1 ? c - 1 : 0;
    }
    __syncthreads();
    const int g0 = s_g0;
    const int w = min(kSlotsPerBlock, n - g0);
    for (int i = threadIdx.x; i < w; i += kThreads) {
      s_off[i] = __ldg(off + g0 + i);
    }
    __syncthreads();

    if (p0 < num_pairs) {
      // Owner of p0: the last window entry <= p0. s_off[0] <= base <= p0,
      // and each rank owns a slot, so it lies in [0, p0 - base].
      int lo = 1, hi = min(w, p0 - base + 1);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= p0) lo = mid + 1; else hi = mid;
      }
      int i = lo - 1;
#pragma unroll
      for (int u = 0; u < kSlotsPerThread; ++u) {
        const int p = p0 + u;
        if (p >= num_pairs) break;
        while (i + 1 < w && s_off[i + 1] <= p) ++i;
        const int g = g0 + i;
        const Rect r = __ldg(rect + g);
        const unsigned int m = static_cast<unsigned int>(__ldg(mask + g));
        // Each field is at most 31 bits wide, so it fits an int once
        // decoded in the rect's own width.
        const int xm = static_cast<int>(r >> (by + bw + bh));
        const int ym = static_cast<int>((r >> (bw + bh)) & ((Rect(1) << by) - 1));
        const int tw = max(static_cast<int>((r >> bh) & ((Rect(1) << bw) - 1)), 1);
        int k = p - s_off[i];
        if (m != 0u) k = kth_set_bit(m, k);
        const int tile = (ym + k / tw) * tiles_x + xm + k % tw;
        a[u] = packed ? ((tile << rank_bits) | g) : tile;
        b[u] = g;
      }
    }
  }

  if (p0 + kSlotsPerThread <= capacity) {
    reinterpret_cast<int4*>(out_a)[p0 / kSlotsPerThread] =
        make_int4(a[0], a[1], a[2], a[3]);
    if (!packed) {
      reinterpret_cast<int4*>(out_b)[p0 / kSlotsPerThread] =
          make_int4(b[0], b[1], b[2], b[3]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kSlotsPerThread; ++u) {
      if (p0 + u < capacity) {
        out_a[p0 + u] = a[u];
        if (!packed) out_b[p0 + u] = b[u];
      }
    }
  }
}

template <typename Rect>
int launch_expand(const void* off, const void* rect, const void* mask,
                  const void* num_pairs, int n, int capacity, int tiles_x,
                  int rank_bits, int sentinel, int by, int bw, int bh,
                  int packed, void* out_a, void* out_b, void* stream) {
  const int blocks = (capacity + kSlotsPerBlock - 1) / kSlotsPerBlock;
  expand_pairs_kernel<Rect><<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(off), static_cast<const Rect*>(rect),
      static_cast<const int*>(mask), static_cast<const int*>(num_pairs),
      n, capacity, tiles_x, rank_bits, sentinel, by, bw, bh, packed,
      static_cast<int*>(out_a), static_cast<int*>(out_b));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// int32 rects (every field fits 31 bits together).
extern "C" int gs_expand_pairs(
    const void* off, const void* rect, const void* mask, const void* num_pairs,
    int n, int capacity, int tiles_x, int rank_bits, int sentinel,
    int by, int bw, int bh, int packed, void* out_a, void* out_b,
    void* stream) {
  return launch_expand<int>(off, rect, mask, num_pairs, n, capacity, tiles_x,
                            rank_bits, sentinel, by, bw, bh, packed, out_a,
                            out_b, stream);
}

// int64 rects: tile grids whose fields need more than 31 bits together.
extern "C" int gs_expand_pairs_i64(
    const void* off, const void* rect, const void* mask, const void* num_pairs,
    int n, int capacity, int tiles_x, int rank_bits, int sentinel,
    int by, int bw, int bh, int packed, void* out_a, void* out_b,
    void* stream) {
  return launch_expand<long long>(off, rect, mask, num_pairs, n, capacity,
                                  tiles_x, rank_bits, sentinel, by, bw, bh,
                                  packed, out_a, out_b, stream);
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
