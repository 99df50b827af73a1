// Shared by the forward (forward.cu, K1) and backward (backward.cu, K2)
// raster kernels: the thread-to-pixel mapping, the staging of one pair's
// needed payload channels with its support extent, the warp's support cull
// and the alpha evaluation with its two gates.
//
// K2 rewinds each pixel's transmittance by exactly the pairs that K1
// composited. A pair that passes a gate in one kernel and fails it in the
// other corrupts the rewound logT of every earlier pair of that pixel, so
// both kernels evaluate q, alpha and the gates through these functions:
// explicitly rounded multiplies and adds (no FMA contraction), in the
// factored order of the plain PyTorch versions (ops/tile_raster.py).
//
// Pixel mapping. A thread owns a 2x2 quad of pixels; a warp owns 8x4 quads,
// a 16x8-pixel box; a tile of tile_size <= 32 is ceil(ts/16) x ceil(ts/8)
// warps (8 warps, 256 threads at 32). Pixels past the tile's edge (odd or
// small tile sizes) are masked per pixel. Per pair, a thread loads the
// staged lane once for its four pixels and shares the per-x and per-y terms
// of q between them (26 rounded instructions for four q's, not 44).
//
// Support cull. At staging, each pair gets a q cut (qcut) at or above every
// q that can pass both gates, and the half-widths (hx, hy) of the ellipse
// q <= qcut, widened for the rounding of q. A warp whose 16x8 box lies
// outside mean +- (hx, hy) skips the pair: no gate evaluation and, in K2, no
// vote. The warp tests 32 pairs at once, one per lane. The cull is exact
// only because it is conservative: it never skips a (pixel, pair) that the
// gates pass (tests/test_torch_raster.py holds the plain twin,
// ops/tile_raster.support_extent, to that). On the card, K1 and K2 built
// with GS_NO_SUPPORT_CULL (every pair kept) must give the same bits as the
// culled build, on scenes whose opacities reach down to alpha_min
// (tests/test_torch_gpu.py), and K1 those of the build before the cull
// (compare_forward_builds.py). A per-pixel test of q against qcut before the
// exponential was measured slower (PERF.md) and is not kept.
//
// No tensor cores: q is six rounded terms per (pixel, pair), and K1 and K2
// must agree on every gate. A TF32 or bf16 product of a pixel basis (the TPU
// kernel's MXU form) would need Dekker splits to keep f32 accuracy, and
// would still move the gates.

#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr int kNch = 16;   // payload channels per row
constexpr int kNout = 8;   // output rows per tile of the forward block
constexpr int kOutLogT = 3;
constexpr int kOutStop = 6;
constexpr int kQuads = 4;  // pixels per thread (a 2x2 quad)

// Staged lane of one pair: three float4, read with 16-byte shared loads.
//   cull:  mean x - ox, mean y - oy (tile-local), half-widths hx, hy
//   conic: a, 2b, c, opacity
//   color: r, g, b, depth
struct Lane {
  float4 cull, conic, color;
};

// The tile's thread layout: warps across and down, and threads per block.
__host__ __device__ inline int warps_x(int tile_size) {
  return (tile_size + 15) / 16;
}
__host__ __device__ inline int warps_y(int tile_size) {
  return (tile_size + 7) / 8;
}
__host__ __device__ inline int block_threads(int tile_size) {
  return 32 * warps_x(tile_size) * warps_y(tile_size);
}

// One thread's quad and its warp's pixel box, in tile-local integer
// coordinates (pixel centres at integers, no +0.5).
struct QuadPixels {
  float x0, y0;            // the quad's top-left pixel; the others at +1
  float bx0, bx1, by0, by1;  // the warp's box, clipped to the tile
  int x, y;                // integer top-left
  unsigned valid;          // bit p: pixel p (x + (p & 1), y + (p >> 1)) in the tile
};

__device__ __forceinline__ QuadPixels quad_pixels(int tid, int tile_size) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wx = warp % warps_x(tile_size);
  const int wy = warp / warps_x(tile_size);
  QuadPixels p;
  p.x = 16 * wx + 2 * (lane & 7);
  p.y = 8 * wy + 2 * (lane >> 3);
  p.x0 = static_cast<float>(p.x);
  p.y0 = static_cast<float>(p.y);
  p.bx0 = static_cast<float>(16 * wx);
  p.bx1 = static_cast<float>(min(16 * wx + 15, tile_size - 1));
  p.by0 = static_cast<float>(8 * wy);
  p.by1 = static_cast<float>(min(8 * wy + 7, tile_size - 1));
  p.valid = 0;
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    if (p.x + (k & 1) < tile_size && p.y + (k >> 1) < tile_size) p.valid |= 1u << k;
  }
  return p;
}

// The support of one pair, shared with the plain twin
// ops/tile_raster.support_extent (same formula, same roundings up to logf
// and sqrtf, whose few-ulp differences the margins cover).
//   r2   = min(sigma^2, 2 log(opacity / alpha_min)), at least 0: past it a
//          gate fails (below alpha_min no pixel is live, and 0 keeps the
//          cut finite);
//   qcut = r2 + 1e-4 |r2| + 1e-4: covers the rounding of log and of the
//          explicitly rounded alpha (~1e-6 relative), so q > qcut fails;
//   hx, hy = sqrt(qbox c / det), sqrt(qbox a / det), the half-widths of the
//          ellipse q <= qbox, qbox = qcut (1 + 1e-4 + 4e-6 kappa), where
//          kappa = (a + c)^2 / det bounds the conic's condition number: the
//          rounded q of a pixel is at least (1 - 16 u kappa) of its exact q
//          at the rounded offsets (u = 2^-24), so a pixel outside the box
//          has a rounded q above qcut.
// No cull (infinite extent) unless a > 0, det = ac - b^2 > 0 and
// kappa <= 6.25e4.
__device__ __forceinline__ void support_extent(float a, float b, float c,
                                               float op, float alpha_min,
                                               float sigma_sq, float& qcut,
                                               float& hx, float& hy) {
  const float r2 = fmaxf(
      fminf(sigma_sq, __fmul_rn(2.0f, logf(__fdiv_rn(op, alpha_min)))), 0.0f);
  qcut = __fadd_rn(__fadd_rn(r2, __fmul_rn(1e-4f, fabsf(r2))), 1e-4f);
  const float det = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, b));
  const float s = __fadd_rn(a, c);
  const float kappa = __fdiv_rn(__fmul_rn(s, s), det);
  hx = hy = __int_as_float(0x7f800000);  // +inf: no cull
  if (a > 0.0f && det > 0.0f && kappa <= 6.25e4f) {
    const float qbox = fmaxf(
        __fmul_rn(qcut, __fadd_rn(1.0001f, __fmul_rn(4e-6f, kappa))), 0.0f);
    hx = sqrtf(__fdiv_rn(__fmul_rn(qbox, c), det));
    hy = sqrtf(__fdiv_rn(__fmul_rn(qbox, a), det));
  }
}

// Stage payload row `row` (64 B, 16-byte aligned) as a Lane for the tile at
// (ox, oy): three 16-byte loads of channels 0-11.
__device__ __forceinline__ void stage_pair(const float* __restrict__ row,
                                           float ox, float oy, float alpha_min,
                                           float sigma_sq, Lane* lane) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 p0 = __ldg(r4 + 0);  // mx, my, a, b
  const float4 p1 = __ldg(r4 + 1);  // c, opacity, r, g
  const float4 p2 = __ldg(r4 + 2);  // b, 1, depth, (11)
  float qcut, hx, hy;
  support_extent(p0.z, p0.w, p1.x, p1.y, alpha_min, sigma_sq, qcut, hx, hy);
  lane->cull = make_float4(__fsub_rn(p0.x, ox), __fsub_rn(p0.y, oy), hx, hy);
  lane->conic = make_float4(p0.z, __fmul_rn(2.0f, p0.w), p1.x, p1.y);
  lane->color = make_float4(p1.z, p1.w, p2.x, p2.z);
}

#if defined(GS_ABLATE_DMAONLY)
// Timing variant `dmaonly` (ops/kernels/ablate.py): the same three 16-byte
// loads of the row, stored as they are, with no support extent.
__device__ __forceinline__ void stage_raw(const float* __restrict__ row,
                                          Lane* lane) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  lane->cull = __ldg(r4 + 0);
  lane->conic = __ldg(r4 + 1);
  lane->color = __ldg(r4 + 2);
}
#endif

#if defined(GS_ABLATE_NOWRITE)
// Timing variant `nowrite`: the sum of v over the block, in thread 0 (a
// warp's butterfly, then the warps in order). Every thread must call it;
// `scratch` holds one float a warp and no thread reads it any more.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += scratch[w];
  }
  return s;
}
#endif

#if defined(GS_ABLATE_BLOCKS)
// Timing builds pinned to production's occupancy (ops/kernels/ablate.py):
// the least dynamic shared memory, at least `smem`, at which at most
// `blocks` blocks of `threads` threads of `kernel` fit on an SM by the
// occupancy API, so that a variant whose registers would fit more blocks
// runs as many as production. A binary search over the opt-in range; the
// last answer is kept, and so is the count it gives (`last_blocks`).
inline int& last_blocks() {
  static int n = 0;
  return n;
}

template <typename Kernel>
inline size_t pinned_smem(Kernel kernel, int threads, size_t smem, int blocks) {
  static int last_threads = -1;
  static size_t last_in = 0, last_out = 0;
  if (threads == last_threads && smem == last_in) return last_out;
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       max_smem);
  auto fit = [&](size_t s) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, s);
    return n;
  };
  size_t lo = smem, hi = static_cast<size_t>(max_smem);
  if (fit(lo) > blocks) {  // the least s in (lo, hi] with fit(s) <= blocks
    while (hi - lo > 1) {
      const size_t mid = lo + (hi - lo) / 2;
      if (fit(mid) <= blocks) {
        hi = mid;
      } else {
        lo = mid;
      }
    }
    lo = hi;
  }
  last_threads = threads;
  last_in = smem;
  last_out = lo;
  last_blocks() = fit(lo);
  return lo;
}
#endif

// Whether the warp's box may hold a pixel inside the pair's support.
// Rounding is monotone, so the box's extreme offsets bound every pixel's
// rounded offset dx = x - mx.
__device__ __forceinline__ bool box_hits(const QuadPixels& p, float4 cull) {
  return __fsub_rn(p.bx0, cull.x) <= cull.z &&
         __fsub_rn(p.bx1, cull.x) >= -cull.z &&
         __fsub_rn(p.by0, cull.y) <= cull.w &&
         __fsub_rn(p.by1, cull.y) >= -cull.w;
}

// The pairs of [jb, min(jb + 32, j1)) whose extent meets the warp's box, as
// a mask (bit b: pair jb + b). Lane b tests pair jb + b, so the warp tests
// 32 pairs with one shared load each and never waits on a culled pair.
// Every lane of the warp must call it.
__device__ __forceinline__ unsigned kept_pairs(const QuadPixels& p,
                                               const Lane* lanes, int jb,
                                               int j1) {
  const int j = jb + (threadIdx.x & 31);
#ifdef GS_NO_SUPPORT_CULL
  return __ballot_sync(0xffffffffu, j < j1);
#else
  return __ballot_sync(0xffffffffu, j < j1 && box_hits(p, lanes[j].cull));
#endif
}

// The quad's offsets and quadratic forms against one pair, in the order of
// the single-pixel formula
//   q = ((a dx) dx + ((2b) dx) dy) + (c dy) dy
// with (a dx) dx, (2b) dx and (c dy) dy computed once per column or row.
// Pixel k is (x0 + (k & 1), y0 + (k >> 1)).
__device__ __forceinline__ void quad_q(const QuadPixels& p, float4 cull,
                                       float4 conic, float dx[2], float dy[2],
                                       float q[kQuads]) {
  dx[0] = __fsub_rn(p.x0, cull.x);
  dx[1] = __fsub_rn(__fadd_rn(p.x0, 1.0f), cull.x);
  dy[0] = __fsub_rn(p.y0, cull.y);
  dy[1] = __fsub_rn(__fadd_rn(p.y0, 1.0f), cull.y);
  float ax[2], bx[2], cy[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ax[i] = __fmul_rn(__fmul_rn(conic.x, dx[i]), dx[i]);
    bx[i] = __fmul_rn(conic.y, dx[i]);
    cy[i] = __fmul_rn(__fmul_rn(conic.z, dy[i]), dy[i]);
  }
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    q[k] = __fadd_rn(__fadd_rn(ax[k & 1], __fmul_rn(bx[k & 1], dy[k >> 1])),
                     cy[k >> 1]);
  }
}

// Alpha before the clamp of a pixel with quadratic form q, and whether the
// pair is live there (alpha_raw >= alpha_min and q <= sigma^2).
__device__ __forceinline__ bool splat_alpha(float q, float op, float alpha_min,
                                            float sigma_sq, float& a_raw) {
  a_raw = __fmul_rn(op, expf(__fmul_rn(-0.5f, q)));
  return a_raw >= alpha_min && q <= sigma_sq;
}

}  // namespace gs
