// R: the binning's per-gaussian rects, survivor masks and pair counts,
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference computes these with XLA
// elementwise ops (gaussiansplat_tpu/ops/binning.py, `tile_ranges` and the
// survivor mask of `compact_rects`), and the port first did the same with
// eager PyTorch (ops/binning.py `tile_rects_torch`, the plain version this
// kernel is held to bit for bit). That version tests 32 tile lanes of every
// gaussian as (N, 32) tensors, whatever the size of its rect.
//
// What it computes, for each gaussian i (one thread):
//   the rect (xmin, ymin, tw, th) in tiles: the support box's tile range
//     (`tile_ranges`), its rows clipped to the strip [tile_row0,
//     tile_row0 + tile_rows) and made strip-relative;
//   count  = min(tw * th, max_tiles), 0 where `valid` is false;
//   mask   = where `cull` (the config's tile_cull on an int32 grid), count
//     > 0 and tw * th <= 32: bit ky * tw + kx set for each tile of the
//     rect whose pixel square meets the visible support {q <= tau}, tau =
//     min(2 (ln max(opacity, 1e-12) - ln alpha_min), sigma_radius^2), by
//     the exact minimum of q over the square (`_rect_qmin`); the count is
//     then min(popcount(mask), max_tiles); else 0;
//   rect   = (((xmin << by | ymin) << bw | tw) << bh) | th where count > 0,
//     else 0; int32, or int64 on tile grids whose fields need more than 31
//     bits (one body, two instantiations: gs_tile_rects, gs_tile_rects_i64);
//   key    = the depth where count > 0, else +inf: the compaction sort's key.
//
// Exactness: every float expression is evaluated as the plain version
// evaluates it, one rounding an operation in the same order: explicit
// round-to-nearest intrinsics (no contraction into FMA), IEEE division,
// NaN-propagating min / max as torch.minimum / maximum / clamp, and the
// device's logf, which torch.log also calls. The tile edge divides as
// torch divides a CUDA tensor by a Python number: by multiplying with the
// float reciprocal, computed on the host (exact for the power-of-two tile
// edges in use, where it equals the division).
//
// What bounds it on this card: bytes. It reads 37 B a gaussian (mean 8,
// conic 12, opacity 4, depth 4, radius_xy 8, valid 1) and writes 16 (rect,
// mask, count, key): 0.05 ms at 3M gaussians at 3.35 TB/s. The arithmetic
// is ~60 operations for each tile of the rect, and a rect averages a few
// tiles.
//
// What the design does about that: one thread a gaussian, 256 a block,
// every load and store coalesced across the warp. A thread tests only the
// tw * th tiles of its own rect, in registers, and sets the mask's bits by
// shifts; the count is one __popc. An invalid gaussian or an empty rect
// (a padding row of a shard's arrivals) loads nothing but `valid` and its
// radii and runs no loop. Each field is read with its own row stride, so a
// column of the (M, 16) payload is read in place.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaskTiles = 32;

// torch.maximum / torch.minimum / torch.clamp on float32: a NaN operand
// gives NaN (fmaxf and fminf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// torch.clamp(floor(x), 0, hi).to(int32), x finite.
__device__ __forceinline__ int to_tile(float x, int hi) {
  return static_cast<int>(nan_min(nan_max(floorf(x), 0.0f),
                                  static_cast<float>(hi)));
}

// a * x * x + 2 b * x * y + c * y * y, left to right; b2 = 2 b.
__device__ __forceinline__ float quad(float a, float b2, float c, float x,
                                      float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(a, x), x),
                             __fmul_rn(__fmul_rn(b2, x), y)),
                   __fmul_rn(__fmul_rn(c, y), y));
}

struct Fields {
  const float* mean2d;           // (N, 2) rows of s_mean floats
  const float* conic;            // (N, 3) rows of s_conic floats
  const float* opacity;          // (N,)
  const float* depth;            // (N,)
  const int* radius_xy;          // (N, 2) rows of s_rad ints
  const unsigned char* valid;    // (N,) bool
  long long s_mean, s_conic, s_op, s_depth, s_rad, s_valid;
};

struct Grid {
  int n, tile_size, tiles_x, tiles_y, tile_row0, tile_rows;
  int by, bw, bh, cull, max_tiles;
  float inv_tile, tau_max, log_alpha_min;
};

template <typename Rect>
__global__ void __launch_bounds__(kThreads) tile_rects_kernel(
    Fields f, Grid g, Rect* __restrict__ rect_out, int* __restrict__ mask_out,
    int* __restrict__ count_out, float* __restrict__ key_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.n) return;
  Rect rect = 0;
  unsigned int mask = 0u;
  int count = 0;
  float key = __int_as_float(0x7f800000);  // +inf: sorts to the tail

  if (__ldg(f.valid + i * f.s_valid)) {
    const int rxi = __ldg(f.radius_xy + i * f.s_rad);
    const int ryi = __ldg(f.radius_xy + i * f.s_rad + 1);
    const float u = __ldg(f.mean2d + i * f.s_mean);
    const float v = __ldg(f.mean2d + i * f.s_mean + 1);
    const float rx = static_cast<float>(rxi);
    const float ry = static_cast<float>(ryi);
    // tile_ranges
    const int xmin = to_tile(__fmul_rn(__fsub_rn(u, rx), g.inv_tile), g.tiles_x);
    int ymin = to_tile(__fmul_rn(__fsub_rn(v, ry), g.inv_tile), g.tiles_y);
    int xmax = to_tile(__fadd_rn(floorf(__fmul_rn(__fadd_rn(u, rx), g.inv_tile)),
                                 1.0f), g.tiles_x);
    int ymax = to_tile(__fadd_rn(floorf(__fmul_rn(__fadd_rn(v, ry), g.inv_tile)),
                                 1.0f), g.tiles_y);
    const bool empty = rxi <= 0 || ryi <= 0;
    xmax = empty ? xmin : max(xmax, xmin);
    ymax = empty ? ymin : max(ymax, ymin);
    // The strip, in strip-relative tile rows.
    ymin = min(max(ymin - g.tile_row0, 0), g.tile_rows);
    ymax = min(max(ymax - g.tile_row0, 0), g.tile_rows);
    const int tw = xmax - xmin;
    const int th = ymax - ymin;
    // int32 as torch multiplies it (wrapping).
    const int area = static_cast<int>(static_cast<unsigned int>(tw) *
                                      static_cast<unsigned int>(th));
    count = min(area, g.max_tiles);

    if (sizeof(Rect) == sizeof(int) && g.cull && count > 0 &&
        area <= kMaskTiles) {
      const float ca = __ldg(f.conic + i * f.s_conic);
      const float cb = __ldg(f.conic + i * f.s_conic + 1);
      const float cc = __ldg(f.conic + i * f.s_conic + 2);
      const float op = __ldg(f.opacity + i * f.s_op);
      const float tau = nan_min(
          __fmul_rn(2.0f, __fsub_rn(logf(nan_max(op, 1e-12f)),
                                    g.log_alpha_min)),
          g.tau_max);
      const float ca_s = nan_max(ca, 1e-12f);
      const float cc_s = nan_max(cc, 1e-12f);
      const float cb2 = __fmul_rn(2.0f, cb);
      const float ts = static_cast<float>(g.tile_size);
      for (int ky = 0; ky < th; ++ky) {
        const float y0 = __fsub_rn(
            static_cast<float>((ymin + ky + g.tile_row0) * g.tile_size), v);
        const float y1 = __fadd_rn(y0, ts);
        const float ye = nan_min(nan_max(0.0f, y0), y1);
        const float xs_num = __fmul_rn(-cb, ye);
        for (int kx = 0; kx < tw; ++kx) {
          const float x0 = __fsub_rn(
              static_cast<float>((xmin + kx) * g.tile_size), u);
          const float x1 = __fadd_rn(x0, ts);
          // _rect_qmin: the form's minimum along the two faces nearest
          // the centre.
          const float xe = nan_min(nan_max(0.0f, x0), x1);
          const float ys = nan_min(
              nan_max(__fdiv_rn(__fmul_rn(-cb, xe), cc_s), y0), y1);
          const float xs = nan_min(nan_max(__fdiv_rn(xs_num, ca_s), x0), x1);
          const float qmin = nan_min(quad(ca, cb2, cc, xe, ys),
                                     quad(ca, cb2, cc, xs, ye));
          if (__fsub_rn(__fmul_rn(qmin, 0.999f), 1e-2f) <= tau) {
            mask |= 1u << (ky * tw + kx);
          }
        }
      }
      count = min(__popc(mask), g.max_tiles);
    }

    if (count > 0) {
      rect = ((((((static_cast<Rect>(xmin) << g.by) | static_cast<Rect>(ymin))
                 << g.bw) | static_cast<Rect>(tw)) << g.bh) |
              static_cast<Rect>(th));
      key = __ldg(f.depth + i * f.s_depth);
    }
  }
  rect_out[i] = rect;
  mask_out[i] = static_cast<int>(mask);
  count_out[i] = count;
  key_out[i] = key;
}

template <typename Rect>
int launch_rects(const void* mean2d, long long s_mean, const void* conic,
                 long long s_conic, const void* opacity, long long s_op,
                 const void* depth, long long s_depth, const void* radius_xy,
                 long long s_rad, const void* valid, long long s_valid, int n,
                 int tile_size, int tiles_x, int tiles_y, int tile_row0,
                 int tile_rows, int by, int bw, int bh, int cull,
                 int max_tiles, float inv_tile, float tau_max,
                 float log_alpha_min, void* rect, void* mask, void* count,
                 void* key, void* stream) {
  if (n <= 0) return 0;
  const Fields f{static_cast<const float*>(mean2d),
                 static_cast<const float*>(conic),
                 static_cast<const float*>(opacity),
                 static_cast<const float*>(depth),
                 static_cast<const int*>(radius_xy),
                 static_cast<const unsigned char*>(valid),
                 s_mean, s_conic, s_op, s_depth, s_rad, s_valid};
  const Grid g{n, tile_size, tiles_x, tiles_y, tile_row0, tile_rows,
               by, bw, bh, cull, max_tiles, inv_tile, tau_max, log_alpha_min};
  const int blocks = (n + kThreads - 1) / kThreads;
  tile_rects_kernel<Rect><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      f, g, static_cast<Rect*>(rect), static_cast<int*>(mask),
      static_cast<int*>(count), static_cast<float*>(key));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define GS_TILE_RECTS_ARGS                                                    \
  const void *mean2d, long long s_mean, const void *conic, long long s_conic, \
      const void *opacity, long long s_op, const void *depth,                 \
      long long s_depth, const void *radius_xy, long long s_rad,              \
      const void *valid, long long s_valid, int n, int tile_size,             \
      int tiles_x, int tiles_y, int tile_row0, int tile_rows, int by, int bw, \
      int bh, int cull, int max_tiles, float inv_tile, float tau_max,         \
      float log_alpha_min, void *rect, void *mask, void *count, void *key,    \
      void *stream
#define GS_TILE_RECTS_CALL                                                    \
  mean2d, s_mean, conic, s_conic, opacity, s_op, depth, s_depth, radius_xy,   \
      s_rad, valid, s_valid, n, tile_size, tiles_x, tiles_y, tile_row0,       \
      tile_rows, by, bw, bh, cull, max_tiles, inv_tile, tau_max,              \
      log_alpha_min, rect, mask, count, key, stream

// int32 rects (every field fits 31 bits together).
extern "C" int gs_tile_rects(GS_TILE_RECTS_ARGS) {
  return launch_rects<int>(GS_TILE_RECTS_CALL);
}

// int64 rects: tile grids whose fields need more than 31 bits together
// (no survivor mask there, as in the plain version).
extern "C" int gs_tile_rects_i64(GS_TILE_RECTS_ARGS) {
  return launch_rects<long long>(GS_TILE_RECTS_CALL);
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
