// K1: forward tile rasterizer, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussiansplat_tpu/ops/pallas/forward.py
// (_fwd_kernel, launched by rasterize_forward).
//
// What it computes, per tile t of the (T,) grid, on the depth-sorted pair
// rows [tile_starts[t], tile_starts[t+1]) of the (P, 16) f32 payload:
//   chunks are windows of chunk_size pairs aligned DOWN to a multiple of
//   chunk_size (base = start / cs * cs); lanes outside [start, end) are masked;
//   per pixel (integer tile-local coordinates, no +0.5) and pair:
//     q      = ca dx^2 + 2 cb dx dy + cc dy^2   (dx = x - (mx - ox), ...)
//     alpha  = min(op exp(-q/2), alpha_max) where op exp(-q/2) >= alpha_min
//              and q <= sigma^2, else the pair is skipped;
//     w      = alpha exp(logT);  acc += w [r, g, b, 1, depth];
//     logT  += log1p(-alpha);
//   after each chunk the tile stops if max over its pixels of logT <= log_eps.
//   Output block (8, tile_size^2) per tile: R, G, B, logT, weight sum, depth
//   sum, the number of chunks composited (as f32), 0.
//
// What bounds it on this card: instruction issue (128 thread instructions
// per clock per SM; its multiplies and adds are rounded apart, so none
// fuse), then the special-function units (16 per clock per SM). The bound
// in chip_smoke.py (`K1_COST`) counts the function's work on the run's
// data: each composited pair's support extent, the gates of every (pixel,
// pair) inside that extent and the compositing of every live (pixel,
// pair): 0.126 ms at 1080p with 1M gaussians, instruction issue (bytes
// 0.027 ms). The kernel takes ~0.65 ms there, 5x the bound. What holds it
// above the bound (PERF.md): the design's own work, 0.211 ms by the same
// counts (a kept (warp, pair) evaluates the gates at all 128 pixels of the
// warp's box, 2.1 times the (pixel, pair)s inside an extent, and a thread
// with a live pixel composites all four of its quad); and the grid's tail:
// the heaviest tile alone takes a third of the kernel, and launching the
// tiles heaviest first would save ~12%, which needs an order computed
// before the launch (a ranking inside the kernel, by segment length, was
// measured slower and is not kept).
//
// What the design does about it (raster_common.cuh holds the shared parts):
// one block per tile, one thread per 2x2 pixel quad, 256 threads at
// tile_size 32 (at most 85 registers: three blocks share an SM). Each
// aligned chunk is staged once into shared memory as 48-byte lanes (three
// 16-byte loads of the row), with the pair's support extent computed once
// per pair. A warp tests 32 staged pairs at once against its 16x8-pixel
// box, one per lane, and walks only the kept ones, reading each with
// 16-byte broadcast loads; the cull removes 61% of the (warp, pair)s at
// 1080p. For a kept pair a thread shares the per-column and per-row terms of
// q between its four pixels and composites the four as straight-line code
// with selects, so their exp / log1p chains overlap. Each pixel composites
// in depth order with the same rounded arithmetic as the one-thread-per-pixel
// kernel before it, so the output is bit-identical to that kernel's
// (compare_forward_builds.py); the tile's early exit is one
// __syncthreads_or per chunk. The TPU kernel's MXU formulation (polynomial
// basis, triangular-matmul prefix sums, bf16 Dekker splits) is not carried
// over, and tensor cores are not used: q is six rounded terms per (pixel,
// pair) that K2 must reproduce gate for gate, which a TF32 or bf16 product
// would not (raster_common.cuh). Staging is not overlapped with compute: a
// tile composites ~2 chunks on average at 1080p, each for tens of
// microseconds, against a copy of ~1 us that the SM's other blocks cover.
//
// Timing variants (ops/kernels/ablate.py), one -D flag each, the TPU
// kernel's `ablate=` on this kernel's structure; with none defined this
// source is the production kernel. Each keeps a 1e-30-scaled fold of the
// work it keeps in an output, so that nvcc does not delete that work.
//   GS_ABLATE_DMAONLY: each chunk's rows staged as raw copies (no extent),
//     no cull, gates or compositing; logT stays 0, so every chunk is
//     streamed (the early exit never fires). The R row holds 1e-30 x a
//     staged value a chunk (at each thread's first pixel), G-depth 0, the
//     stop row the chunk count.
//   GS_ABLATE_NOACC: the cull, gates, alpha, w and the logT sum; no channel
//     accumulation: the weight-sum row holds 1e-30 x its value, R, G, B and
//     depth 0; logT and the stop row are production's bits.
//   GS_ABLATE_NOWRITE: everything, but the 8-row store replaced by one
//     checksum a tile in out[t][0][0], the sum of the tile's 8 rows over
//     its pixels; every other entry is left unwritten.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using gs::kNch;
using gs::kNout;
using gs::kQuads;
using gs::Lane;

__global__ void __launch_bounds__(256, 3) forward_kernel(
    const float* __restrict__ payload, const int* __restrict__ tile_starts,
    int tile_size, int chunk_size, int tiles_x, int tile_row0,
    float alpha_min, float alpha_max, float sigma_sq, float log_eps,
    float* __restrict__ out) {
  extern __shared__ Lane lanes[];  // chunk_size lanes
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int px = tile_size * tile_size;
  const int cs = chunk_size;

  const int start = __ldg(tile_starts + t);
  const int end = __ldg(tile_starts + t + 1);
  const int base = (start / cs) * cs;
  const int n_chunks = (end - base + cs - 1) / cs;

  const float ox = static_cast<float>((t % tiles_x) * tile_size);
  const float oy = static_cast<float>((t / tiles_x + tile_row0) * tile_size);
  const gs::QuadPixels pix = gs::quad_pixels(tid, tile_size);

  float acc_r[kQuads], acc_g[kQuads], acc_b[kQuads], acc_w[kQuads],
      acc_d[kQuads], log_t[kQuads];
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    acc_r[k] = acc_g[k] = acc_b[k] = acc_w[k] = acc_d[k] = log_t[k] = 0.f;
  }
  int ci = 0;
  bool alive = true;
  while (ci < n_chunks && alive) {
    const int cbase = base + ci * cs;
    const int j0 = max(start - cbase, 0);
    const int j1 = min(end - cbase, cs);
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = j0 + tid; j < j1; j += blockDim.x) {
#if defined(GS_ABLATE_DMAONLY)
      gs::stage_raw(payload + static_cast<size_t>(cbase + j) * kNch, lanes + j);
#else
      gs::stage_pair(payload + static_cast<size_t>(cbase + j) * kNch, ox, oy,
                     alpha_min, sigma_sq, lanes + j);
#endif
    }
    __syncthreads();
#if defined(GS_ABLATE_DMAONLY)
    (void)ox;
    (void)oy;
    // An empty segment's one chunk stages nothing.
    if (j0 < j1) acc_r[0] = __fadd_rn(acc_r[0], __fmul_rn(lanes[j0].cull.x, 1e-30f));
#else
    for (int jb = j0; jb < j1; jb += 32) {
      // The warp tests 32 pairs at once, one per lane, then walks the kept
      // ones in depth order.
      unsigned todo = gs::kept_pairs(pix, lanes, jb, j1);
      while (todo) {
        const int j = jb + __ffs(todo) - 1;
        todo &= todo - 1;
        const float4 cull = lanes[j].cull;
        const float4 conic = lanes[j].conic;
#if !defined(GS_ABLATE_NOACC)
        const float4 col = lanes[j].color;
#endif
        float dx[2], dy[2], q[kQuads], a_raw[kQuads];
        gs::quad_q(pix, cull, conic, dx, dy, q);
        bool live[kQuads], any = false;
#pragma unroll
        for (int k = 0; k < kQuads; ++k) {
          live[k] = gs::splat_alpha(q[k], conic.w, alpha_min, sigma_sq,
                                    a_raw[k]) && (pix.valid >> k & 1u);
          any |= live[k];
        }
        if (!any) continue;
        // The four pixels' compositing as straight-line code with selects,
        // so their exp / log1p chains overlap; a pixel that is not live
        // keeps its values.
#pragma unroll
        for (int k = 0; k < kQuads; ++k) {
          const float alpha = fminf(a_raw[k], alpha_max);
          const float w = __fmul_rn(alpha, expf(log_t[k]));
          const float ell = log1pf(-alpha);
#if defined(GS_ABLATE_NOACC)
          acc_w[k] = live[k] ? __fadd_rn(acc_w[k], __fmul_rn(w, 1e-30f)) : acc_w[k];
#else
          acc_r[k] = live[k] ? __fadd_rn(acc_r[k], __fmul_rn(w, col.x)) : acc_r[k];
          acc_g[k] = live[k] ? __fadd_rn(acc_g[k], __fmul_rn(w, col.y)) : acc_g[k];
          acc_b[k] = live[k] ? __fadd_rn(acc_b[k], __fmul_rn(w, col.z)) : acc_b[k];
          acc_w[k] = live[k] ? __fadd_rn(acc_w[k], w) : acc_w[k];
          acc_d[k] = live[k] ? __fadd_rn(acc_d[k], __fmul_rn(w, col.w)) : acc_d[k];
#endif
          log_t[k] = live[k] ? __fadd_rn(log_t[k], ell) : log_t[k];
        }
      }
    }
#endif
    ++ci;
    bool open = false;
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      open |= (pix.valid >> k & 1u) && log_t[k] > log_eps;
    }
    alive = __syncthreads_or(open) != 0;
  }

#if defined(GS_ABLATE_NOWRITE)
  // One checksum a tile; the barrier above ended every read of the lanes.
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    if (!(pix.valid >> k & 1u)) continue;
    sum += acc_r[k] + acc_g[k] + acc_b[k] + log_t[k] + acc_w[k] + acc_d[k] +
           static_cast<float>(ci);
  }
  sum = gs::block_sum(sum, reinterpret_cast<float*>(lanes));
  if (tid == 0) out[static_cast<size_t>(t) * kNout * px] = sum;
#else
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    if (!(pix.valid >> k & 1u)) continue;
    float* o = out + static_cast<size_t>(t) * kNout * px +
               (pix.y + (k >> 1)) * tile_size + pix.x + (k & 1);
    o[0 * px] = acc_r[k];
    o[1 * px] = acc_g[k];
    o[2 * px] = acc_b[k];
    o[3 * px] = log_t[k];
    o[4 * px] = acc_w[k];
    o[5 * px] = acc_d[k];
    o[6 * px] = static_cast<float>(ci);
    o[7 * px] = 0.f;
  }
#endif
}

}  // namespace

extern "C" int gs_rasterize_forward(
    const void* payload, const void* tile_starts, int num_tiles,
    int tile_size, int chunk_size, int tiles_x, int tile_row0,
    float alpha_min, float alpha_max, float sigma_sq, float log_eps,
    void* out, void* stream) {
  const int threads = gs::block_threads(tile_size);
  const size_t smem = static_cast<size_t>(chunk_size) * sizeof(Lane);
#if defined(GS_ABLATE_BLOCKS)
  // A timing build pinned to production's blocks per SM (raster_common.cuh).
  const size_t smem_run =
      gs::pinned_smem(forward_kernel, threads, smem, GS_ABLATE_BLOCKS);
  cudaError_t e = cudaFuncSetAttribute(
      forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_run));
  if (e != cudaSuccess) return static_cast<int>(e);
#else
  // Above 48 KB a block's shared memory is dynamic only after this opt-in.
  cudaError_t e = cudaFuncSetAttribute(
      forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
#endif
#if defined(GS_ABLATE_BLOCKS)
  forward_kernel<<<num_tiles, threads, smem_run,
                   static_cast<cudaStream_t>(stream)>>>(
#else
  forward_kernel<<<num_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
#endif
      static_cast<const float*>(payload), static_cast<const int*>(tile_starts),
      tile_size, chunk_size, tiles_x, tile_row0, alpha_min, alpha_max,
      sigma_sq, log_eps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

#if defined(GS_ABLATE_BLOCKS)
// The blocks per SM of the last launch's configuration, by the occupancy API.
extern "C" int gs_ablate_blocks_per_sm() { return gs::last_blocks(); }
#endif

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
