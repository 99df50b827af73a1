// K2: backward tile rasterizer, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussiansplat_tpu/ops/pallas/backward.py
// (_bwd_kernel, launched by rasterize_backward), unpacked form.
//
// What it computes, per tile t, on the depth-sorted pair rows
// [tile_starts[t], tile_starts[t+1]) of the (P, 16) f32 payload, given the
// forward block (T, 8, tile_size^2) of K1 (row 3 the final logT, row 6 the
// number of chunks K1 composited, stored as f32) and the cotangent block of
// the same shape (rows dR, dG, dB, dlogT, dWsum, dDepth):
//   chunks are the forward's aligned windows; those at or past the stop
//   count get zero rows. Live chunks are swept in reverse, pair by pair:
//     logT_in = logT - log1p(-alpha)       (rewound; never a divide by 1-alpha)
//     w       = alpha exp(logT_in)
//     dw      = dR r + dG g + dB b + dWsum + dDepth depth
//     dalpha  = dw exp(logT_in) - S / (1 - alpha), 0 unless alpha_raw < alpha_max
//     S      += dw w                        (S starts at the pixel's dlogT)
//     dq      = -dalpha alpha / 2
//   and the pair's gradient row is the sum over the tile's pixels of
//     d mean  = -2 dq (a dx + b dy, c dy + b dx),   d conic = dq (dx^2, 2 dx dy, dy^2),
//     d opac  = -2 dq / max(opacity, 1e-20),        d (r, g, b, 1, depth) = (dR, dG, dB, dWsum, dDepth) w;
//   channels 11-15 are zero. Rows past tile_starts[T] are not written.
//
// What bounds it on this card: instruction issue (128 thread instructions
// per clock per SM), then the special-function units (16 per clock per SM:
// an exponential per gate, and a logarithm, an exponential and a reciprocal
// per live (pixel, pair)). The bound in chip_smoke.py (`K2_COST`) counts
// the function's work on the run's data: each composited pair's support
// extent, the gates of every (pixel, pair) inside that extent, and for
// every live (pixel, pair) the gradient and one add per channel of the sum
// over pixels: 0.191 ms at 1080p with 1M gaussians, instruction issue
// (bytes 0.071 ms). The kernel takes ~1.24 ms there, 6.5x the bound. What
// holds it above the bound (PERF.md): the design's own work, 0.379 ms by
// the same counts (the gates and the vote at all 128 pixels of a kept
// (warp, pair), the gradient for all four pixels of a thread in a warp
// with a live one, a 16-shuffle reduction per (warp, pair) with a live
// pixel, the rows' cross-warp sums); and the grid's tail (the heaviest
// tile alone takes 0.35 ms; launching the tiles heaviest first, by K1's
// composited pairs, would save ~12%, which needs an order passed to the
// kernel).
//
// What the design does about it (raster_common.cuh holds the shared
// parts): one block per tile, one thread per 2x2 pixel quad as K1, 256
// threads at tile_size 32, at most 85 registers so that three blocks share
// an SM (a barrier idles only its own block; two blocks per SM measured
// 10% slower). Each live chunk is staged once as 48-byte lanes with the
// pair's support extent; a warp tests 32 pairs at once against its 16x8
// box, zeroes the partials of the pairs it culls, and walks the kept ones
// in reverse, voting (one __any_sync) before any gradient math. A thread
// takes its four pixels' gradients as straight-line code with selects and
// sums them in registers; the warp then sums the 11 values with one
// transpose reduction: values padded to 16, at offset 16 each lane keeps 8
// and sends 8, then 4, 2, 1 and 1 shuffles, 16 in all (the
// one-butterfly-per-value form took 55), after which lanes 2c and 2c+1 hold
// channel c. The gradient's exponential and divide are `expf` and the IEEE
// divide: `__expf` and `__fdividef` took 8% off the kernel (PERF.md), but
// `__expf`'s error grows with |logT| (2 + 1.16 |logT| ulp), and the kernel
// computes the plain version's f32 function. Per sub-block of 128 pairs
// (one chunk at the default chunk_size), one thread per (pair, channel)
// adds the warps' partials from shared memory in warp order and writes the
// row. Every sum
// has a fixed order and there are no atomics: segments partition the sorted
// list, so each row is written by exactly one block and two runs give the
// same bits. The TPU kernel's read-modify-write of the boundary chunk is not
// needed: a block writes only the rows of its own segment. Its MXU
// formulation (moment matrices, triangular-matmul suffix sums, bf16 splits)
// is not carried over, nor are tensor cores used: the gates must be K1's,
// rounded term by term (raster_common.cuh). The rewind is per pixel rather
// than per chunk, which moves values only by rounding.
//
// Timing variants (ops/kernels/ablate.py), one -D flag each, the TPU
// kernel's `ablate=` on this kernel's structure; with none defined this
// source is the production kernel. A variant keeps a 1e-30-scaled fold of
// the work it keeps in a dropped row, so that nvcc does not delete it.
//   GS_ABLATE_DMAONLY: the live chunks staged as raw copies, no cull, gate
//     or gradient math; the rows written hold 1e-30 x a staged value in
//     channel 0 and zeros (the dead tail's zero fill stays).
//   GS_ABLATE_NOGRAD: the cull, gates, alpha, the per-pixel logT rewind and
//     t_in (the recompute), behind production's vote; no dw / dalpha chain,
//     no warp reduction, no partials: rows of zeros, channel 0 holding
//     1e-30 x the thread's sum of w.
//   GS_ABLATE_NOGEOM: no geometric rows 0-5: not summed over the quad, not
//     in the warp reduction (8 values, the same tree), no opacity combine.
//     dalpha with its divide, dq and the dlogT chain stay (row 0 holds
//     1e-30 x the sum of dq); rows 6-10 are production's.
//   GS_ABLATE_NODIRECT: no direct rows 6-10 (their sums and their share of
//     the reduction); rows 0-5 are production's.
//   GS_ABLATE_NOWRITE: everything, but the row stores and the dead tail's
//     zero fill (as the TPU variant) replaced by one checksum a tile in
//     dpayload[start][0], the sum of the tile's rows; every other entry is
//     left unwritten.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using gs::kNch;
using gs::kNout;
using gs::kQuads;
using gs::Lane;

constexpr int kSub = 128;  // pairs reduced together
constexpr int kRed = 11;   // per-pixel values summed per pair (channels 0-10)
constexpr unsigned kFull = 0xffffffffu;

// One step of the transpose reduction over `n` values at lane distance
// `off`: the lane with that bit set keeps the upper half and sends the
// lower, its partner the reverse.
template <int n, int off>
__device__ __forceinline__ void transpose_step(float* v, bool upper) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float send = upper ? v[i] : v[i + n];
    const float keep = upper ? v[i + n] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

// The warp sum of each of 16 per-lane values, in a fixed order: returns the
// sum of value (lane >> 1) in lanes 2c and 2c+1.
__device__ __forceinline__ float warp_transpose_sum(float v[16], int lane) {
  transpose_step<8, 16>(v, lane & 16);
  transpose_step<4, 8>(v, lane & 8);
  transpose_step<2, 4>(v, lane & 4);
  transpose_step<1, 2>(v, lane & 2);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

#if defined(GS_ABLATE_NOGEOM) || defined(GS_ABLATE_NODIRECT)
// The six values these variants reduce, padded to 8: the warp sum of value
// (lane >> 2) in lanes 4c..4c+3, by the tree of warp_transpose_sum (lanes
// 16, 8, 4, 2, 1 apart), so a kept channel's sum has production's bits.
constexpr int kRed8 = 6;
__device__ __forceinline__ float warp_transpose_sum8(float v[8], int lane) {
  transpose_step<4, 16>(v, lane & 16);
  transpose_step<2, 8>(v, lane & 8);
  transpose_step<1, 4>(v, lane & 4);
  const float s = v[0] + __shfl_xor_sync(kFull, v[0], 2);
  return s + __shfl_xor_sync(kFull, s, 1);
}
#endif
#if defined(GS_ABLATE_NOGEOM)
// Reduced value c is direct channel 6 + c, value 5 the fold of dq.
__device__ __forceinline__ int red_channel(int c) { return c < 5 ? 6 + c : 0; }
__device__ __forceinline__ bool summed(int ch) {
  return ch == 0 || (ch >= 6 && ch < kRed);
}
#elif defined(GS_ABLATE_NODIRECT)
__device__ __forceinline__ int red_channel(int c) { return c; }
__device__ __forceinline__ bool summed(int ch) { return ch < 6; }
#endif

__global__ void __launch_bounds__(256, 3) backward_kernel(
    const float* __restrict__ payload, const int* __restrict__ tile_starts,
    const float* __restrict__ fwd, const float* __restrict__ cot,
    int tile_size, int chunk_size, int tiles_x, int tile_row0,
    float alpha_min, float alpha_max, float sigma_sq,
    float* __restrict__ dpayload) {
  extern __shared__ Lane lanes[];  // chunk_size lanes, then the partials
  float* part = reinterpret_cast<float*>(lanes + chunk_size);  // warps x kSub x kRed
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int px = tile_size * tile_size;
  const int cs = chunk_size;

  const int start = __ldg(tile_starts + t);
  const int end = __ldg(tile_starts + t + 1);
  const int base = (start / cs) * cs;
  const int n_chunks = (end - base + cs - 1) / cs;
  const float* f = fwd + static_cast<size_t>(t) * kNout * px;
  const int stop = static_cast<int>(__ldg(f + gs::kOutStop * px));
  const int n_live = min(stop, n_chunks);

  // Rows of the chunks the forward never composited get zeros.
#if !defined(GS_ABLATE_NOWRITE)
  const int z0 = max(start, base + n_live * cs);
  for (int i = tid; i < (end - z0) * kNch; i += blockDim.x) {
    dpayload[static_cast<size_t>(z0) * kNch + i] = 0.f;
  }
#endif

  const float ox = static_cast<float>((t % tiles_x) * tile_size);
  const float oy = static_cast<float>((t / tiles_x + tile_row0) * tile_size);
  const gs::QuadPixels pix = gs::quad_pixels(tid, tile_size);
  float log_t[kQuads], s_dlogt[kQuads], c_r[kQuads], c_g[kQuads],
      c_b[kQuads], c_w[kQuads], c_d[kQuads];
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    log_t[k] = s_dlogt[k] = c_r[k] = c_g[k] = c_b[k] = c_w[k] = c_d[k] = 0.f;
    if (pix.valid >> k & 1u) {
      const int p = (pix.y + (k >> 1)) * tile_size + pix.x + (k & 1);
      const float* c = cot + static_cast<size_t>(t) * kNout * px + p;
      log_t[k] = __ldg(f + gs::kOutLogT * px + p);
      c_r[k] = __ldg(c + 0 * px);
      c_g[k] = __ldg(c + 1 * px);
      c_b[k] = __ldg(c + 2 * px);
      s_dlogt[k] = __ldg(c + 3 * px);
      c_w[k] = __ldg(c + 4 * px);
      c_d[k] = __ldg(c + 5 * px);
    }
  }
#if defined(GS_ABLATE_NOGRAD)
  float fold = 0.f;
#elif defined(GS_ABLATE_NOWRITE)
  float csum = 0.f;
#elif defined(GS_ABLATE_DMAONLY)
  (void)ox;
  (void)oy;
#endif

  for (int ci = n_live - 1; ci >= 0; --ci) {
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
    for (int s1 = j1; s1 > j0; s1 -= kSub) {
      const int s0 = max(s1 - kSub, j0);
#if !defined(GS_ABLATE_DMAONLY)
      for (int jt = s1; jt > s0; jt -= 32) {
        // The warp tests up to 32 pairs at once, one per lane, zeroes the
        // partials of those it culls, then walks the kept ones in reverse
        // depth order.
        const int jb = max(jt - 32, s0);
        unsigned todo = gs::kept_pairs(pix, lanes, jb, jt);
#if defined(GS_ABLATE_NOGEOM) || defined(GS_ABLATE_NODIRECT)
        if (jb + lane < jt && !(todo >> lane & 1u)) {
          float* pp = part + (warp * kSub + (jb + lane - s0)) * kRed;
#pragma unroll
          for (int c = 0; c < kRed8; ++c) pp[red_channel(c)] = 0.f;
        }
#elif !defined(GS_ABLATE_NOGRAD)
        if (jb + lane < jt && !(todo >> lane & 1u)) {
          float* pp = part + (warp * kSub + (jb + lane - s0)) * kRed;
#pragma unroll
          for (int c = 0; c < kRed; ++c) pp[c] = 0.f;
        }
#endif
        while (todo) {
          const int bit = 31 - __clz(todo);
          todo &= ~(1u << bit);
          const int j = jb + bit;
          const float4 cull = lanes[j].cull;
          const float4 conic = lanes[j].conic;
#if !defined(GS_ABLATE_NOGRAD)
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
#if defined(GS_ABLATE_NOGRAD)
          if (__any_sync(kFull, any)) {
#pragma unroll
            for (int k = 0; k < kQuads; ++k) {
              const float alpha = fminf(a_raw[k], alpha_max);
              const float lt = __fsub_rn(log_t[k], log1pf(-alpha));
              const float t_in = expf(lt);
              const float w = alpha * t_in;
              log_t[k] = live[k] ? lt : log_t[k];
              fold = live[k] ? fold + w : fold;
            }
          }
#else
          float r = 0.f;
          if (__any_sync(kFull, any)) {
            // The four pixels as straight-line code with selects, so their
            // chains overlap; a pixel that is not live keeps its state and
            // adds zeros (its values are finite: alpha <= alpha_max < 1).
#if defined(GS_ABLATE_NOGEOM) || defined(GS_ABLATE_NODIRECT)
            float v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) v[k] = 0.f;
#else
            float v[16];
#pragma unroll
            for (int k = 0; k < 16; ++k) v[k] = 0.f;
#endif
#if !defined(GS_ABLATE_NOGEOM)
            const float cb = 0.5f * conic.y;  // the staged lane holds 2b
#endif
#pragma unroll
            for (int k = 0; k < kQuads; ++k) {
#if !defined(GS_ABLATE_NOGEOM)
              const float ddx = dx[k & 1], ddy = dy[k >> 1];
#endif
              const float alpha = fminf(a_raw[k], alpha_max);
              const float lt = __fsub_rn(log_t[k], log1pf(-alpha));  // logT before this pair
              const float t_in = expf(lt);
              const float w = alpha * t_in;
              const float dw = c_r[k] * col.x + c_g[k] * col.y +
                               c_b[k] * col.z + c_w[k] + c_d[k] * col.w;
              const float dalpha =
                  a_raw[k] < alpha_max ? dw * t_in - s_dlogt[k] / (1.0f - alpha)
                                       : 0.f;
              const float dq = live[k] ? -0.5f * dalpha * alpha : 0.f;
#if !defined(GS_ABLATE_NODIRECT)
              const float wl = live[k] ? w : 0.f;
#endif
              log_t[k] = live[k] ? lt : log_t[k];
              s_dlogt[k] = live[k] ? s_dlogt[k] + dw * w : s_dlogt[k];
#if defined(GS_ABLATE_NOGEOM)
              v[0] += c_r[k] * wl;
              v[1] += c_g[k] * wl;
              v[2] += c_b[k] * wl;
              v[3] += c_w[k] * wl;
              v[4] += c_d[k] * wl;
              v[5] += dq;
#elif defined(GS_ABLATE_NODIRECT)
              v[0] += -2.0f * dq * (conic.x * ddx + cb * ddy);
              v[1] += -2.0f * dq * (conic.z * ddy + cb * ddx);
              v[2] += dq * ddx * ddx;
              v[3] += 2.0f * dq * ddx * ddy;
              v[4] += dq * ddy * ddy;
              v[5] += dq;
#else
              v[0] += -2.0f * dq * (conic.x * ddx + cb * ddy);
              v[1] += -2.0f * dq * (conic.z * ddy + cb * ddx);
              v[2] += dq * ddx * ddx;
              v[3] += 2.0f * dq * ddx * ddy;
              v[4] += dq * ddy * ddy;
              v[5] += dq;
              v[6] += c_r[k] * wl;
              v[7] += c_g[k] * wl;
              v[8] += c_b[k] * wl;
              v[9] += c_w[k] * wl;
              v[10] += c_d[k] * wl;
#endif
            }
#if defined(GS_ABLATE_NOGEOM)
            v[5] = __fmul_rn(v[5], 1e-30f);
#endif
#if defined(GS_ABLATE_NOGEOM) || defined(GS_ABLATE_NODIRECT)
            r = warp_transpose_sum8(v, lane);
#else
            r = warp_transpose_sum(v, lane);
#endif
          }
#if defined(GS_ABLATE_NOGEOM) || defined(GS_ABLATE_NODIRECT)
          if (!(lane & 3) && (lane >> 2) < kRed8) {
            part[(warp * kSub + (j - s0)) * kRed + red_channel(lane >> 2)] = r;
          }
#else
          if (!(lane & 1) && (lane >> 1) < kRed) {
            part[(warp * kSub + (j - s0)) * kRed + (lane >> 1)] = r;
          }
#endif
#endif
        }
      }
#endif
      __syncthreads();  // the sub-block's partials are in shared memory
      for (int i = tid; i < (s1 - s0) * kNch; i += blockDim.x) {
        const int slot = i / kNch;
        const int ch = i % kNch;
        float g = 0.f;
#if defined(GS_ABLATE_DMAONLY)
        if (ch == 0) g = __fmul_rn(lanes[s0 + slot].cull.x, 1e-30f);
#elif defined(GS_ABLATE_NOGRAD)
        if (ch == 0) g = __fmul_rn(fold, 1e-30f);
#elif defined(GS_ABLATE_NOGEOM) || defined(GS_ABLATE_NODIRECT)
        if (summed(ch)) {
          for (int w = 0; w < nwarps; ++w) g += part[(w * kSub + slot) * kRed + ch];
          if (ch == 5) {
            g = -2.0f * g / fmaxf(lanes[s0 + slot].conic.w, 1e-20f);
          }
        }
#else
        if (ch < kRed) {
          for (int w = 0; w < nwarps; ++w) g += part[(w * kSub + slot) * kRed + ch];
          if (ch == 5) {
            g = -2.0f * g / fmaxf(lanes[s0 + slot].conic.w, 1e-20f);
          }
        }
#endif
#if defined(GS_ABLATE_NOWRITE)
        csum += g;
#else
        dpayload[static_cast<size_t>(cbase + s0 + slot) * kNch + ch] = g;
#endif
      }
      __syncthreads();  // partials consumed before the next sub-block
    }
  }
#if defined(GS_ABLATE_NOWRITE)
  // One checksum a tile; the barrier above ended every use of the partials.
  csum = gs::block_sum(csum, part);
  if (tid == 0 && end > start) dpayload[static_cast<size_t>(start) * kNch] = csum;
#endif
}

}  // namespace

extern "C" int gs_rasterize_backward(
    const void* payload, const void* tile_starts, const void* fwd,
    const void* cot, int num_tiles, int tile_size, int chunk_size,
    int tiles_x, int tile_row0, float alpha_min, float alpha_max,
    float sigma_sq, void* dpayload, void* stream) {
  const int threads = gs::block_threads(tile_size);
  const size_t smem =
      static_cast<size_t>(chunk_size) * sizeof(Lane) +
      static_cast<size_t>(threads / 32) * kSub * kRed * sizeof(float);
#if defined(GS_ABLATE_BLOCKS)
  // A timing build pinned to production's blocks per SM (raster_common.cuh).
  const size_t smem_run =
      gs::pinned_smem(backward_kernel, threads, smem, GS_ABLATE_BLOCKS);
  cudaError_t e = cudaFuncSetAttribute(
      backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_run));
  if (e != cudaSuccess) return static_cast<int>(e);
#else
  // Above 48 KB a block's shared memory is dynamic only after this opt-in.
  cudaError_t e = cudaFuncSetAttribute(
      backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
#endif
#if defined(GS_ABLATE_BLOCKS)
  backward_kernel<<<num_tiles, threads, smem_run,
                    static_cast<cudaStream_t>(stream)>>>(
#else
  backward_kernel<<<num_tiles, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
#endif
      static_cast<const float*>(payload), static_cast<const int*>(tile_starts),
      static_cast<const float*>(fwd), static_cast<const float*>(cot),
      tile_size, chunk_size, tiles_x, tile_row0, alpha_min, alpha_max,
      sigma_sq, static_cast<float*>(dpayload));
  return static_cast<int>(cudaGetLastError());
}

#if defined(GS_ABLATE_BLOCKS)
// The blocks per SM of the last launch's configuration, by the occupancy API.
extern "C" int gs_ablate_blocks_per_sm() { return gs::last_blocks(); }
#endif

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
