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
// What bounds it on this card: instruction issue. Every (pixel, in-segment
// pair) of the composited chunks re-evaluates K1's gates (14 unfused f32
// instructions and one exponential, raster_common.cuh) and one warp vote;
// a pair that is live in a warp adds ~40 instructions of gradient math, two
// special-function calls, and a reduction of 11 values over the warp (55
// shuffles and adds). Bytes are small: 40 B read and 64 B written per pair,
// 8 rows of 4 B read per pixel.
//
// What the design does about that: one block per tile, one thread per
// pixel, as K1; each live chunk's 10 needed channels are staged once in
// shared memory and read as broadcasts. A warp skips the reduction of a
// pair that none of its pixels composited (one __any_sync). The sum over
// the tile's pixels is taken in a fixed order with no atomics: a butterfly
// of warp shuffles, then, per sub-block of 32 pairs, one thread per (pair,
// channel) adds the warps' partials from shared memory in warp order and
// writes the row. Segments partition the sorted list, so each row is
// written by exactly one block and two runs give the same bits. The TPU
// kernel's read-modify-write of the boundary chunk is not needed: a block
// writes only the rows of its own segment. Its MXU formulation (moment
// matrices, triangular-matmul suffix sums, bf16 splits) is not carried
// over; the rewind is per pixel rather than per chunk, which moves values
// only by rounding.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using gs::kLane;
using gs::kNch;
using gs::kNout;

constexpr int kSub = 32;   // pairs reduced together
constexpr int kRed = 11;   // per-pixel values summed per pair (channels 0-10)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(1024) backward_kernel(
    const float* __restrict__ payload, const int* __restrict__ tile_starts,
    const float* __restrict__ fwd, const float* __restrict__ cot,
    int tile_size, int chunk_size, int tiles_x, int tile_row0,
    float alpha_min, float alpha_max, float sigma_sq,
    float* __restrict__ dpayload) {
  extern __shared__ float smem[];
  float* lanes = smem;                         // chunk_size x kLane
  float* part = smem + chunk_size * kLane;     // warps x kSub x kRed
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int px = tile_size * tile_size;
  const bool has_px = tid < px;  // the block is px rounded up to whole warps
  const int cs = chunk_size;

  const int start = __ldg(tile_starts + t);
  const int end = __ldg(tile_starts + t + 1);
  const int base = (start / cs) * cs;
  const int n_chunks = (end - base + cs - 1) / cs;
  const float* f = fwd + static_cast<size_t>(t) * kNout * px;
  const int stop = static_cast<int>(__ldg(f + gs::kOutStop * px));
  const int n_live = min(stop, n_chunks);

  // Rows of the chunks the forward never composited get zeros.
  const int z0 = max(start, base + n_live * cs);
  for (int i = tid; i < (end - z0) * kNch; i += blockDim.x) {
    dpayload[static_cast<size_t>(z0) * kNch + i] = 0.f;
  }

  const float ox = static_cast<float>((t % tiles_x) * tile_size);
  const float oy = static_cast<float>((t / tiles_x + tile_row0) * tile_size);
  const float xl = static_cast<float>(tid % tile_size);
  const float yl = static_cast<float>(tid / tile_size);
  float log_t = 0.f, s_dlogt = 0.f;
  float c_r = 0.f, c_g = 0.f, c_b = 0.f, c_w = 0.f, c_d = 0.f;
  if (has_px) {
    const float* c = cot + static_cast<size_t>(t) * kNout * px + tid;
    log_t = __ldg(f + gs::kOutLogT * px + tid);
    c_r = __ldg(c + 0 * px);
    c_g = __ldg(c + 1 * px);
    c_b = __ldg(c + 2 * px);
    s_dlogt = __ldg(c + 3 * px);
    c_w = __ldg(c + 4 * px);
    c_d = __ldg(c + 5 * px);
  }

  for (int ci = n_live - 1; ci >= 0; --ci) {
    const int cbase = base + ci * cs;
    const int j0 = max(start - cbase, 0);
    const int j1 = min(end - cbase, cs);
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = j0 + tid; j < j1; j += blockDim.x) {
      gs::stage_pair(payload + static_cast<size_t>(cbase + j) * kNch, ox, oy,
                     lanes + j * kLane);
    }
    __syncthreads();
    for (int s1 = j1; s1 > j0; s1 -= kSub) {
      const int s0 = max(s1 - kSub, j0);
      for (int j = s1 - 1; j >= s0; --j) {
        const float* d = lanes + j * kLane;
        float dx = 0.f, dy = 0.f, q = 0.f, a_raw = 0.f;
        const bool live = has_px && gs::splat_alpha(xl, yl, d, alpha_min,
                                                    sigma_sq, dx, dy, q, a_raw);
        float* pp = part + (warp * kSub + (j - s0)) * kRed;
        if (!__any_sync(kFull, live)) {
          if (lane == 0) {
#pragma unroll
            for (int k = 0; k < kRed; ++k) pp[k] = 0.f;
          }
          continue;
        }
        float v[kRed];
#pragma unroll
        for (int k = 0; k < kRed; ++k) v[k] = 0.f;
        if (live) {
          const float alpha = fminf(a_raw, alpha_max);
          log_t = __fsub_rn(log_t, log1pf(-alpha));  // logT before this pair
          const float t_in = expf(log_t);
          const float w = alpha * t_in;
          const float dw = c_r * d[6] + c_g * d[7] + c_b * d[8] + c_w +
                           c_d * d[9];
          const float dalpha =
              a_raw < alpha_max ? dw * t_in - s_dlogt / (1.0f - alpha) : 0.f;
          s_dlogt += dw * w;
          const float dq = -0.5f * dalpha * alpha;
          v[0] = -2.0f * dq * (d[2] * dx + d[3] * dy);
          v[1] = -2.0f * dq * (d[4] * dy + d[3] * dx);
          v[2] = dq * dx * dx;
          v[3] = 2.0f * dq * dx * dy;
          v[4] = dq * dy * dy;
          v[5] = dq;
          v[6] = c_r * w;
          v[7] = c_g * w;
          v[8] = c_b * w;
          v[9] = c_w * w;
          v[10] = c_d * w;
        }
#pragma unroll
        for (int k = 0; k < kRed; ++k) {
          const float r = warp_sum(v[k]);
          if (lane == 0) pp[k] = r;
        }
      }
      __syncthreads();  // the sub-block's partials are in shared memory
      for (int i = tid; i < (s1 - s0) * kNch; i += blockDim.x) {
        const int slot = i / kNch;
        const int ch = i % kNch;
        float g = 0.f;
        if (ch < kRed) {
          for (int w = 0; w < nwarps; ++w) g += part[(w * kSub + slot) * kRed + ch];
          if (ch == 5) {
            g = -2.0f * g / fmaxf(lanes[(s0 + slot) * kLane + 5], 1e-20f);
          }
        }
        dpayload[static_cast<size_t>(cbase + s0 + slot) * kNch + ch] = g;
      }
      __syncthreads();  // partials consumed before the next sub-block
    }
  }
}

}  // namespace

extern "C" int gs_rasterize_backward(
    const void* payload, const void* tile_starts, const void* fwd,
    const void* cot, int num_tiles, int tile_size, int chunk_size,
    int tiles_x, int tile_row0, float alpha_min, float alpha_max,
    float sigma_sq, void* dpayload, void* stream) {
  const int threads = (tile_size * tile_size + 31) / 32 * 32;
  const size_t smem =
      (static_cast<size_t>(chunk_size) * kLane +
       static_cast<size_t>(threads / 32) * kSub * kRed) * sizeof(float);
  // Above 48 KB a block's shared memory is dynamic only after this opt-in.
  cudaError_t e = cudaFuncSetAttribute(
      backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  backward_kernel<<<num_tiles, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(payload), static_cast<const int*>(tile_starts),
      static_cast<const float*>(fwd), static_cast<const float*>(cot),
      tile_size, chunk_size, tiles_x, tile_row0, alpha_min, alpha_max,
      sigma_sq, static_cast<float*>(dpayload));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
