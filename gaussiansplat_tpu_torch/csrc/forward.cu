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
// What bounds it on this card: instruction issue. Each (pixel, in-segment
// pair) of the composited chunks costs at least 14 instructions and one
// exponential before the gates, and ~15 more when the pair is live. The
// multiplies and adds are not fused, so they issue at 128 per clock per SM
// (half the 67 TFLOP/s f32 peak, which counts an FMA twice); the
// exponentials go to the special-function units at an eighth of that rate,
// which comes second. The bytes are only 40 B per pair read plus 32 KB per
// tile written.
//
// What the design does about that: one block per tile and one thread per
// pixel (tile_size^2 <= 1024 threads). Each aligned chunk's 10 needed
// channels are staged once in shared memory (10 x 4 B x chunk_size, 5 KB at
// 128) and read by all threads as broadcasts, so device memory is touched
// once per pair per tile. A thread composites its pixel sequentially in depth
// order and skips gated pairs; the tile's early exit is one
// __syncthreads_or per chunk. The TPU kernel's MXU formulation (polynomial
// basis, triangular-matmul prefix sums, bf16 Dekker splits) is not carried
// over. q is evaluated with explicitly rounded multiplies and adds (no FMA
// contraction) in the order of the plain version, so the alpha gates flip
// only where exp / log1p round differently; the staging and the gates live
// in raster_common.cuh, which the backward kernel (backward.cu) shares.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using gs::kLane;
using gs::kNch;
using gs::kNout;

__global__ void forward_kernel(
    const float* __restrict__ payload, const int* __restrict__ tile_starts,
    int tile_size, int chunk_size, int tiles_x, int tile_row0,
    float alpha_min, float alpha_max, float sigma_sq, float log_eps,
    float* __restrict__ out) {
  extern __shared__ float lanes[];  // chunk_size x kLane
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
  const float xl = static_cast<float>(tid % tile_size);
  const float yl = static_cast<float>(tid / tile_size);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_w = 0.f, acc_d = 0.f;
  float log_t = 0.f;
  int ci = 0;
  bool alive = true;
  while (ci < n_chunks && alive) {
    const int cbase = base + ci * cs;
    const int j0 = max(start - cbase, 0);
    const int j1 = min(end - cbase, cs);
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = j0 + tid; j < j1; j += blockDim.x) {
      gs::stage_pair(payload + static_cast<size_t>(cbase + j) * kNch, ox,
                     oy, lanes + j * kLane);
    }
    __syncthreads();
    for (int j = j0; j < j1; ++j) {
      const float* d = lanes + j * kLane;
      float dx, dy, q, a_raw;
      if (gs::splat_alpha(xl, yl, d, alpha_min, sigma_sq, dx, dy, q, a_raw)) {
        const float alpha = fminf(a_raw, alpha_max);
        const float w = __fmul_rn(alpha, expf(log_t));
        acc_r = __fadd_rn(acc_r, __fmul_rn(w, d[6]));
        acc_g = __fadd_rn(acc_g, __fmul_rn(w, d[7]));
        acc_b = __fadd_rn(acc_b, __fmul_rn(w, d[8]));
        acc_w = __fadd_rn(acc_w, w);
        acc_d = __fadd_rn(acc_d, __fmul_rn(w, d[9]));
        log_t = __fadd_rn(log_t, log1pf(-alpha));
      }
    }
    ++ci;
    alive = __syncthreads_or(log_t > log_eps) != 0;
  }

  float* o = out + static_cast<size_t>(t) * kNout * px + tid;
  o[0 * px] = acc_r;
  o[1 * px] = acc_g;
  o[2 * px] = acc_b;
  o[3 * px] = log_t;
  o[4 * px] = acc_w;
  o[5 * px] = acc_d;
  o[6 * px] = static_cast<float>(ci);
  o[7 * px] = 0.f;
}

}  // namespace

extern "C" int gs_rasterize_forward(
    const void* payload, const void* tile_starts, int num_tiles,
    int tile_size, int chunk_size, int tiles_x, int tile_row0,
    float alpha_min, float alpha_max, float sigma_sq, float log_eps,
    void* out, void* stream) {
  const int threads = tile_size * tile_size;
  const size_t smem = static_cast<size_t>(chunk_size) * kLane * sizeof(float);
  forward_kernel<<<num_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(payload), static_cast<const int*>(tile_starts),
      tile_size, chunk_size, tiles_x, tile_row0, alpha_min, alpha_max,
      sigma_sq, log_eps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
