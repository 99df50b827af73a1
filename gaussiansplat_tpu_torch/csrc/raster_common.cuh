// Shared by the forward (forward.cu, K1) and backward (backward.cu, K2)
// raster kernels: the staging of one pair's needed payload channels and the
// alpha evaluation with its two gates.
//
// K2 rewinds each pixel's transmittance by exactly the pairs that K1
// composited. A pair that passes a gate in one kernel and fails it in the
// other corrupts the rewound logT of every earlier pair of that pixel, so
// both kernels evaluate q, alpha and the gates through these functions:
// explicitly rounded multiplies and adds (no FMA contraction), in the
// factored order of the plain PyTorch versions (ops/tile_raster.py).

#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr int kNch = 16;   // payload channels per row
constexpr int kLane = 10;  // staged floats per pair
constexpr int kNout = 8;   // output rows per tile of the forward block
constexpr int kOutLogT = 3;
constexpr int kOutStop = 6;

// Staged lane layout: mx - ox, my - oy, conic a, b, c, opacity, r, g, b,
// depth (payload channels 0-8 and 10; channel 9 is the constant 1).
__device__ __forceinline__ void stage_pair(const float* __restrict__ row,
                                           float ox, float oy, float* d) {
  d[0] = __fsub_rn(__ldg(row + 0), ox);
  d[1] = __fsub_rn(__ldg(row + 1), oy);
  d[2] = __ldg(row + 2);
  d[3] = __ldg(row + 3);
  d[4] = __ldg(row + 4);
  d[5] = __ldg(row + 5);
  d[6] = __ldg(row + 6);
  d[7] = __ldg(row + 7);
  d[8] = __ldg(row + 8);
  d[9] = __ldg(row + 10);
}

// Pixel (xl, yl) in tile-local integer coordinates against one staged pair:
// the offsets dx, dy, the quadratic form q and alpha before the clamp.
// Returns whether the pair is live there (alpha_raw >= alpha_min and
// q <= sigma^2).
__device__ __forceinline__ bool splat_alpha(float xl, float yl,
                                            const float* d, float alpha_min,
                                            float sigma_sq, float& dx,
                                            float& dy, float& q,
                                            float& a_raw) {
  dx = __fsub_rn(xl, d[0]);
  dy = __fsub_rn(yl, d[1]);
  q = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(d[2], dx), dx),
                __fmul_rn(__fmul_rn(__fmul_rn(2.0f, d[3]), dx), dy)),
      __fmul_rn(__fmul_rn(d[4], dy), dy));
  a_raw = __fmul_rn(d[5], expf(__fmul_rn(-0.5f, q)));
  return a_raw >= alpha_min && q <= sigma_sq;
}

}  // namespace gs
