// P: the projection and the raster payload of every gaussian in one pass,
// hand-written for Hopper (sm_90a), for calls that need no gradient.
//
// Replaces no TPU kernel: the reference projects with XLA elementwise ops
// (gaussiansplat_tpu/ops/projection.py, `project_gaussians` and
// `make_payload`), and the port first did the same with eager PyTorch
// (ops/projection.py, the plain version this kernel is held to): some
// forty elementwise kernels and the stacks of the payload's sixteen
// columns, each a pass over N in device memory.
//
// What it computes, for each gaussian i (one thread), as
// `project_gaussians` and `make_payload` do:
//   the camera transform, the near / far cull (a culled row divides by 1);
//   the 3D covariance factor R(normalize(q)) diag(exp(log_scales)), the
//     perspective Jacobian's rows with x/z and y/z clamped to 1.3 tan of
//     the half field of view, the 2D covariance (a, b, c) plus the
//     dilation, its determinant, the conic (divided by 1 where det <= 0),
//     lambda1 and the radius ceil(sigma_radius sqrt(lambda1));
//   SH colour of degrees 0-3 from the direction camera centre -> mean,
//     coefficients past `sh_degree` ignored, + 0.5 and clamped at 0;
//   the sigmoid opacity and the opacity-aware extents rx, ry;
//   valid = in front, det > 0, radius > 0, opacity > alpha_min, alive and
//     on screen; radius, rx and ry are 0 where it is false;
//   the payload row [u, v, conic a, b, c, opacity, r, g, b, 1, depth,
//     radius, rx, ry, 0, 0], radius (int32), radius_xy (int32 x 2), valid.
//
// Numerics: float32, every expression evaluated as the plain version
// evaluates it on the card, one rounding an operation in the same order:
// round-to-nearest intrinsics (no contraction into FMA), IEEE division and
// square root, NaN-propagating min / max as torch.clamp, the device's expf
// and logf (torch.exp / sigmoid / log call the same), the constants
// rounded from double to float as torch rounds a Python number. The
// camera transform sums as cuBLAS does (`gemm3`), so the depth, the
// compaction and pair sorts' key, is the plain version's bit for bit; the
// norms and the covariance's sums of three are taken left to right, where
// torch's reductions may order them otherwise, so the other fields agree
// to a few ULPs.
//
// What bounds it on this card: bytes. It reads 237 B a gaussian (means
// 12, quats 16, log_scales 12, logit 4, sh_dc 12, sh_rest 180 at SH 3,
// alive 1) and writes 77 (the payload row 64, radius 4, radius_xy 8,
// valid 1): 0.28 ms at 3M gaussians at 3.35 TB/s. The arithmetic is ~300
// operations a gaussian, far below the card's rate per byte.
//
// What the design does about that: a block of 128 gaussians first copies
// its contiguous slabs of means, quats, log_scales, sh_dc and sh_rest into
// shared memory with 16-byte cp.async copies, the warp's lanes on adjacent
// addresses (a thread reading its own 180-byte sh_rest row would make
// every warp load touch 32 rows), then each thread reads its rows from
// there. Several blocks an SM keep the copies of some in flight while
// others compute. Each payload row leaves as four 16-byte stores; radius,
// radius_xy and valid as one coalesced store each. The camera's tensors
// are read on the device (no host sync for them).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
// Floats a gaussian stages besides sh_rest: means 3, quats 4,
// log_scales 3, sh_dc 3.
constexpr int kStaged = 13;

// Python floats as torch rounds them to float32: from the double.
constexpr float kSH0 = static_cast<float>(0.28209479177387814);
constexpr float kSH1 = static_cast<float>(0.4886025119029199);
constexpr float kSH2a = static_cast<float>(1.0925484305920792);
constexpr float kSH2b = static_cast<float>(-1.0925484305920792);
constexpr float kSH2c = static_cast<float>(0.31539156525252005);
constexpr float kSH2d = static_cast<float>(-1.0925484305920792);
constexpr float kSH2e = static_cast<float>(0.5462742152960396);
constexpr float kSH3a = static_cast<float>(-0.5900435899266435);
constexpr float kSH3b = static_cast<float>(2.890611442640554);
constexpr float kSH3c = static_cast<float>(-0.4570457994644658);
constexpr float kSH3d = static_cast<float>(0.3731763325901154);
constexpr float kSH3e = static_cast<float>(-0.4570457994644658);
constexpr float kSH3f = static_cast<float>(1.445305721320277);
constexpr float kSH3g = static_cast<float>(-0.5900435899266435);
constexpr float kLim = static_cast<float>(1.3);
constexpr float kSlack = static_cast<float>(1.001);
constexpr float kSlackAdd = static_cast<float>(1e-2);
constexpr float kDiscMin = static_cast<float>(0.01);
constexpr float kEps = static_cast<float>(1e-12);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }

// A row of (N, 3) @ (3, 3) as torch's float32 matmul computes it on the
// card (cuBLAS sgemm, no TF32): fused multiply-adds in k order. Measured
// bit-equal on an H100 for 3M rows and two cameras.
__device__ __forceinline__ float gemm3(float a0, float a1, float a2,
                                       float b0, float b1, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, mul(a0, b0)));
}

// torch.clamp on float32: a NaN operand gives NaN (fmaxf / fminf drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// Start copying `count` floats from src to dst (16-byte aligned in shared
// memory), 16 bytes a lane where src is 16-byte aligned, 4 otherwise.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int count) {
  int done = 0;
  if ((reinterpret_cast<std::uintptr_t>(src) & 15) == 0) {
    done = count & ~3;
    for (int k = threadIdx.x * 4; k < done; k += kThreads * 4) {
      cp_async16(dst + k, src + k);
    }
  }
  for (int k = done + threadIdx.x; k < count; k += kThreads) {
    cp_async4(dst + k, src + k);
  }
}

struct Inputs {
  const float* means;           // (N, 3)
  const float* quats;           // (N, 4) wxyz, unnormalized
  const float* log_scales;      // (N, 3)
  const float* logit;           // (N,)
  const float* sh_dc;           // (N, 3)
  const float* sh_rest;         // (N, rest)
  const unsigned char* alive;   // (N,) bool
};

struct Cam {
  const float* R;               // (3, 3) world-to-camera rotation
  const float* t;               // (3,)
  const float *fx, *fy, *cx, *cy;   // 0-d
};

struct Params {
  int n, rest, sh_degree, width, height;
  float near_z, far_z, dilation, sigma_radius, alpha_min, log_alpha_min;
};

__global__ void __launch_bounds__(kThreads) project_kernel(
    Inputs in, Cam cam, Params p, float4* __restrict__ payload,
    int* __restrict__ radius_out, int2* __restrict__ radius_xy_out,
    unsigned char* __restrict__ valid_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_means = smem;
  float* s_quats = s_means + 3 * kThreads;
  float* s_scales = s_quats + 4 * kThreads;
  float* s_dc = s_scales + 3 * kThreads;
  float* s_rest = s_dc + 3 * kThreads;

  const long long i0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(min(static_cast<long long>(kThreads),
                                        p.n - i0));
  stage(s_means, in.means + i0 * 3, rows * 3);
  stage(s_quats, in.quats + i0 * 4, rows * 4);
  stage(s_scales, in.log_scales + i0 * 3, rows * 3);
  stage(s_dc, in.sh_dc + i0 * 3, rows * 3);
  if (p.rest > 0) stage(s_rest, in.sh_rest + i0 * p.rest, rows * p.rest);
  asm volatile("cp.async.commit_group;\n" ::);

  // The camera, while the copies fly: broadcast loads.
  float W[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) W[k] = __ldg(cam.R + k);
  const float tc0 = __ldg(cam.t), tc1 = __ldg(cam.t + 1), tc2 = __ldg(cam.t + 2);
  const float fx = __ldg(cam.fx), fy = __ldg(cam.fy);
  const float cx = __ldg(cam.cx), cy = __ldg(cam.cy);
  const int j = threadIdx.x;
  const long long i = i0 + j;
  const bool live = j < rows;
  const float logit = live ? __ldg(in.logit + i) : 0.0f;
  const bool alive = live && __ldg(in.alive + i) != 0;

  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (!live) return;

  // cam_pts = means @ R^T + t, the product as cuBLAS's sgemm sums it
  const float m0 = s_means[3 * j], m1 = s_means[3 * j + 1],
              m2 = s_means[3 * j + 2];
  const float tx = add(gemm3(m0, m1, m2, W[0], W[1], W[2]), tc0);
  const float ty = add(gemm3(m0, m1, m2, W[3], W[4], W[5]), tc1);
  const float tz = add(gemm3(m0, m1, m2, W[6], W[7], W[8]), tc2);
  const bool in_front = tz > p.near_z && tz < p.far_z;
  const float tzs = in_front ? tz : 1.0f;
  const float u = add(dv(mul(fx, tx), tzs), cx);
  const float v = add(dv(mul(fy, ty), tzs), cy);

  // M = R(normalize(q)) diag(exp(log_scales))
  const float sx = expf(s_scales[3 * j]);
  const float sy = expf(s_scales[3 * j + 1]);
  const float sz = expf(s_scales[3 * j + 2]);
  const float4 q = reinterpret_cast<const float4*>(s_quats)[j];
  const float qn = nan_max(
      sqrtf(add(add(add(mul(q.x, q.x), mul(q.y, q.y)), mul(q.z, q.z)),
                mul(q.w, q.w))),
      kEps);
  const float qw = dv(q.x, qn), qx = dv(q.y, qn), qy = dv(q.z, qn),
              qz = dv(q.w, qn);
  float M[9];
  M[0] = mul(sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz)))), sx);
  M[1] = mul(mul(2.0f, sub(mul(qx, qy), mul(qw, qz))), sy);
  M[2] = mul(mul(2.0f, add(mul(qx, qz), mul(qw, qy))), sz);
  M[3] = mul(mul(2.0f, add(mul(qx, qy), mul(qw, qz))), sx);
  M[4] = mul(sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz)))), sy);
  M[5] = mul(mul(2.0f, sub(mul(qy, qz), mul(qw, qx))), sz);
  M[6] = mul(mul(2.0f, sub(mul(qx, qz), mul(qw, qy))), sx);
  M[7] = mul(mul(2.0f, add(mul(qy, qz), mul(qw, qx))), sy);
  M[8] = mul(sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy)))), sz);

  // The Jacobian's rows times W, clamped at 1.3 tan(fov / 2).
  const float lim_x = mul(kLim, mul(dv(1.0f, fx), mul(0.5f, static_cast<float>(p.width))));
  const float lim_y = mul(kLim, mul(dv(1.0f, fy), mul(0.5f, static_cast<float>(p.height))));
  const float txz = nan_min(nan_max(dv(tx, tzs), -lim_x), lim_x);
  const float tyz = nan_min(nan_max(dv(ty, tzs), -lim_y), lim_y);
  const float inv_z = dv(1.0f, tzs);
  const float ax = mul(fx, inv_z), bx = mul(mul(fx, txz), inv_z);
  const float ay = mul(fy, inv_z), by = mul(mul(fy, tyz), inv_z);
  float t0[3], t1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t0[k] = sub(mul(ax, W[k]), mul(bx, W[6 + k]));
    t1[k] = sub(mul(ay, W[3 + k]), mul(by, W[6 + k]));
  }
  // cov2d via (M^T t0) . (M^T t1)
  float u0[3], u1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    u0[c] = add(add(mul(M[c], t0[0]), mul(M[3 + c], t0[1])), mul(M[6 + c], t0[2]));
    u1[c] = add(add(mul(M[c], t1[0]), mul(M[3 + c], t1[1])), mul(M[6 + c], t1[2]));
  }
  const float a = add(add(add(mul(u0[0], u0[0]), mul(u0[1], u0[1])),
                          mul(u0[2], u0[2])), p.dilation);
  const float b = add(add(mul(u0[0], u1[0]), mul(u0[1], u1[1])),
                      mul(u0[2], u1[2]));
  const float c = add(add(add(mul(u1[0], u1[0]), mul(u1[1], u1[1])),
                          mul(u1[2], u1[2])), p.dilation);
  const float det = sub(mul(a, c), mul(b, b));
  const bool det_ok = det > 0.0f;
  const float inv_det = dv(1.0f, det_ok ? det : 1.0f);
  const float mid = mul(0.5f, add(a, c));
  const float disc = sqrtf(nan_max(sub(mul(mid, mid), det), kDiscMin));
  const float lambda1 = add(mid, disc);
  const float radius_f = ceilf(mul(p.sigma_radius, sqrtf(nan_max(lambda1, 0.0f))));

  // SH colour from the camera centre -R^T t towards the mean.
  const float dx = sub(m0, -add(add(mul(W[0], tc0), mul(W[3], tc1)), mul(W[6], tc2)));
  const float dy = sub(m1, -add(add(mul(W[1], tc0), mul(W[4], tc1)), mul(W[7], tc2)));
  const float dz = sub(m2, -add(add(mul(W[2], tc0), mul(W[5], tc1)), mul(W[8], tc2)));
  const float dn = nan_max(sqrtf(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz))), kEps);
  const float x = dv(dx, dn), y = dv(dy, dn), z = dv(dz, dn);
  float basis[16];
  basis[0] = kSH0;
  if (p.sh_degree >= 1) {
    basis[1] = mul(-kSH1, y);
    basis[2] = mul(kSH1, z);
    basis[3] = mul(-kSH1, x);
  }
  if (p.sh_degree >= 2) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    basis[4] = mul(kSH2a, xy);
    basis[5] = mul(kSH2b, yz);
    basis[6] = mul(kSH2c, sub(sub(mul(2.0f, zz), xx), yy));
    basis[7] = mul(kSH2d, xz);
    basis[8] = mul(kSH2e, sub(xx, yy));
    if (p.sh_degree >= 3) {
      basis[9] = mul(mul(kSH3a, y), sub(mul(3.0f, xx), yy));
      basis[10] = mul(mul(kSH3b, xy), z);
      basis[11] = mul(mul(kSH3c, y), sub(sub(mul(4.0f, zz), xx), yy));
      basis[12] = mul(mul(kSH3d, z),
                      sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      basis[13] = mul(mul(kSH3e, x), sub(sub(mul(4.0f, zz), xx), yy));
      basis[14] = mul(mul(kSH3f, z), sub(xx, yy));
      basis[15] = mul(mul(kSH3g, x), sub(xx, mul(3.0f, yy)));
    }
  }
  const float* dc = s_dc + 3 * j;
  float cr = mul(basis[0], dc[0]);
  float cg = mul(basis[0], dc[1]);
  float cb = mul(basis[0], dc[2]);
  const int k_sh = (p.sh_degree + 1) * (p.sh_degree + 1);
  const float* rest = s_rest + j * p.rest;
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    if (k < k_sh) {
      cr = add(cr, mul(basis[k], rest[3 * (k - 1)]));
      cg = add(cg, mul(basis[k], rest[3 * (k - 1) + 1]));
      cb = add(cb, mul(basis[k], rest[3 * (k - 1) + 2]));
    }
  }
  cr = nan_max(add(cr, 0.5f), 0.0f);
  cg = nan_max(add(cg, 0.5f), 0.0f);
  cb = nan_max(add(cb, 0.5f), 0.0f);

  // Opacity and the opacity-aware extents.
  const float op = dv(1.0f, add(1.0f, expf(-logit)));
  const float tau = mul(2.0f, sub(logf(nan_max(op, kEps)), p.log_alpha_min));
  const float s_eff = nan_min(
      add(mul(sqrtf(nan_max(tau, 0.0f)), kSlack), kSlackAdd), p.sigma_radius);
  const float rx_f = ceilf(mul(s_eff, sqrtf(nan_max(a, 0.0f))));
  const float ry_f = ceilf(mul(s_eff, sqrtf(nan_max(c, 0.0f))));

  const bool on_screen = add(u, rx_f) > 0.0f &&
                         sub(u, rx_f) < static_cast<float>(p.width) &&
                         add(v, ry_f) > 0.0f &&
                         sub(v, ry_f) < static_cast<float>(p.height);
  const bool valid = in_front && det_ok && radius_f > 0.0f &&
                     op > p.alpha_min && alive && on_screen;
  const int radius = valid ? static_cast<int>(radius_f) : 0;
  const int rx = valid ? static_cast<int>(rx_f) : 0;
  const int ry = valid ? static_cast<int>(ry_f) : 0;

  float4* row = payload + 4 * i;
  row[0] = make_float4(u, v, mul(c, inv_det), mul(-b, inv_det));
  row[1] = make_float4(mul(a, inv_det), op, cr, cg);
  row[2] = make_float4(cb, 1.0f, tz, static_cast<float>(radius));
  row[3] = make_float4(static_cast<float>(rx), static_cast<float>(ry), 0.0f, 0.0f);
  radius_out[i] = radius;
  radius_xy_out[i] = make_int2(rx, ry);
  valid_out[i] = valid ? 1 : 0;
}

}  // namespace

extern "C" int gs_project(
    const void* means, const void* quats, const void* log_scales,
    const void* logit, const void* sh_dc, const void* sh_rest,
    const void* alive, const void* R, const void* t, const void* fx,
    const void* fy, const void* cx, const void* cy, int n, int rest,
    int sh_degree, int width, int height, float near_z, float far_z,
    float dilation, float sigma_radius, float alpha_min, float log_alpha_min,
    void* payload, void* radius, void* radius_xy, void* valid, void* stream) {
  if (n <= 0) return 0;
  const Inputs in{static_cast<const float*>(means),
                  static_cast<const float*>(quats),
                  static_cast<const float*>(log_scales),
                  static_cast<const float*>(logit),
                  static_cast<const float*>(sh_dc),
                  static_cast<const float*>(sh_rest),
                  static_cast<const unsigned char*>(alive)};
  const Cam cam{static_cast<const float*>(R), static_cast<const float*>(t),
                static_cast<const float*>(fx), static_cast<const float*>(fy),
                static_cast<const float*>(cx), static_cast<const float*>(cy)};
  const Params p{n, rest, sh_degree, width, height, near_z, far_z, dilation,
                 sigma_radius, alpha_min, log_alpha_min};
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * kThreads * (kStaged + rest);
  project_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, cam, p, static_cast<float4*>(payload), static_cast<int*>(radius),
      static_cast<int2*>(radius_xy), static_cast<unsigned char*>(valid));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
