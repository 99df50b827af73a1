"""The work these inputs need, and the bounds of the raster kernels.

Everything here is counted from the reference's own binning (reference/
render.py), never from the program's tile lists, so the yardstick does not
move when the program's design does.

Raster counts of one frame (`render.RasterCounts`), over the pairs a tile
composites before it stops (every pixel of the tile below trans_eps):
  pairs   (tile, gaussian) pairs with at least one image pixel inside the
          pair's support box (the bounding box of q <= min(sigma^2,
          2 ln(op / alpha_min)));
  inside  (pixel, pair)s inside that box: the only pixels where a gate can
          pass, which any design has to evaluate at least once;
  live    (pixel, pair)s that pass the gates and are composited.

The kernel bounds (`kernel_bound`) are a frozen copy of chip_smoke.py's
`bound`, `K1_COST` and `K2_COST`: the function's work charged in thread
instructions and special-function calls at the card's per-SM rates
(reference/peaks.py), against its bytes at the HBM rate; the larger is the
least time any kernel could take. Its charges, per item:
  pairs:  the support extent (a logarithm, three divides, two square roots:
          ~30 instructions, 6 special-function calls);
  inside: the gates: dx, dy, the factored q, the -1/2 scale, the opacity
          multiply and two compares (14) and an exponential (1);
  live:   K1 the clamp, exp(logT), w, five multiply-adds and log1p (35, 2);
          K2 the rewind, exp, w, dw, dalpha with its divide, dlogT, dq and
          one add per gradient channel for the sum over pixels (63, 3).
Bytes: each input read once and each output written once (the
reference's layout: 9 float32 a pair, RGB and transmittance a pixel).

The floating-point operations (`serve_flops`, `train_flops`) count each
FMA as two and each special function as one, for the algorithm's work
whatever kernel does it (table below); they are divided by the measured
time and the float32 peak for `mfu`.
"""

from __future__ import annotations

from .peaks import PEAK_BYTES_PER_S, RATES

K1_COST = {"pairs": dict(issue=30, sfu=6), "inside": dict(issue=14, sfu=1),
           "live": dict(issue=35, sfu=2)}
K2_COST = {"pairs": dict(issue=30, sfu=6), "inside": dict(issue=14, sfu=1),
           "live": dict(issue=63, sfu=3)}

# Bytes a raster kernel must move: a pair's 9 float32 fields (centre,
# conic, opacity, RGB) read; K1 writes RGB and transmittance a pixel; K2
# reads the RGB cotangent and the final transmittance a pixel and writes
# the 9 gradient fields a pair.
PAIR_BYTES = 9 * 4
K1_PIXEL_BYTES = 4 * 4
K2_PIXEL_BYTES = 4 * 4
K2_PAIR_OUT_BYTES = 9 * 4

# Floating-point operations of the algorithm (FMA = 2, special function =
# 1):
# projection of one gaussian: the camera transform (18), perspective and
# culls (8), quaternion normalization and rotation matrix (48), scales and
# M = R S (12), the clamped Jacobian rows (26), M^T t0 and M^T t1 (36),
# the 2D covariance with dilation (20), determinant and conic (8), radius
# and extents (18), sigmoid (3): 197;
PROJECT_FLOPS = 197
# SH colour: view direction and its normalization (12), the basis of the
# degree (below), 3 channels x (degree + 1)^2 FMAs, +0.5 and clamp (6);
SH_BASIS_FLOPS = {0: 0, 1: 3, 2: 17, 3: 45}
# one pair: its support extent (12);
PAIR_FLOPS = 12
# one (pixel, pair) inside the support box: the gates (15);
INSIDE_FLOPS = 15
# one live (pixel, pair), forward: clamp, log1p, the transmittance, w, three
# colour FMAs (12); backward: the rewind, w, dw, dalpha, the suffix, dq,
# the centre, conic, opacity and colour gradients summed over pixels (45);
LIVE_FLOPS, LIVE_BWD_FLOPS = 12, 45
# one pixel: the background composite, 3 FMAs (6);
PIXEL_FLOPS = 6
# one pixel-channel of the loss, forward and backward: L1 (5), five
# 11 + 11-tap separable blurs of the SSIM both ways (440), the SSIM map and
# its derivative (55): 500;
LOSS_FLOPS = 500
# one parameter of Adam: both moments, the bias corrections, the root and
# the update (12).
ADAM_FLOPS = 12


def sh_flops(degree: int) -> int:
    return 12 + SH_BASIS_FLOPS[degree] + 6 * (degree + 1) ** 2 + 6


def serve_flops(alive: int, sh_degree: int, pixels: int, c) -> float:
    """One frame: every alive gaussian projected, then the raster counts."""
    return (alive * (PROJECT_FLOPS + sh_flops(sh_degree))
            + c.pairs * PAIR_FLOPS + c.inside * INSIDE_FLOPS
            + c.live * LIVE_FLOPS + pixels * PIXEL_FLOPS)


def train_flops(alive: int, sh_degree: int, pixels: int, c) -> float:
    """One step: the forward, the loss, the backward (the gates again, the
    live pairs' gradients, the projection's twice its forward) and Adam
    over the alive gaussians' 59 parameters."""
    per_gauss = PROJECT_FLOPS + sh_flops(sh_degree)
    backward = (c.pairs * PAIR_FLOPS + c.inside * INSIDE_FLOPS
                + c.live * LIVE_BWD_FLOPS + alive * 2 * per_gauss)
    return (serve_flops(alive, sh_degree, pixels, c) + pixels * 3 * LOSS_FLOPS
            + backward + alive * 59 * ADAM_FLOPS)


def bound_s(nbytes: float, work: dict, cost: dict) -> float:
    """Least time (s): bytes over the HBM rate, or each unit's charged
    total over its rate, whichever is larger."""
    totals = {}
    for item, charges in cost.items():
        for unit, per in charges.items():
            totals[unit] = totals.get(unit, 0.0) + work[item] * per
    times = [nbytes / PEAK_BYTES_PER_S]
    times += [v / RATES[k] for k, v in totals.items()]
    return max(times)


def kernel_bound(kernel: str, c, pixels: int) -> float:
    """The bound (s) of K1 ('k1') or K2 ('k2') on one frame's counts."""
    work = dict(pairs=c.pairs, inside=c.inside, live=c.live)
    if kernel == "k1":
        return bound_s(c.pairs * PAIR_BYTES + pixels * K1_PIXEL_BYTES,
                       work, K1_COST)
    if kernel == "k2":
        return bound_s(c.pairs * (PAIR_BYTES + K2_PAIR_OUT_BYTES)
                       + pixels * K2_PIXEL_BYTES, work, K2_COST)
    raise ValueError(f"unknown kernel {kernel!r}")
