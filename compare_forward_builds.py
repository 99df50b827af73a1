#!/usr/bin/env python3
"""Compare the raster kernels (K1 forward, K2 backward) of another source
tree with this checkout's, on the card.

    git archive <commit> gaussiansplat_tpu_torch/csrc | tar -x -C other/
    python3 compare_forward_builds.py other/gaussiansplat_tpu_torch/csrc

Builds `forward.cu` and `backward.cu` of the given csrc directory beside
the checkout's own (one nvcc each, in parallel), and runs both through the
checkout's wrappers on the 1920x1080 benchmark scene of chip_smoke.py at 1M
and 300k gaussians, and at 1M with opacities spread uniformly from
alpha_min to 1 (about a third of the pairs then have a support cut by the
alpha gate rather than by sigma):

* K1: whether the two (T, 8, tile_px) output blocks are equal in every bit;
* K2: on the same payload, K1's block and a seeded cotangent, the largest
  difference of each gradient row 0-10 scaled by that row's largest entry
  in the other tree's output, held to chip_smoke.py's K2 budget
  (`K2_BULK_ATOL` for all but `K2_BULK_FRAC` of the entries, `K2_ATOL` for
  every entry);
* each kernel's time by CUDA events, the two builds in turns (other, this,
  this, other; every reading printed), and the card's SM clock, temperature
  and power draw just after.

Exits non-zero if K1 differs, K2 leaves its budget or no CUDA card is
present. The two trees must export the same launchers
(`gs_rasterize_forward`, `gs_rasterize_backward`).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs


def run_build(build: dict, key: str, args):
    """Launch kernel `key` ('fwd' for K1, 'bwd' for K2) of `build` (a dict
    of CudaKernels) through the checkout's wrapper, so every build gets the
    wrapper's own checks and arguments."""
    from gaussiansplat_tpu_torch.ops.kernels import backward, forward

    module, attr, fn = {
        "fwd": (forward, "FORWARD", forward.rasterize_forward_cuda),
        "bwd": (backward, "BACKWARD", backward.rasterize_backward_cuda),
    }[key]
    own = getattr(module, attr)
    setattr(module, attr, build[key])
    try:
        return fn(*args)
    finally:
        setattr(module, attr, own)


def time_in_turns(other: dict, ours: dict, key: str, args) -> str:
    """Four timings of 10 launches each, in turns other, ours, ours, other:
    'other (a, b) -> ours (c, d) ms', means first."""
    t = [cs.cuda_ms(lambda w=w: run_build(w, key, args), reps=10, warmup=2)
         for w in (other, ours, ours, other)]
    return (f"{(t[0] + t[3]) / 2:.4f} ({t[0]:.4f}, {t[3]:.4f}) -> "
            f"{(t[1] + t[2]) / 2:.4f} ({t[1]:.4f}, {t[2]:.4f}) ms")


def card_state() -> str:
    """The card's SM clock, temperature and power draw, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0].strip()


def spread_opacities(model, alpha_min: float, seed: int) -> None:
    """Set the model's opacities uniform in [alpha_min, 1), from a seed."""
    g = torch.Generator().manual_seed(seed)
    op = alpha_min + (1.0 - alpha_min) * 0.999 * torch.rand(
        model.capacity, generator=g, dtype=torch.float64)
    model.logit_opacities.copy_(torch.log(op / (1.0 - op)).float())


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_forward_builds: needs a CUDA card", file=sys.stderr)
        return 2
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.ops.binning import bin_gaussians
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.ops.kernels import backward, forward
    from gaussiansplat_tpu_torch.ops.kernels.build import CudaKernel, build_all
    from gaussiansplat_tpu_torch.ops.projection import make_payload

    other_dir = Path(argv[0]).resolve()
    ours = {"fwd": forward.FORWARD, "bwd": backward.BACKWARD}
    other = {k: CudaKernel(str(other_dir / v.source.name), v.symbol, v.argtypes)
             for k, v in ours.items()}
    build_all([*ours.values(), *other.values()])

    device = torch.device("cuda")
    cfg = RasterConfig()
    cam = look_at(eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, 0.0), fx=cs.FX,
                  fy=cs.FX, width=cs.WIDTH, height=cs.HEIGHT, device=device)
    card = cs.card_line()
    print(card)
    ok = True
    for n, spread in ((1_000_000, False), (300_000, False), (1_000_000, True)):
        model = cs.bench_scene(n, device)
        label = f"n={n}" + (", opacities spread" if spread else "")
        with torch.no_grad():
            if spread:
                spread_opacities(model, cfg.alpha_min, seed=3)
            proj = cs.project(model, cam, cfg)
            b = bin_gaussians(proj, cs.WIDTH, cs.HEIGHT, cfg, impl="cuda")
            sp = b.gather_payload(make_payload(proj))
            fargs = (sp, b.tile_starts, cs.WIDTH, cs.HEIGHT, cfg)
            a, o = run_build(ours, "fwd", fargs), run_build(other, "fwd", fargs)
            gen = torch.Generator(device=device).manual_seed(7)
            cot = torch.randn(a.shape, generator=gen, device=device)
            cot[:, 4:] = 0.0
            bargs = (sp, b.tile_starts, cot, a, cs.WIDTH, cs.HEIGHT, cfg)
            ga, go = run_build(ours, "bwd", bargs), run_build(other, "bwd", bargs)
        torch.cuda.synchronize()
        same = torch.equal(a.view(torch.int32), o.view(torch.int32))
        ok &= same
        p = int(b.num_pairs)
        print(f"K1 {cs.WIDTH}x{cs.HEIGHT} {label} ({p} pairs): this checkout's "
              f"build vs {argv[0]}: bit-identical {same}")
        worst = 0.0
        for row in range(11):
            scale = float(go[:p, row].abs().max())
            rel = (ga[:p, row] - go[:p, row]).abs() / max(scale, 1e-30)
            dmax = float(rel.max())
            frac = float((rel > cs.K2_BULK_ATOL).float().mean())
            worst = max(worst, dmax)
            inside = scale == 0 or (dmax <= cs.K2_ATOL and frac <= cs.K2_BULK_FRAC)
            ok &= inside
            print(f"  K2 row {row:2d}: max|row| {scale:.3e}, max scaled |diff| "
                  f"{dmax:.3e}, {frac:.4%} above {cs.K2_BULK_ATOL}"
                  + ("" if inside else "  OUTSIDE THE BUDGET"))
        zero = not ga[:p, 11:].any()
        ok &= zero
        print(f"K2 {label}: this checkout's build vs {argv[0]}: rows 0-10 within "
              f"{worst:.3e} of each row's largest entry, rows 11-15 zero {zero}")
        with torch.no_grad():
            k1 = time_in_turns(other, ours, "fwd", fargs)
            k2 = time_in_turns(other, ours, "bwd", bargs)
        print(f"times {label} (CUDA events, 10 launches, in turns other, this, "
              f"this, other): K1 {k1}, K2 {k2}; after: {card_state()} | {card}")
        del model, proj, b, sp, a, o, ga, go, cot
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
