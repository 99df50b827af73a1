#!/usr/bin/env python3
"""Compare the four kernels (K1 forward, K2 backward, K4 expand, K3 segment
reduce) of another source tree with this checkout's, on the card.

    git archive <commit> gaussiansplat_tpu_torch/csrc | tar -x -C other/
    python3 compare_forward_builds.py other/gaussiansplat_tpu_torch/csrc

Builds `forward.cu`, `backward.cu`, `expand.cu` and `segreduce.cu` of the
given csrc directory beside the checkout's own (one nvcc each, in
parallel), and runs both through the checkout's wrappers on the 1920x1080
benchmark scene of chip_smoke.py at 1M and 300k gaussians, at 1M with
opacities spread uniformly from alpha_min to 1 (about a third of the pairs
then have a support cut by the alpha gate rather than by sigma), at 1M
skewed (chip_smoke.py `skewed_scene`: 1% of the gaussians over up to
max_tiles_per_gaussian tiles) and at 3M (K4's separate streams):

* K1: whether the two (T, 8, tile_px) output blocks are equal in every bit;
* K2: on the same payload, K1's block and a seeded cotangent, the largest
  difference of each gradient row 0-10 scaled by that row's largest entry
  in the other tree's output, held to chip_smoke.py's K2 budget
  (`K2_BULK_ATOL` for all but `K2_BULK_FRAC` of the entries, `K2_ATOL` for
  every entry);
* K4 (1M, skewed, 3M): whether the two builds' outputs are equal over the
  whole capacity, in the packed and the separate-streams regime;
* K3 (1M, skewed; seeded random rows in pre-sort order): the same bits on
  every segment this checkout's build sums in one thread group (at most
  `LONG_ROWS` rows), within 1e-5 of each channel's largest entry on the
  segments it splits, which are counted and named by their lengths;
* each kernel's time by CUDA events, the two builds in turns (other, this,
  this, other; every reading printed), and the card's SM clock, temperature
  and power draw just after.

Exits non-zero if K1 or K4 differs, K2 or K3 leaves its budget or no CUDA
card is present. The two trees must export the same launchers
(`gs_rasterize_forward`, `gs_rasterize_backward`, `gs_expand_pairs`,
`gs_segment_reduce`).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs


def run_build(build: dict, key: str, args):
    """Launch kernel `key` ('fwd' K1, 'bwd' K2, 'expand' K4, 'segreduce'
    K3) of `build` (a dict of CudaKernels) through the checkout's wrapper,
    so every build gets the wrapper's own checks and arguments."""
    from gaussiansplat_tpu_torch.ops.kernels import (backward, expand, forward,
                                                     segreduce)

    module, attr, fn = {
        "fwd": (forward, "FORWARD", forward.rasterize_forward_cuda),
        "bwd": (backward, "BACKWARD", backward.rasterize_backward_cuda),
        "expand": (expand, "EXPAND", expand.expand_pairs_cuda),
        "segreduce": (segreduce, "SEGREDUCE",
                      segreduce.segment_reduce_pairs_cuda),
    }[key]
    own = getattr(module, attr)
    setattr(module, attr, build[key])
    try:
        return fn(*args)
    finally:
        setattr(module, attr, own)


def time_in_turns(other: dict, ours: dict, key: str, args,
                  reps: int = 10) -> str:
    """Four timings of `reps` launches each, in turns other, ours, ours,
    other: 'other (a, b) -> ours (c, d) ms', means first."""
    t = [cs.cuda_ms(lambda w=w: run_build(w, key, args), reps=reps, warmup=2)
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


def compare_expand(ours: dict, other: dict, model, cam, cfg, label: str,
                   card: str, argv0: str):
    """K4 of both builds on one scene: whether they are equal over the
    whole capacity, and the compacted rects."""
    from gaussiansplat_tpu_torch.ops.binning import compact_rects

    with torch.no_grad():
        c = compact_rects(cs.project(model, cam, cfg), cs.WIDTH, cs.HEIGHT,
                          cfg)
        args = (c.off_c, c.rect_c, c.mask_c, c.num_pairs, c.capacity,
                c.tiles_x, c.num_tiles, c.rank_bits, c.pack_bits, c.packed_keys)
        a, o = run_build(ours, "expand", args), run_build(other, "expand", args)
        torch.cuda.synchronize()
        a = a if isinstance(a, tuple) else (a,)
        o = o if isinstance(o, tuple) else (o,)
        same = all(torch.equal(x, y) for x, y in zip(a, o))
        regime = "packed keys" if c.packed_keys else "separate streams"
        print(f"K4 {label} ({regime}, capacity {c.capacity}, num_pairs "
              f"{int(c.num_pairs)}): this checkout's build vs {argv0}: equal "
              f"over the whole capacity {same}")
        t = time_in_turns(other, ours, "expand", args, reps=20)
    print(f"times K4 {label} (CUDA events, 20 launches, in turns other, this, "
          f"this, other): {t}; after: {card_state()} | {card}")
    return same, c


def compare_segreduce(ours: dict, other: dict, c, label: str, card: str,
                      argv0: str) -> bool:
    """K3 of both builds on seeded random rows in the pre-sort order of
    compacted rects `c`: bit-equal on the segments summed by one thread
    group, within 1e-5 of each channel's largest entry on the split ones."""
    from gaussiansplat_tpu_torch.ops.kernels.segreduce import LONG_ROWS

    n = c.off_c.shape[0]
    rows, seg = cs.random_presort_rows(c)
    args = (rows, seg, n)
    a = run_build(ours, "segreduce", args)
    o = run_build(other, "segreduce", args)
    torch.cuda.synchronize()
    lens = (seg[1:] - seg[:-1]).long()
    split = lens > LONG_ROWS
    same = torch.equal(a[~split].view(torch.int32), o[~split].view(torch.int32))
    scale = o.abs().amax(0).clamp(min=1e-30)
    rel = float(((a - o).abs() / scale).max())
    differ = int((a != o).any(1).sum())
    named = ""
    if split.any():
        sl = lens[split]
        named = (f"; {int(split.sum())} split segments (ranks with > "
                 f"{LONG_ROWS} rows, lengths {int(sl.min())}-{int(sl.max())}, "
                 f"median {float(sl.float().median()):.0f}), "
                 f"{int((a[split] != o[split]).any(1).sum())} of them differ "
                 "in bits")
    print(f"K3 {label} ({int(c.num_pairs)} pairs): this checkout's "
          f"build vs {argv0}: bit-equal on the unsplit segments {same}, "
          f"{differ} rows differ, max |diff| {rel:.3e} of the channel's "
          f"largest entry{named}")
    t = time_in_turns(other, ours, "segreduce", args, reps=20)
    print(f"times K3 {label} (CUDA events, 20 launches, in turns other, this, "
          f"this, other): {t}; after: {card_state()} | {card}")
    return same and rel <= 1e-5


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
    from gaussiansplat_tpu_torch.ops.kernels import (backward, expand, forward,
                                                     segreduce)
    from gaussiansplat_tpu_torch.ops.kernels.build import CudaKernel, build_all
    from gaussiansplat_tpu_torch.ops.projection import make_payload

    other_dir = Path(argv[0]).resolve()
    ours = {"fwd": forward.FORWARD, "bwd": backward.BACKWARD,
            "expand": expand.EXPAND, "segreduce": segreduce.SEGREDUCE}
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

    # K4 and K3: the bench and skewed scenes at 1M, K4 also at 3M.
    scenes = (("n=1000000", lambda: cs.bench_scene(1_000_000, device)),
              ("n=1000000 skewed", lambda: cs.skewed_scene(1_000_000, device)),
              ("n=3000000", lambda: cs.bench_scene(3_000_000, device, seed=1)))
    for label, make in scenes:
        model = make()
        same, c = compare_expand(ours, other, model, cam, cfg, label, card,
                                 argv[0])
        ok &= same
        del model
        if c.packed_keys:
            ok &= compare_segreduce(ours, other, c, label, card, argv[0])
        del c
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
