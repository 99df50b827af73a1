#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gaussiansplat_tpu_torch) on one card.

    python3 chip_smoke.py

1. Probe: requires a CUDA card; prints `nvidia-smi` name and power limit.
2. Build: compiles the four kernels (K4 expand, K1 forward, K2 backward,
   K3 segment reduce) from gaussiansplat_tpu_torch/csrc (one nvcc per
   source, in parallel) and prints the build time and the ptxas register /
   shared-memory lines.
3. Kernels against their plain PyTorch versions at the main paths' shapes
   (1920x1080): K4 (pair expansion) integer-equal over the whole capacity
   with 1M gaussians (packed keys) and 3M (separate streams); K1 (forward
   raster) on the 1M sorted payload within the image outlier budget, with
   equal stop counts on >= 99.9% of tiles; K2 (backward raster) on the same
   payload, K1's block and a seeded random cotangent, within a budget
   relative to each gradient row's largest entry; K3 (segment reduce) on
   K2's rows in pre-sort order, within 1e-5 of each channel's largest
   entry and bit for bit as the plain twin of its order. K2 and K3 must
   give the same bits on two launches. Times by CUDA events, with the plain
   versions' times and K3's `index_add_` yardstick. Then a skewed scene:
   the 1M scene with 1% of its gaussians at scales in (0.05, 0.4), up to
   max_tiles_per_gaussian pairs each: K4 integer-equal (overflow 0), K3 on
   seeded random rows, with the pair count and segment lengths printed.
   K1's and K2's bounds count this run's raster work with plain PyTorch on
   the card (`raster_work`: composited pairs, the (pixel, pair)s inside
   each pair's support extent, the live (pixel, pair)s) and charge the
   function's work on them at the card's per-SM rates; every term is
   printed, and beside it the figure of the kernels' own design.
4. Serve: the 1M-gaussian SH-3 benchmark scene, 8 orbit requests through
   `render()` after one warm-up, then the scene exported to PLY and 2 frames
   through the CLI; a profile of one request.
5. Train: the same scene, one camera, a target rendered from a copy with
   perturbed colours; `init_train_state`, one warm-up step, then 5 steps of
   `make_train_step` (overflow 0, finite falling loss, every parameter
   group's gradient finite and non-zero); a profile of one step.
6. A small scene with the kernels against the plain versions: image,
   transmittance and every gradient.
7. Loop: the training loop through its entry points at the full width of
   the quality configuration. The bundled benchmark scene (150k GT
   gaussians, SH 3, 800x800, 16 train + 2 test views, 20k init gaussians
   at capacity 262,144) with GT from the dense oracle (ms per GT view
   printed); the GT model through `render()` against its oracle image
   (>= 60 dB); `Trainer.fit` for 800 iterations on a compressed schedule
   (6 densify passes at 100-600, an opacity reset at 400, evals every 200,
   checkpoints at 400 and 800): overflow 0 on every logged step, finite
   loss, rising gaussian count, eval PSNR at 800 above that at 200; then a
   fresh Trainer resumes from the step-400 checkpoint alone and runs to
   800 (densify passes at 500 and 600, alive count within 10% of the
   straight run's). Median step ms, each densify pass's ms, eval ms per
   view and the phase's peak device memory are printed.
8. CLI train: `python -m gaussiansplat_tpu_torch train --scene synthetic`
   as a user runs it (on the card by default) for 200 steps, `--resume`
   to 300, and `eval` of the exported PLY; the run's files, overflow 0,
   K1-K4 on every step.
9. Giant frames: the 1M bench scene at 7680x4320 with 32 px tiles and at
   3840x2160 with 16 px tiles (240 x 135 tiles: int64 rects), fx scaled
   with the width, `pairs_per_gaussian` raised until nothing overflows. K4
   integer-equal to its plain version over the whole capacity and timed
   beside its bytes bound; the 4K frame through `render()` against the
   plain path; the 8K frame through `render()` (overflow 0, finite),
   request ms and a profile of one request.
10. 2D splats: 1M screen-space splats (2-10 px, opacity 0.7) at 1920x1080,
   render and backward through K1-K4 against the plain versions (image
   budget, gradients within 2e-3), request ms, 20 Adam steps toward a
   target from a perturbed copy (finite falling loss, K1-K4 every step).
11. Sharded: this script started as 2 ranks (`--sharded-rank`, gloo) on
   the one card; the tile-sharded render (tile=2) against `render()`, one
   step at (data=1, tile=2) and at (data=2, tile=1) against the
   single-device mean-of-views loss (1e-5 relative) and gradients (2e-3),
   replicas bit-equal, K1-K4 in every rank, step ms per rank.
The serve phase also checks native IO: the CLI read the exported 1M PLY
with the native parser; both parsers' times are printed.
The launch counts are zeroed just before the serve, the train, the loop,
the CLI-train, each giant frame's requests and the 2D steps (and in each
rank around its render and steps) and read just after; every kernel of
the phase must have launched (K1-K4 on every training step, K4 and K1 on
every render).

Every phase raises on failure. The last two lines are one JSON object with
per-kernel numbers and `{"ok": true, "device": {...}}`. Exits non-zero when
no CUDA card is present.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM3,
# and 67 TFLOP/s float32 outside the tensor cores, which counts each FMA as
# two operations: 132 SMs x 128 lanes x 1.98 GHz. Per-SM rates of compute
# capability 9.0 (CUDA C++ programming guide, "Arithmetic Instructions",
# throughput of native arithmetic instructions, in results per clock per
# SM): 128 32-bit float adds, multiplies or FMAs, which is also the issue
# rate of any instruction (4 schedulers x 32 lanes); 16 special-function
# results (exp2, log2, reciprocal); 32 warp-shuffle results. Shared memory
# delivers 32 banks x 4 B per clock (the guide's "Shared Memory" section):
# one warp-wide load per clock per SM, a broadcast 16-byte load included.
SMS, CLOCK = 132, 1.98e9
PEAK_BYTES_PER_S = 3.35e12
# How long `cuda_ms` holds the card while the host enqueues the timed calls.
HOLD_MS = 5.0
RATES = {"instruction issue": 128 * SMS * CLOCK,
         "special-function units": 16 * SMS * CLOCK,
         "shared-memory loads": 32 * SMS * CLOCK,
         "warp shuffles": 32 * SMS * CLOCK}
# The bounds count the work of the function on this run's data (counts
# from `raster_work`), whatever the design, in thread instructions and
# special-function calls:
#   pairs:  every composited pair, its support extent (a logarithm, three
#           divides and two square roots: ~30 instructions, 6 calls);
#   inside: every (pixel, pair) inside that extent (|dx| <= hx, |dy| <= hy:
#           the only pixels where a gate can pass), the gates: dx, dy, the
#           factored q, the -1/2 scale, the opacity multiply and two
#           compares (14) and an exponential;
#   live:   every live (pixel, pair): K1 the clamp, exp(logT), w, five
#           multiply-adds and log1p (35, 2 calls); K2 the rewind, exp, w,
#           dw, dalpha with its divide, dlogT, dq and one add per gradient
#           channel for the sum over pixels (63, 3 calls).
K1_COST = {"pairs": dict(issue=30, sfu=6), "inside": dict(issue=14, sfu=1),
           "live": dict(issue=35, sfu=2)}
K2_COST = {"pairs": dict(issue=30, sfu=6), "inside": dict(issue=14, sfu=1),
           "live": dict(issue=63, sfu=3)}
# The design's figure, printed beside the bound (not the bound): the same
# counts charged with what K1 and K2 issue, in lane slots (a warp-wide
# instruction is 32; a 16-byte shared load of 32 lanes 128, a broadcast 32):
#   tested:    every (warp, pair) of the composited chunks, one lane: a
#              16-byte load, the box test, the ballot (12; K2 23 with the
#              zero stores of a culled pair's partial);
#   kept:      every (warp, pair) whose box meets the extent, all 32 lanes:
#              the bit walk, three broadcast loads, the quad's q, four gates
#              (78; K2 80 with the vote), whether or not a pixel is inside;
#   live_warp: K2, every (warp, pair) with a live pixel, all 32 lanes: the
#              16-shuffle transpose reduction and the partial's store (64);
#   live:      as in the bound;
#   rows:      K2, every composited pair: 16 threads add the 8 warps'
#              partials and store the row.
K1_DESIGN = {"tested": dict(issue=12, lds=4),
             "kept": dict(issue=78 * 32, lds=3 * 32, sfu=4 * 32),
             "live": dict(issue=35, sfu=2)}
K2_DESIGN = {"tested": dict(issue=23, lds=4),
             "kept": dict(issue=80 * 32, lds=3 * 32, sfu=4 * 32),
             "live_warp": dict(issue=64 * 32, shfl=16 * 32),
             "live": dict(issue=63, sfu=3),
             "pairs": dict(issue=16 * 18, lds=16 * 8)}
# K2's budget against its plain version, relative to each gradient row's
# largest entry: all but 0.1% of the entries within 1e-4 (per-pixel against
# per-chunk rewinding and other summation orders move them by ~1e-6), every
# entry within 1e-2 (a knife-edge alpha gate, where exp rounds differently,
# moves one pair's row by one pixel's share: up to ~3e-3 in the CPU tests).
K2_BULK_ATOL, K2_BULK_FRAC, K2_ATOL = 1e-4, 1e-3, 1e-2

WIDTH, HEIGHT, N_GAUSSIANS, FX = 1920, 1080, 1_000_000, 1600.0
# Per-axis scales of the skewed scene's large 1% (`skewed_scene`).
SKEWED_SCALES = (0.05, 0.4)


def bench_scene(n: int, device, seed: int = 0):
    """The benchmark scene of the reference's bench.py at (WIDTH, HEIGHT, n):
    opacity 0.8, SH degree 3, world scale so every n tiles the screen at the
    same per-splat pixel area."""
    from gaussiansplat_tpu_torch.models import random_model

    k = (1600.0 / FX) * ((WIDTH * HEIGHT / n) / 2.0736) ** 0.5
    g = torch.Generator().manual_seed(seed)
    return random_model(g, n, sh_degree=3, extent=1.0, opacity=0.8,
                        scale_range=(0.004 * k, 0.012 * k), device=device)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` back-to-back calls. The card
    is held by a sleep kernel (HOLD_MS) while the host enqueues the calls,
    so that a kernel shorter than its wrapper's host time (K4: ~0.02 ms)
    is timed back to back, not at the host's enqueue rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(HOLD_MS * 1e-3 * CLOCK))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def assert_budget(got, want, what, atol=1e-4, outlier_frac=1e-3,
                  outlier_atol=5e-2) -> float:
    """All but `outlier_frac` of entries within atol, every entry within
    outlier_atol (alpha-gate flips move a pixel by ~alpha_min)."""
    d = (got - want).abs()
    dmax = float(d.max())
    frac = float((d > atol).float().mean())
    if not (dmax <= outlier_atol and frac <= outlier_frac):
        raise AssertionError(f"{what}: max|diff| {dmax:.3e}, "
                             f"{frac:.3%} of entries above {atol}")
    return dmax


def bound(nbytes: float, work: dict, cost: dict):
    """Bytes over the memory rate and each unit's total over its per-SM
    peak rate (ms): the largest, which one it is, and every term."""
    units = {"issue": "instruction issue", "sfu": "special-function units",
             "lds": "shared-memory loads", "shfl": "warp shuffles"}
    totals = {}
    for item, charges in cost.items():
        for unit, per in charges.items():
            totals[units[unit]] = totals.get(units[unit], 0.0) + work[item] * per
    times = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    times.update({k: v / RATES[k] * 1e3 for k, v in totals.items()})
    worst = max(times, key=times.get)
    return times[worst], "bytes" if worst == "bytes" else "operations", times


def bound_text(nbytes: float, work: dict, cost: dict, design: dict) -> str:
    """The bound with every term, and the design's figure."""
    ms, by, parts = bound(nbytes, work, cost)
    d_ms, _, d_parts = bound(nbytes, work, design)
    d_by = max(d_parts, key=d_parts.get)
    return (f"bound {ms:.4f} ms ({by}; "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
            + f"), design figure {d_ms:.4f} ms ({d_by})")


def raster_work(sp, tile_starts, stops, cfg, batch: int = 8192) -> dict:
    """What K1 and K2 evaluate on this run's data, counted with plain
    PyTorch on the card: the in-segment pairs of the chunks K1 composited
    (its stop row), and over them the (pixel, pair)s, those inside the
    pair's support extent, the live (pixel, pair)s, and the (warp, pair)s
    the cull tests, those it keeps and those with a live pixel. Gates:
    ops/tile_raster.alpha_gates; extent: its twin support_extent; warps:
    the 16x8-pixel boxes of csrc/raster_common.cuh."""
    from gaussiansplat_tpu_torch.ops.binning import tile_grid
    from gaussiansplat_tpu_torch.ops.kernels.common import WARP_BOX, raster_warps
    from gaussiansplat_tpu_torch.ops.tile_raster import alpha_gates, support_extent

    device = sp.device
    ts, cs = cfg.tile_size, cfg.chunk_size
    tiles_x, _ = tile_grid(WIDTH, HEIGHT, ts)
    starts = tile_starts.to(torch.int64)
    base = starts[:-1] // cs * cs
    reach = torch.minimum(starts[1:], base + stops.to(torch.int64) * cs)
    lens = torch.clamp(reach - starts[:-1], min=0)
    tile = torch.repeat_interleave(torch.arange(lens.numel(), device=device), lens)
    first = torch.repeat_interleave(starts[:-1], lens)
    offs = torch.arange(tile.numel(), device=device) - torch.repeat_interleave(
        torch.cumsum(lens, 0) - lens, lens)
    rows = first + offs                                   # composited pairs
    idx = torch.arange(ts * ts, device=device)
    xl, yl = (idx % ts).float(), (idx // ts).float()
    wx, wy = raster_warps(ts)
    bw, bh = WARP_BOX
    warp_of = (yl.long() // bh) * wx + xl.long() // bw
    onehot = torch.nn.functional.one_hot(warp_of, wx * wy).float()
    w = torch.arange(wx * wy, device=device)
    bx0 = ((w % wx) * bw).float()
    bx1 = torch.clamp(bx0 + bw - 1, max=ts - 1)
    by0 = ((w // wx) * bh).float()
    by1 = torch.clamp(by0 + bh - 1, max=ts - 1)
    kept = live_warp = live = inside = 0
    for i in range(0, rows.numel(), batch):
        r, t = rows[i:i + batch], tile[i:i + batch]
        pay = sp[r]
        mx = (pay[:, 0] - ((t % tiles_x) * ts).float())[:, None]
        my = (pay[:, 1] - ((t // tiles_x) * ts).float())[:, None]
        ca, cb, cc, op = (pay[:, k][:, None] for k in (2, 3, 4, 5))
        dx, dy = xl - mx, yl - my
        _, _, lv = alpha_gates(ca, cb, cc, op, dx, dy, cfg)
        _, hx, hy = support_extent(ca, cb, cc, op, cfg)
        inside += int(((dx.abs() <= hx) & (dy.abs() <= hy)).sum())
        hits = ((bx0 - mx <= hx) & (bx1 - mx >= -hx)
                & (by0 - my <= hy) & (by1 - my >= -hy))
        kept += int(hits.sum())
        live_warp += int(((lv.float() @ onehot) > 0).sum())
        live += int(lv.sum())
    pairs = rows.numel()
    return dict(pairs=pairs, evaluated=pairs * ts * ts, inside=inside,
                live=live, tested=pairs * wx * wy, kept=kept,
                live_warp=live_warp)


def print_work(work: dict, card: str) -> None:
    ev = max(work["evaluated"], 1)
    print("raster work on this run's data (K1 and K2 sweep the same chunks): "
          f"{work['pairs']} composited pairs, {work['evaluated']} (pixel, "
          f"pair)s, {work['inside']} inside the support extent "
          f"({work['inside'] / ev:.4f}), {work['live']} live "
          f"({work['live'] / ev:.4f}); {work['tested']} (warp, pair)s tested "
          f"by the cull, {work['kept']} kept "
          f"({work['kept'] / max(work['tested'], 1):.4f}), {work['live_warp']} "
          f"with a live pixel | {card}")


def project(model, cam, cfg):
    from gaussiansplat_tpu_torch.ops.projection import project_gaussians

    return project_gaussians(model.means, model.quats, model.log_scales,
                             model.logit_opacities, model.sh, cam, cfg,
                             sh_degree=3, alive=model.alive)


def check_expand(model, cam, cfg, packed_expected: bool, label: str,
                 card: str, width: int = WIDTH, height: int = HEIGHT):
    """K4 against its plain version on one scene (integer-equal over the
    whole capacity, overflow 0); returns its record and the compacted
    rects."""
    from gaussiansplat_tpu_torch.ops.binning import compact_rects, expand_compacted

    c = compact_rects(project(model, cam, cfg), width, height, cfg)
    if c.packed_keys != packed_expected:
        raise AssertionError(f"expected packed_keys={packed_expected}")
    if int(c.overflow) != 0:
        raise AssertionError(f"K4 {label}: overflow {int(c.overflow)}")
    got = expand_compacted(c, "cuda")
    want = expand_compacted(c, "torch")
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, want))
    if err != 0:
        raise AssertionError(f"K4 differs from its plain version (max {err})")
    ms = cuda_ms(lambda: expand_compacted(c, "cuda"), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: expand_compacted(c, "torch"), reps=3)
    n = c.off_c.shape[0]
    # Outputs written, and the offsets, rects (4 or 8 B) and masks read.
    nbytes = c.capacity * 4 * len(got) + n * (8 + c.rect_c.element_size()) + 4
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    regime = "packed keys" if c.packed_keys else "separate streams"
    lens = segment_lengths(c)
    print(f"K4 expand {label} {width}x{height} n={n} ({regime}, "
          f"{c.rect_c.dtype} rects, {c.tiles_x}x{c.num_tiles // c.tiles_x} "
          f"tiles of {cfg.tile_size} px, capacity "
          f"{c.capacity}, num_pairs {int(c.num_pairs)}, overflow "
          f"{int(c.overflow)}; pairs per gaussian with pairs: median "
          f"{lens['median']}, p99 {lens['p99']}, max {lens['max']}): equal "
          f"over the whole capacity; {ms:.4f} ms (CUDA events), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes) | {card}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                num_pairs=int(c.num_pairs), lens=lens), c


def segment_lengths(c) -> dict:
    """Median, p99 and max of the pair counts of the gaussians with pairs
    (the segment lengths K3 sums)."""
    seg = torch.cat([c.off_c, c.num_pairs[None]]).to(torch.int64)
    lens = (seg[1:] - seg[:-1]).float()
    lens = lens[lens > 0]
    q = torch.quantile(lens, torch.tensor([0.5, 0.99], device=lens.device))
    return dict(median=float(q[0]), p99=float(q[1]), max=int(lens.max()))


def check_forward(model, cam, cfg, card: str):
    """K1 against its plain version on the 1080p sorted payload."""
    from gaussiansplat_tpu_torch.ops.binning import bin_gaussians
    from gaussiansplat_tpu_torch.ops.kernels.forward import (
        rasterize_forward_cuda,
        rasterize_forward_torch,
    )
    from gaussiansplat_tpu_torch.ops.projection import make_payload

    proj = project(model, cam, cfg)
    b = bin_gaussians(proj, WIDTH, HEIGHT, cfg, impl="cuda")
    sp = b.gather_payload(make_payload(proj))
    args = (sp, b.tile_starts, WIDTH, HEIGHT, cfg)
    got = rasterize_forward_cuda(*args)
    want = rasterize_forward_torch(*args)
    torch.cuda.synchronize()
    err = 0.0
    for row, name in ((0, "R"), (1, "G"), (2, "B"), (4, "weight sum")):
        err = max(err, assert_budget(got[:, row], want[:, row], f"K1 {name}"))
    assert_budget(torch.exp(got[:, 3]), torch.exp(want[:, 3]),
                  "K1 transmittance")
    depth_scale = float(proj.depth[proj.valid].max())
    assert_budget(got[:, 5] / depth_scale, want[:, 5] / depth_scale,
                  "K1 depth / max depth")
    stops_g, stops_w = got[:, 6, 0], want[:, 6, 0]
    same = int((stops_g == stops_w).sum())
    t = stops_g.shape[0]
    print(f"K1 stop counts equal on {same} of {t} tiles")
    if same < 0.999 * t:
        raise AssertionError("K1 stop counts differ on more than 0.1% of tiles")

    ms = cuda_ms(lambda: rasterize_forward_cuda(*args), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: rasterize_forward_torch(*args), reps=2)
    # Bound: `K1_COST` on the counts of this run's data. Bytes: the
    # composited pairs' 10 needed channels read once, the output block
    # written.
    work = raster_work(sp, b.tile_starts, stops_g, cfg)
    print_work(work, card)
    num_pairs = int(b.num_pairs)
    nbytes = work["pairs"] * 40 + got.numel() * 4 + b.tile_starts.numel() * 4
    bound_ms, bound_by, _ = bound(nbytes, work, K1_COST)
    print(f"K1 forward {WIDTH}x{HEIGHT} n={model.capacity} ({t} tiles, "
          f"{num_pairs} pairs, {work['pairs']} pairs composited): image rows "
          f"max|diff| {err:.3e}; {ms:.4f} ms (CUDA events), plain "
          f"{plain_ms:.3f} ms, {bound_text(nbytes, work, K1_COST, K1_DESIGN)} "
          f"| {card}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by), work


def check_backward(model, cam, cfg, work: dict, card: str):
    """K2 against its plain version on the 1080p sorted payload, K1's block
    and a seeded random cotangent (rows 4 and 5 zero, as the rasterizer
    makes them); `work` holds the counts of K1's check on the same data.
    Returns its record and the binning and gradient rows that K3 is checked
    on."""
    from gaussiansplat_tpu_torch.ops.binning import bin_gaussians
    from gaussiansplat_tpu_torch.ops.kernels.backward import (
        rasterize_backward_cuda,
        rasterize_backward_torch,
    )
    from gaussiansplat_tpu_torch.ops.kernels.forward import rasterize_forward_cuda
    from gaussiansplat_tpu_torch.ops.projection import make_payload

    device = model.device
    proj = project(model, cam, cfg)
    b = bin_gaussians(proj, WIDTH, HEIGHT, cfg, impl="cuda")
    sp = b.gather_payload(make_payload(proj))
    fwd = rasterize_forward_cuda(sp, b.tile_starts, WIDTH, HEIGHT, cfg)
    gen = torch.Generator(device=device).manual_seed(7)
    cot = torch.randn(fwd.shape, generator=gen, device=device)
    cot[:, 4:] = 0.0
    args = (sp, b.tile_starts, cot, fwd, WIDTH, HEIGHT, cfg)
    got = rasterize_backward_cuda(*args)
    again = rasterize_backward_cuda(*args)
    want = rasterize_backward_torch(*args)
    torch.cuda.synchronize()
    n = int(b.num_pairs)
    if not torch.equal(got[:n], again[:n]):
        raise AssertionError("K2 gave different bits on two launches")
    if got[:n, 11:].any():
        raise AssertionError("K2 wrote non-zero rows 11-15")
    err = 0.0
    for row in range(11):
        scale = float(want[:n, row].abs().max())
        d = (got[:n, row] - want[:n, row]).abs()
        err = max(err, float(d.max()))
        rel = d / max(scale, 1e-30)
        dmax, frac = float(rel.max()), float((rel > K2_BULK_ATOL).float().mean())
        print(f"  K2 row {row:2d}: max|row| {scale:.3e}, max scaled |diff| "
              f"{dmax:.3e}, {frac:.4%} above {K2_BULK_ATOL}")
        if scale > 0 and not (dmax <= K2_ATOL and frac <= K2_BULK_FRAC):
            raise AssertionError(f"K2 row {row} outside its budget")
    if float(got[:n, :6].abs().max()) == 0.0:
        raise AssertionError("K2 gave no geometry gradient")

    ms = cuda_ms(lambda: rasterize_backward_cuda(*args), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: rasterize_backward_torch(*args), reps=1)
    # Bound: `K2_COST` on K1's counts (K2 sweeps the chunks K1
    # composited). Bytes: the composited pairs read (40 B), every row of the
    # segments written (64 B), 7 rows of the cotangent and forward blocks
    # read per pixel.
    px = cfg.tile_size ** 2
    nbytes = (work["pairs"] * 40 + n * 64 + fwd.shape[0] * px * 7 * 4
              + b.tile_starts.numel() * 4)
    bound_ms, bound_by, _ = bound(nbytes, work, K2_COST)
    print(f"K2 backward {WIDTH}x{HEIGHT} n={model.capacity} ({n} pairs, "
          f"{work['pairs']} pairs composited): bit-equal on two launches, rows "
          f"0-10 max|diff| {err:.3e}; {ms:.4f} ms (CUDA events), plain "
          f"{plain_ms:.3f} ms, {bound_text(nbytes, work, K2_COST, K2_DESIGN)} "
          f"| {card}")
    valid = torch.arange(got.shape[0], device=device) < n
    dsorted = got.masked_fill(~valid[:, None], 0.0)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by), b, dsorted


def check_segreduce(rows, seg, n: int, label: str, card: str):
    """K3 against its plain version on pre-sort rows (rows past seg[-1]
    zero): within 1e-5 of each channel's largest entry, the same bits on
    two launches and the same bits as the plain twin of its order."""
    from gaussiansplat_tpu_torch.ops.kernels.segreduce import (
        long_segment_pieces,
        segment_reduce_pairs_cuda,
        segment_reduce_pairs_split,
        segment_reduce_pairs_torch,
    )

    num_pairs = int(seg[-1])
    got = segment_reduce_pairs_cuda(rows, seg, n)
    again = segment_reduce_pairs_cuda(rows, seg, n)
    want = segment_reduce_pairs_torch(rows, seg, n)
    twin = segment_reduce_pairs_split(rows, seg, n)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"K3 {label} gave different bits on two launches")
    if not torch.equal(got.view(torch.int32), twin.view(torch.int32)):
        raise AssertionError(f"K3 {label} differs from the plain twin of its "
                             "order")
    scale = want.abs().amax(0).clamp(min=1e-30)
    rel = float(((got - want).abs() / scale).max())
    err = float((got - want).abs().max())
    if rel > 1e-5:
        raise AssertionError(f"K3 {label}: max |diff| {rel:.3e} of the "
                             "channel's largest entry")
    split = int(long_segment_pieces(seg)[0].numel())
    # Yardstick only: one index_add_ over each row's rank (atomic on the
    # card); the port never calls it there.
    p = rows.shape[0]
    pos = torch.arange(p, dtype=torch.int32, device=rows.device)
    rank = torch.clamp(torch.searchsorted(seg, pos, right=True, out_int32=True) - 1,
                       0, n - 1)
    out = torch.zeros((n, 16), device=rows.device)
    ms = cuda_ms(lambda: segment_reduce_pairs_cuda(rows, seg, n), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: segment_reduce_pairs_torch(rows, seg, n), reps=5)
    library_ms = cuda_ms(lambda: out.index_add_(0, rank, rows), reps=20, warmup=3)
    nbytes = num_pairs * 64 + n * 64 + (n + 1) * 4
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"K3 segment reduce {label} n={n} ({num_pairs} pairs, {split} "
          f"segments split): bit-equal on two launches and to the plain twin "
          f"of its order, max|diff| {err:.3e} ({rel:.3e} of the channel's "
          f"largest entry); {ms:.4f} ms (CUDA events), plain {plain_ms:.3f} "
          f"ms, index_add_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes) | {card}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                library_ms=library_ms, split=split)


def presort_rows(b, dsorted):
    """K2's rows in pre-sort order (each rank's pairs contiguous), the rows
    past num_pairs zero: what the gather's backward hands K3."""
    rows = torch.empty_like(dsorted).index_copy_(0, b.sorted_pos.long(),
                                                 dsorted)
    rows[int(b.num_pairs):] = 0.0
    return rows


def random_presort_rows(c, seed: int = 13):
    """K3's inputs for compacted rects `c`: seeded random (capacity, 16)
    rows in pre-sort order, zero past num_pairs, and the segment offsets."""
    gen = torch.Generator(device=c.off_c.device).manual_seed(seed)
    rows = torch.randn((c.capacity, 16), generator=gen, device=c.off_c.device)
    rows[int(c.num_pairs):] = 0.0
    return rows, torch.cat([c.off_c, c.num_pairs[None]])


def skewed_scene(n: int, device, seed: int = 0):
    """The benchmark scene with 1% of its gaussians (chosen from the seed)
    given scales uniform in SKEWED_SCALES on each axis: backgrounds and
    skies, up to max_tiles_per_gaussian tiles each at 1080p."""
    model = bench_scene(n, device, seed)
    g = torch.Generator().manual_seed(seed + 100)
    idx = torch.randperm(n, generator=g)[: n // 100]
    lo, hi = (math.log(s) for s in SKEWED_SCALES)
    scales = lo + (hi - lo) * torch.rand((idx.numel(), 3), generator=g)
    with torch.no_grad():
        model.log_scales[idx.to(device)] = scales.to(device)
    return model


def check_skewed(cfg, cam, device, card: str):
    """K4 and K3 on the skewed scene: K4 integer-equal over the whole
    capacity, K3 on seeded random rows in pre-sort order."""
    model = skewed_scene(N_GAUSSIANS, device)
    with torch.no_grad():
        k4, c = check_expand(model, cam, cfg, True, "skewed", card)
        if k4["lens"]["max"] < 300:
            raise AssertionError("skewed scene: longest segment "
                                 f"{k4['lens']['max']}")
        rows, seg = random_presort_rows(c)
        k3 = check_segreduce(rows, seg, c.off_c.shape[0], "skewed", card)
    del model, c, rows
    torch.cuda.empty_cache()
    return k4, k3


def serve(model, cfg, card: str):
    """8 render requests plus 2 CLI frames; returns the CLI-checked stats."""
    from gaussiansplat_tpu_torch import cli
    from gaussiansplat_tpu_torch.ops.camera import orbit_camera
    from gaussiansplat_tpu_torch.render import render
    from gaussiansplat_tpu_torch.utils import export_ply

    device = model.device
    cams = [orbit_camera(2.0 * math.pi * i / 8, 4.0, fx=FX, fy=FX,
                         width=WIDTH, height=HEIGHT, device=device)
            for i in range(8)]
    images, times = [], []
    with torch.inference_mode():
        render(model, cams[0], cfg)          # warm-up
        torch.cuda.synchronize()
        for cam in cams:
            t0 = time.perf_counter()
            out = render(model, cam, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if out.image.shape != (HEIGHT, WIDTH, 3):
                raise AssertionError(f"image shape {tuple(out.image.shape)}")
            if not bool(torch.isfinite(out.image).all()):
                raise AssertionError("non-finite pixels")
            if int(out.overflow) != 0:
                raise AssertionError(f"overflow {int(out.overflow)}")
            if int(out.num_pairs) == 0 or float(out.image.max()) <= 0.0:
                raise AssertionError("nothing was rendered")
            images.append(out.image.clone())
            print(f"request {len(times)}: {times[-1]:.3f} ms (host clock to "
                  f"synchronize), num_pairs {int(out.num_pairs)}, overflow "
                  f"{int(out.overflow)}, max_chunks_needed "
                  f"{int(out.max_chunks_needed)} | {card}")

    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "scene.ply")
        export_ply(ply, model)
        outdir = os.path.join(tmp, "frames")
        t0 = time.perf_counter()
        rc = cli.main(["render", "--ply", ply, "--out", outdir, "--frames",
                       "2", "--width", str(WIDTH), "--height", str(HEIGHT),
                       "--fx", str(FX), "--radius", "4", "--orbit-height",
                       "0", "--device", "cuda"])
        cli_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"CLI render exited {rc}")
        native = native_io(ply, model.capacity, card)
        # The CLI's orbit angles 0 and pi are requests 1 and 5 above.
        for i, req in ((0, 0), (1, 4)):
            frame = _load_frame(os.path.join(outdir, f"frame_{i:04d}.png"))
            want = (torch.clamp(images[req], 0, 1) * 255).to(torch.uint8)
            if not np.array_equal(frame, want.cpu().numpy()):
                raise AssertionError(f"CLI frame {i} differs from request {req + 1}")
    print(f"CLI: 2 frames of {WIDTH}x{HEIGHT} in {cli_s:.2f} s (PLY import "
          "included), equal to the served frames")
    return times, native


def native_io(ply: str, n: int, card: str) -> dict:
    """Native IO (in the serve phase): the CLI render just read `ply` with the native parser
    (data/native_loader.py, built with g++ into _build/); the parse of the
    n-gaussian PLY timed with it and with the numpy fallback, the arrays
    equal."""
    from gaussiansplat_tpu_torch.data import ply as ply_mod

    if ply_mod.LAST_PARSER != "native":
        raise AssertionError(f"the CLI read the PLY with {ply_mod.LAST_PARSER}")
    times = {}
    for parser in ("native", "numpy"):
        saved = ply_mod._NATIVE
        if parser == "numpy":
            ply_mod._NATIVE = False
        try:
            t0 = time.perf_counter()
            arrays = ply_mod.load_gaussian_ply(ply)
            times[parser] = (time.perf_counter() - t0) * 1e3
        finally:
            ply_mod._NATIVE = saved
        if ply_mod.LAST_PARSER != parser:
            raise AssertionError(f"{parser} parse used {ply_mod.LAST_PARSER}")
        if parser == "native":
            first = arrays
    if not all(np.array_equal(a, b) for a, b in zip(first, arrays)):
        raise AssertionError("native and numpy PLY parses differ")
    mb = os.path.getsize(ply) / 2 ** 20
    print(f"native IO: the CLI read the PLY with the native parser; parse of "
          f"{n} gaussians ({mb:.1f} MiB) {times['native']:.3f} ms native, "
          f"{times['numpy']:.3f} ms numpy, equal arrays | {card}")
    return dict(parse_ms=times, mib=mb)


def profile(fn, what: str, card: str, top: int = 12) -> None:
    """Device time by kernel of one call of fn (torch.profiler), after one
    unprofiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel events only: an operator's device time, and a user annotation's
    # (the optimizer step's), repeat their kernels'.
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profiled {what}: kernels busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"wall (profiler on; idle share {1 - busy / wall_ms:.3f}) | {card}")
    for ms, count, key in rows[:top]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")


def profile_request(model, cfg, card: str) -> None:
    """Device time by kernel of one served request."""
    from gaussiansplat_tpu_torch.ops.camera import orbit_camera
    from gaussiansplat_tpu_torch.render import render

    cam = orbit_camera(0.5, 4.0, fx=FX, fy=FX, width=WIDTH, height=HEIGHT,
                       device=model.device)
    with torch.inference_mode():
        profile(lambda: render(model, cam, cfg), "request", card)


def train(model, cam, cfg, kernels, card: str):
    """init_train_state, one warm-up step, then 5 steps of make_train_step
    against a target rendered from a copy of the scene with perturbed
    colours. The launch counts are zeroed after the warm-up; K1-K4 must
    launch on every step. Returns per-step ms and the phase's launches."""
    import copy

    from gaussiansplat_tpu_torch.config import TrainConfig
    from gaussiansplat_tpu_torch.models import scene_extent
    from gaussiansplat_tpu_torch.render import render
    from gaussiansplat_tpu_torch.train import init_train_state, make_train_step

    device = model.device
    ref = copy.deepcopy(model)
    gen = torch.Generator(device=device).manual_seed(11)
    with torch.no_grad():
        ref.sh_dc.add_(0.3 * torch.randn(ref.sh_dc.shape, generator=gen,
                                         device=device))
        gt = render(ref, cam, cfg).image
    del ref
    tcfg = TrainConfig()
    state = init_train_state(model, tcfg, float(scene_extent(model)))
    step = make_train_step(cfg, tcfg)
    state, _ = step(state, cam, gt, 3)      # warm-up
    torch.cuda.synchronize()

    for k in kernels:
        k.launches = 0
    times, losses = [], []
    for i in range(5):
        before = [k.launches for k in kernels]
        t0 = time.perf_counter()
        state, met = step(state, cam, gt, 3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step = {k.name: k.launches - b for k, b in zip(kernels, before)}
        loss = float(met["loss"])
        losses.append(loss)
        print(f"train step {i + 1}: {times[-1]:.3f} ms (host clock to "
              f"synchronize), loss {loss:.6f}, psnr {float(met['psnr']):.3f}, "
              f"num_pairs {int(met['num_pairs'])}, overflow "
              f"{int(met['overflow'])}, launches {per_step} | {card}")
        if int(met["overflow"]) != 0:
            raise AssertionError(f"training step {i + 1}: overflow")
        if not math.isfinite(loss):
            raise AssertionError(f"training step {i + 1}: loss {loss}")
        if min(per_step.values()) < 1:
            raise AssertionError(f"training step {i + 1} skipped a kernel: "
                                 f"{per_step}")
    launches = {k.name: k.launches for k in kernels}
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over 5 steps: {losses}")
    for name, prm in model.trainable().items():
        if not bool(torch.isfinite(prm.grad).all()) or not bool(prm.grad.any()):
            raise AssertionError(f"gradient of {name} is not finite and non-zero")
    print(f"per-step ms: mean {float(np.mean(times)):.3f}, min {min(times):.3f}, "
          f"max {max(times):.3f} over 5 steps at {WIDTH}x{HEIGHT}, "
          f"n={model.capacity}, SH 3; loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"launches during training {launches} | {card}")
    profile(lambda: step(state, cam, gt, 3), "training step", card, top=16)
    return times, launches


# The loop phase's schedule: the 3DGS schedule compressed to 800 steps.
LOOP_SCHEDULE = dict(iterations=800, sh_degree=3, sh_increase_every=200,
                     densify_start=100, densify_every=100, densify_end=600,
                     densify_target_fraction=0.08, opacity_reset_every=400,
                     eval_every=200, log_every=100, checkpoint_every=400)


def loop(kernels, card: str) -> dict:
    """The training loop on the quality configuration's scene (see the
    module docstring, phase 7). Returns the phase's launch counts."""
    from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
    from gaussiansplat_tpu_torch.data.benchmark import (
        benchmark_scene, make_gt_renderer)
    from gaussiansplat_tpu_torch.models import scene_extent
    from gaussiansplat_tpu_torch.render import render
    from gaussiansplat_tpu_torch.train import Trainer, psnr
    from gaussiansplat_tpu_torch.utils import StageTimer

    device = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = RasterConfig()
    t0 = time.perf_counter()
    scene, gt_model = benchmark_scene(
        n_points=150_000, width=800, height=800, init_points=20_000,
        capacity=262_144, sh_degree=3, n_train=16, n_test=2,
        gt_renderer="oracle", cfg=cfg, device=device)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    cam, gt_img = scene.test_views[0]
    gt_render = make_gt_renderer(gt_model, cfg, 3)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        again = gt_render(cam)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(again, gt_img):
        raise AssertionError("the oracle GT of a view is not reproducible")
    n_views = len(scene.train_views) + len(scene.test_views)
    print(f"loop scene: 150k GT gaussians, SH 3, 800x800, {n_views} GT views "
          f"and the init model in {scene_s:.3f} s; one oracle GT view "
          f"{min(times):.3f} ms (of 2: {times[0]:.3f}, {times[1]:.3f}); init "
          f"{int(scene.init_model.num_alive)} gaussians at capacity "
          f"{scene.init_model.capacity} | {card}")
    black = torch.zeros((3,), device=device)
    with torch.inference_mode():
        out = render(gt_model, cam, cfg, sh_degree=3, background=black)
    gt_psnr = float(psnr(out.image, gt_img))      # psnr() caps MSE at 1e-12
    d = (out.image - gt_img).abs()
    print(f"GT model through render() against its oracle image: "
          f"{gt_psnr:.3f} dB (MSE {float((d * d).mean()):.3e}, max|diff| "
          f"{float(d.max()):.3e}), overflow {int(out.overflow)}")
    if not gt_psnr >= 60.0 or int(out.overflow) != 0:
        raise AssertionError(f"render() vs oracle: {gt_psnr} dB")
    del gt_model, gt_render, out, again

    tcfg = TrainConfig(**LOOP_SCHEDULE)
    init_copy = copy.deepcopy(scene.init_model)
    rows, timer = [], StageTimer()
    for k in kernels:
        k.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpts")
        t0 = time.perf_counter()
        model, met = Trainer(raster_cfg=cfg, cfg=tcfg).fit(
            scene.init_model, scene.train_views,
            log=lambda it, m: rows.append((it, m)), ckpt_dir=ckpt,
            eval_views=scene.test_views, timer=timer)
        fit_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        saved = sorted(os.listdir(ckpt))
        if saved != ["step_00000400", "step_00000800"]:
            raise AssertionError(f"checkpoints {saved}")
        resume_dir = os.path.join(tmp, "resume")
        os.makedirs(resume_dir)
        shutil.copytree(os.path.join(ckpt, "step_00000400"),
                        os.path.join(resume_dir, "step_00000400"))
        rrows, rtimer = [], StageTimer()
        rmodel, rmet = Trainer(raster_cfg=cfg, cfg=tcfg).fit(
            init_copy, scene.train_views,
            log=lambda it, m: rrows.append((it, m)), ckpt_dir=resume_dir,
            resume=True, eval_views=scene.test_views, timer=rtimer)
    peak = torch.cuda.max_memory_allocated()

    train_rows = [(it, m) for it, m in rows if m.get("kind") != "eval"]
    evals = {it: m for it, m in rows if m.get("kind") == "eval"}
    for it, m in rows:
        print(f"loop [step {it}] " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in m.items()))
    dens = [(it, m) for it, m in train_rows if "cloned" in m]
    if [it for it, _ in dens] != [100, 200, 300, 400, 500, 600]:
        raise AssertionError(f"densify passes at {[it for it, _ in dens]}")
    if any(m["overflow"] != 0 for _, m in train_rows):
        raise AssertionError("overflow on a logged step")
    if not all(math.isfinite(m["loss"]) for _, m in train_rows):
        raise AssertionError("non-finite loss")
    alive = [int(m["num_alive"]) for _, m in train_rows]
    if alive[0] != 20_000 or not int(model.num_alive) > 20_000:
        raise AssertionError(f"num_alive {alive} -> {int(model.num_alive)}")
    if sorted(evals) != [200, 400, 600, 800]:
        raise AssertionError(f"evals at {sorted(evals)}")
    if not evals[800]["eval_psnr"] > evals[200]["eval_psnr"]:
        raise AssertionError("eval PSNR at 800 not above that at 200")
    for it, m in dens:
        print(f"densify pass at {it}: cloned {m['cloned']:.0f}, split "
              f"{m['split']:.0f}, pruned {m['pruned']:.0f}, dropped "
              f"{m['dropped']:.0f}{' (prune_big on: world and screen size)' if it > 400 else ''}")
    print(f"num_alive at the logged steps {alive}, after the run "
          f"{int(model.num_alive)}; one opacity reset (at 400); eval PSNR "
          + ", ".join(f"{it}: {m['eval_psnr']:.4f} dB" for it, m in
                      sorted(evals.items())))

    # Launches: K1-K4 on every step, K4 and K1 also on every eval render.
    steps, renders = tcfg.iterations, len(timer.ms["eval_view"])
    want = {"expand": steps + renders, "forward": steps + renders,
            "backward": steps, "segreduce": steps}
    print(f"launches during the loop: {launches} for {steps} steps and "
          f"{renders} eval renders")
    for name, count in want.items():
        if launches[name] < count:
            raise AssertionError(f"kernel {name} launched {launches[name]} "
                                 f"times, {count} expected")

    # The resumed run: steps 401-800 from the step-400 checkpoint alone.
    rtrain = [(it, m) for it, m in rrows if m.get("kind") != "eval"]
    rdens = [it for it, m in rtrain if "cloned" in m]
    n_r = len(rtimer.ms["step"])
    if n_r != 400 or rtrain[0][0] != 500 or rdens != [500, 600]:
        raise AssertionError(f"resume: {n_r} steps, logged from "
                             f"{rtrain[0][0]}, densify at {rdens}")
    ra, sa = int(rmodel.num_alive), int(model.num_alive)
    if not math.isfinite(rmet["loss"]) or abs(ra - sa) > 0.1 * sa:
        raise AssertionError(f"resume: loss {rmet['loss']}, alive {ra} vs {sa}")
    print(f"resume from step_00000400 alone: steps 401-800, densify at "
          f"{rdens}, final loss {rmet['loss']:.6f} (straight "
          f"{met['loss']:.6f}), num_alive {ra} (straight {sa}), eval PSNR at "
          f"800 {[m['eval_psnr'] for it, m in rrows if m.get('kind') == 'eval'][-1]:.4f} dB")

    # Device time by kernel of one step, one densify pass and one eval
    # view on the trained model (~30k gaussians).
    from gaussiansplat_tpu_torch.train import (
        init_train_state, make_densify_fn, make_eval_fn, make_train_step)

    state = init_train_state(model, tcfg, float(scene_extent(model)))
    step = make_train_step(cfg, tcfg)
    tcam, tgt = scene.train_views[0]
    profile(lambda: step(state, tcam, tgt, 3), "loop training step", card,
            top=8)
    dfn = make_densify_fn(tcfg)
    profile(lambda: dfn(state, state.extent, True, 120.0), "densify pass",
            card, top=6)
    efn = make_eval_fn(cfg, tcfg)
    profile(lambda: efn(model, cam, gt_img, 3), "eval view", card, top=6)

    step_ms = timer.ms["step"]
    print(f"loop: fit {fit_s:.3f} s for {steps} steps; step ms median "
          f"{float(np.median(step_ms)):.3f} (quartiles "
          f"{float(np.percentile(step_ms, 25)):.3f}-"
          f"{float(np.percentile(step_ms, 75)):.3f}, host clock to "
          f"synchronize, densify passes excluded); densify pass ms "
          + ", ".join(f"{t:.3f}" for t in timer.ms["densify"])
          + f"; eval ms per view median "
          f"{float(np.median(timer.ms['eval_view'])):.3f}; peak device "
          f"memory {peak} B ({peak / 2**30:.3f} GiB) | {card}")
    return launches


def cli_train(kernels, card: str) -> dict:
    """The loop through its CLI: `train --scene synthetic --sh-degree 1`
    (the default scene: 1024 GT gaussians, 256x256, 24 + 4 views, oracle
    GT) for 200 steps on the CLI's default device, `--resume` to 300, then
    `eval` of the exported PLY. Checks the run's files, overflow 0 and that K1-K4
    launched on every step. Returns the launch counts."""
    import contextlib
    import io

    from gaussiansplat_tpu_torch import cli

    for k in kernels:
        k.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run")
        # SH degree 1: the synthetic scene's gaussians carry degree 1
        # (as the reference's CLI tests run it).
        args = ["train", "--scene", "synthetic", "--sh-degree", "1",
                "--out", out, "--eval-every", "100"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = cli.main(args + ["--iterations", "200"])
            rc2 = cli.main(args + ["--iterations", "300", "--resume"])
        train_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        rows = [json.loads(line)
                for line in open(os.path.join(out, "metrics.jsonl"))]
        files = sorted(os.listdir(out))
        ckpts = sorted(os.listdir(os.path.join(out, "ckpts")))
        previews = sorted(os.listdir(os.path.join(out, "previews")))
        with contextlib.redirect_stdout(io.StringIO()) as ev:
            rc3 = cli.main(["eval", "--scene", "synthetic", "--sh-degree",
                            "1", "--ply", os.path.join(out, "point_cloud.ply")])
    if (rc, rc2, rc3) != (0, 0, 0):
        raise AssertionError(f"CLI exit codes {rc}, {rc2}, {rc3}")
    result = json.loads(ev.getvalue().strip().splitlines()[-1])
    train_rows = [r for r in rows if r.get("kind") != "eval"]
    evals = [(r["step"], r["eval_psnr"]) for r in rows if r.get("kind") == "eval"]
    if files != ["ckpts", "metrics.jsonl", "point_cloud.ply", "previews"] \
            or ckpts != ["step_00000200", "step_00000300"] \
            or [st for st, _ in evals] != [100, 200, 300] or len(previews) != 3:
        raise AssertionError(f"CLI run: {files} {ckpts} {previews} {evals}")
    if any(r["overflow"] != 0 for r in train_rows) or not all(
            math.isfinite(r["loss"]) for r in train_rows):
        raise AssertionError(f"CLI run rows: {train_rows}")
    if min(launches.values()) < 300:
        raise AssertionError(f"CLI run launches {launches} for 300 steps")
    print(f"CLI train --scene synthetic on the card: 200 steps, then --resume "
          f"to 300, in {train_s:.3f} s (scene build included); logged steps "
          f"{[r['step'] for r in train_rows]}; eval PSNR "
          + ", ".join(f"{st}: {p:.3f} dB" for st, p in evals)
          + f"; checkpoints {ckpts}; CLI eval of the PLY {result['psnr']:.3f} "
          f"dB / SSIM {result['ssim']:.4f} on {result['n_views']} views; "
          f"launches {launches} | {card}")
    return launches


def _load_frame(path: str) -> np.ndarray:
    if os.path.exists(path):
        from PIL import Image

        return np.asarray(Image.open(path))
    return np.load(path + ".npy")


def small_reference_check():
    """A small scene: kernels against the plain versions, end to end."""
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.render import render
    from gaussiansplat_tpu_torch.models import random_model

    g = torch.Generator().manual_seed(1)
    model = random_model(g, 4096, sh_degree=3, opacity=0.9, device="cuda")
    cam = look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=440.0, fy=440.0,
                  width=256, height=192, device="cuda")
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    with torch.inference_mode():
        a = render(model, cam, background=bg, impl="cuda")
        b = render(model, cam, background=bg, impl="torch")
    if int(a.num_pairs) != int(b.num_pairs) or int(a.overflow) != 0:
        raise AssertionError("small scene: pair counts differ")
    err = assert_budget(a.image, b.image, "small scene image")
    assert_budget(a.transmittance, b.transmittance, "small scene transmittance")
    print(f"small scene 256x192 n=4096: kernels vs plain versions max|diff| "
          f"{err:.3e}")

    # Gradients: MSE to a target plus 0.1 mean transmittance.
    target = torch.rand((192, 256, 3), generator=g).to("cuda")
    grads = {}
    for impl in ("cuda", "torch"):
        model.zero_grad(set_to_none=True)
        bg_g = bg.clone().requires_grad_(True)
        out = render(model, cam, background=bg_g, impl=impl)
        loss = ((out.image - target) ** 2).mean() + 0.1 * out.transmittance.mean()
        loss.backward()
        grads[impl] = {k: p.grad.clone() for k, p in model.trainable().items()}
        grads[impl]["background"] = bg_g.grad.clone()
    worst = 0.0
    for k, want in grads["torch"].items():
        got = grads["cuda"][k]
        rel = float(((got - want).abs() / want.abs().max().clamp(min=1e-30)).max())
        worst = max(worst, rel)
        if rel > 2e-3 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"small scene gradient {k}: {rel:.3e} of its "
                                 "largest entry")
    print(f"small scene gradients (six groups and background): kernels vs "
          f"plain versions within {worst:.3e} of each one's largest entry")


# Giant frames: (width, height, tile size). Both tile grids are 240 x 135
# tiles, whose rect needs 32 bits: K4's int64 instantiation.
GIANT_FRAMES = ((7680, 4320, 32), (3840, 2160, 16))


def sized_cfg(proj, width: int, height: int, tile_size: int = 32):
    """A RasterConfig at `tile_size` whose pair capacity holds every pair of
    this frame: the default pairs_per_gaussian, raised (in steps of 4, with
    10% to spare) when the default would overflow. Returns it and the frame's
    pair count."""
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.ops.binning import compact_rects

    cfg = RasterConfig(tile_size=tile_size)
    c = compact_rects(proj, width, height, cfg)
    total = int(c.num_pairs) + int(c.overflow)
    n = proj.mean2d.shape[0]
    ppg = cfg.pairs_per_gaussian
    while cfg.pair_capacity(n) < 1.1 * total:
        ppg += 4.0
        cfg = RasterConfig(tile_size=tile_size, pairs_per_gaussian=ppg)
    return cfg, total


def giant_grids(model, kernels, card: str) -> dict:
    """Phase 9: the 1M bench scene at 7680x4320 (32 px tiles) and 3840x2160
    (16 px tiles), fx scaled with the width. K4 (int64 rects) integer-equal
    to its plain version over the whole capacity and timed; the 4K frame
    through render() against the plain path on the card; the 8K frame
    through render() (overflow 0, finite, request ms, then a profile of one
    request). The launch counts are zeroed just before the timed render()
    calls and read just after."""
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.render import render

    recs, launches = {}, {}
    for width, height, ts in GIANT_FRAMES:
        label = f"{width}x{height}/{ts}px"
        cam = look_at(eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, 0.0),
                      fx=FX * width / WIDTH, fy=FX * width / WIDTH,
                      width=width, height=height, device=model.device)
        with torch.no_grad():
            cfg, total = sized_cfg(project(model, cam, RasterConfig()),
                                   width, height, ts)
            print(f"{label}: {total} pairs; pairs_per_gaussian "
                  f"{cfg.pairs_per_gaussian} (capacity "
                  f"{cfg.pair_capacity(model.capacity)})")
            rec, c = check_expand(model, cam, cfg, False, label, card,
                                  width=width, height=height)
            if c.rect_c.dtype != torch.int64:
                raise AssertionError(f"{label}: rects are {c.rect_c.dtype}")
        del c
        for k in kernels:
            k.launches = 0
        times = []
        with torch.inference_mode():
            for _ in range(4):                   # one warm-up, 3 requests
                t0 = time.perf_counter()
                out = render(model, cam, cfg)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            if out.image.shape != (height, width, 3) or int(out.overflow) != 0 \
                    or not bool(torch.isfinite(out.image).all()) \
                    or float(out.image.max()) <= 0.0:
                raise AssertionError(f"{label}: shape {tuple(out.image.shape)}, "
                                     f"overflow {int(out.overflow)}")
            launches[label] = {k.name: k.launches for k in kernels}
            if launches[label]["expand"] < 4 or launches[label]["forward"] < 4:
                raise AssertionError(f"{label}: launches {launches[label]}")
            err = None
            if ts == 32:
                profile(lambda: render(model, cam, cfg), f"{label} request",
                        card, top=10)
            if ts == 16:
                want = render(model, cam, cfg, impl="torch")
                err = assert_budget(out.image, want.image, f"{label} image")
                assert_budget(out.transmittance, want.transmittance,
                              f"{label} transmittance")
        print(f"render() {label} n={model.capacity}: {int(out.num_pairs)} "
              f"pairs, overflow 0, request ms {', '.join(f'{t:.3f}' for t in times[1:])} "
              f"(host clock to synchronize; warm-up {times[0]:.3f})"
              + ("" if err is None else f"; against the plain path max|diff| "
                                        f"{err:.3e}")
              + f"; launches {launches[label]} | {card}")
        rec.update(request_ms=times[1:], launches=launches[label],
                   num_pairs=int(out.num_pairs), image_err=err)
        recs[label] = rec
        del out
        torch.cuda.empty_cache()
    return recs


def splats2d_phase(kernels, card: str) -> dict:
    """Phase 10: 1M 2D splats (2-10 px, opacity 0.7) at 1920x1080. Render
    and backward through K1-K4 against the plain versions on the card
    (image within the budget, every gradient within 2e-3 of its largest
    entry), request ms, then 20 Adam steps toward a target rendered from a
    perturbed copy (finite falling loss, K1-K4 on every step)."""
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.models import (
        project_splats2d, random_splats2d, render_splats2d)

    device = torch.device("cuda")
    model = random_splats2d(torch.Generator().manual_seed(0), N_GAUSSIANS,
                            WIDTH, HEIGHT, scale_range=(2.0, 10.0),
                            opacity=0.7, device=device)
    with torch.no_grad():
        cfg, total = sized_cfg(project_splats2d(model, RasterConfig(), WIDTH,
                                                HEIGHT), WIDTH, HEIGHT)
        ref = copy.deepcopy(model)
        gen = torch.Generator(device=device).manual_seed(21)
        ref.colors.add_(0.2 * torch.randn(ref.colors.shape, generator=gen,
                                          device=device)).clamp_(0.0, 1.0)
        ref.means2d.add_(torch.randn(ref.means2d.shape, generator=gen,
                                     device=device))
        target = render_splats2d(ref, WIDTH, HEIGHT, cfg).image
    del ref
    print(f"2D splats {WIDTH}x{HEIGHT} n={N_GAUSSIANS}: {total} pairs, "
          f"pairs_per_gaussian {cfg.pairs_per_gaussian}")

    grads, images = {}, {}
    for impl in ("cuda", "torch"):
        model.zero_grad(set_to_none=True)
        out = render_splats2d(model, WIDTH, HEIGHT, cfg, impl=impl)
        ((out.image - target) ** 2).mean().backward()
        if int(out.overflow) != 0:
            raise AssertionError(f"2D splats overflow {int(out.overflow)}")
        images[impl] = out.image.detach()
        grads[impl] = {k: p.grad.clone() for k, p in model.trainable().items()}
    err = assert_budget(images["cuda"], images["torch"], "2D splat image")
    worst = 0.0
    for k, want in grads["torch"].items():
        got = grads["cuda"][k]
        rel = float(((got - want).abs() / want.abs().max().clamp(min=1e-30)).max())
        worst = max(worst, rel)
        if rel > 2e-3 or not bool(torch.isfinite(got).all()) or not bool(want.any()):
            raise AssertionError(f"2D splat gradient {k}: {rel:.3e}")
    del grads, images
    print(f"2D splats against the plain versions: image max|diff| {err:.3e}, "
          f"gradients (5 groups) within {worst:.3e} of each one's largest entry")

    req = []
    with torch.inference_mode():
        for _ in range(4):
            t0 = time.perf_counter()
            render_splats2d(model, WIDTH, HEIGHT, cfg)
            torch.cuda.synchronize()
            req.append((time.perf_counter() - t0) * 1e3)

    opt = torch.optim.Adam([dict(params=[model.means2d], lr=0.05),
                            dict(params=[model.log_scales, model.thetas,
                                         model.logit_opacities], lr=0.01),
                            dict(params=[model.colors], lr=0.01)])
    for k in kernels:
        k.launches = 0
    losses, step_ms = [], []
    for i in range(20):
        before = [k.launches for k in kernels]
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        out = render_splats2d(model, WIDTH, HEIGHT, cfg)
        loss = ((out.image - target) ** 2).mean()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step = [k.launches - b for k, b in zip(kernels, before)]
        losses.append(float(loss.detach()))
        if min(per_step) < 1 or int(out.overflow) != 0 \
                or not math.isfinite(losses[-1]):
            raise AssertionError(f"2D step {i + 1}: launches {per_step}, "
                                 f"overflow {int(out.overflow)}, loss {losses[-1]}")
    launches = {k.name: k.launches for k in kernels}
    if not losses[-1] < 0.9 * losses[0]:
        raise AssertionError(f"2D fit: loss {losses[0]} -> {losses[-1]}")
    print(f"2D splats: request ms {', '.join(f'{t:.3f}' for t in req[1:])} "
          f"(warm-up {req[0]:.3f}); 20 Adam steps, step ms median "
          f"{float(np.median(step_ms[1:])):.3f} (first {step_ms[0]:.3f}), loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; launches {launches} | {card}")
    del model, opt, target, out
    torch.cuda.empty_cache()
    return dict(request_ms=req[1:], step_ms=step_ms, losses=losses,
                launches=launches, image_err=err, grad_rel=worst)


SHARDED_TIMEOUT_S = 600
# The raster configuration of the sharded steps (see `sharded_phase`).
STEP_CFG = dict(trans_eps=0.0)


def sharded_inputs(device):
    """The sharded phase's scene, its two views and their targets (rendered
    from a copy with perturbed colours), the same in every process."""
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.render import render

    model = bench_scene(N_GAUSSIANS, device)
    cams = [look_at(eye=eye, target=(0.0, 0.0, 0.0), fx=FX, fy=FX,
                    width=WIDTH, height=HEIGHT, device=device)
            for eye in ((0.0, 0.0, -4.0), (0.6, 0.3, -3.9))]
    ref = copy.deepcopy(model)
    gen = torch.Generator(device=device).manual_seed(11)
    with torch.no_grad():
        ref.sh_dc.add_(0.3 * torch.randn(ref.sh_dc.shape, generator=gen,
                                         device=device))
        gts = torch.stack([render(ref, c, RasterConfig()).image for c in cams])
    return model, cams, gts


def sharded_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank of the sharded phase (2 ranks on one card, gloo): the
    tile-sharded render (tile=2), then one step at (data=1, tile=2) and at
    (data=2, tile=1), each followed by 2 timed steps. Writes its results to
    out/rank<r>.pt."""
    import datetime
    import hashlib

    import torch.distributed as dist

    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.config import TrainConfig
    from gaussiansplat_tpu_torch.models import scene_extent
    from gaussiansplat_tpu_torch.ops.kernels.backward import BACKWARD
    from gaussiansplat_tpu_torch.ops.kernels.expand import EXPAND
    from gaussiansplat_tpu_torch.ops.kernels.forward import FORWARD
    from gaussiansplat_tpu_torch.ops.kernels.segreduce import SEGREDUCE
    from gaussiansplat_tpu_torch.parallel import (
        make_mesh, make_sharded_train_step, make_tile_sharded_render,
        pad_targets, stack_cameras)
    from gaussiansplat_tpu_torch.train import init_train_state

    kernels = (EXPAND, FORWARD, BACKWARD, SEGREDUCE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
    res = {}
    try:
        cfg = RasterConfig()
        model, cams, gts = sharded_inputs(device)
        bg = torch.tensor([0.1, 0.2, 0.3], device=device)
        f = make_tile_sharded_render(make_mesh(1, 2), cfg, WIDTH, HEIGHT, 3)
        for k in kernels:
            k.launches = 0
        times = []
        with torch.inference_mode():
            for _ in range(3):
                t0 = time.perf_counter()
                img, trans = f(model, cams[0], bg)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        res["render"] = dict(image=img.cpu(), trans=trans.cpu(), ms=times,
                             launches={k.name: k.launches for k in kernels})
        tcfg = TrainConfig()
        extent = float(scene_extent(model))
        cfg = RasterConfig(**STEP_CFG)
        for data, tile in ((1, 2), (2, 1)):
            mesh = make_mesh(data, tile)
            m = copy.deepcopy(model)
            state = init_train_state(m, tcfg, extent)
            step = make_sharded_train_step(mesh, cfg, tcfg, WIDTH, HEIGHT, 3,
                                           return_grads=True)
            stacked = stack_cameras(cams[:data])
            targets = pad_targets(gts[:data], HEIGHT, cfg.tile_size, tile)
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            state, met = step(state, stacked, targets)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            launches = {k.name: k.launches for k in kernels}
            flat = torch.cat([p.detach().reshape(-1)
                              for p in m.trainable().values()]).cpu()
            rec = dict(loss=float(met["loss"]), overflow=int(met["overflow"]),
                       digest=hashlib.sha256(flat.numpy().tobytes()).hexdigest(),
                       launches=launches, first_ms=first_ms)
            if mesh.rank == 0:
                rec["grads"] = {k: g.cpu() for k, g in met["grads"].items()}
            del met
            ms = []
            for _ in range(2):
                t0 = time.perf_counter()
                state, met = step(state, stacked, targets)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            rec["ms"] = ms
            res[f"step_d{data}t{tile}"] = rec
            del state, m, step, met
            torch.cuda.empty_cache()
        res["rank"] = rank
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def sharded_phase(card: str) -> dict:
    """Phase 11: the sharded paths in 2 gloo ranks on the one card (NCCL
    refuses two ranks on one device; the collective helpers stage the
    card's tensors through host memory on gloo). Each rank is this script
    with `--sharded-rank`; a rank's failure or a timeout fails the phase.
    Then, here: the tile-sharded render against render() (image budget),
    each step's loss within 1e-5 relative of the single-device
    mean-of-views loss, its gradients within 2e-3 of each group's largest
    entry, the replicas bit-equal, K1-K4 launched in every rank.

    The steps run with the tile early exit off (`STEP_CFG`): a tile's
    chunks are aligned to the pair list, which differs between a strip and
    the whole frame, so with the exit on a tile may stop a chunk sooner or
    later (the render's ~6.5e-5) and the DSSIM's curvature (1 / C2) turns
    that into gradient differences of ~2e-3 of the largest entry. Without
    it both sides composite the same pairs in the same order and the
    comparison holds the sharding itself."""
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.config import TrainConfig
    from gaussiansplat_tpu_torch.render import render
    from gaussiansplat_tpu_torch.train.loss import photometric_loss

    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{os.path.join(tmp, 'store')}"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-rank",
             str(r), "--world", str(world), "--store", store, "--out", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=SHARDED_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"sharded rank {r} exited {p.returncode}:"
                                     f"\n{log[-6000:]}")
        wall_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]

    device = torch.device("cuda")
    cfg, tcfg = RasterConfig(), TrainConfig()
    model, cams, gts = sharded_inputs(device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=device)
    with torch.inference_mode():
        full = render(model, cams[0], cfg, background=bg)
    rec = {"wall_s": wall_s}
    for r, res in enumerate(ranks):
        err = assert_budget(res["render"]["image"].to(device), full.image,
                            f"rank {r} tile-sharded image")
        assert_budget(res["render"]["trans"].to(device), full.transmittance,
                      f"rank {r} tile-sharded transmittance")
        if min(res["render"]["launches"][k] for k in ("expand", "forward")) < 3:
            raise AssertionError(f"rank {r} render launches "
                                 f"{res['render']['launches']}")
        print(f"sharded render (data=1, tile=2) rank {r}: max|diff| {err:.3e} "
              f"against render(); ms {', '.join(f'{t:.3f}' for t in res['render']['ms'])}; "
              f"launches {res['render']['launches']} | {card}")
    rec["render_ms"] = [res["render"]["ms"] for res in ranks]
    del full
    cfg = RasterConfig(**STEP_CFG)
    for data, tile in ((1, 2), (2, 1)):
        key = f"step_d{data}t{tile}"
        model.zero_grad(set_to_none=True)
        loss = sum(photometric_loss(render(model, c, cfg).image, g,
                                    tcfg.ssim_lambda)
                   for c, g in zip(cams[:data], gts[:data])) / data
        loss.backward()
        loss = float(loss.detach())
        want = {k: p.grad for k, p in model.trainable().items()}
        worst = 0.0
        for name, g in ranks[0][key]["grads"].items():
            w = want[name]
            rel = float(((g.to(device) - w).abs()
                         / w.abs().max().clamp(min=1e-30)).max())
            worst = max(worst, rel)
            if rel > 2e-3 or not bool(w.any()):
                raise AssertionError(f"{key} gradient {name}: {rel:.3e}")
        lrel = max(abs(res[key]["loss"] - loss) / abs(loss) for res in ranks)
        if lrel > 1e-5:
            raise AssertionError(f"{key} loss {[res[key]['loss'] for res in ranks]}"
                                 f" vs {loss}")
        if len({res[key]["digest"] for res in ranks}) != 1:
            raise AssertionError(f"{key}: replicas differ after the step")
        for r, res in enumerate(ranks):
            if min(res[key]["launches"].values()) < 1 or res[key]["overflow"]:
                raise AssertionError(f"{key} rank {r}: {res[key]['launches']}")
            print(f"sharded step (data={data}, tile={tile}) rank {r}: loss "
                  f"{res[key]['loss']:.7f} (single device {loss:.7f}), "
                  f"step ms {res[key]['first_ms']:.3f} (first), "
                  f"{', '.join(f'{t:.3f}' for t in res[key]['ms'])}; launches "
                  f"{res[key]['launches']} | {card}")
        print(f"sharded step (data={data}, tile={tile}): loss within "
              f"{lrel:.3e} relative, gradients within {worst:.3e} of each "
              f"group's largest entry, replicas bit-equal")
        rec[key] = dict(loss_rel=lrel, grad_rel=worst,
                        ms=[res[key]["ms"] for res in ranks],
                        launches=[res[key]["launches"] for res in ranks])
    print(f"sharded phase: 2 gloo ranks on one card in {wall_s:.3f} s "
          f"(scene builds included) | {card}")
    del model, gts
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    from gaussiansplat_tpu_torch.ops.kernels.backward import BACKWARD
    from gaussiansplat_tpu_torch.ops.kernels.build import build_all, ptxas_lines
    from gaussiansplat_tpu_torch.ops.kernels.expand import EXPAND
    from gaussiansplat_tpu_torch.ops.kernels.forward import FORWARD
    from gaussiansplat_tpu_torch.ops.kernels.segreduce import SEGREDUCE
    from gaussiansplat_tpu_torch.config import RasterConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. probe
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    kernels = build_all([EXPAND, FORWARD, BACKWARD, SEGREDUCE])
    print(f"built {len(kernels)} kernels in {time.perf_counter() - t0:.2f} s "
          "(nvcc -gencode arch=compute_90a,code=sm_90a, one process each)")
    for k in kernels:
        for line in ptxas_lines(k.build_log):
            print(f"  {k.name}: {line}")

    # 3. kernels against their plain versions
    from gaussiansplat_tpu_torch.ops.camera import look_at

    cfg = RasterConfig()
    bench_cam = look_at(eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, 0.0), fx=FX,
                        fy=FX, width=WIDTH, height=HEIGHT, device=device)
    big = bench_scene(3_000_000, device, seed=1)
    with torch.no_grad():
        check_expand(big, bench_cam, cfg, False, "3M", card)
    del big
    torch.cuda.empty_cache()
    k4_skewed, k3_skewed = check_skewed(cfg, bench_cam, device, card)
    model = bench_scene(N_GAUSSIANS, device)
    with torch.no_grad():
        k4, _ = check_expand(model, bench_cam, cfg, True, "bench", card)
        k1, work = check_forward(model, bench_cam, cfg, card)
        k2, binning, dsorted = check_backward(model, bench_cam, cfg, work, card)
        k3 = check_segreduce(presort_rows(binning, dsorted),
                             binning.seg_offsets,
                             binning.depth_order.shape[0], "bench", card)
    del binning, dsorted
    torch.cuda.empty_cache()

    # 4. serve: counts zeroed just before, read just after
    EXPAND.launches = 0
    FORWARD.launches = 0
    times, native = serve(model, cfg, card)
    launches = {"expand": EXPAND.launches, "forward": FORWARD.launches}
    print(f"launches during serving: {launches}")
    for name, count in launches.items():
        # One launch per frame: 1 warm-up + 8 requests + 2 CLI frames.
        if count < 10:
            raise AssertionError(f"kernel {name} launched {count} times while "
                                 "serving 11 frames")
    print(f"per-request ms: mean {float(np.mean(times)):.3f}, min "
          f"{min(times):.3f}, max {max(times):.3f} over {len(times)} requests "
          f"at {WIDTH}x{HEIGHT}, n={N_GAUSSIANS} | {card}")

    profile_request(model, cfg, card)
    torch.cuda.empty_cache()

    # 5. train: counts zeroed after the warm-up step, read after 5 steps
    _, train_launches = train(model, bench_cam, cfg,
                              [EXPAND, FORWARD, BACKWARD, SEGREDUCE], card)
    del model
    torch.cuda.empty_cache()

    # 6. small scene against the plain versions
    small_reference_check()
    torch.cuda.empty_cache()

    # 7. loop: counts zeroed just before Trainer.fit, read just after
    loop_launches = loop([EXPAND, FORWARD, BACKWARD, SEGREDUCE], card)
    torch.cuda.empty_cache()

    # 8. the loop through the CLI: counts zeroed just before, read after
    cli_train([EXPAND, FORWARD, BACKWARD, SEGREDUCE], card)

    # 9. giant frames (int64 rects): counts zeroed before each frame's
    # render() calls, read just after
    model = bench_scene(N_GAUSSIANS, device)
    giant = giant_grids(model, [EXPAND, FORWARD], card)
    del model
    torch.cuda.empty_cache()

    # 10. 2D splats: counts zeroed just before the 20 steps, read after
    splats = splats2d_phase([EXPAND, FORWARD, BACKWARD, SEGREDUCE], card)

    # 11. sharded, 2 gloo ranks on this card (each rank zeroes and reads
    # its own counts around its render and each step)
    sharded = sharded_phase(card)

    record = {"kernels": [
        {"name": "expand_pairs", "route": "cuda",
         "source": "gaussiansplat_tpu_torch/csrc/expand.cu",
         "replaces": "gaussiansplat_tpu/ops/pallas/expand.py:274",
         "launches": launches["expand"], "max_abs_err": k4["err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "skewed_ms": k4_skewed["ms"],
         "skewed_bound_ms": k4_skewed["bound_ms"],
         "skewed_num_pairs": k4_skewed["num_pairs"]},
        {"name": "rasterize_forward", "route": "cuda",
         "source": "gaussiansplat_tpu_torch/csrc/forward.cu",
         "replaces": "gaussiansplat_tpu/ops/pallas/forward.py:262",
         "launches": launches["forward"], "max_abs_err": k1["err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None},
        {"name": "rasterize_backward", "route": "cuda",
         "source": "gaussiansplat_tpu_torch/csrc/backward.cu",
         "replaces": "gaussiansplat_tpu/ops/pallas/backward.py:448",
         "launches": train_launches["backward"], "max_abs_err": k2["err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "segment_reduce_pairs", "route": "cuda",
         "source": "gaussiansplat_tpu_torch/csrc/segreduce.cu",
         "replaces": "gaussiansplat_tpu/ops/pallas/segreduce.py:232",
         "launches": train_launches["segreduce"], "max_abs_err": k3["err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": "bytes",
         "library_ms": k3["library_ms"], "skewed_ms": k3_skewed["ms"],
         "skewed_bound_ms": k3_skewed["bound_ms"],
         "skewed_library_ms": k3_skewed["library_ms"],
         "skewed_max_abs_err": k3_skewed["err"]},
    ]}
    for k, name in zip(record["kernels"], ("expand", "forward", "backward",
                                            "segreduce")):
        k["loop_launches"] = loop_launches[name]
        k["splats2d_launches"] = splats["launches"][name]
        k["sharded_step_launches"] = [
            r[name] for key in ("step_d1t2", "step_d2t1")
            for r in sharded[key]["launches"]]
    for label, g in giant.items():
        tag = "int64_" + label.replace("/", "_")
        record["kernels"][0].update({
            f"{tag}_ms": g["ms"], f"{tag}_plain_ms": g["plain_ms"],
            f"{tag}_bound_ms": g["bound_ms"], f"{tag}_max_abs_err": g["err"],
            f"{tag}_num_pairs": g["num_pairs"],
            f"{tag}_launches": g["launches"]["expand"]})
        record["kernels"][1][f"{tag}_launches"] = g["launches"]["forward"]
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--sharded-rank" in sys.argv:
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("--sharded-rank", type=int, required=True)
        ap.add_argument("--world", type=int, required=True)
        ap.add_argument("--store", required=True)
        ap.add_argument("--out", required=True)
        a = ap.parse_args()
        sys.exit(sharded_worker(a.sharded_rank, a.world, a.store, a.out))
    sys.exit(main())
