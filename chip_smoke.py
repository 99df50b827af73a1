#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gaussiansplat_tpu_torch) on one card.

    python3 chip_smoke.py

1. Probe: requires a CUDA card; prints `nvidia-smi` name and power limit.
2. Build: compiles the six kernels (K4 expand, the pair gather, K1
   forward, K2 backward, K3 segment reduce, R rects) from
   gaussiansplat_tpu_torch/csrc
   (one nvcc per source, in parallel) and prints the build time and the
   ptxas register / shared-memory lines.
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
3b. Determinism: on phase 3's 1080p/1M scene, `render()` and autograd of
   mean(image^2) run twice: the image, the loss and the gradient of every
   parameter bit-equal; then one `make_train_step` from two deep copies of
   a state one step into training: parameters, alive, Adam moments and
   step counts, densify statistics, the generator and the loss bit-equal.
   K1-K4 and the gather on every run.
3c. The pair gather on the 3M scene at 1920x1080 and 3840x2160 (fx
   scaled with the width): rows [0, num_pairs) bit-equal to its plain
   version (two index_selects), the rows past it unwritten (a NaN-filled
   output keeps its NaNs); timed by CUDA events beside its bytes bound
   (136 B a pair), the plain version, and the library's two index_selects
   over every slot and over the binned pairs only. Alone on the card:
   `python3 -c "import chip_smoke as cs; cs.gather_phase(cs.card_line())"`.
3d. R, the binning's rects, survivor masks, counts and depth keys, on the
   same two frames: bit-equal to its plain version; timed beside its bytes
   bound (53 B a gaussian) and the plain version, and the whole compaction
   and binning timed with R and with the plain front. Alone on the card:
   `python3 -c "import chip_smoke as cs; cs.rects_phase(cs.card_line())"`.
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
7b. Restart: the loop scene's untrained initial model, 24 steps of
   `Trainer.fit` (RESTART_SCHEDULE: checkpoints every 8 steps, densify
   passes every 4, the SH degree ramping), once straight and once through
   `utils.run_resilient` with the card's own out-of-memory inside step 12:
   the timer (`BallastAtStep`) takes a ballast that leaves OOM_MARGIN of
   the card free, so the step's allocations fail in the caching allocator.
   Exactly one restart, on a torch.OutOfMemoryError; the retry resumes at
   step 9 and densifies at 12, 16, 20 and 24; the final state_dict and the
   last loss bit-equal to the straight run's. Both wall times and both
   peaks of device memory (the retry's from the restart on, which must not
   exceed the straight run's by more than 5%) are printed.
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
12. Gaussian axis: 2 ranks (`--sharded-rank gauss`) and 4 ranks
   (`--sharded-rank gauss2d`) of this script on the card, started from the
   environment through `parallel.multihost.initialize` (gloo). The
   gauss-sharded render (strip all_to_all) against `render()`, no row
   dropped; one gauss-sharded step (loss 1e-5, each rank's gradient block
   2e-3, K1-K4 in each rank, the counted all-to-all bytes equal to
   `capacity.ici_bytes_per_step`, peak memory beside the plan's total);
   the depth ring (image and transmittance 2e-4, MSE gradients 2e-3, bytes
   equal to `capacity.ici_bytes_per_step_ring`); one (data, gauss) =
   (2, 2) step against the single-device mean over two views, the data
   replicas bit-equal. Render and step ms per rank.
13. HBM: the single-card ceiling of a 1080p gauss-sharded step by
   out-of-memory bisection over at most HBM_PROBES subprocess probes
   (`--hbm-probe N`), seeded by the closed form at the nominal 80 GiB;
   the measured budget and slack must agree with `parallel/capacity.py`.
14. Timing variants (ops/kernels/ablate.py): phase 3's 1080p/1M inputs
   again (payload, tile starts, K1's block, the seeded cotangent, K2's
   rows, K3's pre-sort rows). The variants of K1 (dmaonly, noacc,
   nowrite), K2 (dmaonly, nograd, nogeom, nodirect, nowrite) and K3
   (dmaonly, stacked) built at once; each build's ptxas lines, registers,
   shared memory and blocks per SM (a variant whose blocks per SM differ
   from production's is flagged: its time prices occupancy too), and its
   SASS by opcode (`cuobjdump -sass`), which must still hold the work the
   variant keeps (`kept_work`); a variant that spills is flagged too. The
   K1 and K2 variants that fit more blocks than production are built again
   pinned to production's count (`ablate.variant_kernel(blocks=)`; the
   occupancy API must report it), and production with them: the padding
   that pins them also shrinks the SM's L1, so they are compared with
   production pinned the same way (which must give production's bits). Each variant launched once against
   production's output on the same inputs (`ablate.contract`: kept rows
   within 1e-6 of each row's largest entry, bit for bit for K1 noacc's
   logT and stop rows and for K3 stacked; dropped rows at most 1e-20; K1
   dmaonly's stop row counting every chunk; the nowrite checksums within
   1e-5 of the tile's sum of magnitudes), on its own launch counter. Then
   production, the variants and the pinned builds timed in turns by CUDA
   events, and `ablate.decompose`'s components printed, for the free
   builds and among the pinned ones; the JSON record's K1, K2 and K3
   entries carry `variants_ms`, `derived_ms`, `variant_flags` and, where
   builds were pinned, `pinned_ms` and `pinned_derived_ms`.
The serve phase also checks native IO: the CLI read the exported 1M PLY
with the native parser; both parsers' times are printed.
The launch counts are zeroed just before each determinism run, the
serve, the train, the loop, the restart, the CLI-train, each giant frame's requests and the 2D steps (and in each
rank around its render, steps and ring) and read just after; every kernel
of the phase must have launched (K1-K4 and the gather on every training
step, K4, the gather and K1 on every render).

Every phase raises on failure. The last two lines are one JSON object with
per-kernel numbers and `{"ok": true, "device": {...}}`. Exits non-zero when
no CUDA card is present.
"""

from __future__ import annotations

import copy
import dataclasses
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


def bench_scene(n: int, device, seed: int = 0, draw_on_device: bool = False):
    """The benchmark scene of the reference's bench.py at (WIDTH, HEIGHT, n):
    opacity 0.8, SH degree 3, world scale so every n tiles the screen at the
    same per-splat pixel area. Drawn on the host (the same numbers on every
    device), or on `device` when `draw_on_device` (faster at tens of
    millions; other numbers of the same kind)."""
    from gaussiansplat_tpu_torch.models import random_model

    k = (1600.0 / FX) * ((WIDTH * HEIGHT / n) / 2.0736) ** 0.5
    g = torch.Generator(device=device if draw_on_device else "cpu")
    g.manual_seed(seed)
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


# The pair gather's frames (phase 3c): the 3M scene at the benchmark's
# 1080p and 4K shapes (fx scaled with the width).
GATHER_FRAMES = ((WIDTH, HEIGHT, FX), (2 * WIDTH, 2 * HEIGHT, 2 * FX))
# Bytes the gather must move a pair: the rank and the depth-order entry
# read (4 B each), the payload row read and the row written (64 B each).
GATHER_PAIR_BYTES = 136


def check_gather(model, cam, cfg, card: str) -> dict:
    """The pair gather against its plain version on one frame's binning:
    rows [0, num_pairs) bit-equal, the rows past it left as they were (a
    NaN-filled output keeps its NaNs). Timed beside its bytes bound, its
    plain version (two index_selects over every slot) and the library's
    two index_selects over the binned pairs only."""
    from gaussiansplat_tpu_torch.ops.binning import bin_gaussians
    from gaussiansplat_tpu_torch.ops.kernels.gather import (
        gather_pairs_cuda,
        gather_pairs_torch,
    )
    from gaussiansplat_tpu_torch.ops.projection import make_payload

    proj = project(model, cam, cfg)
    b = bin_gaussians(proj, cam.width, cam.height, cfg, impl="cuda")
    payload = make_payload(proj)
    del proj
    if int(b.overflow) != 0:
        raise AssertionError(f"gather {cam.width}x{cam.height}: overflow "
                             f"{int(b.overflow)}")
    args = (payload, b.depth_order, b.sorted_ranks, b.num_pairs)
    p, k = b.sorted_ranks.shape[0], int(b.num_pairs)
    out = torch.full((p, 16), float("nan"), device=payload.device)
    got = gather_pairs_cuda(*args, out=out)
    want = gather_pairs_torch(*args)
    torch.cuda.synchronize()
    if not torch.equal(got[:k].view(torch.int32), want[:k].view(torch.int32)):
        raise AssertionError("the gather differs from its plain version")
    if not bool(got[k:].isnan().all()):
        raise AssertionError("the gather wrote rows past num_pairs")
    del out, got, want
    ranks = b.sorted_ranks[:k]
    ms = cuda_ms(lambda: gather_pairs_cuda(*args), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: gather_pairs_torch(*args), reps=5)
    library_ms = cuda_ms(lambda: payload.index_select(0, b.depth_order)
                         .index_select(0, b.sorted_ranks), reps=5)
    pairs_ms = cuda_ms(lambda: payload.index_select(0, b.depth_order)
                       .index_select(0, ranks), reps=5)
    bound_ms = k * GATHER_PAIR_BYTES / PEAK_BYTES_PER_S * 1e3
    print(f"gather {cam.width}x{cam.height} n={payload.shape[0]} ({k} pairs "
          f"of {p} slots, {100 * k / p:.2f}% filled): rows [0, num_pairs) "
          f"bit-equal, the rest unwritten; {ms:.4f} ms (CUDA events), bound "
          f"{bound_ms:.4f} ms (bytes, {GATHER_PAIR_BYTES} B a pair), plain "
          f"{plain_ms:.4f} ms; library index_select x 2 over every slot "
          f"{library_ms:.4f} ms, over the pairs only {pairs_ms:.4f} ms | {card}")
    return dict(ms=ms, bound_ms=bound_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_pairs_ms=pairs_ms,
                num_pairs=k, slots=p)


def gather_phase(card: str) -> dict:
    """Phase 3c: `check_gather` on the 3M scene at each of GATHER_FRAMES;
    the records by frame ('1920x1080', '3840x2160')."""
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.ops.camera import look_at

    device = torch.device("cuda")
    cfg = RasterConfig()
    model = bench_scene(3_000_000, device, seed=1)
    records = {}
    with torch.no_grad():
        for width, height, fx in GATHER_FRAMES:
            cam = look_at(eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, 0.0), fx=fx,
                          fy=fx, width=width, height=height, device=device)
            records[f"{width}x{height}"] = check_gather(model, cam, cfg, card)
            torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return records


# Bytes R must move a gaussian: mean2d 8, conic 12, opacity 4, depth 4,
# radius_xy 8 and valid 1 read; rect, mask, count and depth key 4 each
# written.
RECTS_GAUSSIAN_BYTES = 53


def check_rects(model, cam, cfg, card: str) -> dict:
    """R against its plain version on one frame (rect, mask, count and depth
    key bit-equal), timed beside its bytes bound and the plain version; the
    whole compaction (compact_rects) and binning (bin_gaussians) timed with
    R and with the plain front."""
    from gaussiansplat_tpu_torch.ops.binning import (
        bin_gaussians,
        compact_rects,
        expand_compacted,
        sort_pairs,
        tile_grid,
        tile_rects_torch,
    )
    from gaussiansplat_tpu_torch.ops.kernels.rects import tile_rects_cuda

    proj = project(model, cam, cfg)
    n = proj.mean2d.shape[0]
    tiles_x, tiles_y = tile_grid(cam.width, cam.height, cfg.tile_size)
    by, bw = tiles_y.bit_length(), tiles_x.bit_length()
    args = (proj.mean2d, proj.conic, proj.opacity, proj.depth,
            proj.radius_xy, proj.valid, cfg, tiles_x, tiles_y, 0, tiles_y,
            (by, bw, by), torch.int32)
    got = tile_rects_cuda(*args)
    want = tile_rects_torch(*args)
    torch.cuda.synchronize()
    for what, a, b in zip(("rect", "mask", "count", "key"), got, want):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"R's {what} differs from its plain version")
    pairs = int(want[2].to(torch.int64).sum())
    del got, want
    ms = cuda_ms(lambda: tile_rects_cuda(*args), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: tile_rects_torch(*args), reps=5)
    compact_ms = cuda_ms(lambda: compact_rects(proj, cam.width, cam.height,
                                               cfg, impl="cuda"), reps=5)
    compact_plain_ms = cuda_ms(lambda: compact_rects(
        proj, cam.width, cam.height, cfg, impl="torch"), reps=5)
    bin_ms = cuda_ms(lambda: bin_gaussians(proj, cam.width, cam.height, cfg,
                                           impl="cuda"), reps=5)
    def bin_plain_front():
        c = compact_rects(proj, cam.width, cam.height, cfg, impl="torch")
        return sort_pairs(c, expand_compacted(c, "cuda"))

    bin_plain_front_ms = cuda_ms(bin_plain_front, reps=5)
    bound_ms = n * RECTS_GAUSSIAN_BYTES / PEAK_BYTES_PER_S * 1e3
    print(f"R rects {cam.width}x{cam.height} n={n} ({pairs} pairs): rect, "
          f"mask, count and key bit-equal; {ms:.4f} ms (CUDA events), bound "
          f"{bound_ms:.4f} ms (bytes, {RECTS_GAUSSIAN_BYTES} B a gaussian), "
          f"plain {plain_ms:.3f} ms; compact_rects {compact_ms:.3f} ms (plain "
          f"front {compact_plain_ms:.3f}); bin_gaussians {bin_ms:.3f} ms "
          f"(plain front {bin_plain_front_ms:.3f}) | {card}")
    return dict(ms=ms, bound_ms=bound_ms, plain_ms=plain_ms,
                compact_ms=compact_ms, compact_plain_ms=compact_plain_ms,
                bin_ms=bin_ms, bin_plain_front_ms=bin_plain_front_ms,
                pairs=pairs)


def rects_phase(card: str) -> dict:
    """Phase 3d: `check_rects` on the 3M scene at each of GATHER_FRAMES;
    the records by frame ('1920x1080', '3840x2160')."""
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.ops.camera import look_at

    device = torch.device("cuda")
    cfg = RasterConfig()
    model = bench_scene(3_000_000, device, seed=1)
    records = {}
    with torch.no_grad():
        for width, height, fx in GATHER_FRAMES:
            cam = look_at(eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, 0.0), fx=fx,
                          fy=fx, width=width, height=height, device=device)
            records[f"{width}x{height}"] = check_rects(model, cam, cfg, card)
            torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return records


def determinism_phase(model, cam, cfg, kernels, card: str) -> dict:
    """Phase 3b: the 1080p/1M render with its gradients, and one training
    step, each run twice and held bit for bit (see the module docstring).
    Returns the launch counts of each run."""
    from gaussiansplat_tpu_torch.config import TrainConfig
    from gaussiansplat_tpu_torch.models import scene_extent
    from gaussiansplat_tpu_torch.render import render
    from gaussiansplat_tpu_torch.train import init_train_state, make_train_step

    params = model.trainable()

    def render_grads():
        out = render(model, cam, cfg, sh_degree=3)
        loss = torch.mean(out.image ** 2)
        grads = torch.autograd.grad(loss, list(params.values()))
        return out.image.detach(), loss.detach(), dict(zip(params, grads))

    def counted(fn):
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k.name: k.launches for k in kernels}
        if min(launches.values()) < 1:
            raise AssertionError(f"determinism: a kernel did not launch: "
                                 f"{launches}")
        return out, ms, launches

    (img1, l1, g1), ms1, n1 = counted(render_grads)
    (img2, l2, g2), ms2, n2 = counted(render_grads)
    differ = [k for k in g1 if not torch.equal(g1[k], g2[k])]
    if not torch.equal(img1, img2) or not torch.equal(l1, l2) or differ:
        raise AssertionError(
            f"determinism: render and gradients differ between two runs: "
            f"image {not torch.equal(img1, img2)}, loss {float(l1)} vs "
            f"{float(l2)}, gradients {differ}")
    if not all(bool(g.any()) for g in g1.values()):
        raise AssertionError("determinism: a gradient is all zero")
    print(f"determinism: render + autograd of mean(image^2) twice at "
          f"{WIDTH}x{HEIGHT}, n={model.capacity}, SH 3: image, loss "
          f"{float(l1)!r} and the gradients of {list(g1)} bit-equal "
          f"({ms1:.3f} / {ms2:.3f} ms, launches {n1}, {n2}) | {card}")

    # One step from two deep copies of a state one step into training.
    tcfg = TrainConfig()
    gt = torch.flip(img1, [1])
    step = make_train_step(cfg, tcfg)
    base = init_train_state(copy.deepcopy(model), tcfg,
                            float(scene_extent(model)))
    base, _ = step(base, cam, gt, 3)
    runs = []
    for _ in range(2):
        state = copy.deepcopy(base)
        (state, met), ms, n = counted(lambda: step(state, cam, gt, 3))
        runs.append((state, met, ms, n))
    del base
    (a, ma, msa, na), (b, mb, msb, nb) = runs
    differ = [f"model.{k}" for k, v in a.model.state_dict().items()
              if not torch.equal(v, b.model.state_dict()[k])]
    for ga, gb in zip(a.optimizer.param_groups, b.optimizer.param_groups):
        sa = a.optimizer.state[ga["params"][0]]
        sb = b.optimizer.state[gb["params"][0]]
        differ += [f"adam.{ga['name']}.{k}" for k in ("step", "exp_avg",
                                                      "exp_avg_sq")
                   if not torch.equal(sa[k], sb[k])]
    differ += [f"densify.{f}" for f in ("grad2d_sum", "grad2d_count",
                                        "max_radii")
               if not torch.equal(getattr(a.densify, f), getattr(b.densify, f))]
    if a.step != b.step or a.step != 2:
        differ.append(f"step {a.step} vs {b.step}")
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        differ.append("generator")
    if not torch.equal(ma["loss"], mb["loss"]):
        differ.append("loss")
    if differ:
        raise AssertionError(f"determinism: one training step from two "
                             f"copies of a state differs in {differ}")
    print(f"determinism: one make_train_step from two deep copies of a state "
          f"(one step in): parameters, alive, Adam moments and step counts, "
          f"densify statistics, generator and loss {float(ma['loss'])!r} "
          f"bit-equal ({msa:.3f} / {msb:.3f} ms, launches {na}, {nb}) | {card}")
    del runs, a, b
    return {"render": [n1, n2], "step": [na, nb]}


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


def loop(kernels, card: str):
    """The training loop on the quality configuration's scene (see the
    module docstring, phase 7). Returns the phase's launch counts, and the
    scene's untrained initial model and its train views for phase 7b."""
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
    fresh = copy.deepcopy(scene.init_model)
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

    # Launches: K1-K4 and the gather on every step, K4, the gather and K1
    # also on every eval render.
    steps, renders = tcfg.iterations, len(timer.ms["eval_view"])
    want = {"expand": steps + renders, "gather": steps + renders,
            "forward": steps + renders, "backward": steps, "segreduce": steps}
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
    return launches, (fresh, scene.train_views)


# Phase 7b's schedule: checkpoints at 8, 16 and 24, densify passes every 4
# steps from 4, the SH degree ramping every 6 steps; every step logged. The
# out-of-memory comes at step OOM_STEP (after the step-8 checkpoint, in the
# first epoch of the 16 views), with OOM_MARGIN bytes of the card left free.
RESTART_SCHEDULE = dict(iterations=24, checkpoint_every=8, densify_start=4,
                        densify_every=4, densify_end=24,
                        densify_target_fraction=0.08, sh_degree=3,
                        sh_increase_every=6, log_every=1)
OOM_STEP, OOM_MARGIN = 12, 64 << 20


class BallastAtStep:
    """A `Trainer.fit` timer whose train step, at its `at`-th call, first
    takes a ballast tensor that leaves between `margin` and `margin` + 2 MiB
    of the card free (the caching allocator's cache emptied first): the
    step's own allocations then fail in the allocator with
    torch.OutOfMemoryError. Every wrapped call is timed by `timer`
    (utils/logging.StageTimer); `ballast` is freed by its holder."""

    def __init__(self, timer, at: int, margin: int):
        self.timer, self.at, self.margin = timer, at, margin
        self.calls, self.ballast, self.taken = 0, None, 0

    def wrap(self, name: str, fn):
        timed = self.timer.wrap(name, fn)
        if name != "step":
            return timed

        def step(*args, **kwargs):
            self.calls += 1
            if self.calls == self.at:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                free, _ = torch.cuda.mem_get_info()
                size = (free - self.margin) // (2 << 20) * (2 << 20)
                self.ballast = torch.empty(size, dtype=torch.uint8,
                                           device="cuda")
                self.taken = size
            return timed(*args, **kwargs)

        return step


def restart_phase(init_model, views, kernels, card: str) -> dict:
    """Phase 7b: fail-fast restart on the card (see the module docstring).
    Returns the restart run's launch counts."""
    from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
    from gaussiansplat_tpu_torch.train import Trainer
    from gaussiansplat_tpu_torch.utils import StageTimer, run_resilient

    trainer = Trainer(raster_cfg=RasterConfig(),
                      cfg=TrainConfig(**RESTART_SCHEDULE))
    iters = RESTART_SCHEDULE["iterations"]
    every = RESTART_SCHEDULE["checkpoint_every"]
    ckpt = (OOM_STEP - 1) // every * every       # the retry's checkpoint

    def measured(run):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base

    with tempfile.TemporaryDirectory() as tmp:
        straight = copy.deepcopy(init_model)
        rows = []
        (_, met), straight_s, straight_peak = measured(lambda: trainer.fit(
            straight, views, log=lambda it, m: rows.append((it, m)),
            ckpt_dir=os.path.join(tmp, "straight")))
        if straight_peak < 4 * OOM_MARGIN:
            raise AssertionError(f"restart: a step needs {straight_peak} B, "
                                 f"not above 4x the margin {OOM_MARGIN} B")

        model = copy.deepcopy(init_model)
        timer = BallastAtStep(StageTimer(), OOM_STEP, OOM_MARGIN)
        restarts, rrows = [], []

        def on_restart(attempt, exc):
            restarts.append((attempt, type(exc), str(exc).splitlines()[0],
                             timer.ballast is not None))
            timer.ballast = None
            # The retry's peak: from here, after the ballast is gone.
            torch.cuda.reset_peak_memory_stats()

        for k in kernels:
            k.launches = 0
        (out, rmet), restart_s, retry_peak = measured(lambda: run_resilient(
            trainer.fit, model, views, log=lambda it, m: rrows.append((it, m)),
            ckpt_dir=os.path.join(tmp, "restart"), timer=timer, backoff_s=0.0,
            on_restart=on_restart))
        launches = {k.name: k.launches for k in kernels}

    print(f"restart: {len(restarts)} restart(s) "
          + "; ".join(f"attempt {a}: {t.__module__}.{t.__name__} ({msg}), "
                      f"ballast held {held}" for a, t, msg, held in restarts)
          + f"; ballast {timer.taken} B ({timer.taken / 2**30:.3f} GiB)")
    if len(restarts) != 1 or not issubclass(restarts[0][1], torch.OutOfMemoryError) \
            or not restarts[0][3]:
        raise AssertionError(f"restart: want one torch.OutOfMemoryError "
                             f"raised while the ballast was held: {restarts}")
    its = [it for it, _ in rrows]
    first, retry = rrows[:OOM_STEP - 1], rrows[OOM_STEP - 1:]
    want_its = list(range(1, OOM_STEP)) + list(range(ckpt + 1, iters + 1))
    if its != want_its:
        raise AssertionError(f"restart: logged steps {its}, want {want_its}")
    dens = ([it for it, m in first if "cloned" in m],
            [it for it, m in retry if "cloned" in m])
    straight_dens = [it for it, m in rows if "cloned" in m]
    if dens != ([4, 8], [12, 16, 20, 24]) or straight_dens != [4, 8, 12, 16, 20, 24]:
        raise AssertionError(f"restart: densify passes {dens}, straight "
                             f"{straight_dens}")
    if out is not model:
        raise AssertionError("restart: fit returned another model")
    want = straight.state_dict()
    differ = [k for k, v in model.state_dict().items()
              if not torch.equal(v, want[k])]
    if differ or rmet["loss"] != met["loss"]:
        raise AssertionError(f"restart: {differ} differ from the straight "
                             f"run; loss {rmet['loss']} vs {met['loss']}")
    steps = OOM_STEP - 1 + iters - ckpt
    if min(launches.values()) < steps:
        raise AssertionError(f"restart: launches {launches} for {steps} steps")
    cam = views[0][0]
    print(f"restart at {cam.width}x{cam.height}, capacity {model.capacity}, "
          f"{iters} steps: "
          f"out-of-memory inside step {OOM_STEP}, retry from the step-{ckpt} "
          f"checkpoint (steps {ckpt + 1}-{iters}), densify passes {dens[1]} "
          f"after it; "
          f"final state_dict ({len(want)} tensors, {int(model.num_alive)} "
          f"alive) bit-equal to the straight run's, last loss "
          f"{rmet['loss']!r} equal; wall {straight_s:.3f} s straight, "
          f"{restart_s:.3f} s with the restart; peak device memory above "
          f"the run's start {straight_peak} B straight, {retry_peak} B in "
          f"the retry; launches {launches} for {steps} steps | {card}")
    if retry_peak > 1.05 * straight_peak:
        raise AssertionError(f"restart: the retry's peak {retry_peak} B is "
                             f"above the straight run's {straight_peak} B")
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
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.render import render
    from gaussiansplat_tpu_torch.models import random_model

    g = torch.Generator().manual_seed(1)
    model = random_model(g, 4096, sh_degree=3, opacity=0.9, device="cuda")
    cam = look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=440.0, fy=440.0,
                  width=256, height=192, device="cuda")
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    with torch.inference_mode():
        a = render(model, cam, RasterConfig(impl="cuda"), background=bg)
        b = render(model, cam, RasterConfig(impl="torch"), background=bg)
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
        out = render(model, cam, RasterConfig(impl=impl), background=bg_g)
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
                want = render(model, cam,
                              dataclasses.replace(cfg, impl="torch"))
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
        out = render_splats2d(model, WIDTH, HEIGHT,
                              dataclasses.replace(cfg, impl=impl))
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


def free_port() -> int:
    """A free TCP port on the loopback interface (the ranks' rendezvous)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_init() -> torch.device:
    """A rank of this script: the process group from the environment that
    `run_ranks` sets, as torchrun sets it (`multihost.initialize`, gloo:
    NCCL refuses two ranks on one card)."""
    from gaussiansplat_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(backend="gloo", timeout_s=SHARDED_TIMEOUT_S)
    return torch.device("cuda", torch.cuda.current_device())


def run_ranks(job: str, world: int):
    """Start `world` ranks of this script (`--sharded-rank JOB`) on the one
    card, wait for all of them and return their results (out/rank<r>.pt)
    and the wall seconds. A rank's failure or a timeout fails the phase."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
                   LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(world))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-rank", job,
             "--out", tmp], env=dict(env, RANK=str(r)),
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
                raise AssertionError(f"{job} rank {r} exited {p.returncode}:"
                                     f"\n{log[-6000:]}")
        wall_s = time.perf_counter() - t0
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(world)], wall_s


def tile_worker(out: str) -> int:
    """One rank of the sharded phase (2 ranks on one card): the
    tile-sharded render (tile=2), then one step at (data=1, tile=2) and at
    (data=2, tile=1), each followed by 2 timed steps. Writes its results to
    out/rank<r>.pt."""
    import hashlib

    import torch.distributed as dist

    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.config import TrainConfig
    from gaussiansplat_tpu_torch.models import scene_extent
    from gaussiansplat_tpu_torch.ops.kernels.backward import BACKWARD
    from gaussiansplat_tpu_torch.ops.kernels.expand import EXPAND
    from gaussiansplat_tpu_torch.ops.kernels.forward import FORWARD
    from gaussiansplat_tpu_torch.ops.kernels.rects import RECTS
    from gaussiansplat_tpu_torch.ops.kernels.segreduce import SEGREDUCE
    from gaussiansplat_tpu_torch.parallel import (
        make_mesh, make_sharded_train_step, make_tile_sharded_render,
        pad_targets, stack_cameras)
    from gaussiansplat_tpu_torch.train import init_train_state

    kernels = (EXPAND, FORWARD, BACKWARD, SEGREDUCE, RECTS)
    device = rank_init()
    rank = dist.get_rank()
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
    with `--sharded-rank tile`; a rank's failure or a timeout fails the
    phase. Then, here: the tile-sharded render against render() (image
    budget), each step's loss within 1e-5 relative of the single-device
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

    ranks, wall_s = run_ranks("tile", 2)
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


# The share of a rank's gaussians that one strip may receive: the bench
# scene falls about evenly on the 2 strips, and the gaussians that straddle
# the boundary go to both, so the plan's default of 0.5 would drop rows.
GAUSS_SEND_FRACTION = 0.6
GAUSS_BG = (0.1, 0.2, 0.3)


def _counts(kernels) -> dict:
    return {k.name: k.launches for k in kernels}


def _timed(fn, reps: int) -> list:
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def gauss_worker(out: str) -> int:
    """One rank of the gauss phase (2 ranks on one card): the gauss-sharded
    render (3 timed requests), one gauss-sharded training step under the
    collective counter with its peak memory, 2 more timed steps, then the
    depth-ring render and the backward of an MSE loss under the counter.
    The launch counts are zeroed just before each and read just after.
    Writes its results to out/rank<r>.pt."""
    import torch.distributed as dist

    from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
    from gaussiansplat_tpu_torch.models import scene_extent
    from gaussiansplat_tpu_torch.ops.kernels.backward import BACKWARD
    from gaussiansplat_tpu_torch.ops.kernels.expand import EXPAND
    from gaussiansplat_tpu_torch.ops.kernels.forward import FORWARD
    from gaussiansplat_tpu_torch.ops.kernels.rects import RECTS
    from gaussiansplat_tpu_torch.ops.kernels.segreduce import SEGREDUCE
    from gaussiansplat_tpu_torch.parallel import (
        init_gauss_sharded_state, make_depth_ring_render, make_gauss_mesh,
        make_gauss_sharded_render, make_gauss_sharded_train_step,
        plan_gauss_sharded, shard_model)
    from gaussiansplat_tpu_torch.utils.comm_bytes import count_collectives

    kernels = (EXPAND, FORWARD, BACKWARD, SEGREDUCE, RECTS)
    device = rank_init()
    rank = dist.get_rank()
    res = {"rank": rank}
    try:
        model, cams, gts = sharded_inputs(device)
        mesh = make_gauss_mesh()
        nd = mesh.tile
        bg = torch.tensor(GAUSS_BG, device=device)
        plan = plan_gauss_sharded(N_GAUSSIANS, nd, WIDTH, HEIGHT, 3,
                                  RasterConfig(),
                                  send_fraction=GAUSS_SEND_FRACTION)
        sm = shard_model(model, mesh)
        f = make_gauss_sharded_render(mesh, RasterConfig(), WIDTH, HEIGHT, 3,
                                      send_cap=plan.send_cap)
        box = {}
        with torch.inference_mode():
            for k in kernels:
                k.launches = 0
            ms = _timed(lambda: box.update(r=f(sm, cams[0], bg, with_aux=True)),
                        3)
            launches = _counts(kernels)
        img, trans, aux = box["r"]
        res["render"] = dict(
            image=img.cpu(), trans=trans.cpu(), ms=ms, launches=launches,
            **{k: int(aux[k]) for k in ("overflow", "pack_overflow",
                                        "bin_overflow")})
        del sm, img, trans, aux, box["r"]

        cfg, tcfg = RasterConfig(**STEP_CFG), TrainConfig()
        extent = float(scene_extent(model))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        state = init_gauss_sharded_state(model, mesh, tcfg, extent)
        step = make_gauss_sharded_train_step(mesh, cfg, tcfg, WIDTH, HEIGHT,
                                             3, send_cap=plan.send_cap,
                                             return_grads=True)
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        with count_collectives() as counter:
            first = _timed(lambda: box.update(s=step(state, cams[0], gts[0])), 1)
        _, met = box["s"]
        res["step"] = dict(
            loss=float(met["loss"]), overflow=int(met["overflow"]),
            grads={k: g.cpu() for k, g in met["grads"].items()},
            launches=_counts(kernels), comm=counter.bytes(), first_ms=first,
            peak=torch.cuda.max_memory_allocated() - base,
            plan_total=plan.total_bytes, send_cap=plan.send_cap)
        del met, box["s"]
        res["step"]["ms"] = _timed(lambda: step(state, cams[0], gts[0]), 2)
        del state, step
        torch.cuda.empty_cache()

        ring = make_depth_ring_render(mesh, cfg, WIDTH, HEIGHT, 3)
        sm = shard_model(model, mesh)
        for k in kernels:
            k.launches = 0

        def ring_step():
            img, trans = ring(sm, cams[0], bg)
            ((img - gts[0]) ** 2).mean().backward()
            box.update(img=img.detach(), trans=trans)

        with count_collectives() as counter:
            first = _timed(ring_step, 1)
        launches = _counts(kernels)
        with torch.inference_mode():
            ms = _timed(lambda: ring(sm, cams[0], bg), 2)
        res["ring"] = dict(
            image=box["img"].cpu(), trans=box["trans"].detach().cpu(),
            grads={k: p.grad.cpu() for k, p in sm.trainable().items()},
            launches=launches, comm=counter.bytes(), first_ms=first, ms=ms)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def gauss2d_worker(out: str) -> int:
    """One rank of the (data, gauss) = (2, 2) phase (4 ranks on one card):
    one step of `make_gauss2d_train_step` over the two views (launch counts
    zeroed just before and read just after), then one timed step. Writes
    its results to out/rank<r>.pt."""
    import hashlib

    import torch.distributed as dist

    from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
    from gaussiansplat_tpu_torch.models import scene_extent
    from gaussiansplat_tpu_torch.ops.kernels.backward import BACKWARD
    from gaussiansplat_tpu_torch.ops.kernels.expand import EXPAND
    from gaussiansplat_tpu_torch.ops.kernels.forward import FORWARD
    from gaussiansplat_tpu_torch.ops.kernels.rects import RECTS
    from gaussiansplat_tpu_torch.ops.kernels.segreduce import SEGREDUCE
    from gaussiansplat_tpu_torch.parallel import (
        init_gauss_sharded_state, make_gauss2d_train_step, make_mesh2d,
        plan_gauss_sharded, stack_cameras)

    kernels = (EXPAND, FORWARD, BACKWARD, SEGREDUCE, RECTS)
    device = rank_init()
    rank = dist.get_rank()
    try:
        model, cams, gts = sharded_inputs(device)
        mesh = make_mesh2d(2, 2)
        cfg, tcfg = RasterConfig(**STEP_CFG), TrainConfig()
        plan = plan_gauss_sharded(N_GAUSSIANS, 2, WIDTH, HEIGHT, 3, cfg,
                                  send_fraction=GAUSS_SEND_FRACTION)
        state = init_gauss_sharded_state(model, mesh, tcfg,
                                         float(scene_extent(model)))
        step = make_gauss2d_train_step(mesh, cfg, tcfg, WIDTH, HEIGHT, 3,
                                       send_cap=plan.send_cap,
                                       return_grads=True)
        stacked = stack_cameras(cams)
        box = {}
        for k in kernels:
            k.launches = 0
        first = _timed(lambda: box.update(s=step(state, stacked, gts)), 1)
        launches = _counts(kernels)
        _, met = box.pop("s")
        flat = torch.cat([p.detach().reshape(-1)
                          for p in state.model.trainable().values()]).cpu()
        res = dict(rank=rank, loss=float(met["loss"]),
                   overflow=int(met["overflow"]),
                   digest=hashlib.sha256(flat.numpy().tobytes()).hexdigest(),
                   grads={k: g.cpu() for k, g in met["grads"].items()},
                   launches=launches, first_ms=first)
        del met
        res["ms"] = _timed(lambda: step(state, stacked, gts), 1)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _grad_rel(got: dict, want: dict, r: int, nd: int, what: str) -> float:
    """Gauss block r of nd against its slice of the single-device
    gradient, relative to each group's largest entry of that slice."""
    worst = 0.0
    for name, g in got.items():
        w = want[name]
        n = w.shape[0] // nd
        w = w[r * n:(r + 1) * n]
        rel = float(((g.to(w.device) - w).abs()
                     / w.abs().max().clamp(min=1e-30)).max())
        worst = max(worst, rel)
        if rel > 2e-3 or not bool(w.any()):
            raise AssertionError(f"{what} block {r} gradient {name}: {rel:.3e}")
    return worst


def _single_grads(model, loss) -> tuple:
    model.zero_grad(set_to_none=True)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone()
                                  for k, p in model.trainable().items()}


def gauss_phase(card: str) -> dict:
    """Phase 12: the gaussian-axis paths, in gloo ranks of this script on
    the one card (`--sharded-rank gauss`, 2 ranks; `--sharded-rank
    gauss2d`, 4 ranks), each started from the environment through
    `multihost.initialize`. Then, here, against the single-device paths on
    the same 1080p/1M scene:
      * the gauss-sharded render: the image budget against render(), no
        row dropped by the exchange or by the strip binning;
      * one gauss-sharded step: loss within 1e-5 relative, each rank's
        gradient block within 2e-3 of each group's largest entry of its
        slice, K1-K4 in every rank, the counter's all-to-all bytes equal to
        `capacity.ici_bytes_per_step`, the step's peak memory beside the
        plan's total;
      * the depth ring: image and transmittance within 2e-4 of render(),
        the MSE gradients within 2e-3, K1-K4 in every rank, the counter's
        bytes equal to `capacity.ici_bytes_per_step_ring`;
      * one (data, gauss) = (2, 2) step: the loss and gradients against the
        single-device mean over the two views, the data replicas
        bit-equal, K1-K4 in every rank.
    The steps and the ring run with the tile early exit off (`STEP_CFG`),
    as in the sharded phase."""
    from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
    from gaussiansplat_tpu_torch.parallel.capacity import (
        ici_bytes_per_step, ici_bytes_per_step_ring, plan_gauss_sharded)
    from gaussiansplat_tpu_torch.render import render
    from gaussiansplat_tpu_torch.train.loss import photometric_loss

    ranks, wall_s = run_ranks("gauss", 2)
    ranks2d, wall2d_s = run_ranks("gauss2d", 4)
    device = torch.device("cuda")
    cfg, tcfg = RasterConfig(**STEP_CFG), TrainConfig()
    model, cams, gts = sharded_inputs(device)
    bg = torch.tensor(GAUSS_BG, device=device)
    plan = plan_gauss_sharded(N_GAUSSIANS, 2, WIDTH, HEIGHT, 3, RasterConfig(),
                              send_fraction=GAUSS_SEND_FRACTION)
    rec = {"wall_s": wall_s, "wall2d_s": wall2d_s,
           "render_ms": [res["render"]["ms"] for res in ranks]}
    with torch.inference_mode():
        full = render(model, cams[0], RasterConfig(), background=bg)
    for r, res in enumerate(ranks):
        rr = res["render"]
        drops = {k: rr[k] for k in ("overflow", "pack_overflow", "bin_overflow")}
        if any(drops.values()) or min(rr["launches"][k]
                                      for k in ("expand", "forward")) < 3:
            raise AssertionError(f"rank {r} gauss render {drops} "
                                 f"{rr['launches']}")
        err = assert_budget(rr["image"].to(device), full.image,
                            f"rank {r} gauss-sharded image")
        assert_budget(rr["trans"].to(device), full.transmittance,
                      f"rank {r} gauss-sharded transmittance")
        print(f"gauss-sharded render (D=2) rank {r}: max|diff| {err:.3e} "
              f"against render(); {drops}; ms "
              f"{', '.join(f'{t:.3f}' for t in rr['ms'])}; launches "
              f"{rr['launches']} | {card}")
    del full

    loss, want = _single_grads(model, photometric_loss(
        render(model, cams[0], cfg).image, gts[0], tcfg.ssim_lambda))
    worst = 0.0
    for r, res in enumerate(ranks):
        st = res["step"]
        worst = max(worst, _grad_rel(st["grads"], want, r, 2, "gauss step"))
        if (abs(st["loss"] - loss) > 1e-5 * abs(loss) or st["overflow"]
                or min(st["launches"].values()) < 1):
            raise AssertionError(f"gauss step rank {r}: loss {st['loss']} vs "
                                 f"{loss}, overflow {st['overflow']}, "
                                 f"{st['launches']}")
        if st["comm"].get("all-to-all") != ici_bytes_per_step(plan):
            raise AssertionError(f"gauss step rank {r}: {st['comm']}, closed "
                                 f"form all-to-all {ici_bytes_per_step(plan)}")
        print(f"gauss-sharded step (D=2, send_cap {st['send_cap']}) rank {r}: "
              f"loss {st['loss']:.7f} (single device {loss:.7f}); collective "
              f"bytes {st['comm']} (closed form all-to-all "
              f"{ici_bytes_per_step(plan)}); peak {st['peak']} B, the plan's "
              f"total {st['plan_total']} B (x{st['peak'] / st['plan_total']:.3f});"
              f" step ms {st['first_ms'][0]:.3f} (first), "
              f"{', '.join(f'{t:.3f}' for t in st['ms'])}; launches "
              f"{st['launches']} | {card}")
    print(f"gauss-sharded step: gradients within {worst:.3e} of each group's "
          f"largest entry")
    rec["step"] = dict(grad_rel=worst, ms=[res["step"]["ms"] for res in ranks],
                       peak=[res["step"]["peak"] for res in ranks],
                       plan_total=plan.total_bytes,
                       comm=ranks[0]["step"]["comm"])

    single = render(model, cams[0], cfg, background=bg)
    _, want = _single_grads(model, ((single.image - gts[0]) ** 2).mean())
    closed = ici_bytes_per_step_ring(N_GAUSSIANS, 2, WIDTH, HEIGHT)
    worst = 0.0
    for r, res in enumerate(ranks):
        rg = res["ring"]
        err = float((rg["image"].to(device) - single.image.detach()).abs().max())
        terr = float((rg["trans"].to(device)
                      - single.transmittance.detach()).abs().max())
        worst = max(worst, _grad_rel(rg["grads"], want, r, 2, "depth ring"))
        if max(err, terr) > 2e-4 or min(rg["launches"].values()) < 1:
            raise AssertionError(f"depth ring rank {r}: image {err:.3e}, "
                                 f"trans {terr:.3e}, {rg['launches']}")
        if rg["comm"]["total"] != closed:
            raise AssertionError(f"depth ring rank {r}: {rg['comm']}, closed "
                                 f"form {closed}")
        print(f"depth ring (D=2) rank {r}: image {err:.3e}, transmittance "
              f"{terr:.3e} against render(); collective bytes {rg['comm']} "
              f"(closed form {closed}); render + backward ms "
              f"{rg['first_ms'][0]:.3f}, render ms "
              f"{', '.join(f'{t:.3f}' for t in rg['ms'])}; launches "
              f"{rg['launches']} | {card}")
    print(f"depth ring: gradients within {worst:.3e} of each group's largest "
          f"entry")
    rec["ring"] = dict(grad_rel=worst, ms=[res["ring"]["ms"] for res in ranks],
                       comm=ranks[0]["ring"]["comm"])
    del single

    loss, want = _single_grads(model, sum(
        photometric_loss(render(model, c, cfg).image, g, tcfg.ssim_lambda)
        for c, g in zip(cams, gts)) / 2)
    worst = 0.0
    for r, res in enumerate(ranks2d):
        worst = max(worst, _grad_rel(res["grads"], want, r % 2, 2,
                                     "(2, 2) step"))
        if (abs(res["loss"] - loss) > 1e-5 * abs(loss) or res["overflow"]
                or min(res["launches"].values()) < 1):
            raise AssertionError(f"(2, 2) step rank {r}: loss {res['loss']} vs "
                                 f"{loss}, overflow {res['overflow']}, "
                                 f"{res['launches']}")
        print(f"(data, gauss) = (2, 2) step rank {r}: loss {res['loss']:.7f} "
              f"(single device {loss:.7f}); step ms {res['first_ms'][0]:.3f} "
              f"(first), {res['ms'][0]:.3f}; launches {res['launches']} | {card}")
    for g in range(2):       # ranks g and 2 + g hold gauss block g
        if ranks2d[g]["digest"] != ranks2d[2 + g]["digest"]:
            raise AssertionError(f"(2, 2) step: the replicas of gauss block {g}"
                                 " differ")
    print(f"(data, gauss) = (2, 2) step: gradients within {worst:.3e} of each "
          f"group's largest entry, data replicas bit-equal")
    rec["d2g2"] = dict(grad_rel=worst, ms=[res["ms"] for res in ranks2d])
    rec["launches"] = {
        "gauss_render": [res["render"]["launches"] for res in ranks],
        "gauss_step": [res["step"]["launches"] for res in ranks],
        "ring": [res["ring"]["launches"] for res in ranks],
        "gauss2d_step": [res["launches"] for res in ranks2d]}
    print(f"gauss phase: 2 + 4 gloo ranks on one card in {wall_s:.3f} + "
          f"{wall2d_s:.3f} s (scene builds included) | {card}")
    del model, gts, want
    torch.cuda.empty_cache()
    return rec


# The HBM phase's budget: out-of-memory probes, each in its own process.
HBM_PROBES, HBM_PROBE_TIMEOUT_S, HBM_OOM_RC = 6, 150, 3


def hbm_probe(n: int) -> int:
    """One probe of the HBM phase (`--hbm-probe N`): a 1920x1080
    gauss-sharded training step at N gaussians of the bench scene on one
    rank (no process group), its exchange sized for every gaussian
    (send_fraction 1, as `capacity.max_gaussians_per_chip` plans it).
    Prints one JSON line with the peak device memory of the step and the
    plan's total; exits HBM_OOM_RC when the card runs out of memory."""
    from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.parallel import (
        init_gauss_sharded_state, make_gauss_mesh, make_gauss_sharded_train_step,
        plan_gauss_sharded)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    try:
        cfg, tcfg = RasterConfig(), TrainConfig()
        plan = plan_gauss_sharded(n, 1, WIDTH, HEIGHT, 3, cfg, send_fraction=1.0)
        mesh = make_gauss_mesh(1)
        model = bench_scene(n, device, draw_on_device=True)
        state = init_gauss_sharded_state(model, mesh, tcfg, 1.0)
        del model
        cam = look_at(eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, 0.0), fx=FX,
                      fy=FX, width=WIDTH, height=HEIGHT, device=device)
        gt = torch.rand((HEIGHT, WIDTH, 3), device=device,
                        generator=torch.Generator(device=device).manual_seed(3))
        step = make_gauss_sharded_train_step(mesh, cfg, tcfg, WIDTH, HEIGHT, 3,
                                             send_cap=plan.send_cap)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, met = step(state, cam, gt)
        torch.cuda.synchronize()
        loss = float(met["loss"])
        if not math.isfinite(loss) or int(met["overflow"]):
            raise AssertionError(f"probe at {n}: loss {loss}, overflow "
                                 f"{int(met['overflow'])}")
        print(json.dumps({"n": n, "peak": torch.cuda.max_memory_allocated(),
                          "plan_total": plan.total_bytes, "loss": loss}))
    except torch.cuda.OutOfMemoryError as e:
        print(f"out of memory at {n}: {str(e)[:300]}")
        return HBM_OOM_RC
    return 0


def hbm_phase(card: str) -> dict:
    """Phase 13: the single-card memory ceiling of a 1080p gauss-sharded
    training step, by out-of-memory bisection (`capacity.bisect_ceiling`)
    over subprocess probes (`hbm_probe`), seeded by the closed form's
    ceiling at the card's nominal 80 GiB. A probe that fails otherwise or
    times out is inconclusive and moves neither end. Prints the nominal and
    the measured ceiling, the peak memory of the largest step that fit (the
    budget) and its ratio to the plan's total (the slack), beside the
    budget and slack written in `capacity.py`; fails unless they agree
    within 10% (capacity.py is then out of date)."""
    from gaussiansplat_tpu_torch.parallel import capacity

    seed = capacity.max_gaussians_per_chip(
        WIDTH, HEIGHT, 3, hbm_bytes=capacity.HBM_NOMINAL_BYTES)
    fits = {}

    def probe(n: int):
        t0 = time.perf_counter()
        try:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--hbm-probe",
                 str(n)], capture_output=True, text=True,
                timeout=HBM_PROBE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            print(f"HBM probe {n}: inconclusive (timed out after "
                  f"{HBM_PROBE_TIMEOUT_S} s)")
            return None
        dt = time.perf_counter() - t0
        if r.returncode == 0:
            fits[n] = json.loads(r.stdout.strip().splitlines()[-1])
            print(f"HBM probe {n}: fit, peak {fits[n]['peak']} B ({dt:.1f} s)")
            return True
        if r.returncode == HBM_OOM_RC:
            print(f"HBM probe {n}: out of memory ({dt:.1f} s)")
            return False
        print(f"HBM probe {n}: inconclusive (exit {r.returncode}, {dt:.1f} s): "
              f"{(r.stdout + r.stderr)[-600:]}")
        return None

    out = capacity.bisect_ceiling(probe, seed, HBM_PROBES, resolution=0.05)
    if out["fit"] is None:
        raise AssertionError(f"HBM phase: no probe fit {out['probes']}")
    top = fits[out["fit"]]
    budget, slack = top["peak"], top["peak"] / top["plan_total"]
    print(f"HBM ceiling, 1920x1080 gauss-sharded step on one rank: nominal "
          f"{capacity.HBM_NOMINAL_BYTES} B -> closed-form ceiling {seed} "
          f"gaussians; measured: {out['fit']} fit, "
          f"{out['oom'] if out['oom'] is not None else 'none'} ran out; budget "
          f"(peak at {out['fit']}) {budget} B, slack x{slack:.4f} the plan; "
          f"capacity.py: {capacity.HBM_EFFECTIVE_BYTES} B, x{capacity.HBM_SLACK}"
          f" ({capacity.HBM_CARD}) | {card}")
    for what, got, have in (("budget", budget, capacity.HBM_EFFECTIVE_BYTES),
                            ("slack", slack, capacity.HBM_SLACK)):
        if abs(got - have) > 0.1 * got:
            raise AssertionError(f"capacity.py's HBM {what} {have} is not the "
                                 f"measured {got}")
    return dict(seed=seed, fit=out["fit"], oom=out["oom"], budget=budget,
                slack=slack, probes=out["probes"])


# Phase 14's SASS summary: the opcodes printed for each build.
SASS_KEYS = ("total", "MUFU", "MUFU.EX2", "MUFU.LG2", "MUFU.RCP", "SHFL",
             "LDG.128", "LDG", "STG", "LDS", "STS", "BAR")


def kept_work(kernel: str, variant: str, counts: dict) -> tuple:
    """Whether the SASS of a variant still holds the work it keeps, against
    production's (`counts[kernel][""]`): every variant but dmaonly keeps the
    gates, the compositing or rewind exponentials and the log1p (equal
    MUFU.EX2 and MUFU.LG2 counts); dmaonly keeps the 16-byte row loads (at
    least production's LDG.128: it loads all three 16-byte quarters of a
    row where production loads the third in narrower pieces); K2 nogeom
    keeps dalpha's divide (more MUFU.RCP than nograd, which drops it)."""
    c, full = counts[kernel][variant], counts[kernel][""]
    if variant == "stacked":
        return True, "the production library"
    if variant == "dmaonly":
        ok = c.get("LDG.128", 0) >= full.get("LDG.128", 0) > 0
        return ok, (f"16-byte loads {c.get('LDG.128', 0)} (production "
                    f"{full.get('LDG.128', 0)})")
    ex, lg = c.get("MUFU.EX2", 0), c.get("MUFU.LG2", 0)
    ok = ex == full.get("MUFU.EX2", 0) and lg == full.get("MUFU.LG2", 0) and ex > 0
    text = (f"MUFU.EX2 {ex}, MUFU.LG2 {lg} (production "
            f"{full.get('MUFU.EX2', 0)}, {full.get('MUFU.LG2', 0)})")
    if (kernel, variant) == ("backward", "nogeom"):
        rcp, rcp_ng = c.get("MUFU.RCP", 0), counts[kernel]["nograd"].get("MUFU.RCP", 0)
        ok = ok and rcp > rcp_ng
        text += f", MUFU.RCP {rcp} against nograd's {rcp_ng}"
    return ok, text


def launch_build(module, attr: str, build, call):
    """`call()` with `module.<attr>` (a wrapper's production kernel) swapped
    for `build`, so the wrapper launches that build (a pinned variant)."""
    own = getattr(module, attr)
    setattr(module, attr, build)
    try:
        return call()
    finally:
        setattr(module, attr, own)


def ablate_phase(card: str) -> dict:
    """Phase 14 (module docstring): the timing variants of K1, K2 and K3 on
    phase 3's 1080p/1M inputs. Returns each kernel's `variants_ms`,
    `derived_ms` and `variant_flags`, and for K1 and K2 the times of the
    builds pinned to production's blocks per SM, production among them
    (`pinned_ms`), and the components those price (`pinned_derived_ms`)."""
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.ops.binning import bin_gaussians
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.ops.kernels import ablate
    from gaussiansplat_tpu_torch.ops.kernels import backward as backward_mod
    from gaussiansplat_tpu_torch.ops.kernels import forward as forward_mod
    from gaussiansplat_tpu_torch.ops.kernels.backward import (
        BACKWARD,
        rasterize_backward_cuda,
    )
    from gaussiansplat_tpu_torch.ops.kernels.build import (
        blocks_per_sm,
        build_all,
        ptxas_lines,
        ptxas_usage,
        sass_counts,
    )
    from gaussiansplat_tpu_torch.ops.kernels.common import LANE_BYTES, raster_warps
    from gaussiansplat_tpu_torch.ops.kernels.forward import (
        FORWARD,
        rasterize_forward_cuda,
    )
    from gaussiansplat_tpu_torch.ops.kernels.segreduce import (
        SEGREDUCE,
        segment_reduce_pairs_cuda,
    )
    from gaussiansplat_tpu_torch.ops.projection import make_payload

    device = torch.device("cuda")
    cfg = RasterConfig()
    cam = look_at(eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, 0.0), fx=FX, fy=FX,
                  width=WIDTH, height=HEIGHT, device=device)
    model = bench_scene(N_GAUSSIANS, device)
    with torch.no_grad():
        proj = project(model, cam, cfg)
        b = bin_gaussians(proj, WIDTH, HEIGHT, cfg, impl="cuda")
        sp = b.gather_payload(make_payload(proj))
        ts = b.tile_starts
        fwd = rasterize_forward_cuda(sp, ts, WIDTH, HEIGHT, cfg)
        gen = torch.Generator(device=device).manual_seed(7)
        cot = torch.randn(fwd.shape, generator=gen, device=device)
        cot[:, 4:] = 0.0
        grad = rasterize_backward_cuda(sp, ts, cot, fwd, WIDTH, HEIGHT, cfg)
        valid = torch.arange(grad.shape[0], device=device) < int(b.num_pairs)
        rows = presort_rows(b, grad.masked_fill(~valid[:, None], 0.0))
        seg, nrank = b.seg_offsets, b.depth_order.shape[0]
        red = segment_reduce_pairs_cuda(rows, seg, nrank)
    del model, proj
    torch.cuda.synchronize()

    bases = {"forward": FORWARD, "backward": BACKWARD, "segreduce": SEGREDUCE}
    modules = {"forward": (forward_mod, "FORWARD"),
               "backward": (backward_mod, "BACKWARD")}
    builds = {k: {"": base, **ablate.variant_kernels(k, base)}
              for k, base in bases.items()}
    t0 = time.perf_counter()
    build_all([k for d in builds.values() for k in d.values()])
    print(f"built {sum(len(d) - 1 for d in builds.values())} variant kernels "
          f"in {time.perf_counter() - t0:.2f} s (one nvcc each, in parallel; "
          "stacked is the production library)")

    wx, wy = raster_warps(cfg.tile_size)
    launch = {"forward": (32 * wx * wy, cfg.chunk_size * LANE_BYTES),
              "backward": (32 * wx * wy, cfg.chunk_size * LANE_BYTES
                           + wx * wy * 128 * 11 * 4),
              "segreduce": (256, 0)}

    def describe(kernel, v, k, occ0):
        """Print a build's ptxas figures and SASS; its blocks per SM."""
        threads, dyn = launch[kernel]
        use = ptxas_usage(k.build_log)
        occ = blocks_per_sm(use["registers"], threads, use["smem"] + dyn)
        c = sass_counts(k.library_path())
        flag = "" if occ0 is None or occ == occ0 else (
            f"  OCCUPANCY DIFFERS from production's {occ0} blocks/SM: "
            "its time prices occupancy too")
        if v and use["spill_stores"] + use["spill_loads"]:
            flag += "  SPILLS: its time prices the spills too"
        print(f"  {kernel} {v or 'production'}: {use['registers']} "
              f"registers, {use['smem']} B static + {dyn} B dynamic shared, "
              f"spills {use['spill_stores']}/{use['spill_loads']} B -> {occ} "
              f"blocks/SM{flag}")
        for line in ptxas_lines(k.build_log):
            print(f"    {line}")
        print("    SASS " + ", ".join(f"{key} {c.get(key, 0)}"
                                      for key in SASS_KEYS))
        return occ, c, flag.strip()

    counts, failures, flags, occs, notes = {}, [], {}, {}, {}
    for kernel, d in builds.items():
        counts[kernel] = {}
        occ0 = None
        for v, k in d.items():
            occs[(kernel, v)], counts[kernel][v], flags[(kernel, v)] = describe(
                kernel, v, k, occ0)
            occ0 = occs[(kernel, "")]
        for v in ablate.VARIANTS[kernel]:
            ok, text = kept_work(kernel, v, counts)
            print(f"  {kernel} {v} keeps its work in SASS: {ok} ({text})")
            if not ok:
                failures.append(f"{kernel} {v}: SASS {text}")

    # Builds of the variants that fit more blocks than production, pinned
    # to production's count (the launcher pads their shared memory), and
    # production pinned the same way: the padding also takes L1 from the
    # SM, so the pinned variants are compared with it.
    pinned = {}
    for kernel in ablate.PINNABLE:
        more = [v for v in ablate.VARIANTS[kernel]
                if occs[(kernel, v)] > occs[(kernel, "")]]
        for v in ([""] + more if more else []):
            pinned[(kernel, v)] = ablate.variant_kernel(
                kernel, bases[kernel], v, blocks=occs[(kernel, "")])
    t0 = time.perf_counter()
    build_all(pinned.values())
    print(f"built {len(pinned)} builds pinned to production's blocks per SM "
          f"in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{kk} {v or 'production'}" for kk, v in pinned))

    calls = {
        "forward": lambda v: rasterize_forward_cuda(sp, ts, WIDTH, HEIGHT, cfg,
                                                    ablate=v),
        "backward": lambda v: rasterize_backward_cuda(sp, ts, cot, fwd, WIDTH,
                                                      HEIGHT, cfg, ablate=v),
        "segreduce": lambda v: segment_reduce_pairs_cuda(rows, seg, nrank,
                                                         ablate=v),
    }

    def run(kernel, v, pin):
        """One launch of variant v (pinned: its pinned build)."""
        if not pin:
            return calls[kernel](v)
        return launch_build(*modules[kernel], pinned[(kernel, v)],
                            lambda: calls[kernel](""))

    def label(v, pin):
        return (v or "full") + (" pinned" if pin else "")

    full = {"forward": fwd, "backward": grad, "segreduce": red}
    out = {}
    with torch.no_grad():
        for kernel in calls:
            names = list(ablate.VARIANTS[kernel])
            pins = [v for v in ["", *names] if (kernel, v) in pinned]
            for v, pin in [(v, False) for v in names] + [(v, True) for v in pins]:
                k = pinned[(kernel, v)] if pin else builds[kernel][v]
                before = {id(x): x.launches for x in
                          (*builds[kernel].values(), *pinned.values())}
                got = run(kernel, v, pin)
                torch.cuda.synchronize()
                moved = [x for x in (*builds[kernel].values(), *pinned.values())
                         if x.launches != before[id(x)]]
                if v:
                    r = ablate.contract(kernel, v, got, full[kernel], ts,
                                        cfg.chunk_size)
                else:   # pinned production: production's bits
                    n = int(ts[-1]) if kernel == "backward" else got.shape[0]
                    same = torch.equal(got[:n].view(torch.int32),
                                       full[kernel][:n].view(torch.int32))
                    r = dict(ok=same, text=f"production's bits: {same}")
                ok = r["ok"] and moved == [k]
                name = label(v, pin)
                if pin:
                    n_blocks = ablate.pinned_blocks_per_sm(k)
                    ok = ok and n_blocks == occs[(kernel, "")]
                    name += f" ({n_blocks} blocks/SM by the occupancy API)"
                elif "chunks_streamed" in r:
                    notes[kernel] = (f"; chunks: dmaonly streamed "
                                     f"{r['chunks_streamed']}, production "
                                     f"composited {r['chunks_composited']}")
                print(f"  {kernel} {name}: contract "
                      f"{'met' if ok else 'FAILED'}: {r['text']}; launched on "
                      f"its own counter: {moved == [k]}")
                if not ok:
                    failures.append(f"{kernel} {name}: {r['text']}")
                del got
            keys = [("", False), *((v, False) for v in names),
                    *((v, True) for v in pins)]
            order = [*keys, *reversed(keys)]
            reps, warmup = (20, 3) if kernel == "segreduce" else (10, 2)
            readings = {}
            for v, pin in order:
                readings.setdefault((v, pin), []).append(cuda_ms(
                    lambda v=v, pin=pin: run(kernel, v, pin), reps=reps,
                    warmup=warmup))
            mean = {key: float(np.mean(t)) for key, t in readings.items()}
            times = {f"{v or 'full'}_ms": mean[(v, False)] for v in ["", *names]}
            derived = ablate.decompose(times, kernel)
            out[kernel] = dict(variants_ms=times, derived_ms=derived,
                               variant_flags={v: flags[(kernel, v)] for v in names
                                              if flags[(kernel, v)]})
            print(f"{kernel} variants ({reps} launches each, CUDA events, two "
                  "readings in turns: production, the variants, the pinned "
                  "builds, then the same reversed): " + ", ".join(
                      f"{label(*key)} {mean[key]:.4f} ms ("
                      + ", ".join(f"{x:.4f}" for x in t) + ")"
                      for key, t in readings.items()) + f" | {card}")
            print(f"{kernel} components: " + ", ".join(
                f"{k} {x:.4f}" for k, x in derived.items())
                + notes.get(kernel, "") + f" | {card}")
            if pins:
                pinned_ms = {f"{v or 'full'}_ms": mean[(v, True)] for v in pins}
                pinned_derived = ablate.decompose(pinned_ms, kernel)
                out[kernel].update(pinned_ms=pinned_ms,
                                   pinned_derived_ms=pinned_derived)
                print(f"{kernel} components among the builds pinned to "
                      f"production's {occs[(kernel, '')]} blocks/SM ("
                      + ", ".join(label(v, True) for v in pins) + "): "
                      + ", ".join(f"{k} {x:.4f}" for k, x in
                                  pinned_derived.items()) + f" | {card}")
    if failures:
        raise AssertionError("timing variants: " + "; ".join(failures))
    return out

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    from gaussiansplat_tpu_torch.ops.kernels.backward import BACKWARD
    from gaussiansplat_tpu_torch.ops.kernels.build import build_all, ptxas_lines
    from gaussiansplat_tpu_torch.ops.kernels.expand import EXPAND
    from gaussiansplat_tpu_torch.ops.kernels.forward import FORWARD
    from gaussiansplat_tpu_torch.ops.kernels.gather import GATHER
    from gaussiansplat_tpu_torch.ops.kernels.rects import RECTS
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
    kernels = build_all([EXPAND, GATHER, FORWARD, BACKWARD, SEGREDUCE, RECTS])
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

    # 3b. determinism: counts zeroed just before each run, read just after
    determinism = determinism_phase(model, bench_cam, cfg, kernels, card)
    torch.cuda.empty_cache()

    # 3c. the pair gather at the 3M scene's 1080p and 4K shapes
    gather = gather_phase(card)

    # 3d. R, the binning's rects, at the same shapes
    rects = rects_phase(card)

    # 4. serve: counts zeroed just before, read just after
    for k in (EXPAND, GATHER, FORWARD, RECTS):
        k.launches = 0
    times, native = serve(model, cfg, card)
    launches = {k.name: k.launches for k in (EXPAND, GATHER, FORWARD, RECTS)}
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
    _, train_launches = train(model, bench_cam, cfg, kernels, card)
    del model
    torch.cuda.empty_cache()

    # 6. small scene against the plain versions
    small_reference_check()
    torch.cuda.empty_cache()

    # 7. loop: counts zeroed just before Trainer.fit, read just after
    loop_launches, (init_model, views) = loop(kernels, card)
    torch.cuda.empty_cache()

    # 7b. restart after the card's out-of-memory: counts zeroed just before
    # run_resilient, read just after
    restart_launches = restart_phase(init_model, views, kernels, card)
    del init_model, views
    torch.cuda.empty_cache()

    # 8. the loop through the CLI: counts zeroed just before, read after
    cli_train(kernels, card)

    # 9. giant frames (int64 rects): counts zeroed before each frame's
    # render() calls, read just after
    model = bench_scene(N_GAUSSIANS, device)
    giant = giant_grids(model, [EXPAND, FORWARD], card)
    del model
    torch.cuda.empty_cache()

    # 10. 2D splats: counts zeroed just before the 20 steps, read after
    splats = splats2d_phase(kernels, card)

    # 11. sharded, 2 gloo ranks on this card (each rank zeroes and reads
    # its own counts around its render and each step)
    sharded = sharded_phase(card)

    # 12. gaussian-axis paths, 2 and 4 gloo ranks on this card (each rank
    # zeroes and reads its own counts around each of its paths)
    gauss = gauss_phase(card)

    # 13. the single-card memory ceiling, by out-of-memory probes
    hbm_phase(card)

    # 14. the timing variants of K1, K2 and K3 and their cost decomposition
    ablation = ablate_phase(card)
    torch.cuda.empty_cache()

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
        k["restart_launches"] = restart_launches[name]
        k["determinism_launches"] = [
            r[name] for key in ("render", "step") for r in determinism[key]]
        k["splats2d_launches"] = splats["launches"][name]
        k["sharded_step_launches"] = [
            r[name] for key in ("step_d1t2", "step_d2t1")
            for r in sharded[key]["launches"]]
        for key, per_rank in gauss["launches"].items():
            k[f"{key}_launches"] = [r.get(name, 0) for r in per_rank]
    for k, name in zip(record["kernels"][1:], ("forward", "backward",
                                                "segreduce")):
        k.update(ablation[name])
    record["kernels"].append({
        "name": "gather_pairs", "route": "cuda",
        "source": "gaussiansplat_tpu_torch/csrc/gather.cu",
        "replaces": None, "launches": launches["gather"],
        "train_launches": train_launches["gather"],
        "loop_launches": loop_launches["gather"],
        "restart_launches": restart_launches["gather"],
        "determinism_launches": [
            r["gather"] for key in ("render", "step") for r in determinism[key]],
        "splats2d_launches": splats["launches"]["gather"],
        "bound_by": "bytes",
        **{f"{key}_{frame}": rec[key] for frame, rec in gather.items()
           for key in ("ms", "bound_ms", "plain_ms", "library_ms",
                       "library_pairs_ms", "num_pairs")}})
    record["kernels"].append({
        "name": "tile_rects", "route": "cuda",
        "source": "gaussiansplat_tpu_torch/csrc/rects.cu",
        "replaces": None, "launches": launches["rects"],
        "train_launches": train_launches["rects"],
        "loop_launches": loop_launches["rects"],
        "restart_launches": restart_launches["rects"],
        "determinism_launches": [
            r["rects"] for key in ("render", "step") for r in determinism[key]],
        "splats2d_launches": splats["launches"]["rects"],
        **{f"{key}_launches": [r.get("rects", 0) for r in per_rank]
           for key, per_rank in gauss["launches"].items()},
        "bound_by": "bytes",
        **{f"{key}_{frame}": rec[key] for frame, rec in rects.items()
           for key in ("ms", "bound_ms", "plain_ms", "compact_ms",
                       "compact_plain_ms", "bin_ms", "bin_plain_front_ms")}})
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
    if "--sharded-rank" in sys.argv or "--hbm-probe" in sys.argv:
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("--sharded-rank", choices=("tile", "gauss", "gauss2d"))
        ap.add_argument("--out")
        ap.add_argument("--hbm-probe", type=int)
        a = ap.parse_args()
        if a.hbm_probe:
            sys.exit(hbm_probe(a.hbm_probe))
        sys.exit({"tile": tile_worker, "gauss": gauss_worker,
                  "gauss2d": gauss2d_worker}[a.sharded_rank](a.out))
    sys.exit(main())
