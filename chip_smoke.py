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
   entry. K2 and K3 must give the same bits on two launches. Times by CUDA
   events, with the plain versions' times and K3's `index_add_` yardstick.
4. Serve: the 1M-gaussian SH-3 benchmark scene, 8 orbit requests through
   `render()` after one warm-up, then the scene exported to PLY and 2 frames
   through the CLI; a profile of one request.
5. Train: the same scene, one camera, a target rendered from a copy with
   perturbed colours; `init_train_state`, one warm-up step, then 5 steps of
   `make_train_step` (overflow 0, finite falling loss, every parameter
   group's gradient finite and non-zero); a profile of one step.
6. A small scene with the kernels against the plain versions: image,
   transmittance and every gradient.
The launch counts are zeroed just before the serve and the train phases and
read just after; every kernel of the phase must have launched (K1-K4 on
every training step).

Every phase raises on failure. The last two lines are one JSON object with
per-kernel numbers and `{"ok": true, "device": {...}}`. Exits non-zero when
no CUDA card is present.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM3,
# and 67 TFLOP/s float32 outside the tensor cores, which counts each FMA as
# two operations. K1 rounds every multiply and add apart (no FMA), so its
# float32 work is bounded by instruction issue: 128 thread instructions per
# clock per SM, half of 67e12. Its exponentials run on the special-function
# units at 16 results per clock per SM, an eighth of that (CUDA programming
# guide, arithmetic instruction throughput, compute capability 9.0).
PEAK_BYTES_PER_S = 3.35e12
PEAK_ISSUE_PER_S = 67e12 / 2
PEAK_SFU_PER_S = PEAK_ISSUE_PER_S / 8
# Work per (pixel, in-segment pair) of the composited chunks that K1 cannot
# avoid before its gates: 14 instructions (dx, dy, the factored quadratic
# form with 2cb taken per pair: 6 mul and 2 add, the -1/2 scale, the opacity
# multiply, the two gate compares) and one exponential. Pairs that pass the
# gates cost more; that is not counted, so the bound is a floor.
K1_ISSUE_PER_EVAL = 14
K1_SFU_PER_EVAL = 1
# K2 re-evaluates the same gates for every (pixel, in-segment pair) of the
# chunks K1 composited (the shared code of raster_common.cuh: 14
# instructions and one exponential) and votes once per warp and pair
# (__any_sync) before it knows whether the pair is live anywhere in the
# warp: 15 instructions. Live pairs add ~40 instructions, two
# special-function calls and the warp reduction; not counted, so the bound
# is a floor.
K2_ISSUE_PER_EVAL = 15
K2_SFU_PER_EVAL = 1
# K2's budget against its plain version, relative to each gradient row's
# largest entry: all but 0.1% of the entries within 1e-4 (per-pixel against
# per-chunk rewinding and other summation orders move them by ~1e-6), every
# entry within 1e-2 (a knife-edge alpha gate, where exp rounds differently,
# moves one pair's row by one pixel's share: up to ~3e-3 in the CPU tests).
K2_BULK_ATOL, K2_BULK_FRAC, K2_ATOL = 1e-4, 1e-3, 1e-2

WIDTH, HEIGHT, N_GAUSSIANS, FX = 1920, 1080, 1_000_000, 1600.0


def bench_scene(n: int, device, seed: int = 0):
    """The benchmark scene of the reference's bench.py at (WIDTH, HEIGHT, n):
    opacity 0.8, SH degree 3, world scale so every n tiles the screen at the
    same per-splat pixel area."""
    from gaussiansplat_tpu_torch.models import random_model

    k = (1600.0 / FX) * ((WIDTH * HEIGHT / n) / 2.0736) ** 0.5
    g = torch.Generator().manual_seed(seed)
    return random_model(g, n, sh_degree=3, extent=1.0, opacity=0.8,
                        scale_range=(0.004 * k, 0.012 * k), device=device)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def composited_pairs(tile_starts, stops, chunk_size: int) -> int:
    """In-segment pairs of the chunks the tiles composited (K1's stop row):
    the pairs K1 and K2 evaluate at every pixel."""
    starts = tile_starts.to(torch.int64)
    base = starts[:-1] // chunk_size * chunk_size
    reach = torch.minimum(starts[1:], base + stops.to(torch.int64) * chunk_size)
    return int(torch.clamp(reach - starts[:-1], min=0).sum())


def bound(nbytes: float, evals: float, issue_per_eval: int, sfu_per_eval: int):
    """The largest of the bytes, instruction-issue and special-function
    times (ms), and which one it is."""
    times = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
             "instruction issue": evals * issue_per_eval / PEAK_ISSUE_PER_S * 1e3,
             "special-function units": evals * sfu_per_eval / PEAK_SFU_PER_S * 1e3}
    worst = max(times, key=times.get)
    return times[worst], "bytes" if worst == "bytes" else "operations", times


def project(model, cam, cfg):
    from gaussiansplat_tpu_torch.ops.projection import project_gaussians

    return project_gaussians(model.means, model.quats, model.log_scales,
                             model.logit_opacities, model.sh, cam, cfg,
                             sh_degree=3, alive=model.alive)


def check_expand(model, cam, cfg, packed_expected: bool, card: str):
    """K4 against its plain version on one scene; returns its record."""
    from gaussiansplat_tpu_torch.ops.binning import compact_rects, expand_compacted

    c = compact_rects(project(model, cam, cfg), WIDTH, HEIGHT, cfg)
    if c.packed_keys != packed_expected:
        raise AssertionError(f"expected packed_keys={packed_expected}")
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
    nbytes = c.capacity * 4 * len(got) + 3 * n * 4 + 4
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    regime = "packed keys" if c.packed_keys else "separate streams"
    print(f"K4 expand {WIDTH}x{HEIGHT} n={n} ({regime}, capacity "
          f"{c.capacity}, num_pairs {int(c.num_pairs)}): equal over the whole "
          f"capacity; {ms:.4f} ms (CUDA events), plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms (bytes) | {card}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)


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
    # Bound: the pairs K1 must read (40 B of needed channels each) and the
    # output block written, against the instructions and exponentials of
    # each (pixel, in-segment pair) of the chunks this run's data made it
    # composite; the largest of the three times.
    evaluated = composited_pairs(b.tile_starts, stops_g, cfg.chunk_size)
    num_pairs = int(b.num_pairs)
    nbytes = num_pairs * 40 + got.numel() * 4 + b.tile_starts.numel() * 4
    bound_ms, bound_by, parts = bound(nbytes, evaluated * cfg.tile_size ** 2,
                                      K1_ISSUE_PER_EVAL, K1_SFU_PER_EVAL)
    print(f"K1 forward {WIDTH}x{HEIGHT} n={model.capacity} ({t} tiles, "
          f"{num_pairs} pairs, {evaluated} pairs composited): image rows "
          f"max|diff| {err:.3e}; {ms:.4f} ms (CUDA events), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f") | {card}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def check_backward(model, cam, cfg, card: str):
    """K2 against its plain version on the 1080p sorted payload, K1's block
    and a seeded random cotangent (rows 4 and 5 zero, as the rasterizer
    makes them). Returns its record and the binning and gradient rows that
    K3 is checked on."""
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
    # Bound: payload rows read (40 B) and gradient rows written (64 B) per
    # pair, 7 rows of the cotangent and forward blocks read per pixel,
    # against the gate evaluations of the composited chunks.
    evaluated = composited_pairs(b.tile_starts, fwd[:, 6, 0], cfg.chunk_size)
    px = cfg.tile_size ** 2
    nbytes = n * (40 + 64) + fwd.shape[0] * px * 7 * 4 + b.tile_starts.numel() * 4
    bound_ms, bound_by, parts = bound(nbytes, evaluated * px,
                                      K2_ISSUE_PER_EVAL, K2_SFU_PER_EVAL)
    print(f"K2 backward {WIDTH}x{HEIGHT} n={model.capacity} ({n} pairs, "
          f"{evaluated} pairs composited): bit-equal on two launches, rows "
          f"0-10 max|diff| {err:.3e}; {ms:.4f} ms (CUDA events), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f") | {card}")
    valid = torch.arange(got.shape[0], device=device) < n
    dsorted = got.masked_fill(~valid[:, None], 0.0)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by), b, dsorted


def check_segreduce(b, dsorted, card: str):
    """K3 against its plain version on K2's rows in pre-sort order."""
    from gaussiansplat_tpu_torch.ops.kernels.segreduce import (
        segment_reduce_pairs_cuda,
        segment_reduce_pairs_torch,
    )

    n = b.depth_order.shape[0]
    num_pairs = int(b.num_pairs)
    rows = torch.empty_like(dsorted).index_copy_(0, b.sorted_pos.long(), dsorted)
    rows[num_pairs:] = 0.0
    seg = b.seg_offsets
    got = segment_reduce_pairs_cuda(rows, seg, n)
    again = segment_reduce_pairs_cuda(rows, seg, n)
    want = segment_reduce_pairs_torch(rows, seg, n)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("K3 gave different bits on two launches")
    scale = want.abs().amax(0).clamp(min=1e-30)
    rel = float(((got - want).abs() / scale).max())
    err = float((got - want).abs().max())
    if rel > 1e-5:
        raise AssertionError(f"K3: max |diff| {rel:.3e} of the channel's largest entry")
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
    print(f"K3 segment reduce n={n} ({num_pairs} pairs): bit-equal on two "
          f"launches, max|diff| {err:.3e} ({rel:.3e} of the channel's largest "
          f"entry); {ms:.4f} ms (CUDA events), plain {plain_ms:.3f} ms, "
          f"index_add_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes) "
          f"| {card}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                library_ms=library_ms)


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
        # The CLI's orbit angles 0 and pi are requests 1 and 5 above.
        for i, req in ((0, 0), (1, 4)):
            frame = _load_frame(os.path.join(outdir, f"frame_{i:04d}.png"))
            want = (torch.clamp(images[req], 0, 1) * 255).to(torch.uint8)
            if not np.array_equal(frame, want.cpu().numpy()):
                raise AssertionError(f"CLI frame {i} differs from request {req + 1}")
    print(f"CLI: 2 frames of {WIDTH}x{HEIGHT} in {cli_s:.2f} s (PLY import "
          "included), equal to the served frames")
    return times


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = smi.strip()
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
        check_expand(big, bench_cam, cfg, False, card)
    del big
    torch.cuda.empty_cache()
    model = bench_scene(N_GAUSSIANS, device)
    with torch.no_grad():
        k4 = check_expand(model, bench_cam, cfg, True, card)
        k1 = check_forward(model, bench_cam, cfg, card)
        k2, binning, dsorted = check_backward(model, bench_cam, cfg, card)
        k3 = check_segreduce(binning, dsorted, card)
    del binning, dsorted
    torch.cuda.empty_cache()

    # 4. serve: counts zeroed just before, read just after
    EXPAND.launches = 0
    FORWARD.launches = 0
    times = serve(model, cfg, card)
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

    record = {"kernels": [
        {"name": "expand_pairs", "route": "cuda",
         "source": "gaussiansplat_tpu_torch/csrc/expand.cu",
         "replaces": "gaussiansplat_tpu/ops/pallas/expand.py:274",
         "launches": launches["expand"], "max_abs_err": k4["err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
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
         "library_ms": k3["library_ms"]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
