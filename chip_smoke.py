#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gaussiansplat_tpu_torch) on one card.

    python3 chip_smoke.py

1. Probe: requires a CUDA card; prints `nvidia-smi` name and power limit.
2. Build: compiles every kernel of the render path from
   gaussiansplat_tpu_torch/csrc (one nvcc per source, in parallel) and
   prints the build time and the ptxas register / shared-memory lines.
3. Kernels against their plain PyTorch versions at the render path's shapes
   (1920x1080): K4 (pair expansion) integer-equal over the whole capacity
   with 1M gaussians (packed keys) and 3M (separate streams); K1 (forward
   raster) on the 1M sorted payload within the image outlier budget, with
   equal stop counts on >= 99.9% of tiles. Times by CUDA events.
4. Serve: the 1M-gaussian SH-3 benchmark scene, 8 orbit requests through
   `render()` after one warm-up, then the scene exported to PLY and 2 frames
   through the CLI. The launch counts are zeroed just before this phase and
   read just after; each kernel must have launched.
5. A small scene rendered with the kernels against the plain versions.

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
    cs = cfg.chunk_size
    starts = b.tile_starts.to(torch.int64)
    base = starts[:-1] // cs * cs
    reach = torch.minimum(starts[1:], base + stops_g.to(torch.int64) * cs)
    evaluated = int(torch.clamp(reach - starts[:-1], min=0).sum())
    evals = evaluated * cfg.tile_size ** 2
    num_pairs = int(b.num_pairs)
    nbytes = num_pairs * 40 + got.numel() * 4 + starts.numel() * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    issue_ms = evals * K1_ISSUE_PER_EVAL / PEAK_ISSUE_PER_S * 1e3
    sfu_ms = evals * K1_SFU_PER_EVAL / PEAK_SFU_PER_S * 1e3
    bound_ms = max(bytes_ms, issue_ms, sfu_ms)
    bound_by = "bytes" if bound_ms == bytes_ms else "operations"
    print(f"K1 forward {WIDTH}x{HEIGHT} n={model.capacity} ({t} tiles, "
          f"{num_pairs} pairs, {evaluated} pairs composited): image rows "
          f"max|diff| {err:.3e}; {ms:.4f} ms (CUDA events), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; bytes "
          f"{bytes_ms:.4f} ms, instruction issue {issue_ms:.4f} ms, "
          f"special-function units {sfu_ms:.4f} ms) | {card}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


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


def profile_request(model, cfg, card: str) -> None:
    """Device time by kernel of one served request (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gaussiansplat_tpu_torch.ops.camera import orbit_camera
    from gaussiansplat_tpu_torch.render import render

    cam = orbit_camera(0.5, 4.0, fx=FX, fy=FX, width=WIDTH, height=HEIGHT,
                       device=model.device)
    with torch.inference_mode():
        render(model, cam, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render(model, cam, cfg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel events only: an operator's device time repeats its kernels'.
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profiled request: kernels busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"wall (profiler on; idle share {1 - busy / wall_ms:.3f}) | {card}")
    for ms, count, key in rows[:12]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    from gaussiansplat_tpu_torch.ops.kernels.build import build_all, ptxas_lines
    from gaussiansplat_tpu_torch.ops.kernels.expand import EXPAND
    from gaussiansplat_tpu_torch.ops.kernels.forward import FORWARD
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
    kernels = build_all([EXPAND, FORWARD])
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

    # 5. small scene against the plain versions
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
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
