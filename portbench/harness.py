"""One run of one cell: inputs from the seed, the program's set-up and
warm-up, the measured window (traced or not), then, once the window has
closed and the program's state is freed, the reference on what the
window produced and the per-layer readers.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import cells, drive, inputs as inputs_mod, judge
from .reference import render as R
from .reference import train as ref_train
from .devtrace import Reduced, Tracer

# Top-level module names the run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussiansplat_tpu")


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class RunData:
    """What a per-layer reader (portbench/metrics/<name>.py) reads."""

    kind: str                    # 'serve' or 'train'
    calls: int                   # frames or steps in the traced window
    window_s: float              # the traced window, host clock
    trace: Reduced
    counts: list                 # RasterCounts: compared frames / followed steps
    k1_s: Optional[List[float]]  # K1's device s on those same launches
    k2_s: Optional[List[float]]  # K2's (training)
    num_pairs: Optional[List[int]]  # serve: the program's counter, each frame
    alive: int
    sh_degree: int
    pixels: int


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    numbers: Dict[str, float]
    checks: dict
    memory_peak_bytes: int
    parts: Dict[str, float]
    check_s: float = 0.0           # the reference's comparison, after the window
    detail: Optional[dict] = None  # training: both sides' readings
    run: Optional[RunData] = None
    traced_rate: Optional[float] = None


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, parts: Dict[str, float]) -> Outcome:
    inp = inputs_mod.make(cell, seed, device)
    parts.update(inp.seconds)
    _free(device)
    _reset_peak(device)
    if cell.traffic["kind"] == "serve":
        return _serve(cell, inp, seed, seconds, trace, device, t_start, parts)
    return _train(cell, inp, seconds, trace, device, t_start, parts)


def _serve(cell, inp, seed, seconds, trace, device, t_start, parts) -> Outcome:
    tr = cell.traffic
    rcfg = drive.raster_config(cell.config)
    t0 = time.perf_counter()
    m = drive.model(inp, device)
    warm = tr["warmup_frames"]
    for i in range(warm):
        drive.serve_frame(m, inp.poses[i], rcfg, device)
    drive.sync(device)
    parts["warmup_s"] = time.perf_counter() - t0
    tracer = Tracer(device) if trace else None
    rng = np.random.default_rng(inputs_mod.sub_seed(seed, 5))
    setup_s = time.perf_counter() - t_start
    w = drive.serve_window(m, inp.poses, warm, rcfg, seconds,
                           tr["compare_frames"], rng, device,
                           on_start=tracer.start if tracer else None)
    if tracer:
        tracer.stop()
    peak = _peak(device)
    frames = len(w.latencies_s)
    overflow = int((w.overflow > 0).sum())
    num_pairs = w.num_pairs.tolist()
    kept, lat, window_s = w.kept, w.latencies_s, w.window_s
    del m, w
    _free(device)

    t_check = time.perf_counter()
    rc = R.Raster.from_dict(cell.config["raster"])
    compared, counts = [], []
    with R.fp32_math():
        for idx, img, trans in kept:
            cam = inputs_mod.ref_camera(inp.poses[idx], device)
            proj = R.project(inp.params, inp.alive, cam, rc, inp.sh_degree)
            ri, rt, cnt = R.render(proj, cam, rc, inp.background, count=trace)
            compared.append((img, trans, ri, rt))
            counts.append(cnt)
    numbers = judge.serve_numbers(compared)
    numbers["overflow_calls"] = overflow
    ok, checks = judge.check(numbers, cell.limits)
    e2e = dict(frames_per_s=frames / window_s,
               frame_p95_ms=float(np.percentile(np.asarray(lat) * 1e3, 95)),
               setup_s=setup_s)
    out = Outcome(correct=ok, attempted=frames, failed=overflow,
                  end_to_end=e2e, numbers=numbers, checks=checks,
                  memory_peak_bytes=peak, parts=parts,
                  check_s=time.perf_counter() - t_check)
    if tracer:
        red = tracer.reduce()
        k1 = red.kernels["forward_kernel"]
        k1_s = ([k1[idx - warm] for idx, _, _ in kept]
                if len(k1) == frames else None)
        out.run = RunData(kind="serve", calls=frames, window_s=window_s,
                          trace=red, counts=counts, k1_s=k1_s, k2_s=None,
                          num_pairs=num_pairs, alive=int(inp.alive.sum()),
                          sh_degree=inp.sh_degree,
                          pixels=tr["width"] * tr["height"])
        out.traced_rate = frames / window_s
    return out


def _train(cell, inp, seconds, trace, device, t_start, parts) -> Outcome:
    tr = cell.traffic
    steps = tr["follow_steps"]
    t0 = time.perf_counter()
    trainer = drive.trainer(inp, cell.config, device)
    parts["trainer_s"] = time.perf_counter() - t0
    first_tracer = Tracer(device) if trace else None
    if first_tracer:
        first_tracer.start()
    got = drive.first_steps(trainer, inp, cell.config, steps)
    if first_tracer:
        first_tracer.stop()
    parts["warmup_s"] = time.perf_counter() - t0
    parts["first_step_s"] = got.pop("first_step_s")
    tracer = Tracer(device) if trace else None
    setup_s = time.perf_counter() - t_start
    w = drive.train_window(trainer, inp, steps, seconds, device,
                           on_start=tracer.start if tracer else None)
    if tracer:
        tracer.stop()
    peak = _peak(device)
    overflow = int((w.overflow > 0).sum())
    nonfinite = int((~torch.isfinite(w.losses)).sum())
    n, window_s = w.steps, w.window_s
    del trainer, w
    _free(device)

    t_check = time.perf_counter()
    rc = R.Raster.from_dict(cell.config["raster"])
    views = [(inputs_mod.ref_camera(inp.poses[v], device), inp.targets[v],
              inp.background) for v in inp.order[:steps]]
    want = ref_train.follow(inp.params, inp.alive, views, rc,
                            cell.config["train"], inp.sh_degree, inp.extent,
                            steps, count=trace)
    numbers = judge.train_numbers(got, want)
    numbers["overflow_calls"] = overflow
    numbers["nonfinite_calls"] = nonfinite
    ok, checks = judge.check(numbers, cell.limits)
    e2e = dict(train_steps_per_s=n / window_s, setup_s=setup_s)
    out = Outcome(correct=ok, attempted=n, failed=overflow + nonfinite,
                  end_to_end=e2e, numbers=numbers, checks=checks,
                  memory_peak_bytes=peak, parts=parts,
                  check_s=time.perf_counter() - t_check,
                  detail=dict(program=got, reference={
                      k: want[k] for k in ("losses", "grad_norms",
                                           "change_norms")}))
    if tracer:
        first = first_tracer.reduce()
        k1 = first.kernels["forward_kernel"]
        k2 = first.kernels["backward_kernel"]
        out.run = RunData(kind="train", calls=n, window_s=window_s,
                          trace=tracer.reduce(), counts=want["counts"],
                          k1_s=k1 if len(k1) == steps else None,
                          k2_s=k2 if len(k2) == steps else None,
                          num_pairs=None, alive=int(inp.alive.sum()),
                          sh_degree=inp.sh_degree,
                          pixels=tr["width"] * tr["height"])
        out.traced_rate = n / window_s
    return out
