"""One run of one cell on one rank: inputs from the seed, the program's
set-up and warm-up, the measured window (traced or not), then, once the
window has closed and the program's state is freed, the reference on what
the window produced. What every program shares lives here: the closed
serve and train windows, their timing, the tracer, the reservoir sample,
the check against the limits, the peak memory, and the job's outcome
merged from its ranks'. What one program path does lives in its program
file (portbench/programs/<name>.py).

The window loops are closed: one viewer asks for the next frame when the
last is on the host's side of `synchronize()`; one trainer calls the next
step when the last call returns. Nothing compiles inside them: the
program's set-up warms every shape first. In a job of several ranks
(`ranks.Group`) a barrier opens the window, every rank makes the calls
rank 0 decides on, and the window ends when every rank has drained its
device.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import cells, inputs as inputs_mod, judge
from .devtrace import Reduced, Tracer
from .inputs import sync
from .ranks import SOLO

# Top-level module names the run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussiansplat_tpu")


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Frame:
    """What a program's serve call returns: the outputs the comparison
    reads (cloned when the frame is sampled), the call's overflow counter
    and, where the program counts them, the pairs it binned."""

    keep: Tuple[torch.Tensor, ...]
    overflow: torch.Tensor
    num_pairs: Optional[torch.Tensor] = None


@dataclasses.dataclass
class CallSpans:
    """One frame's or step's spans as the program recorded them
    (gaussiansplat_tpu_torch/utils/logging.py `calls`): the top-level
    span's name, the summed self device ms of the spans of each name (None
    when the call was not timed on a card) and each counter's sum."""

    top: str
    ms: Optional[Dict[str, float]]
    counters: Dict[str, float]

    @classmethod
    def of(cls, call) -> "CallSpans":
        names = {s.name for s in call.spans}
        counters = {k for s in call.spans for k in s.counters}
        timed = call.spans[0].self_ms is not None
        return cls(top=call.spans[0].name,
                   ms={n: call.self_ms(n) for n in names} if timed else None,
                   counters={k: call.counter(k) for k in counters})

    def self_ms(self, name: str) -> Optional[float]:
        return None if self.ms is None else self.ms.get(name, 0)

    def counter(self, name: str):
        return self.counters.get(name, 0)


def window_spans() -> Optional[List[CallSpans]]:
    """The calls the program's span recorder keeps, oldest first; None for
    a program without spans."""
    try:
        from gaussiansplat_tpu_torch.utils.logging import calls
    except ImportError:
        return None
    return [CallSpans.of(c) for c in calls()]


@dataclasses.dataclass
class RunData:
    """What a per-layer reader (portbench/metrics/<name>.py) reads: rank
    0's run, and in `ranks` every rank's (rank 0's first; [itself] on one
    card)."""

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
    spans: Optional[List[CallSpans]] = None  # the program's, see window_spans
    ranks: List["RunData"] = dataclasses.field(default_factory=list)


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
    failed_calls: List[int] = dataclasses.field(default_factory=list)


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


def run(cell: cells.Cell, program, seed: int, seconds: float, trace: bool,
        device, t_start: float, parts: Dict[str, float],
        peers=SOLO) -> Outcome:
    """This rank's run of the cell through `program` (its program file)."""
    inp = inputs_mod.make(cell, program, seed, device)
    parts.update(inp.seconds)
    _free(device)
    _reset_peak(device)
    if cell.traffic["kind"] == "serve":
        return _serve(cell, program, inp, seed, seconds, trace, device,
                      t_start, parts, peers)
    return _train(cell, program, inp, seconds, trace, device, t_start, parts,
                  peers)


@dataclasses.dataclass
class ServeWindow:
    latencies_s: List[float]
    window_s: float
    kept: list              # [(frame index, the frame's kept outputs)]
    num_pairs: Optional[torch.Tensor]
    overflow: torch.Tensor


def serve_window(program, server, poses: List[inputs_mod.Pose], first: int,
                 seconds: float, keep: int, rng: np.random.Generator, device,
                 peers=SOLO, on_start=None) -> ServeWindow:
    """Frames of poses[first:] until `seconds` have passed on rank 0.
    `keep` frames, a uniform sample of all that the window completes
    (reservoir sampling from `rng`), are kept for the comparison."""
    lat, pairs, over = [], [], []
    kept: Dict[int, tuple] = {}
    sync(device)
    if on_start is not None:
        on_start()
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        ts = time.perf_counter()
        out = program.serve_call(server, poses[(first + i) % len(poses)],
                                 device)
        sync(device)
        te = time.perf_counter()
        lat.append(te - ts)
        pairs.append(out.num_pairs)
        over.append(out.overflow)
        slot = i if i < keep else int(rng.integers(0, i + 1))
        if slot < keep:
            kept[slot] = (first + i, tuple(t.clone() for t in out.keep))
        i += 1
        if not peers.decide(i, te < deadline):
            break
    if peers.world > 1:
        peers.barrier("drained")
        te = time.perf_counter()
    return ServeWindow(latencies_s=lat, window_s=te - t0,
                       kept=sorted(kept.values(), key=lambda k: k[0]),
                       num_pairs=None if pairs[0] is None else torch.stack(pairs),
                       overflow=torch.stack(over))


@dataclasses.dataclass
class TrainWindow:
    steps: int
    window_s: float
    overflow: torch.Tensor
    losses: torch.Tensor


def train_window(program, trainer, inp: inputs_mod.Inputs, first: int,
                 seconds: float, device, peers=SOLO,
                 on_start=None) -> TrainWindow:
    """Steps first, first + 1, ... issued until `seconds` have passed on
    rank 0, then the device drained: the window ends when the last step is
    done on every rank."""
    over, losses = [], []
    sync(device)
    if on_start is not None:
        on_start()
    n = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while peers.decide(n, time.perf_counter() < deadline):
        met = program.train_call(trainer, inp, first + n)
        over.append(met["overflow"])
        losses.append(met["loss"])
        n += 1
    sync(device)
    peers.barrier("drained")
    return TrainWindow(steps=n, window_s=time.perf_counter() - t0,
                       overflow=torch.stack(over), losses=torch.stack(losses))


def _serve(cell, program, inp, seed, seconds, trace, device, t_start, parts,
           peers) -> Outcome:
    tr = cell.traffic
    t0 = time.perf_counter()
    server = program.serve_setup(cell, inp, device)
    warm = tr["warmup_frames"]
    for i in range(warm):
        program.serve_call(server, inp.poses[i], device)
    sync(device)
    parts["warmup_s"] = time.perf_counter() - t0
    tracer = Tracer(device) if trace else None
    rng = np.random.default_rng(inputs_mod.sub_seed(seed, 5))
    peers.barrier("open")
    setup_s = time.perf_counter() - t_start
    w = serve_window(program, server, inp.poses, warm, seconds,
                     tr["compare_frames"], rng, device, peers,
                     on_start=tracer.start if tracer else None)
    if tracer:
        tracer.stop()
    peak = _peak(device)
    frames = len(w.latencies_s)
    failed = torch.nonzero(w.overflow > 0).flatten().tolist()
    num_pairs = None if w.num_pairs is None else w.num_pairs.tolist()
    kept, lat, window_s = w.kept, w.latencies_s, w.window_s
    del server, w
    _free(device)

    t_check = time.perf_counter()
    numbers, counts = program.serve_check(cell, inp, kept, trace, device)
    numbers["overflow_calls"] = len(failed)
    ok, checks = judge.check(numbers, cell.limits)
    e2e = dict(frames_per_s=frames / window_s,
               frame_p95_ms=float(np.percentile(np.asarray(lat) * 1e3, 95)),
               setup_s=setup_s)
    out = Outcome(correct=ok, attempted=frames, failed=len(failed),
                  end_to_end=e2e, numbers=numbers, checks=checks,
                  memory_peak_bytes=peak, parts=parts,
                  check_s=time.perf_counter() - t_check, failed_calls=failed)
    if tracer:
        red = tracer.reduce()
        k1 = red.kernels["forward_kernel"]
        k1_s = ([k1[idx - warm] for idx, _ in kept]
                if len(k1) == frames else None)
        out.run = RunData(kind="serve", calls=frames, window_s=window_s,
                          trace=red, counts=counts, k1_s=k1_s, k2_s=None,
                          num_pairs=num_pairs, alive=int(inp.alive.sum()),
                          sh_degree=inp.sh_degree,
                          pixels=tr["width"] * tr["height"],
                          spans=window_spans())
        out.traced_rate = frames / window_s
    return out


def _train(cell, program, inp, seconds, trace, device, t_start, parts,
           peers) -> Outcome:
    tr = cell.traffic
    steps = tr["follow_steps"]
    t0 = time.perf_counter()
    trainer = program.train_setup(cell, inp, device)
    parts["trainer_s"] = time.perf_counter() - t0
    first_tracer = Tracer(device) if trace else None
    if first_tracer:
        first_tracer.start()
    got = program.first_steps(trainer, cell, inp, steps)
    if first_tracer:
        first_tracer.stop()
    parts["warmup_s"] = time.perf_counter() - t0
    parts["first_step_s"] = got.pop("first_step_s")
    tracer = Tracer(device) if trace else None
    peers.barrier("open")
    setup_s = time.perf_counter() - t_start
    w = train_window(program, trainer, inp, steps, seconds, device, peers,
                     on_start=tracer.start if tracer else None)
    if tracer:
        tracer.stop()
    peak = _peak(device)
    overflow = int((w.overflow > 0).sum())
    nonfinite = int((~torch.isfinite(w.losses)).sum())
    failed = torch.nonzero((w.overflow > 0) | ~torch.isfinite(w.losses)
                           ).flatten().tolist()
    n, window_s = w.steps, w.window_s
    del trainer, w
    _free(device)

    t_check = time.perf_counter()
    numbers, want = program.train_check(cell, inp, got, trace, device)
    numbers["overflow_calls"] = overflow
    numbers["nonfinite_calls"] = nonfinite
    ok, checks = judge.check(numbers, cell.limits)
    e2e = dict(train_steps_per_s=n / window_s, setup_s=setup_s)
    out = Outcome(correct=ok, attempted=n, failed=len(failed),
                  end_to_end=e2e, numbers=numbers, checks=checks,
                  memory_peak_bytes=peak, parts=parts,
                  check_s=time.perf_counter() - t_check, failed_calls=failed,
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
                          pixels=tr["width"] * tr["height"],
                          spans=window_spans())
        out.traced_rate = n / window_s
    return out


def merge(outs: List[Outcome]) -> Outcome:
    """The job's outcome from its ranks' (rank 0's first): rank 0's
    timings and readings; correct only where every rank's check passed,
    each number compared at its worst rank; the calls that failed on any
    rank; the fullest rank's peak; every rank's RunData in `run.ranks`."""
    out = outs[0]
    if out.run is not None:
        out.run.ranks = [o.run for o in outs]
    if len(outs) == 1:
        return out
    out.correct = all(o.correct for o in outs)
    for o in outs[1:]:
        for name, c in o.checks.items():
            if name not in out.checks or c["value"] > out.checks[name]["value"]:
                out.checks[name] = c
                out.numbers[name] = o.numbers[name]
    out.failed_calls = sorted(set().union(*(o.failed_calls for o in outs)))
    out.failed = len(out.failed_calls)
    out.memory_peak_bytes = max(o.memory_peak_bytes for o in outs)
    return out
