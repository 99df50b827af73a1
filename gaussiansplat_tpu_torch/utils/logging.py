"""Metrics, logging and profiling hooks.

Scalar metrics stream to stdout and an append-only JSONL file; profiling
wraps `torch.profiler`, and `named_scope` labels a stage in its timeline.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import IO, Optional

import torch


class MetricLogger:
    """Streams step metrics to stdout and (optionally) a JSONL file."""

    def __init__(self, jsonl_path: Optional[str] = None, stream: Optional[IO] = None):
        # Resolve stdout lazily: binding sys.stdout here breaks under
        # redirected or captured output (the stream may be closed later).
        self.stream = stream
        self._file = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
            self._file = open(jsonl_path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: dict) -> None:
        scalars = {
            k: (float(v) if not isinstance(v, (str, bool)) else v)
            for k, v in metrics.items()
        }
        parts = " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in scalars.items()
        )
        (self.stream or sys.stdout).write(f"[step {step}] {parts}\n")
        if self._file is not None:
            self._file.write(
                json.dumps({"step": step, "t": time.time() - self._t0, **scalars})
                + "\n"
            )

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the enclosed block with `torch.profiler` (host and, where a
    card is present, device activity) and write a Chrome trace to
    `logdir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def named_scope(name: str):
    """Label a pipeline stage in profiler timelines (usable as a context
    manager or a decorator)."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Host-clock milliseconds of every call of the functions it wraps,
    by name (`ms[name]`). Each timed call ends with
    `torch.cuda.synchronize()` once the card is in use, so a time is the
    work's and not its enqueue; that synchronize is the timer's cost (the
    host can no longer run ahead into the next call)."""

    def __init__(self):
        self.ms = {}

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return out

        return timed
