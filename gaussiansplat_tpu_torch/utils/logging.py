"""Metrics, logging and the program's spans.

Scalar metrics stream to stdout and an append-only JSONL file. `span` and
`count` mark the program's layers (projection, binning, gather, raster,
loss, backward, optimizer) while `torch.profiler` records, and `calls`
reads each frame's or step's spans back with their device times.
`StageTimer` times whole calls on the host clock and synchronizes.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import IO, Any, Deque, Dict, List, Optional

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


# --- Spans and counters ---------------------------------------------------

_autograd_profiler = torch.autograd.profiler

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def profiling() -> bool:
        """True while `torch.profiler` records (a module flag: one read)."""
        return _autograd_profiler._is_profiler_enabled
else:
    profiling = torch._C._autograd._profiler_enabled


_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


class Call:
    """One top-level call (a frame, a training step): its spans in the
    order they opened, the top-level span first."""

    __slots__ = ("id", "spans")

    def __init__(self, call_id: int):
        self.id = call_id
        self.spans: List[Span] = []

    def self_ms(self, name: str) -> Optional[float]:
        """Summed self device ms of the call's spans named `name` (0.0 if it
        has none); None when the call was not timed on a CUDA device."""
        if self.spans[0].self_ms is None:
            return None
        return sum(s.self_ms for s in self.spans if s.name == name)

    def counter(self, name: str):
        """The sum of counter `name` over the call's spans."""
        return sum(s.counters.get(name, 0) for s in self.spans)


class Span:
    """One open or finished span. `t0_ns` / `t1_ns` are host stamps on the
    clock of the profiler's CPU events (`time.time_ns()`); `device_ms` and
    `self_ms` (device ms less the part its child spans cover) are filled in
    by `SpanRecorder.calls` and stay None for host-only calls."""

    __slots__ = ("name", "parent", "call", "t0_ns", "t1_ns", "device_ms",
                 "self_ms", "counters", "_recorder", "_device", "_stream",
                 "_range", "_events", "_pending")

    def __init__(self, recorder: "SpanRecorder", name: str, device=None):
        self._recorder = recorder
        self.name = name
        self._device = device
        self.parent: Optional[Span] = None
        self.call: Optional[Call] = None
        self.t0_ns = self.t1_ns = 0
        self.device_ms: Optional[float] = None
        self.self_ms: Optional[float] = None
        self.counters: Dict[str, Any] = {}
        self._stream = None
        self._events = None
        self._pending = []

    def __enter__(self) -> "Span":
        self._recorder._enter(self)
        return self

    def __exit__(self, *exc) -> None:
        self._recorder._exit(self)


class SpanRecorder:
    """Spans and counters at the program's layer boundaries, on the
    profiler's clock, kept for the last `keep` top-level calls.

    A span enters a profiler range named `name` (torch's
    `_RecordFunctionFast`, far cheaper than `record_function` while the
    profiler records), so it lands in the profiler's timeline beside the
    kernels, stamps the host clock, and on a CUDA call records a pair of
    pooled timing events on the stream that was current when the call
    opened; it never synchronizes. A span opened while no span is open on
    its thread (autograd's backward runs on a device thread of its own)
    takes the innermost open span of the open top-level call as parent, so
    every span of one frame or step carries that call's id. The device of
    the top-level span's work (`device=`) decides whether the call is timed
    on the card; inner spans follow their call."""

    def __init__(self, keep: int = 4096):
        self.keep = keep
        self._calls: Deque[Call] = collections.deque()
        self._pool: List[torch.cuda.Event] = []
        self._local = threading.local()
        self._open: Optional[List[Span]] = None   # the open call's stack
        self._next_id = 0

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _innermost(self) -> Optional[Span]:
        stack = self._stack()
        if stack:
            return stack[-1]
        owner = self._open
        return owner[-1] if owner else None

    def _event(self) -> torch.cuda.Event:
        try:
            return self._pool.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def _enter(self, s: Span) -> None:
        stack = self._stack()
        parent = self._innermost()
        if parent is None:
            s.call = Call(self._next_id)
            self._next_id += 1
            if s._device is not None and torch.device(s._device).type == "cuda":
                s._stream = torch.cuda.current_stream(s._device)
            self._open = stack
        else:
            s.call, s._stream = parent.call, parent._stream
        s.parent = parent
        s.call.spans.append(s)
        stack.append(s)
        s._range = _RANGE(s.name)
        s._range.__enter__()
        s.t0_ns = time.time_ns()
        if s._stream is not None:
            s._events = (self._event(), self._event())
            s._events[0].record(s._stream)

    def _exit(self, s: Span) -> None:
        if s._events is not None:
            s._events[1].record(s._stream)
        s.t1_ns = time.time_ns()
        s._range.__exit__(None, None, None)
        s._range = None
        stack = self._stack()
        stack.pop()
        if s.parent is None:
            self._open = None
            self._calls.append(s.call)
            while len(self._calls) > self.keep:
                self._recycle(self._calls.popleft())

    def count(self, name: str, value) -> None:
        """Add `value` (a number or a 0-d tensor, read at `calls`) to
        counter `name` of the innermost open span; dropped when none is
        open."""
        s = self._innermost()
        if s is not None:
            s._pending.append((name, value))

    def _recycle(self, call: Call) -> None:
        for s in call.spans:
            if s._events is not None:
                self._pool.extend(s._events)
                s._events = None

    def calls(self, top: Optional[str] = None) -> List[Call]:
        """The kept calls, oldest first (those whose top-level span is named
        `top`, if given), with device ms, self ms and counters resolved.
        Synchronizes the card when a call holds unread events: read after
        the measured window."""
        got = [c for c in self._calls if top is None or c.spans[0].name == top]
        if any(s._events is not None for c in got for s in c.spans):
            torch.cuda.synchronize()
        for c in got:
            self._resolve(c)
        return got

    def _resolve(self, call: Call) -> None:
        for s in call.spans:
            for name, value in s._pending:
                if isinstance(value, torch.Tensor):
                    value = value.item()
                s.counters[name] = s.counters.get(name, 0) + value
            s._pending = []
            if s._events is not None:
                s.device_ms = s._events[0].elapsed_time(s._events[1])
        if call.spans[0].device_ms is None:
            return
        self._recycle(call)
        for s in call.spans:
            s.self_ms = s.device_ms
        for s in call.spans[1:]:
            s.parent.self_ms -= s.device_ms

    def reset(self) -> None:
        """Forget every kept call."""
        while self._calls:
            self._recycle(self._calls.popleft())


RECORDER = SpanRecorder()
_OFF = contextlib.nullcontext()


def span(name: str, device=None):
    """A span of the program's layer `name` (use as a context manager).
    Off, it is one shared no-op context: a span records only while
    `torch.profiler` records. `device`: where a top-level span's work runs
    (a CUDA device times the call on the card)."""
    if not profiling():
        return _OFF
    return Span(RECORDER, name, device)


def count(name: str, value) -> None:
    """Add `value` to counter `name` of the innermost open span, while
    `torch.profiler` records."""
    if profiling():
        RECORDER.count(name, value)


def calls(top: Optional[str] = None) -> List[Call]:
    """`RECORDER.calls(top)`: the kept calls, resolved."""
    return RECORDER.calls(top)


class StageTimer:
    """Host-clock milliseconds of every call of the functions it wraps,
    by name (`ms[name]`). Each timed call ends with
    `torch.cuda.synchronize()` once the card is in use, so a time is the
    work's and not its enqueue; that synchronize is the timer's cost (the
    host can no longer run ahead into the next call). It is therefore not
    for a measured window: `span` times the layers inside one without
    synchronizing."""

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
