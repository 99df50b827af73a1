"""The device trace of a window, from torch.profiler (CUPTI), reduced to
what the per-layer metrics read.

The profiler's raw events are read directly (`kineto_results.events()`):
building torch's per-event Python objects takes minutes at the hundreds of
thousands of events a window holds. Kernels, memory copies and memsets are
the device's work (the device's mirrors of host ranges are not).
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "portbench.window"
ADAM = "Optimizer.step#Adam.step"
# Gaps shorter than this are summed under one name in the breakdown.
SHORT_GAP_NS = 20_000
TOP = 10


@dataclasses.dataclass
class Reduced:
    window_s: float                      # the traced window
    busy_s: float                        # union of device intervals in it
    device_ops: List[Tuple[str, float]]  # seconds by kernel name, top TOP
    idle_gaps: List[Tuple[str, float]]   # idle seconds by host op, top TOP
    kernels: Dict[str, List[float]]      # seconds of each launch, in order
    adam_s: List[float]                  # device s of each Adam.step range


class Tracer:
    """Profile one window: `start()` before it, `stop()` after it."""

    def __init__(self, device) -> None:
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.rf = record_function(WINDOW)

    def start(self) -> None:
        self.prof.__enter__()
        self.rf.__enter__()

    def stop(self) -> None:
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def reduce(self, kernel_keys=("forward_kernel", "backward_kernel")) -> Reduced:
        return reduce(self.prof.profiler.kineto_results.events(), kernel_keys)


def reduce(events, kernel_keys) -> Reduced:
    cpu, dev, launches, ranges = [], [], [], set()
    w0 = w1 = None
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            name = e.name()
            if name == WINDOW:
                w0, w1 = e.start_ns(), e.end_ns()
            elif e.is_user_annotation():
                ranges.add(name)
            if name.startswith("cu"):
                launches.append((e.start_ns(), e.correlation_id()))
            if name != WINDOW:
                cpu.append((e.start_ns(), e.end_ns(), name))
    if w0 is None:
        raise RuntimeError("the profiler recorded no window")
    # A user range recorded on the host is mirrored on the device under its
    # name: it is not the device's work.
    ranges.add(WINDOW)
    dev = sorted(d for d in dev
                 if d[1] > w0 and d[0] < w1 and d[2] not in ranges)

    busy = 0
    gaps = []
    cur = w0
    for s, e, _, _ in dev:
        s, e = max(s, w0), min(e, w1)
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))

    by_name = defaultdict(int)
    kernels = {k: [] for k in kernel_keys}
    for s, e, name, _ in dev:
        by_name[name] += e - s
        k = _kernel_key(name)
        if k in kernels:
            kernels[k].append((e - s) * 1e-9)

    cpu.sort()
    starts = [c[0] for c in cpu]
    idle = defaultdict(int)
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_GAP_NS:
            idle[f"gaps under {SHORT_GAP_NS // 1000} us"] += g1 - g0
            continue
        idle[_host_op(cpu, starts, (g0 + g1) // 2)] += g1 - g0

    # Adam's device time: the work of the launches made inside its ranges,
    # joined by correlation id.
    corr = defaultdict(int)
    for s, e, _, c in dev:
        corr[c] += e - s
    launches.sort()
    at = [t for t, _ in launches]
    adam_s = []
    for s, e, n in cpu:
        if n == ADAM and w0 <= s <= w1:
            lo, hi = bisect.bisect_left(at, s), bisect.bisect_right(at, e)
            adam_s.append(sum(corr[c] for _, c in launches[lo:hi]) * 1e-9)

    top = lambda d: sorted(((k, v * 1e-9) for k, v in d.items()),
                           key=lambda kv: -kv[1])[:TOP]
    return Reduced(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                   device_ops=top(by_name), idle_gaps=top(idle),
                   kernels=kernels, adam_s=adam_s)


def _kernel_key(name: str) -> str:
    """A kernel's bare function name: 'void ns::forward_kernel<...>(...)'
    and '(anonymous namespace)::forward_kernel(...)' are 'forward_kernel'."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for sep in "(<":
        name = name.split(sep, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


def _host_op(cpu, starts, t) -> str:
    """The innermost host op running at t (latest start that contains t)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 400, -1), -1):
        s, e, name = cpu[j]
        if e >= t:
            return name
    return "host (no op)"
