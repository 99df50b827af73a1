"""Fail-fast training resilience: restart from the last checkpoint.

A transient runtime error (an out-of-memory, a lost or preempted worker)
costs at most `checkpoint_every` steps of work instead of the run: the
wrapper reruns the fit with `resume=True`, which continues from the newest
checkpoint. Genuine bugs propagate at once.

`is_transient` classifies by exception type first, then by the XLA status
words of the reference (`TRANSIENT_MARKERS`, matched as whole words), so
an error that carries one of those words classifies as it does there:

* transient: `torch.OutOfMemoryError` (the caching allocator's
  out-of-memory, `torch.cuda.OutOfMemoryError`; XLA's RESOURCE_EXHAUSTED),
  `torch.distributed.DistNetworkError` (a peer lost or unreachable;
  UNAVAILABLE) and `DistStoreError` (a store timeout; DEADLINE_EXCEEDED);
* never transient, whatever the text: `torch.AcceleratorError`, a CUDA
  error that poisons the process's context (an illegal address, a
  device-side assert, a launch failure): no call in this process can
  succeed after it. Nor `torch.distributed.DistBackendError`, a failed or
  aborted NCCL communicator: `fit` would run again on the same process
  group, and an aborted communicator cannot be used again; the process
  must exit and be restarted by its launcher, which is the fail-fast path.

Whole words keep cuBLAS's `CUBLAS_STATUS_INTERNAL_ERROR` from reading as
XLA's INTERNAL.
"""

from __future__ import annotations

import gc
import re
import time
import traceback
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "ABORTED",
    "INTERNAL",
    "DEADLINE_EXCEEDED",
    "preempted",
)

NEVER_TRANSIENT = (torch.AcceleratorError, dist.DistBackendError)
TRANSIENT = (torch.OutOfMemoryError, dist.DistNetworkError, dist.DistStoreError)

_MARKERS = re.compile(r"\b(?:" + "|".join(TRANSIENT_MARKERS) + r")\b")


def is_transient(exc: BaseException) -> bool:
    if isinstance(exc, NEVER_TRANSIENT):
        return False
    if isinstance(exc, TRANSIENT):
        return True
    return _MARKERS.search(f"{type(exc).__name__}: {exc}") is not None


def _release(exc: BaseException) -> None:
    """Drop the locals of the failed attempt's finished frames (its train
    state, activations and optimizer), along the exception's chain."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        traceback.clear_frames(exc.__traceback__)
        exc = exc.__cause__ or exc.__context__


def run_resilient(
    fit: Callable[..., Tuple],
    *args,
    max_restarts: int = 3,
    backoff_s: float = 5.0,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
    **kwargs,
):
    """Run `fit(*args, resume=..., **kwargs)` with restart-on-transient-error.

    `fit` must accept a `resume` keyword (as Trainer.fit does) so each retry
    continues from the newest checkpoint rather than step 0. Non-transient
    errors propagate immediately. Before a retry, what the failed attempt
    held is let go (its frames, then the allocator's cached blocks), so the
    retry has the card's memory as the first attempt had it.
    """
    attempt = 0
    while True:
        try:
            return fit(*args, resume=(attempt > 0) or kwargs.pop("resume", False),
                       **kwargs)
        except Exception as exc:  # noqa: BLE001 - filtered via is_transient
            if not is_transient(exc) or attempt >= max_restarts:
                raise
            attempt += 1
            if on_restart is not None:
                on_restart(attempt, exc)
            else:
                traceback.print_exc()
                print(f"[resilience] transient failure; restart {attempt}/"
                      f"{max_restarts} after {backoff_s:.0f}s")
            _release(exc)
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        time.sleep(backoff_s)
