"""Fail-fast training resilience: restart from the last checkpoint.

A transient runtime error (an out-of-memory, a lost or preempted worker)
costs at most `checkpoint_every` steps of work instead of the run: the
wrapper reruns the fit with `resume=True`, which continues from the newest
checkpoint. Genuine bugs propagate at once.
"""

from __future__ import annotations

import time
import traceback
from typing import Callable, Optional, Tuple

TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "ABORTED",
    "INTERNAL",
    "DEADLINE_EXCEEDED",
    "preempted",
)


def is_transient(exc: BaseException) -> bool:
    msg = f"{type(exc).__name__}: {exc}"
    return any(m in msg for m in TRANSIENT_MARKERS)


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
    errors propagate immediately.
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
            time.sleep(backoff_s)
