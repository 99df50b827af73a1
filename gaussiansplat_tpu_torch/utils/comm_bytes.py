"""Collective-communication accounting of the sharded paths.

The counterpart of the reference's `utils/hlo_comm.py`. There is no
compiled HLO to read here, so the collective helpers of `parallel/mesh.py`
report every call to the counters that are active (`count_collectives`),
and the bytes are summed with the same per-device conventions, counting
only bytes that leave the device:

  * all-to-all, local operand B bytes: (D-1)/D * B (the diagonal block
    stays local).
  * collective-permute, operand B: B for every pair that sends it to
    another rank.
  * all-reduce, operand B: 2 * (D-1)/D * B (ring all-reduce:
    reduce-scatter + all-gather).
  * all-gather, output B: (D-1)/D * B.
  * reduce-scatter, input B: (D-1)/D * B.
  * broadcast, operand B: (D-1)/D * B (a pipelined ring broadcast: every
    rank but the last forwards B). The reference has no broadcast: its
    replicated results are psums.

D is the size of the group the collective ran over. These are the
standard ring-schedule volumes; NCCL and gloo may choose other schedules,
so the figures are volumes, not a trace of the wire.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Tuple

ALL_TO_ALL = "all-to-all"
PERMUTE = "collective-permute"
ALL_REDUCE = "all-reduce"
ALL_GATHER = "all-gather"
REDUCE_SCATTER = "reduce-scatter"
BROADCAST = "broadcast"

# The counters that record, innermost last (`count_collectives`).
_ACTIVE: List["CommCounter"] = []


def _factor(op: str, n: int) -> float:
    frac = (n - 1) / n
    return {ALL_TO_ALL: frac, PERMUTE: 1.0, ALL_REDUCE: 2.0 * frac,
            ALL_GATHER: frac, REDUCE_SCATTER: frac, BROADCAST: frac}[op]


def collective_bytes(records: Iterable[Tuple], n_devices: int) -> Dict[str, int]:
    """Per-device off-chip traffic by collective type, in bytes.

    `records` are (op, bytes) or (op, bytes, group_size) tuples, the bytes
    being the quantity the module docstring's convention names (operand,
    or the output of an all-gather); a record without a group size ran
    over `n_devices`. Returns one entry per op type present plus "total",
    as `gaussiansplat_tpu/utils/hlo_comm.collective_bytes` does."""
    out: Dict[str, int] = {}
    total = 0.0
    for rec in records:
        op, nbytes = rec[0], rec[1]
        n = rec[2] if len(rec) > 2 else n_devices
        b = nbytes * _factor(op, n)
        out[op] = out.get(op, 0) + int(round(b))
        total += b
    out["total"] = int(round(total))
    return out


class CommCounter:
    """The collectives recorded while the counter was active, as
    (op, bytes, group_size) records."""

    def __init__(self):
        self.records: List[Tuple[str, int, int]] = []

    def bytes(self) -> Dict[str, int]:
        """`collective_bytes` of the records (each with its group size)."""
        return collective_bytes(self.records, 1)


@contextlib.contextmanager
def count_collectives():
    """Record every collective that `parallel/mesh.py` issues inside the
    block (forward and backward alike) into the yielded `CommCounter`."""
    counter = CommCounter()
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.remove(counter)


def record(op: str, nbytes: int, group_size: int) -> None:
    """Called by the collective helpers for every collective they issue."""
    for counter in _ACTIVE:
        counter.records.append((op, int(nbytes), int(group_size)))


def compiled_collective_bytes(fn, n_devices: int, *args, **kwargs):
    """Run `fn(*args, **kwargs)` once under a counter and account its
    collectives. Returns (bytes_by_type, result). `n_devices` sizes the
    records of no group, as in `collective_bytes`; every helper records its
    own group's size."""
    with count_collectives() as counter:
        result = fn(*args, **kwargs)
    return collective_bytes(counter.records, n_devices), result
