"""exchange_roofline.train: the payload exchange's share of its link
roofline. The bound is the off-card bytes of the step's two `all_to_all`s
(counter `exchange_bytes` of `gs.exchange` and `gs.exchange.bwd`: (D-1)/D
of each send buffer, `utils/comm_bytes.py`'s convention) at the link
peak below; the time is the device time of those two spans, the
collective's kernels with any wait for a peer. The NCCL kernels run on
NCCL's own stream; the spans' events, on the step's stream, bracket them
from the step's hand-over to its wait for them. (The window's trace keeps
only its ten longest kernel names, which at 32M leave the NCCL kernels
out, so their own time cannot be read there.) Over the traced window's
steps, bytes and time each summed over the ranks; none off CUDA or where
the program records no `exchange_bytes`. Moves train_steps_per_s.
"""

from portbench.metrics import _spans

# The per-direction link peak of each of the four cards: `nvidia-smi
# nvlink -s` on the four-card H100 machine reads 18 NVLink 4 links of
# 26.562 GB/s on every card (`nvidia-smi topo -m` does not run there).
# NVIDIA's data sheet gives 450 GB/s a direction; the larger figure keeps
# the share from being overstated.
LINK_PEAK_BYTES_PER_S = 18 * 26.5625e9
SPANS = ("gs.exchange", "gs.exchange.bwd")


def read(run):
    moved, seconds = 0, 0.0
    for r in run.ranks:
        calls = _spans.window_calls(r, "train")
        if calls is None or any(c.ms is None for c in calls):
            return None
        moved += sum(c.counter("exchange_bytes") for c in calls)
        seconds += 1e-3 * sum(c.self_ms(n) for c in calls for n in SPANS)
    if moved <= 0 or seconds <= 0:
        return None
    return 100.0 * moved / LINK_PEAK_BYTES_PER_S / seconds
