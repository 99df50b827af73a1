"""HBM capacity math of the gauss-sharded training step on one H100.

For the gaussian-axis-sharded path (parallel/gauss_shard.py) this module
answers in closed form: at a given (N gaussians, gauss-mesh size, SH
degree, image size), what does each card hold, what `send_cap` does the
strip all_to_all need, and does the whole training step fit in a card's
memory? It also gives the collective bytes a step moves
(`ici_bytes_per_step`, `ici_bytes_per_step_ring`), which the counter of
`utils/comm_bytes.py` measures equal on a real step.

The byte counts are those of the arrays this port allocates: the model's
parameters with its bool `alive` buffer, the Adam moments of the six
parameter groups, the exchange's send and receive buffers, what the
projection keeps for its backward, and one strip's binning: its
compaction (the tile-survivor masks of every row it bins) and, after it,
its pair streams. The step's peak is in one of the two binning phases:
the pair streams where every gaussian is binned (one card), the
compaction where the strip bins the `n_strips x send_cap` rows of its
arrivals (several cards). `fits` applies a slack factor for the rest (the
pack's and the step's small temporaries, the allocator's rounding).

The slack is measured, not assumed: a rank's peak, decomposed by the
allocator's history, at 8M gaussians a card at 1920x1080, SH 3, on one
card and on four. No figure here comes from the reference's TPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

from ..config import RasterConfig
from ..ops.kernels.common import NOUT
from ..ops.sh import num_sh_coeffs

# The card these figures were measured on, as nvidia-smi names it.
HBM_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# The card's nominal memory, 80 GiB (the bisection's seed). PyTorch sees
# 85,017,493,504 B (79.18 GiB) of it on HBM_CARD.
HBM_NOMINAL_BYTES = 80 << 30
# Measured on HBM_CARD by chip_smoke.py's HBM phase: a 1920x1080 step at
# 23,497,129 gaussians fit and one at 24,115,474 ran out of memory, with
# the code of that time. The budget is the peak device memory
# (`torch.cuda.max_memory_allocated`) of the step that fit.
HBM_EFFECTIVE_BYTES = 76_613_107_712
# A rank's peak over `total_bytes`, at 8M gaussians a card, 1920x1080, SH
# 3 (less the inputs a harness holds beside the step): 42,612,352,000 B
# on each of four cards (32M, send_fraction 0.46), the larger reading, and
# 29,895,577,600 B on one card (ratio 0.96: there the exchange's buffers
# and the payload are not live at the peak).
HBM_SLACK = 1.0204

# Bytes a binned row holds at the peak of the binning's compaction
# (`ops/binning.compact_rects`): the tile-survivor mask's (rows,
# MASK_TILES) temporaries and the per-row rects. Measured equal on the
# card (the allocator's history) and on the CPU (the profiler).
_COMPACTION_ROW_BYTES = 1964
# Bytes a gaussian's projection keeps for its backward, the payload
# included (`ops/projection.project_gaussians`, `make_payload`, the model's
# SH concatenation), by SH degree: measured on the CPU by the profiler
# (650 at SH 3 against 636 on the card).
_PROJECTION_BYTES = {0: 314, 1: 394, 2: 486, 3: 650}

# Per-gaussian f32 channels of the model (models/gaussians.py): means 3 +
# quats 4 + log_scales 3 + logit_opacities 1 (+ the alive bool, 1 byte).
_BASE_CH = 11
# Payload channels exchanged per row (ops/projection.PAYLOAD_DIM).
_PAYLOAD_CH = 16


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Byte budget of one training step on one card of a gauss mesh."""

    n_gaussians: int
    n_devices: int
    sh_degree: int
    width: int
    height: int
    local_capacity: int        # gaussian slots owned per card
    send_cap: int              # exchange rows per (source, destination strip)
    params_bytes: int          # parameter shard and alive mask
    optimizer_bytes: int       # Adam exp_avg + exp_avg_sq
    exchange_bytes: int        # all_to_all send + receive buffers
    projection_bytes: int      # what the projection keeps for its backward
    raster_bytes: int          # strip binning streams, sorted payload, grads
    compaction_bytes: int      # the strip binning's compaction of its rows
    image_bytes: int           # K1/K2 blocks, gathered frame, target
    total_bytes: int           # the step's peak: the larger binning phase

    def fits(self, hbm_bytes: int = HBM_EFFECTIVE_BYTES,
             slack: float = HBM_SLACK) -> bool:
        """True if the step fits under `hbm_bytes` with `slack` headroom."""
        return self.total_bytes * slack <= hbm_bytes

    def summary(self) -> str:
        g = 1 << 30
        return (
            f"{self.n_gaussians / 1e6:.1f}M gaussians / {self.n_devices} chips"
            f" (sh{self.sh_degree}, {self.width}x{self.height}): "
            f"{self.local_capacity / 1e6:.2f}M per chip — params "
            f"{self.params_bytes / g:.2f} GiB, opt {self.optimizer_bytes / g:.2f}"
            f" GiB, exchange {self.exchange_bytes / g:.2f} GiB (send_cap "
            f"{self.send_cap}), projection {self.projection_bytes / g:.2f} "
            f"GiB, raster {self.raster_bytes / g:.2f} GiB or compaction "
            f"{self.compaction_bytes / g:.2f} GiB, image "
            f"{self.image_bytes / g:.2f} GiB -> total "
            f"{self.total_bytes / g:.2f} GiB"
        )


def arrival_pair_capacity(cfg: RasterConfig, n_strips: int,
                          send_cap: int) -> int:
    """The pair capacity of one strip's binning of the n_strips * send_cap
    arrivals: a 1/n_strips share with a 2x skew factor (scenes are never
    spread evenly over image rows), at least 4 chunks."""
    return max(2 * cfg.pair_capacity(n_strips * send_cap) // n_strips,
               4 * cfg.chunk_size)


def plan_gauss_sharded(
    n_gaussians: int,
    n_devices: int,
    width: int,
    height: int,
    sh_degree: int = 3,
    cfg: Optional[RasterConfig] = None,
    send_fraction: float = 0.5,
    with_optimizer: bool = True,
) -> CapacityPlan:
    """Closed-form per-card byte budget of gauss-sharded training.

    send_fraction bounds the share of a card's local gaussians that can
    land in one destination strip (`pack_by_strip` drops the rest and
    counts them); 0.5 is generous for scenes without a strong vertical
    concentration. A one-card mesh has one strip, which receives every
    visible gaussian: there the fraction is 1 whatever is asked (the
    reference's plan keeps the fraction asked, which drops rows at D = 1)."""
    cfg = cfg or RasterConfig()
    k = num_sh_coeffs(sh_degree)
    d = n_devices
    local = -(-n_gaussians // d)

    per_gauss_ch = _BASE_CH + 3 * k          # + flat SH (3K channels)
    params = local * (per_gauss_ch * 4 + 1)  # f32 channels + alive byte
    optimizer = 2 * local * per_gauss_ch * 4 if with_optimizer else 0

    send_cap = max(math.ceil(local * (1.0 if d == 1 else send_fraction)), 1)
    # send + receive buffers: (n_strips, send_cap, PAYLOAD_DIM) f32 each.
    exchange = 2 * d * send_cap * _PAYLOAD_CH * 4

    # One strip's binning of the arrivals (gauss_shard.render_gauss_sharded_
    # strip): the depth-ordered payload table, four i32 streams per pair
    # slot (keys, sorted tiles, ranks, pre-sort positions), and the sorted
    # payload K1 reads beside the gradient rows K2 writes.
    arrivals = d * send_cap
    pair_cap = arrival_pair_capacity(cfg, d, send_cap)
    raster = (arrivals * _PAYLOAD_CH * 4
              + pair_cap * 4 * 4
              + pair_cap * _PAYLOAD_CH * 4 * 2)
    # Before the pair streams exist, the compaction of the same rows.
    compaction = arrivals * _COMPACTION_ROW_BYTES
    projection = local * _PROJECTION_BYTES[sh_degree]

    # K1's output block and K2's cotangent block of the strip, the gathered
    # (padded) frame and transmittance, and the full target.
    ts = cfg.tile_size
    tiles_x = -(-width // ts)
    rows = -(-height // (d * ts))
    strip_px = rows * ts * tiles_x * ts
    image = (strip_px * NOUT * 2 + d * rows * ts * width * 4
             + height * width * 3) * 4

    total = (params + optimizer + exchange + projection
             + max(raster, compaction) + image)
    return CapacityPlan(
        n_gaussians=n_gaussians,
        n_devices=d,
        sh_degree=sh_degree,
        width=width,
        height=height,
        local_capacity=local,
        send_cap=send_cap,
        params_bytes=params,
        optimizer_bytes=optimizer,
        exchange_bytes=exchange,
        projection_bytes=projection,
        raster_bytes=raster,
        compaction_bytes=compaction,
        image_bytes=image,
        total_bytes=total,
    )


def ici_bytes_per_step(plan: CapacityPlan) -> int:
    """Collective bytes per card of one gauss-sharded training step's
    payload exchange (utils/comm_bytes.py conventions): the forward
    all_to_all sends every off-diagonal (send_cap, 16) f32 block, and the
    backward's reverse all_to_all the same again. The static buffer moves
    in full, unused rows included. Other collectives of a step (the strip
    gather, the metric reductions) are image- or scalar-sized and not
    counted here; `chip_smoke.py` and the tests hold this figure equal to
    the counter's `all-to-all` entry over one step."""
    return 2 * (plan.n_devices - 1) * plan.send_cap * _PAYLOAD_CH * 4


def ring_hops(n_devices: int) -> int:
    """Full-image hops of the depth ring: log2(D) doubling hops for a power
    of two, else D - 1 rotations (parallel/depth_ring.py)."""
    d = n_devices
    if d == 1:
        return 0
    return d.bit_length() - 1 if d & (d - 1) == 0 else d - 1


def ici_bytes_per_step_ring(
    n_gaussians: int,
    n_devices: int,
    width: int,
    height: int,
    slab_cap_factor: float = 2.0,
) -> int:
    """Collective bytes per card of one depth-ring render and its backward
    (parallel/depth_ring.py), utils/comm_bytes.py conventions:

      * the slab all_to_all, forward and backward: 2 (D-1) cap 64 B with
        cap = max(slab_cap_factor * local // D, 256), the render's default;
      * the ring: `ring_hops(D)` (C, logT) image permutes of W H 16 B,
        forward and backward (each permute's transpose is one permute);
      * the broadcast of rank 0's composite, (D-1)/D W H 16 B, forward
        only: its backward hands rank 0 its own cotangent and moves
        nothing;
      * the slab-bound histogram all-reduce, 2 (D-1)/D 512 * 4 B, forward
        only (slab routing carries no gradient).

    Two differences from the reference's closed form: it prices
    ceil(log2 D) hops for every D, where its ring (and this one) runs
    D - 1 rotations when D is not a power of two; and its composite is a
    psum, 2 (D-1)/D images each way, where this one is a broadcast."""
    d = n_devices
    local = -(-n_gaussians // d)
    cap = max(int(slab_cap_factor * local) // d, 256)
    frac = (d - 1) / d
    img = width * height * 4 * 4
    a2a = (d - 1) * cap * _PAYLOAD_CH * 4
    total = 2 * a2a + 2 * ring_hops(d) * img + frac * img + 2 * frac * 512 * 4
    return int(round(total))


def preferred_gauss_schedule(
    n_gaussians: int,
    n_devices: int,
    width: int,
    height: int,
    sh_degree: int = 3,
    cfg: Optional[RasterConfig] = None,
) -> dict:
    """Collective-volume rule between the two exact gaussian-axis
    schedules: strip routing (gauss_shard.py, pixels stationary) and the
    depth ring (depth_ring.py, the full grid on every card). Returns both
    byte counts and the one that moves fewer."""
    plan = plan_gauss_sharded(
        n_gaussians, n_devices, width, height, sh_degree, cfg)
    strip = ici_bytes_per_step(plan)
    ring = ici_bytes_per_step_ring(n_gaussians, n_devices, width, height)
    return dict(
        strip_bytes=strip,
        ring_bytes=ring,
        preferred="ring" if ring < strip else "strip",
    )


def predicted_weak_scaling(
    n_per_device: int,
    width: int,
    height: int,
    device_counts,
    step_ms_per_million: float,
    link_gbps: float,
    sh_degree: int = 3,
    cfg: Optional[RasterConfig] = None,
) -> list:
    """Predicted gauss-axis weak-scaling efficiency from a compute-vs-link
    byte model, with no overlap of the two.

    Per-card compute is fixed under weak scaling (the local shard size is
    constant); the growing term is the exchange volume, linear in
    (n_devices - 1) * send_cap. Both rates are the caller's:
    `step_ms_per_million`, a measured one-card step time per million
    gaussians at this resolution, and `link_gbps`, the per-direction rate
    of the links between cards in GB/s. Neither has been measured across
    cards for this port."""
    rows = []
    compute_ms = step_ms_per_million * n_per_device / 1e6
    for nd in device_counts:
        plan = plan_gauss_sharded(
            n_per_device * nd, nd, width, height, sh_degree, cfg)
        comm_ms = (ici_bytes_per_step(plan) / (link_gbps * 1e9)) * 1e3
        eff = compute_ms / (compute_ms + comm_ms)
        rows.append(dict(
            devices=nd,
            n_gaussians=n_per_device * nd,
            send_cap=plan.send_cap,
            ici_bytes_per_step=ici_bytes_per_step(plan),
            compute_ms=round(compute_ms, 2),
            comm_ms=round(comm_ms, 3),
            predicted_efficiency=round(eff, 4),
        ))
    return rows


def max_gaussians_per_chip(
    width: int,
    height: int,
    sh_degree: int = 3,
    hbm_bytes: int = HBM_EFFECTIVE_BYTES,
    cfg: Optional[RasterConfig] = None,
    with_optimizer: bool = True,
    slack: float = HBM_SLACK,
) -> int:
    """Largest single-card N whose training step fits (bisection over the
    closed-form budget with n_devices=1 and send_fraction=1)."""
    lo, hi = 1 << 16, 1 << 28
    while hi - lo > 1 << 16:
        mid = (lo + hi) // 2
        plan = plan_gauss_sharded(
            mid, 1, width, height, sh_degree, cfg,
            send_fraction=1.0, with_optimizer=with_optimizer,
        )
        if plan.fits(hbm_bytes, slack):
            lo = mid
        else:
            hi = mid
    return lo


def min_devices_for(
    n_gaussians: int,
    width: int,
    height: int,
    sh_degree: int = 3,
    hbm_bytes: int = HBM_EFFECTIVE_BYTES,
    cfg: Optional[RasterConfig] = None,
    max_devices: int = 4096,
) -> int:
    """Smallest power-of-two gauss-mesh size whose per-card step fits.

    Each strip bins all `D x send_cap = send_fraction x N` rows it may
    receive, so at a fixed fraction a card's compaction does not shrink
    with D: a D-card mesh is planned at send_fraction min(1, 2 / D), twice
    the share of an even strip (the default 0.5 at D = 4), and a render or
    step on that mesh needs the same."""
    d = 1
    while d <= max_devices:
        if plan_gauss_sharded(
            n_gaussians, d, width, height, sh_degree, cfg,
            send_fraction=min(1.0, 2.0 / d),
        ).fits(hbm_bytes):
            return d
        d *= 2
    raise ValueError(
        f"{n_gaussians} gaussians do not fit on {max_devices} devices"
    )


def bisect_ceiling(
    probe: Callable[[int], Optional[bool]],
    seed: int,
    max_probes: int,
    resolution: float = 0.03,
) -> dict:
    """Bracket the largest N that fits by out-of-memory probes.

    `probe(n)` returns True (the step ran), False (it ran out of device
    memory) or None (inconclusive: it failed otherwise, or timed out).
    An inconclusive probe moves neither end of the bracket; the next probe
    goes below it. The first probe is `seed` (the closed form's ceiling at
    the nominal memory); then steps of x1.25 up while everything fits, of
    x0.8 down while nothing has, and midpoints once both ends are known,
    until they are within `resolution` of each other. Returns `fit` (the
    largest N that ran, or None), `oom` (the smallest that ran out, or
    None) and `probes`, a list of (n, result)."""
    fit = oom = None
    probes: List[tuple] = []
    n = seed
    for _ in range(max_probes):
        result = probe(n)
        probes.append((n, result))
        if result is True:
            fit = n if fit is None else max(fit, n)
        elif result is False:
            oom = n if oom is None else min(oom, n)
        if fit is not None and oom is not None:
            if oom - fit <= resolution * fit:
                break
            n = (fit + n) // 2 if result is None else (fit + oom) // 2
        elif result is None:
            n = (fit + n) // 2 if fit is not None else int(n * 0.8)
        elif fit is not None:
            n = int(fit * 1.25)
        else:
            n = int(oom * 0.8)
    return dict(fit=fit, oom=oom, probes=probes)
