"""The numbers that decide `correct`, each held to the limit in the cell's
limits file (portbench/limits/<workload>.json).

Serving (every sampled frame against the reference's render of its pose):
  image_tile_mae   the worst 32x32-pixel block's mean |difference| of the
                   RGB image, over the sampled frames;
  trans_tile_mae   the same for the final transmittance.
A block's mean is deaf to a single pixel whose alpha sits on the alpha_min
edge in one side's rounding, and hears a block rendered wrong.

Training (the first steps against the reference following them):
  loss_gap         max over the steps of |loss - reference| / reference;
  grad_gap         max over the leaves of the gap between the norms of the
                   program's and the reference's first gradient, over the
                   reference's norm of that leaf or of the median leaf,
                   whichever is larger;
  change_gap       the same for each leaf's change over the steps, over the
                   leaves whose reference gradient is at least 1e-3 of the
                   median leaf's (a leaf the loss does not reach moves by
                   round-off alone).
Both kinds also hold the program's own guarantee `overflow_calls` (calls
that dropped pairs for capacity) and `nonfinite_calls` to 0.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

import torch

BLOCK = 32


def block_mae_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """Worst BLOCK x BLOCK block's mean |a - b| of (H, W[, C]) images."""
    d = (a.float() - b.float()).abs()
    if d.ndim == 2:
        d = d[..., None]
    if not bool(torch.isfinite(d).all()):
        return math.inf
    h, w, c = d.shape
    ph, pw = -h % BLOCK, -w % BLOCK
    d = torch.nn.functional.pad(d, (0, 0, 0, pw, 0, ph))
    cnt = torch.nn.functional.pad(torch.ones((h, w, 1), device=d.device),
                                  (0, 0, 0, pw, 0, ph))
    blocks = lambda x: x.reshape((h + ph) // BLOCK, BLOCK, (w + pw) // BLOCK,
                                 BLOCK, x.shape[-1]).sum((1, 3, 4))
    return float((blocks(d) / (blocks(cnt) * c)).max())


def serve_numbers(frames) -> Dict[str, float]:
    """frames: [(image, trans, ref_image, ref_trans)]."""
    img = max(block_mae_max(a, ra) for a, _, ra, _ in frames)
    tr = max(block_mae_max(t, rt) for _, t, _, rt in frames)
    return dict(image_tile_mae=img, trans_tile_mae=tr)


def _worst_leaf(got: Dict[str, float], want: Dict[str, float], leaves) -> float:
    floor = statistics.median(want[k] for k in leaves)
    gaps = [abs(got[k] - want[k]) / max(want[k], floor) for k in leaves]
    return math.inf if any(map(math.isnan, gaps)) else max(gaps)


def train_numbers(got: dict, want: dict) -> Dict[str, float]:
    """got, want: {'losses', 'grad_norms', 'change_norms'}."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    g = want["grad_norms"]
    leaves = sorted(g)
    moved = [k for k in leaves if g[k] >= 1e-3 * statistics.median(g.values())]
    return dict(
        loss_gap=math.inf if math.isnan(loss) else loss,
        grad_gap=_worst_leaf(got["grad_norms"], g, leaves),
        change_gap=_worst_leaf(got["change_norms"], want["change_norms"], moved),
    )


def check(numbers: Dict[str, float], limits: dict) -> Tuple[bool, dict]:
    """Each number beside its limit; correct when none is over."""
    checks = {}
    for name, value in numbers.items():
        limit = limits[name]["limit"]
        checks[name] = dict(value=value, limit=limit)
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
