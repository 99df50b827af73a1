"""Densification statistics of adaptive density control.

The trainer accumulates, per gaussian slot, the norm of the loss gradient
with respect to its screen-space centre (the gradient of the zero
`mean2d_offset` that `render` takes), the number of steps it was visible
and its largest screen radius. Clone, split, prune and opacity reset, which
read these statistics, are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class DensifyState:
    """Running densification statistics, reset after every densify step."""

    grad2d_sum: torch.Tensor    # (C,) f32 sum of ||d loss / d mean2d|| over steps
    grad2d_count: torch.Tensor  # (C,) int32 steps where the gaussian was visible
    max_radii: torch.Tensor     # (C,) int32 max screen radius since the last reset

    @classmethod
    def zeros(cls, capacity: int, device="cuda") -> "DensifyState":
        return cls(
            grad2d_sum=torch.zeros((capacity,), dtype=torch.float32, device=device),
            grad2d_count=torch.zeros((capacity,), dtype=torch.int32, device=device),
            max_radii=torch.zeros((capacity,), dtype=torch.int32, device=device),
        )

    @torch.no_grad()
    def update(self, grad2d: torch.Tensor, radii: torch.Tensor) -> "DensifyState":
        """Accumulate one step, in place: grad2d (C, 2) loss gradient w.r.t.
        screen position; radii (C,) int32 screen radii (0 = invisible).
        Returns self."""
        visible = radii > 0
        norm = torch.linalg.vector_norm(grad2d, dim=-1)
        self.grad2d_sum += torch.where(visible, norm, torch.zeros_like(norm))
        self.grad2d_count += visible.to(torch.int32)
        torch.maximum(self.max_radii, radii.to(torch.int32), out=self.max_radii)
        return self
