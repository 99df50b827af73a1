"""PLY interop for the gaussian model."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.ply import load_gaussian_ply, save_gaussian_ply
from ..models.gaussians import from_arrays


def export_ply(path: str, model) -> int:
    """Write the alive gaussians as an INRIA-format PLY. Returns the number
    written."""
    alive = model.alive.detach().cpu().numpy()
    idx = np.nonzero(alive)[0]
    get = lambda a: a.detach().cpu().numpy()[idx]
    save_gaussian_ply(
        path, get(model.means), get(model.quats), get(model.log_scales),
        get(model.logit_opacities), get(model.sh_dc), get(model.sh_rest),
    )
    return len(idx)


def import_ply(path: str, capacity: Optional[int] = None, device="cuda"):
    """Load an INRIA-format PLY into a GaussianModel on `device`."""
    return from_arrays(*load_gaussian_ply(path), capacity=capacity,
                       device=device)
