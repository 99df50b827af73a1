"""Checkpoint / resume of the training state, and PLY interop.

A checkpoint is a directory `step_<8 digits>` holding `state.pt`, written
by `torch.save` and read back with `torch.load(weights_only=True)`: the
model's parameters and `alive` mask, the optimizer's `state_dict` (Adam
moments and step counts), the densification statistics, the step, the
scene extent and the state of the train state's `torch.Generator`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

_STATE_FILE = "state.pt"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, state, step: int) -> str:
    """Write the train state (train/trainer.TrainState) under
    `ckpt_dir/step_<step>`; returns that directory."""
    path = _step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    d = state.densify
    payload = dict(
        model=state.model.state_dict(),
        optimizer=state.optimizer.state_dict(),
        densify=dict(grad2d_sum=d.grad2d_sum, grad2d_count=d.grad2d_count,
                     max_radii=d.max_radii),
        step=int(state.step),
        extent=float(state.extent),
        generator=state.generator.get_state(),
    )
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, template, step: Optional[int] = None):
    """Restore the checkpoint of `step` (default: the latest) into
    `template`, a train state with the same shapes (e.g. from
    `init_train_state`), in place: its model's parameters are overwritten,
    so its optimizer keeps holding them. Returns (state, step), or
    (template, None) when there is no checkpoint."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return template, None
    payload = torch.load(os.path.join(_step_dir(ckpt_dir, step), _STATE_FILE),
                         map_location="cpu", weights_only=True)
    template.model.load_state_dict(payload["model"])
    template.optimizer.load_state_dict(payload["optimizer"])
    d = template.densify
    for name, value in payload["densify"].items():
        getattr(d, name).copy_(value)
    template.step = payload["step"]
    template.extent = payload["extent"]
    template.generator.set_state(payload["generator"])
    return template, step


def export_ply(path: str, model) -> int:
    """Write the alive gaussians as an INRIA-format PLY. Returns the number
    written."""
    # The PLY and model imports wait for the call: the ops modules import
    # utils (for its spans), and data and models import ops.
    from ..data.ply import save_gaussian_ply

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
    from ..data.ply import load_gaussian_ply
    from ..models.gaussians import from_arrays

    return from_arrays(*load_gaussian_ply(path), capacity=capacity,
                       device=device)
