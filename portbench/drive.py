"""The system under test: gaussiansplat_tpu_torch, driven through its own
entry points (`render.render`, `train.init_train_state`,
`train.make_train_step`) on the inputs the benchmark made.

The window loops are closed: one viewer asks for the next frame when the
last is on the host's side of `synchronize()`; one trainer calls the next
step when the last call returns. Nothing compiles inside them: the caller
warms every shape first.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
from gaussiansplat_tpu_torch.models.gaussians import PARAM_NAMES, GaussianModel
from gaussiansplat_tpu_torch.ops.camera import make_camera
from gaussiansplat_tpu_torch.render import render
from gaussiansplat_tpu_torch.train import init_train_state, make_train_step

from .inputs import Inputs, Pose, sync

# TrainConfig fields the configuration files state.
TRAIN_FIELDS = ("iterations", "ssim_lambda", "lr_means", "lr_means_final",
                "lr_quats", "lr_scales", "lr_opacities", "lr_sh_dc",
                "lr_sh_rest")


def raster_config(config: dict) -> RasterConfig:
    names = {f.name for f in dataclasses.fields(RasterConfig)}
    return RasterConfig(**{k: v for k, v in config["raster"].items()
                           if k in names})


def train_config(config: dict) -> TrainConfig:
    return TrainConfig(**{k: config["train"][k] for k in TRAIN_FIELDS})


def kernels():
    """The port's four CUDA kernels (launch counters included)."""
    from gaussiansplat_tpu_torch.ops.kernels.backward import BACKWARD
    from gaussiansplat_tpu_torch.ops.kernels.expand import EXPAND
    from gaussiansplat_tpu_torch.ops.kernels.forward import FORWARD
    from gaussiansplat_tpu_torch.ops.kernels.segreduce import SEGREDUCE

    return [EXPAND, FORWARD, BACKWARD, SEGREDUCE]


def load_kernels() -> None:
    """Build what is missing (nvcc, all at once, into the port's _build/
    inside the checkout) and load every library."""
    from gaussiansplat_tpu_torch.ops.kernels.build import build_all

    for k in build_all(kernels()):
        k.fn()


def model(inputs: Inputs, device) -> GaussianModel:
    """The program's model: its own copy of the initial parameters."""
    return GaussianModel(**{k: inputs.params[k].clone() for k in PARAM_NAMES},
                         alive=inputs.alive.clone()).to(device)


def camera(pose: Pose, device):
    return make_camera(pose.R, pose.t, pose.fx, pose.fy, pose.width,
                       pose.height, cx=pose.cx, cy=pose.cy, device=device)


@dataclasses.dataclass
class ServeWindow:
    latencies_s: List[float]
    window_s: float
    kept: list              # [(frame index, image, transmittance)]
    num_pairs: torch.Tensor
    overflow: torch.Tensor


def serve_frame(m: GaussianModel, pose: Pose, cfg: RasterConfig, device):
    with torch.inference_mode():
        return render(m, camera(pose, device), cfg)


def serve_window(m, poses: List[Pose], first: int, cfg, seconds: float,
                 keep: int, rng: np.random.Generator, device,
                 on_start=None) -> ServeWindow:
    """Frames of poses[first:] until `seconds` have passed. `keep` frames,
    a uniform sample of all that the window completes (reservoir sampling
    from `rng`), are kept for the comparison."""
    lat, pairs, over = [], [], []
    kept: Dict[int, tuple] = {}
    sync(device)
    if on_start is not None:
        on_start()
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        ts = time.perf_counter()
        out = serve_frame(m, poses[(first + i) % len(poses)], cfg, device)
        sync(device)
        te = time.perf_counter()
        lat.append(te - ts)
        pairs.append(out.num_pairs)
        over.append(out.overflow)
        slot = i if i < keep else int(rng.integers(0, i + 1))
        if slot < keep:
            kept[slot] = (first + i, out.image.clone(), out.transmittance.clone())
        i += 1
        if te >= deadline:
            break
    return ServeWindow(latencies_s=lat, window_s=te - t0,
                       kept=sorted(kept.values(), key=lambda k: k[0]),
                       num_pairs=torch.stack(pairs), overflow=torch.stack(over))


@dataclasses.dataclass
class Trainer:
    """One training state and its step, as the program builds them."""

    state: object
    step: object
    model: GaussianModel
    cameras: list


def trainer(inputs: Inputs, config: dict, device) -> Trainer:
    m = model(inputs, device)
    state = init_train_state(m, train_config(config), inputs.extent)
    return Trainer(state=state,
                   step=make_train_step(raster_config(config),
                                        train_config(config)),
                   model=m, cameras=[camera(p, device) for p in inputs.poses])


def train_call(tr: Trainer, inputs: Inputs, k: int):
    """Step k (from 0) of the cell: view inputs.order[k]."""
    v = inputs.order[k]
    tr.state, met = tr.step(tr.state, tr.cameras[v], inputs.targets[v],
                            inputs.sh_degree)
    return met


def first_steps(tr: Trainer, inputs: Inputs, config: dict,
                steps: int) -> dict:
    """The cell's first `steps` steps through the window's own call, and
    what the comparison reads of them: each loss, each leaf's first
    gradient as Adam holds it after one step (exp_avg / (1 - beta1)), and
    each leaf's change after the steps."""
    beta1 = config["train"]["beta1"]
    opt = tr.state.optimizer
    losses, grad_norms = [], {}
    t0 = time.perf_counter()
    for k in range(steps):
        met = train_call(tr, inputs, k)
        losses.append(float(met["loss"]))
        if k == 0:
            first_s = time.perf_counter() - t0
        if k == 0:
            for group in opt.param_groups:
                st = opt.state.get(group["params"][0], {})
                g = st["exp_avg"] / (1 - beta1) if "exp_avg" in st else None
                grad_norms[group["name"]] = (
                    0.0 if g is None else float(torch.linalg.vector_norm(g)))
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(
            getattr(tr.model, k) - inputs.params[k])) for k in PARAM_NAMES}
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change,
                first_step_s=first_s)


@dataclasses.dataclass
class TrainWindow:
    steps: int
    window_s: float
    overflow: torch.Tensor
    losses: torch.Tensor


def train_window(tr: Trainer, inputs: Inputs, first: int, seconds: float,
                 device, on_start=None) -> TrainWindow:
    """Steps first, first + 1, ... issued until `seconds` have passed, then
    the device drained: the window ends when the last step is done."""
    over, losses = [], []
    sync(device)
    if on_start is not None:
        on_start()
    n = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        met = train_call(tr, inputs, first + n)
        over.append(met["overflow"])
        losses.append(met["loss"])
        n += 1
    sync(device)
    return TrainWindow(steps=n, window_s=time.perf_counter() - t0,
                       overflow=torch.stack(over), losses=torch.stack(losses))
