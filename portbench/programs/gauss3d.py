"""The program path of 3D gaussians on one card: gaussiansplat_tpu_torch
driven through its own entry points (`render.render`,
`train.init_train_state`, `train.make_train_step`) on the inputs the
benchmark made, and the plain reference's side of the comparison
(portbench/reference/). The harness uses this file for a configuration
that names no program; portbench/README.md lists what a program file
gives.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
from gaussiansplat_tpu_torch.models.gaussians import PARAM_NAMES, GaussianModel
from gaussiansplat_tpu_torch.ops.camera import make_camera
from gaussiansplat_tpu_torch.render import render
from gaussiansplat_tpu_torch.train import init_train_state, make_train_step

from portbench import judge
from portbench.harness import Frame
from portbench.inputs import Inputs, Pose, ref_camera, sub_seed
from portbench.reference import oracle, scenes
from portbench.reference import render as R
from portbench.reference import train as ref_train

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


def load_kernels() -> None:
    """Build what is missing of the port's five CUDA kernels (nvcc, all at
    once, into the port's _build/ inside the checkout) and load every
    library."""
    from gaussiansplat_tpu_torch.ops.kernels.backward import BACKWARD
    from gaussiansplat_tpu_torch.ops.kernels.build import build_all
    from gaussiansplat_tpu_torch.ops.kernels.expand import EXPAND
    from gaussiansplat_tpu_torch.ops.kernels.forward import FORWARD
    from gaussiansplat_tpu_torch.ops.kernels.gather import GATHER
    from gaussiansplat_tpu_torch.ops.kernels.segreduce import SEGREDUCE

    for k in build_all([EXPAND, FORWARD, BACKWARD, SEGREDUCE, GATHER]):
        k.fn()


# --- inputs -----------------------------------------------------------------

def scene(config: dict, seed: int, device):
    """(params, alive): the configuration's scene, drawn from the seed."""
    sc = config["scene"]
    if sc["kind"] == "bench":
        s = sc["sizing"]
        return scenes.bench_scene(sub_seed(seed, 0), sc["n"], sc["sh_degree"],
                                  sc["opacity"], sc["scale_range"],
                                  s["width"], s["height"], s["fx"],
                                  sc["sh_rest_std"], device)
    if sc["kind"] == "quality":
        return scenes.quality_init(seed, sc["init_points"], sc["capacity"],
                                   sc["sh_degree"], sc["init_opacity"], device)
    raise ValueError(f"unknown scene kind {sc['kind']!r}")


def targets(config: dict, tr: dict, params, alive, poses, seed: int,
            device):
    """A training target for each view, rendered by the reference."""
    rc = R.Raster.from_dict(config["raster"])
    kind = tr["targets"]["kind"]
    if kind == "sh_dc_noise":
        g = torch.Generator(device=device)
        g.manual_seed(sub_seed(seed, 4))
        src = dict(params)
        src["sh_dc"] = params["sh_dc"] + tr["targets"]["std"] * torch.randn(
            params["sh_dc"].shape, generator=g, device=device)
        deg, dense = tr["sh_degree"], False
    elif kind == "ground_truth":
        gt = config["ground_truth"]
        src, alive = scenes.quality_gt(seed, gt["n_points"], gt["sh_degree"],
                                       device)
        deg, dense = gt["sh_degree"], True
    else:
        raise ValueError(f"unknown targets kind {kind!r}")
    out = []
    with R.fp32_math():
        for pose in poses:
            cam = ref_camera(pose, device)
            proj = R.project(src, alive, cam, rc, deg)
            if dense:
                img = oracle.render_dense(proj, cam, rc)[0]
            else:
                img = R.render(proj, cam, rc)[0]
            out.append(img.contiguous())
    return out


# --- the program --------------------------------------------------------------

def model(inputs: Inputs, device) -> GaussianModel:
    """The program's model: its own copy of the initial parameters."""
    return GaussianModel(**{k: inputs.params[k].clone() for k in PARAM_NAMES},
                         alive=inputs.alive.clone()).to(device)


def camera(pose: Pose, device):
    return make_camera(pose.R, pose.t, pose.fx, pose.fy, pose.width,
                       pose.height, cx=pose.cx, cy=pose.cy, device=device)


@dataclasses.dataclass
class Server:
    model: GaussianModel
    cfg: RasterConfig


def serve_setup(cell, inputs: Inputs, device) -> Server:
    return Server(model=model(inputs, device), cfg=raster_config(cell.config))


def serve_call(server: Server, pose: Pose, device) -> Frame:
    """One frame of `pose`, as a viewer asks for it."""
    with torch.inference_mode():
        out = render(server.model, camera(pose, device), server.cfg)
    return Frame(keep=(out.image, out.transmittance), overflow=out.overflow,
                 num_pairs=out.num_pairs)


@dataclasses.dataclass
class Trainer:
    """One training state and its step, as the program builds them."""

    state: object
    step: object
    model: GaussianModel
    cameras: list


def train_setup(cell, inputs: Inputs, device) -> Trainer:
    m = model(inputs, device)
    state = init_train_state(m, train_config(cell.config), inputs.extent)
    return Trainer(state=state,
                   step=make_train_step(raster_config(cell.config),
                                        train_config(cell.config)),
                   model=m, cameras=[camera(p, device) for p in inputs.poses])


def train_call(tr: Trainer, inputs: Inputs, k: int) -> dict:
    """Step k (from 0) of the cell: view inputs.order[k]. The step's
    metrics, 0-d tensors on the device, `loss` and `overflow` among them."""
    v = inputs.order[k]
    tr.state, met = tr.step(tr.state, tr.cameras[v], inputs.targets[v],
                            inputs.sh_degree)
    return met


def first_steps(tr: Trainer, cell, inputs: Inputs, steps: int) -> dict:
    """The cell's first `steps` steps through the window's own call, and
    what the comparison reads of them: each loss, each leaf's first
    gradient as Adam holds it after one step (exp_avg / (1 - beta1)), and
    each leaf's change after the steps."""
    beta1 = cell.config["train"]["beta1"]
    opt = tr.state.optimizer
    losses, grad_norms = [], {}
    t0 = time.perf_counter()
    for k in range(steps):
        met = train_call(tr, inputs, k)
        losses.append(float(met["loss"]))
        if k == 0:
            first_s = time.perf_counter() - t0
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


# --- the reference's side -------------------------------------------------------

def serve_check(cell, inputs: Inputs, kept, count: bool, device):
    """(numbers, counts): each kept frame [(request index, (image,
    transmittance))] against the reference's render of its pose, and the
    reference's raster counts of each (with `count`)."""
    rc = R.Raster.from_dict(cell.config["raster"])
    compared, counts = [], []
    with R.fp32_math():
        for idx, (img, trans) in kept:
            cam = ref_camera(inputs.poses[idx % len(inputs.poses)], device)
            proj = R.project(inputs.params, inputs.alive, cam, rc,
                             inputs.sh_degree)
            ri, rt, cnt = R.render(proj, cam, rc, inputs.background,
                                   count=count)
            compared.append((img, trans, ri, rt))
            counts.append(cnt)
    return judge.serve_numbers(compared), counts


def follow(cell, inputs: Inputs, device, **kw) -> dict:
    """The reference following the cell's first steps (`kw`: the control's
    payload_dtype, the half_batch fault, count)."""
    steps = cell.traffic["follow_steps"]
    views = [(ref_camera(inputs.poses[v], device), inputs.targets[v],
              inputs.background) for v in inputs.order[:steps]]
    return ref_train.follow(inputs.params, inputs.alive, views,
                            R.Raster.from_dict(cell.config["raster"]),
                            cell.config["train"], inputs.sh_degree,
                            inputs.extent, steps, **kw)


def train_check(cell, inputs: Inputs, got: dict, count: bool, device):
    """(numbers, reference): the first steps `got` against the reference
    following them; the reference's readings hold each step's raster
    counts under 'counts' (with `count`)."""
    want = follow(cell, inputs, device, count=count)
    return judge.train_numbers(got, want), want


def control(cell, inputs: Inputs, seed: int, device) -> dict:
    """The numbers of the control (the reference with the raster payload
    rounded to bfloat16) and, in training, of the half-batch fault, each
    put in the program's place (portbench/control.py)."""
    if cell.traffic["kind"] == "train":
        want = follow(cell, inputs, device)
        return dict(
            control=judge.train_numbers(
                follow(cell, inputs, device, payload_dtype=torch.bfloat16),
                want),
            half_batch=judge.train_numbers(
                follow(cell, inputs, device, half_batch=True), want))
    # compare_frames poses drawn from the seed among the first 256 of the
    # cell's request sequence.
    rc = R.Raster.from_dict(cell.config["raster"])
    rng = np.random.default_rng(sub_seed(seed, 6))
    idx = rng.choice(min(256, len(inputs.poses)),
                     cell.traffic["compare_frames"], replace=False)
    frames = []
    with R.fp32_math():
        for i in sorted(idx.tolist()):
            cam = ref_camera(inputs.poses[i], device)
            proj = R.project(inputs.params, inputs.alive, cam, rc,
                             inputs.sh_degree)
            ri, rt, _ = R.render(proj, cam, rc, inputs.background)
            bf = R.round_fields(proj["fields"], torch.bfloat16)
            ci, ct, _ = R.render(proj, cam, rc, inputs.background, fields=bf)
            frames.append((ci, ct, ri, rt))
    return dict(control=judge.serve_numbers(frames))
