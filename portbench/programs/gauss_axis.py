"""The program path of the port's gaussian-axis sharding, one process a
card, for training cells: `parallel.make_gauss_mesh`,
`init_gauss_sharded_state` and `make_gauss_sharded_train_step` over
`make_gauss_sharded_render`, on the process group that
`parallel.multihost.initialize()` brings up from torchrun's environment
(NCCL on cards, gloo on the CPU). Each rank holds 1/D of every parameter
and its Adam moments and rasterizes one strip of the frame
(`parallel.strip_bounds`); the strips are gathered, so every rank holds the
whole frame.

The configuration states `send_fraction`, the share of a rank's block
that the exchange makes room for in one strip (`plan_gauss_sharded`); a
warm-up step that drops a payload row fails the run.

Inputs: every rank draws the whole scene from the seed (gauss3d's, its
cube of centres turned to the views: `scene`), so that each rank's block
is the whole scene's rows; the targets are
gauss3d's, rendered by reference/sharded_train.py, their views dealt over
the ranks (view v on rank v % D) and broadcast.

The reference's side follows the first steps once over the ranks
(reference/sharded_train.py deals its tile blocks over them): the
numbers of gauss3d, and `grad_block_gap`, each rank's block of the first
gradient against the reference's same rows. The control and the faults
(`control`) run in one process.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from gaussiansplat_tpu_torch.models.gaussians import PARAM_NAMES, GaussianModel
from gaussiansplat_tpu_torch.parallel import (
    GAUSS_AXIS,
    init_gauss_sharded_state,
    make_gauss_mesh,
    make_gauss_sharded_train_step,
    multihost,
    plan_gauss_sharded,
)

from portbench import judge
from portbench.inputs import ref_camera, sub_seed
from portbench.programs import gauss3d
from portbench.programs.gauss3d import (  # noqa: F401  (the program's names)
    camera,
    load_kernels,
    raster_config,
    train_config,
)
from portbench.reference import render as R
from portbench.reference import sharded_train


def orbit_start(seed: int) -> float:
    """The angle of the first view of an orbit of views, as portbench/
    inputs.py draws it: the first number of the seed's stream 1. The views
    follow at quarter turns (for four), in seeded order."""
    return float(np.random.default_rng(sub_seed(seed, 1)).uniform(
        0, 2 * math.pi))


def scene(config: dict, seed: int, device):
    """gauss3d's scene. A bench scene's cube of centres is turned about the
    vertical axis so that the orbit's first view meets a face of it head
    on, and so every view does: the cube's faces are a quarter turn apart,
    as the four views are. Drawn as it is, the cube would meet the views
    at the seed's angle, and the step's cost follows that angle. The
    rotations, scales, colours and SH bands are drawn alike in every
    direction, so only the centres are turned."""
    params, alive = gauss3d.scene(config, seed, device)
    if config["scene"]["kind"] != "bench":
        return params, alive
    # Turning by phi adds phi to every point's angle atan2(x, z) about the
    # vertical, as inputs.py's orbit_eye measures the views' angle.
    phi = orbit_start(seed)
    c, s = math.cos(phi), math.sin(phi)
    x, y, z = params["means"].unbind(-1)
    params["means"] = torch.stack((c * x + s * z, y, c * z - s * x), dim=-1)
    return params, alive


def _start(device) -> None:
    """Bring up this rank's process group (once)."""
    cuda = torch.device(device).type == "cuda"
    multihost.initialize(backend="nccl" if cuda else "gloo")


def targets(config: dict, tr: dict, params, alive, poses, seed: int, device):
    """gauss3d's targets (the reference's render of a copy of the scene
    with N(0, std^2) noise on the SH DC band), rendered by
    reference/sharded_train.py. On a rank of a job the views are dealt
    over the ranks and each target broadcast from the rank that rendered
    it; a lone process (the control) renders every view."""
    if tr["targets"]["kind"] != "sh_dc_noise":
        raise ValueError(f"unknown targets kind {tr['targets']['kind']!r}")
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 4))
    src = dict(params)
    src["sh_dc"] = params["sh_dc"] + tr["targets"]["std"] * torch.randn(
        params["sh_dc"].shape, generator=g, device=device)
    rc = R.Raster.from_dict(config["raster"])
    rank, world = 0, 1
    if "RANK" in os.environ:
        _start(device)
        rank, world = dist.get_rank(), dist.get_world_size()
    out = []
    for v, pose in enumerate(poses):
        if v % world == rank:
            t = sharded_train.image(src, alive, ref_camera(pose, device), rc,
                                    tr["sh_degree"]).contiguous()
        else:
            t = torch.empty((tr["height"], tr["width"], 3),
                            dtype=torch.float32, device=device)
        if world > 1:
            dist.broadcast(t, src=v % world)
        out.append(t)
    return out


def _mesh(device):
    _start(device)
    return make_gauss_mesh()


def _model(inputs) -> GaussianModel:
    """The whole scene as a model over the inputs' own tensors, for
    `init_gauss_sharded_state` to copy this rank's block from."""
    return GaussianModel(**{k: inputs.params[k] for k in PARAM_NAMES},
                         alive=inputs.alive)


def _plan(cell, inputs, nd: int):
    tr = cell.traffic
    return plan_gauss_sharded(int(inputs.alive.numel()), nd, tr["width"],
                              tr["height"], inputs.sh_degree,
                              raster_config(cell.config),
                              send_fraction=cell.config["send_fraction"])


# --- training ---------------------------------------------------------------

@dataclasses.dataclass
class Trainer:
    state: object
    step: object
    mesh: object
    cameras: list


def train_setup(cell, inputs, device) -> Trainer:
    mesh = _mesh(device)
    tr = cell.traffic
    rcfg, tcfg = raster_config(cell.config), train_config(cell.config)
    plan = _plan(cell, inputs, mesh.axis_size(GAUSS_AXIS))
    state = init_gauss_sharded_state(_model(inputs), mesh, tcfg, inputs.extent)
    step = make_gauss_sharded_train_step(mesh, rcfg, tcfg, tr["width"],
                                         tr["height"], inputs.sh_degree,
                                         send_cap=plan.send_cap)
    return Trainer(state=state, step=step, mesh=mesh,
                   cameras=[camera(p, device) for p in inputs.poses])


def train_call(tr: Trainer, inputs, k: int) -> dict:
    """Step k (from 0) of the cell: view inputs.order[k]."""
    v = inputs.order[k]
    tr.state, met = tr.step(tr.state, tr.cameras[v], inputs.targets[v])
    return met


def first_steps(tr: Trainer, cell, inputs, steps: int) -> dict:
    """gauss3d's readings, each a norm over every rank's block (squares
    summed over the ranks), and `grad_block`, this rank's block of the
    first gradient (Adam's exp_avg / (1 - beta1)) on the host. Raises when
    a step's exchange dropped payload rows."""
    beta1 = cell.config["train"]["beta1"]
    opt = tr.state.optimizer
    losses, grad_sq, block = [], {}, {}
    t0 = time.perf_counter()
    for k in range(steps):
        met = train_call(tr, inputs, k)
        losses.append(float(met["loss"]))
        dropped = int(met["pack_overflow"])
        if dropped:
            raise RuntimeError(
                f"step {k}: the exchange dropped {dropped} payload rows; "
                f"send_fraction {cell.config['send_fraction']} is too small "
                "for this scene and its views")
        if k == 0:
            first_s = time.perf_counter() - t0
            for group in opt.param_groups:
                g = opt.state[group["params"][0]]["exp_avg"] / (1 - beta1)
                grad_sq[group["name"]] = g.square().sum()
                block[group["name"]] = g.cpu()
    m = tr.state.model
    r0 = tr.mesh.axis_index(GAUSS_AXIS) * m.capacity
    with torch.no_grad():
        change_sq = {k: (getattr(m, k) - inputs.params[k][r0:r0 + m.capacity]
                         ).square().sum() for k in PARAM_NAMES}
    names = sorted(grad_sq)
    sq = torch.stack([grad_sq[k] for k in names]
                     + [change_sq[k] for k in PARAM_NAMES])
    dist.all_reduce(sq)
    norms = sq.sqrt().tolist()
    return dict(losses=losses, grad_norms=dict(zip(names, norms)),
                change_norms=dict(zip(PARAM_NAMES, norms[len(names):])),
                grad_block=block, first_step_s=first_s)


# --- the reference's side -------------------------------------------------------

def follow(cell, inputs, device, **kw) -> dict:
    """reference/sharded_train.py following the cell's first steps (`kw`:
    the control's payload_dtype, the half_batch fault, count, group,
    keep)."""
    steps = cell.traffic["follow_steps"]
    views = [(ref_camera(inputs.poses[v], device), inputs.targets[v],
              inputs.background) for v in inputs.order[:steps]]
    alive = kw.pop("alive", inputs.alive)
    return sharded_train.follow(inputs.params, alive, views,
                                R.Raster.from_dict(cell.config["raster"]),
                                cell.config["train"], inputs.sh_degree,
                                inputs.extent, steps, **kw)


def _blocks(n: int, nd: int):
    local = n // nd
    return [(r * local, (r + 1) * local) for r in range(nd)]


def train_check(cell, inputs, got: dict, count: bool, device):
    """(numbers, reference): the first steps `got` against the reference
    following them once over the ranks, and `grad_block_gap` of this
    rank's block; the reference's readings hold each step's raster counts
    under 'counts' (with `count`)."""
    block = got.pop("grad_block")
    rank, world = dist.get_rank(), dist.get_world_size()
    keep = _blocks(int(inputs.alive.numel()), world)[rank]
    want = follow(cell, inputs, device, count=count, group=dist.group.WORLD,
                  keep=keep)
    numbers = judge.train_numbers(got, want)
    numbers["grad_block_gap"] = sharded_train.block_gap(
        {k: v.to(device) for k, v in block.items()},
        {k: v.to(device) for k, v in want.pop("first_grads").items()})
    return numbers, want


def _gap_over_blocks(got: dict, want: dict, blocks, device) -> float:
    return max(sharded_train.block_gap(
        {k: got[k][a:b].to(device) for k in got},
        {k: want[k][a:b].to(device) for k in want}) for a, b in blocks)


def control(cell, inputs, seed: int, device) -> dict:
    """The numbers of the control (the reference with the raster payload
    rounded to bfloat16) and of the faults, each put in the program's
    place, with `grad_block_gap` at the worst of the cell's `chips`
    blocks: the half batch; `block_left_out`, the first rank's block
    missing from the frame; `blocks_rolled`, the first gradient's blocks
    each handed to the next rank (its norms unchanged, so only
    grad_block_gap can see it)."""
    blocks = _blocks(int(inputs.alive.numel()), cell.chips)
    want = follow(cell, inputs, device)
    dead = inputs.alive.clone()
    dead[blocks[0][0]:blocks[0][1]] = False
    out = {}
    for kind, kw in (("control", dict(payload_dtype=torch.bfloat16)),
                     ("half_batch", dict(half_batch=True)),
                     ("block_left_out", dict(alive=dead))):
        got = follow(cell, inputs, device, **kw)
        nums = judge.train_numbers(got, want)
        nums["grad_block_gap"] = _gap_over_blocks(
            got["first_grads"], want["first_grads"], blocks, device)
        out[kind] = nums
    local = blocks[0][1]
    rolled = {k: torch.roll(v, local, dims=0)
              for k, v in want["first_grads"].items()}
    out["blocks_rolled"] = dict(grad_block_gap=_gap_over_blocks(
        rolled, want["first_grads"], blocks, device))
    return out
