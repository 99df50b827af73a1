"""A program path of the port's gaussian-axis sharding for the tests of a
cell on several ranks (test_portbench_programs.py writes it into a copy
as portbench/programs/gauss_sharded.py): `parallel.make_gauss_sharded_render`
and `init_gauss_sharded_state` / `make_gauss_sharded_train_step`. Each
rank brings up the process group as under torchrun (gloo on the CPU,
NCCL on cards), holds 1/D of the scene and rasterizes its strip of the
frame; the strips are gathered, so every rank holds the whole frame and
compares it. The scene, the targets, the reference's side and the control
are gauss3d's, on the whole scene.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from gaussiansplat_tpu_torch.models.gaussians import PARAM_NAMES
from gaussiansplat_tpu_torch.parallel import (
    GAUSS_AXIS,
    init_gauss_sharded_state,
    make_gauss_mesh,
    make_gauss_sharded_render,
    make_gauss_sharded_train_step,
    multihost,
    plan_gauss_sharded,
    shard_model,
)

from portbench.harness import Frame
from portbench.programs import gauss3d
from portbench.programs.gauss3d import (  # noqa: F401  (the program's names)
    camera,
    control,
    load_kernels,
    raster_config,
    scene,
    serve_check,
    targets,
    train_check,
    train_config,
)

# Every gaussian of a shard may land in one strip at these sizes.
SEND_FRACTION = 1.0


def _mesh(device):
    cuda = torch.device(device).type == "cuda"
    multihost.initialize(backend="nccl" if cuda else "gloo")
    return make_gauss_mesh()


@dataclasses.dataclass
class Server:
    model: object
    render: object
    background: torch.Tensor


def serve_setup(cell, inputs, device) -> Server:
    mesh = _mesh(device)
    tr = cell.traffic
    render = make_gauss_sharded_render(
        mesh, raster_config(cell.config), tr["width"], tr["height"],
        inputs.sh_degree, send_fraction=SEND_FRACTION)
    return Server(model=shard_model(gauss3d.model(inputs, device), mesh),
                  render=render, background=inputs.background)


def serve_call(server: Server, pose, device) -> Frame:
    with torch.no_grad():
        img, trans, aux = server.render(server.model, camera(pose, device),
                                        server.background, with_aux=True)
    return Frame(keep=(img, trans), overflow=aux["overflow"])


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
    plan = plan_gauss_sharded(int(inputs.alive.numel()),
                              mesh.axis_size(GAUSS_AXIS),
                              tr["width"], tr["height"], inputs.sh_degree,
                              rcfg, send_fraction=SEND_FRACTION)
    state = init_gauss_sharded_state(gauss3d.model(inputs, device), mesh,
                                     tcfg, inputs.extent)
    step = make_gauss_sharded_train_step(mesh, rcfg, tcfg, tr["width"],
                                         tr["height"], inputs.sh_degree,
                                         send_cap=plan.send_cap)
    return Trainer(state=state, step=step, mesh=mesh,
                   cameras=[camera(p, device) for p in inputs.poses])


def train_call(tr: Trainer, inputs, k: int) -> dict:
    v = inputs.order[k]
    tr.state, met = tr.step(tr.state, tr.cameras[v], inputs.targets[v])
    return met


def first_steps(tr: Trainer, cell, inputs, steps: int) -> dict:
    """gauss3d's readings, each a norm over every rank's block: squares
    summed over the ranks."""
    beta1 = cell.config["train"]["beta1"]
    opt = tr.state.optimizer
    losses, grad_sq = [], {}
    t0 = time.perf_counter()
    for k in range(steps):
        met = train_call(tr, inputs, k)
        losses.append(float(met["loss"]))
        if k == 0:
            first_s = time.perf_counter() - t0
            for group in opt.param_groups:
                st = opt.state[group["params"][0]]
                grad_sq[group["name"]] = (st["exp_avg"] / (1 - beta1)).square().sum()
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
                first_step_s=first_s)
