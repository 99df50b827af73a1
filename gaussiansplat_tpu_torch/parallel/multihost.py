"""Multi-process entry points: the torch.distributed wiring, the global
mesh and the per-rank view feeding of the data axis.

Every process (one per card) runs the same program:

    from gaussiansplat_tpu_torch.parallel import multihost as mh

    mh.initialize()                      # torchrun's environment
    mesh = mh.make_global_mesh(data=..., tile=...)
    step = make_sharded_train_step(mesh, ...)
    views = mh.process_views(all_views, 1, it, mesh.data, mesh.data_index)
    cams, gts = mh.global_batch(mesh, views, height, tile_size)
    state, metrics = step(state, cams, gts)

Launch, one command per host:

    torchrun --nnodes H --nproc-per-node 8 --rdzv-endpoint host0:29500 \
        train_script.py

`initialize` also takes the address, world size and ranks as arguments
(or MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE / LOCAL_RANK set by
hand). The data axis spans hosts (its gradient all-reduce runs once a
step); the tile or gauss axis stays within one host (`make_global_mesh`
checks that), where the per-gaussian collectives of every step run.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.camera import Camera
from .mesh import Mesh, broadcast, make_mesh
from .train import pad_targets, stack_cameras


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> None:
    """Bring up the default process group (idempotent: returns at once if
    one is running).

    Arguments not given come from torchrun's environment: `init_method`
    defaults to `env://` (MASTER_ADDR, MASTER_PORT), `world_size` to
    WORLD_SIZE, `rank` to RANK and `local_rank` to LOCAL_RANK. The backend
    is `nccl` unless one is given, and NCCL requires a card: with no card
    visible this raises rather than carry the rank on through host memory.
    gloo runs only when asked for: `backend="gloo"` for several ranks on
    one card, which NCCL refuses, or for ranks on the CPU. With CUDA, this
    rank's card is cuda:LOCAL_RANK."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "multihost.initialize: the nccl backend needs a CUDA card and "
            "torch.cuda.is_available() is False on this rank; pass "
            "backend='gloo' to run the ranks on the CPU")
    env = os.environ
    if world_size is None:
        world_size = int(env["WORLD_SIZE"])
    if rank is None:
        rank = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", 0))
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)


def make_global_mesh(data: Optional[int] = None, tile: int = 1) -> Mesh:
    """The (data, tile) mesh over every rank of the world. `data` defaults
    to world / tile. The tile axis must divide the ranks of one host
    (LOCAL_WORLD_SIZE, which torchrun sets; the whole world without it), so
    that each view's strip group stays on one host."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if world % tile:
            raise ValueError(f"tile={tile} must divide the world size {world}")
        data = world // tile
    if data * tile != world:
        raise ValueError(f"mesh {data}x{tile} != world size {world}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if tile > local or local % tile:
        raise ValueError(
            f"tile={tile} must divide the ranks of one host ({local}) so "
            "the strip collectives stay on one host")
    return make_mesh(data, tile)


def process_views(
    views: Sequence,
    batch: int,
    step: int,
    process_count: Optional[int] = None,
    process_index: Optional[int] = None,
) -> List:
    """The views that one feeder takes at a global step, round-robin by
    feeder index over the reference's global sample index. `batch` is the
    feeder's share of the data axis. A feeder is a process of the world by
    default (its size and rank); with a (data, tile) mesh pass
    `process_count=mesh.data`, `process_index=mesh.data_index` and batch 1,
    so that the ranks of one strip group take the same view."""
    if process_count is None:
        process_count = dist.get_world_size() if dist.is_initialized() else 1
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    out = []
    for b in range(batch):
        g = step * batch * process_count + process_index * batch + b
        out.append(views[g % len(views)])
    return out


def global_batch(
    mesh: Mesh,
    local_views: Sequence[Tuple[Camera, torch.Tensor]],
    height: int,
    tile_size: int,
) -> Tuple[Camera, torch.Tensor]:
    """This rank's batch for `make_sharded_train_step`: the one (camera,
    target) view of its data group (`process_views` with batch 1), as a
    stacked camera and a target padded to the strip-aligned height, each
    with a leading axis of mesh.data entries. Only this rank's view is
    held: the leading axis is an expanded view of it (the step reads the
    entry of its data index), and nothing is gathered."""
    if len(local_views) != 1:
        raise ValueError(f"one view per data group, got {len(local_views)}")
    cam, gt = local_views[0]
    cams = stack_cameras([cam] * mesh.data)
    gts = pad_targets(gt[None], height, tile_size, mesh.tile)
    return cams, gts.expand(mesh.data, *gts.shape[1:])


def replicate(mesh: Mesh, module: torch.nn.Module,
              optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Overwrite, in place, every parameter and buffer of `module` (and
    every tensor of the optimizer's state) with rank 0's, over the world
    group of the mesh, so that every rank holds the same values."""
    group = mesh.group(None)
    tensors = list(module.parameters()) + list(module.buffers())
    if optimizer is not None:
        for st in optimizer.state.values():
            tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            t.copy_(broadcast(t, 0, group))
