"""The (data, tile) process mesh of the sharded paths, on torch.distributed.

The world process group is laid out row-major as a (data, tile) grid:
global rank = data_index * tile + tile_index.
  * `data`: views (cameras) are split across it; gradients are summed.
  * `tile`: the pixel-tile rows of one view are split into horizontal
    strips across it; per-gaussian gradients are partial sums, summed.
A `Mesh` holds this rank's coordinates and one subgroup per axis: the ranks
that share its data index (its tile group) and those that share its tile
index (its data group).

The backend is the caller's: `nccl` across cards, `gloo` on the CPU (and
for several ranks on one card, which NCCL refuses). The collective helpers
below stage CUDA tensors through host memory on gloo groups, whose
collectives are not all implemented for CUDA tensors; on NCCL they pass the
tensors as they are. A 1 x 1 mesh needs no process group: every collective
is then the identity.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig

DATA_AXIS = "data"
TILE_AXIS = "tile"


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, tile) grid and its two subgroups
    (None when the axis has one rank or no process group is running)."""

    data: int
    tile: int
    rank: int
    data_group: Optional[dist.ProcessGroup]
    tile_group: Optional[dist.ProcessGroup]
    world_group: Optional[dist.ProcessGroup]

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, TILE_AXIS: self.tile}

    @property
    def data_index(self) -> int:
        return self.rank // self.tile

    @property
    def tile_index(self) -> int:
        return self.rank % self.tile

    @property
    def size(self) -> int:
        return self.data * self.tile

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The group of one axis name, or `None` for both axes (the world)."""
        return {DATA_AXIS: self.data_group, TILE_AXIS: self.tile_group,
                None: self.world_group}[axis]

    def axis_size(self, axis: Optional[str]) -> int:
        return {DATA_AXIS: self.data, TILE_AXIS: self.tile,
                None: self.size}[axis]


def make_mesh(data: int = 1, tile: int = 1) -> Mesh:
    """Lay the running world process group out as (data, tile). Every rank
    must call it (it creates the subgroups with `dist.new_group`, the same
    groups in the same order on every rank). The world size must be
    data * tile; a 1 x 1 mesh also works with no process group."""
    need = data * tile
    if data < 1 or tile < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({data}, {tile})")
    if not dist.is_available() or not dist.is_initialized():
        if need != 1:
            raise ValueError(f"a ({data}, {tile}) mesh needs {need} processes "
                             "in an initialized torch.distributed group")
        return Mesh(1, 1, 0, None, None, None)
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"need {need} processes, the world has {world}")
    rank = dist.get_rank()
    tile_group = data_group = None
    for d in range(data):
        g = dist.new_group([d * tile + t for t in range(tile)])
        if rank // tile == d:
            tile_group = g
    for t in range(tile):
        g = dist.new_group([d * tile + t for d in range(data)])
        if rank % tile == t:
            data_group = g
    return Mesh(data, tile, rank, data_group if data > 1 else None,
                tile_group if tile > 1 else None, dist.group.WORLD)


def mesh_from_config(cfg: MeshConfig) -> Mesh:
    return make_mesh(cfg.data, cfg.tile)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on `group` must go through host memory: CUDA
    tensors on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """`op` ('sum' or 'max') of `t` over `group`, returned as a new tensor
    on t's device; the identity when group is None. Every rank gets the
    same bits."""
    if group is None:
        return t.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    buf = t.detach().to("cpu" if _staged(t, group) else t.device,
                        copy=True).contiguous()
    dist.all_reduce(buf, op=red, group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` (same shape and dtype on each), in group-rank
    order, on t's device; [t] when group is None."""
    if group is None:
        return [t]
    src = t.detach().to("cpu" if _staged(t, group) else t.device).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]
