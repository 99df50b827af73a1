"""The process meshes of the sharded paths, on torch.distributed.

The world process group is laid out row-major as a 2-D grid of a major
`data` axis and a minor axis, `tile` or `gauss`:
global rank = data_index * minor + minor_index.
  * `data`: views (cameras) are split across it; gradients are summed.
  * `tile`: the pixel-tile rows of one view are split into horizontal
    strips across it; per-gaussian gradients are partial sums, summed.
  * `gauss`: the gaussians (parameters and Adam moments) are split across
    it; each rank owns a contiguous block of the capacity axis
    (parallel/gauss_shard.py).
A `Mesh` holds this rank's coordinates, the axis names and one subgroup
per axis: the ranks that share its data index (its minor group) and those
that share its minor index (its data group).

The backend is the caller's: `nccl` across cards, `gloo` on the CPU (and
for several ranks on one card, which NCCL refuses). The collective helpers
below stage CUDA tensors through host memory on gloo groups, whose
collectives are not all implemented for CUDA tensors; on NCCL they pass the
tensors as they are. A group of one rank (`None`) needs no process group:
every collective is then the identity. Every helper reports what it moves
to `utils/comm_bytes.py`. `AllToAll`, `Permute` and `Broadcast` are the
differentiable forms: autograd Functions whose backward issues the
transposed collective, so every rank must call `backward()` (the backward
collectives pair up across ranks).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..utils import comm_bytes as cb
from ..utils.logging import count, span

DATA_AXIS = "data"
TILE_AXIS = "tile"
GAUSS_AXIS = "gauss"


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, minor) grid and its two subgroups
    (None when the axis has one rank or no process group is running).
    `data` and `tile` are the sizes of the major and the minor axis; the
    minor axis is named `axes[1]` (`tile` or `gauss`)."""

    data: int
    tile: int
    rank: int
    data_group: Optional[dist.ProcessGroup]
    tile_group: Optional[dist.ProcessGroup]
    world_group: Optional[dist.ProcessGroup]
    axes: Tuple[str, str] = (DATA_AXIS, TILE_AXIS)

    @property
    def shape(self) -> dict:
        return {self.axes[0]: self.data, self.axes[1]: self.tile}

    @property
    def data_index(self) -> int:
        return self.rank // self.tile

    @property
    def tile_index(self) -> int:
        return self.rank % self.tile

    @property
    def size(self) -> int:
        return self.data * self.tile

    def group(self, axis: Optional[str]) -> Optional[dist.ProcessGroup]:
        """The group of one axis name, or `None` for both axes (the world)."""
        return {self.axes[0]: self.data_group, self.axes[1]: self.tile_group,
                None: self.world_group}[axis]

    def axis_size(self, axis: Optional[str]) -> int:
        return {self.axes[0]: self.data, self.axes[1]: self.tile,
                None: self.size}[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's index along one axis (its rank in that axis' group)."""
        return {self.axes[0]: self.data_index,
                self.axes[1]: self.tile_index}[axis]


def make_grid(data: int, minor: int, minor_axis: str) -> Mesh:
    """Lay the running world process group out as (data, minor). Every rank
    must call it (it creates the subgroups with `dist.new_group`, the same
    groups in the same order on every rank). The world size must be
    data * minor; a 1 x 1 mesh also works with no process group."""
    need = data * minor
    axes = (DATA_AXIS, minor_axis)
    if data < 1 or minor < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({data}, {minor})")
    if not dist.is_available() or not dist.is_initialized():
        if need != 1:
            raise ValueError(f"a ({data}, {minor}) mesh needs {need} processes "
                             "in an initialized torch.distributed group")
        return Mesh(1, 1, 0, None, None, None, axes)
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"need {need} processes, the world has {world}")
    rank = dist.get_rank()
    minor_group = data_group = None
    for d in range(data):
        g = dist.new_group([d * minor + t for t in range(minor)])
        if rank // minor == d:
            minor_group = g
    for t in range(minor):
        g = dist.new_group([d * minor + t for d in range(data)])
        if rank % minor == t:
            data_group = g
    return Mesh(data, minor, rank, data_group if data > 1 else None,
                minor_group if minor > 1 else None, dist.group.WORLD, axes)


def make_mesh(data: int = 1, tile: int = 1) -> Mesh:
    """The (data, tile) mesh of the tile-sharded paths (`make_grid`)."""
    return make_grid(data, tile, TILE_AXIS)


def mesh_from_config(cfg: MeshConfig) -> Mesh:
    return make_mesh(cfg.data, cfg.tile)


def _device(t: torch.Tensor, group) -> torch.device:
    """Where a collective on `group` runs: host memory on gloo (CUDA
    tensors are staged through it), the card on NCCL (a host tensor is
    copied to the current card)."""
    if dist.get_backend(group) == dist.Backend.GLOO:
        return torch.device("cpu")
    return t.device if t.is_cuda else torch.device("cuda",
                                                   torch.cuda.current_device())


def _buffer(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous private copy of t where the collective runs."""
    return t.detach().to(_device(t, group), copy=True).contiguous()


def _global(group, r: int) -> int:
    return dist.get_global_rank(group, r)


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """`op` ('sum' or 'max') of `t` over `group`, returned as a new tensor
    on t's device; the identity when group is None. Every rank gets the
    same bits."""
    if group is None:
        return t.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    buf = _buffer(t, group)
    dist.all_reduce(buf, op=red, group=group)
    cb.record(cb.ALL_REDUCE, buf.nbytes, dist.get_world_size(group))
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` (same shape and dtype on each), in group-rank
    order, on t's device; [t] when group is None."""
    if group is None:
        return [t]
    src = t.detach().to(_device(t, group)).contiguous()
    n = dist.get_world_size(group)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    cb.record(cb.ALL_GATHER, n * src.nbytes, n)
    return [p.to(t.device) for p in parts]


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Split `t` on dim 0 into one equal block per rank of `group`, send
    block j to group rank j, and concatenate the blocks received on dim 0
    in group-rank order (a tiled `lax.all_to_all` on axis 0). The identity
    when group is None."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"dim 0 ({t.shape[0]}) must split into {n} blocks")
    src = _buffer(t, group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    cb.record(cb.ALL_TO_ALL, src.nbytes, n)
    return out.to(t.device)


def permute(t: torch.Tensor, pairs: Sequence[Tuple[int, int]],
            group) -> torch.Tensor:
    """`lax.ppermute`: for every (src, dst) pair of group ranks, src's `t`
    becomes dst's result; a rank that no pair sends to gets zeros. Each
    rank appears at most once as a source and once as a destination."""
    me = dist.get_rank(group) if group is not None else 0
    src = _buffer(t, group) if group is not None else t.detach()
    out = torch.zeros_like(src)
    ops = []
    for s, d in pairs:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, _global(group, d), group))
            cb.record(cb.PERMUTE, src.nbytes, dist.get_world_size(group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, _global(group, s), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(t.device)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank `src`'s `t` on every rank of `group` (a new tensor on t's
    device); t itself when group is None."""
    if group is None:
        return t
    buf = _buffer(t, group)
    dist.broadcast(buf, src=_global(group, src), group=group)
    cb.record(cb.BROADCAST, buf.nbytes, dist.get_world_size(group))
    return buf.to(t.device)


def off_card_bytes(t: torch.Tensor, group) -> int:
    """The bytes of t that leave the card in an `all_to_all` over `group`
    (utils/comm_bytes.py's convention); 0 on a group of one rank."""
    if group is None:
        return 0
    n = dist.get_world_size(group)
    return cb.collective_bytes([(cb.ALL_TO_ALL, t.nbytes, n)], n)["total"]


class AllToAll(torch.autograd.Function):
    """Differentiable `all_to_all`. Equal blocks make it its own transpose:
    the backward is the same exchange of the cotangents, which returns each
    block's cotangent to the rank that sent the block. With `bwd_span`, the
    backward is that span (utils/logging.py), counting its
    `exchange_bytes`."""

    @staticmethod
    def forward(ctx, t, group, bwd_span=None):
        ctx.group, ctx.bwd_span = group, bwd_span
        out = all_to_all(t, group)
        return out.clone() if out is t else out

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd_span is None:
            return all_to_all(g.contiguous(), ctx.group), None, None
        with span(ctx.bwd_span):
            count("exchange_bytes", off_card_bytes(g, ctx.group))
            return all_to_all(g.contiguous(), ctx.group), None, None


class Permute(torch.autograd.Function):
    """Differentiable `permute`; the backward runs the inverse permutation,
    which returns each received tensor's cotangent to its sender."""

    @staticmethod
    def forward(ctx, t, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return permute(t, pairs, group)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.pairs]
        return permute(g.contiguous(), inverse, ctx.group), None, None


class Broadcast(torch.autograd.Function):
    """`broadcast` of a result that every rank then uses alike (each rank
    computes the same loss from it). The transpose of a broadcast sums the
    D ranks' cotangents at the source, which would count that one loss D
    times; the backward hands the source its own cotangent instead, and
    every other rank zeros. It issues no collective."""

    @staticmethod
    def forward(ctx, t, src, group):
        ctx.is_src = group is None or dist.get_rank(group) == src
        out = broadcast(t, src, group)
        return out.clone() if out is t else out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None
