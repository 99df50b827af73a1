"""Sharded paths of the port on torch.distributed: the (data, tile) mesh,
the tile-sharded render and the sharded training step."""

from .mesh import DATA_AXIS, TILE_AXIS, Mesh, make_mesh, mesh_from_config
from .render import make_tile_sharded_render, render_strip, resolve_shard_impl
from .train import SSIM_HALO, make_sharded_train_step, pad_targets, stack_cameras

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "SSIM_HALO",
    "TILE_AXIS",
    "make_mesh",
    "make_sharded_train_step",
    "make_tile_sharded_render",
    "mesh_from_config",
    "pad_targets",
    "render_strip",
    "resolve_shard_impl",
    "stack_cameras",
]
