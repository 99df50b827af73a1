"""Sharded paths of the port on torch.distributed: the (data, tile) and
(data, gauss) meshes, the tile-sharded render and step, the gauss-sharded
render and step (strip all_to_all), the depth-slab ring, the 2-D data x
gauss step, multi-process wiring and the capacity plan."""

from .capacity import (
    CapacityPlan,
    max_gaussians_per_chip,
    min_devices_for,
    plan_gauss_sharded,
)
from .depth_ring import make_depth_ring_render
from .gauss_shard import (
    GAUSS_AXIS,
    make_gauss_mesh,
    make_gauss_sharded_render,
    shard_model,
)
from .gauss_train import init_gauss_sharded_state, make_gauss_sharded_train_step
from .gauss2d import (
    make_gauss2d_render,
    make_gauss2d_train_step,
    make_mesh2d,
    shard_model_2d,
)
from .mesh import DATA_AXIS, TILE_AXIS, Mesh, make_mesh, mesh_from_config
from .render import (
    make_tile_sharded_render,
    render_strip,
    resolve_shard_impl,
    strip_bounds,
)
from .train import SSIM_HALO, make_sharded_train_step, pad_targets, stack_cameras

__all__ = [
    "CapacityPlan",
    "DATA_AXIS",
    "GAUSS_AXIS",
    "Mesh",
    "SSIM_HALO",
    "TILE_AXIS",
    "init_gauss_sharded_state",
    "make_depth_ring_render",
    "make_gauss2d_render",
    "make_gauss2d_train_step",
    "make_gauss_mesh",
    "make_gauss_sharded_render",
    "make_gauss_sharded_train_step",
    "make_mesh",
    "make_mesh2d",
    "make_sharded_train_step",
    "make_tile_sharded_render",
    "max_gaussians_per_chip",
    "min_devices_for",
    "mesh_from_config",
    "pad_targets",
    "plan_gauss_sharded",
    "render_strip",
    "resolve_shard_impl",
    "shard_model",
    "shard_model_2d",
    "stack_cameras",
    "strip_bounds",
]
