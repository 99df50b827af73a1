"""Configuration dataclasses of the PyTorch/CUDA port.

Copies of the reference package's `RasterConfig`, `TrainConfig` and
`MeshConfig` (same defaults), kept here so the port imports nothing of the
JAX package. `RasterConfig` differs in two ways:

* `impl` selects the rasterizer backend: 'auto' (CUDA tensors use the
  hand-written kernels, CPU tensors their plain PyTorch versions), 'cuda'
  or 'torch' (see ops/raster_dispatch.py).
* the reference's `packed` is gone: the port always computes the unpacked
  f32 semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static configuration of the tile rasterizer.

    The pair list has the fixed capacity `pair_capacity(N)`; pairs beyond it
    are counted in `overflow` instead of reallocating.
    """

    # Pixel tile edge; one CUDA block of tile_size^2 threads renders a tile,
    # so tile_size <= 32 (1024 threads per block).
    tile_size: int = 32

    # Pairs are composited in depth-ordered chunks of this many; the forward
    # kernel stages one chunk in shared memory and checks early exit per chunk.
    chunk_size: int = 128

    # Static capacity of the (tile, depth, gaussian) pair list as a multiple
    # of N (rounded up to a multiple of chunk_size).
    pairs_per_gaussian: float = 8.0

    # Hard cap on tiles a single gaussian may be duplicated into.
    max_tiles_per_gaussian: int = 1024

    # EWA low-pass dilation added to the 2x2 screen-space covariance.
    cov2d_dilation: float = 0.3

    # Bounding radius in standard deviations; splat support is gated at
    # q <= sigma_radius^2 in every rasterizer.
    sigma_radius: float = 3.0

    # Exact per-tile support culling during binning (ops/binning.py).
    tile_cull: bool = True

    # Splats with alpha < alpha_min are skipped, alpha is clamped to
    # alpha_max, and a tile stops once every pixel's transmittance is below
    # trans_eps (trans_eps <= 0 disables the early exit).
    alpha_min: float = 1.0 / 255.0
    alpha_max: float = 0.999
    trans_eps: float = 1e-4

    # Near / far cull depths (world units).
    near: float = 0.2
    far: float = 1e6

    # 'auto', 'cuda' or 'torch' (see module docstring).
    impl: str = "auto"

    def pair_capacity(self, num_gaussians: int) -> int:
        cap = int(self.pairs_per_gaussian * num_gaussians)
        cap = max(cap, 4 * self.chunk_size)
        # Round to a multiple of chunk_size so chunk loops never straddle.
        return ((cap + self.chunk_size - 1) // self.chunk_size) * self.chunk_size


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (standard 3DGS schedule)."""

    iterations: int = 30_000
    ssim_lambda: float = 0.2

    lr_means: float = 1.6e-4
    lr_means_final: float = 1.6e-6
    lr_quats: float = 1e-3
    lr_scales: float = 5e-3
    lr_opacities: float = 5e-2
    lr_sh_dc: float = 2.5e-3
    lr_sh_rest: float = 2.5e-3 / 20.0

    densify_start: int = 500
    densify_end: int = 15_000
    densify_every: int = 100
    densify_grad_thresh: float = 2e-4
    densify_target_fraction: Optional[float] = None
    densify_scale_thresh: float = 0.01
    split_factor: float = 1.6
    prune_opacity: float = 0.005
    prune_radius_frac: float = 0.1
    prune_screen_frac: float = 0.15
    opacity_reset_every: int = 3_000
    opacity_reset_value: float = 0.01

    sh_degree: int = 3
    sh_increase_every: int = 1_000

    white_background: bool = False
    random_background: bool = False

    eval_every: int = 1_000
    checkpoint_every: int = 5_000
    log_every: int = 100
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device layout for multi-card runs (data axis x tile axis)."""

    data_axis: str = "data"
    tile_axis: str = "tile"
    data: int = 1
    tile: int = 1

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.tile)
