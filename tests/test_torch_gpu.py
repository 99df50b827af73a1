"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; every test skips (inside the `cuda` fixture) where
torch.cuda.is_available() is False. This file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from imgcheck import assert_images_close

from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.models import random_model
from gaussiansplat_tpu_torch.ops.binning import (
    bin_gaussians,
    compact_rects,
    expand_compacted,
)
from gaussiansplat_tpu_torch.ops.camera import look_at
from gaussiansplat_tpu_torch.ops.kernels.expand import EXPAND
from gaussiansplat_tpu_torch.ops.kernels.forward import (
    FORWARD,
    rasterize_forward_cuda,
    rasterize_forward_torch,
)
from gaussiansplat_tpu_torch.ops.projection import make_payload, project_gaussians
from gaussiansplat_tpu_torch.render import render

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scene(device, n, width, height, seed=0, opacity=0.8, fx=None):
    g = torch.Generator().manual_seed(seed)
    model = random_model(g, n, sh_degree=3, opacity=opacity, device=device)
    cam = look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0),
                  fx=fx or 1.7 * width, fy=fx or 1.7 * width,
                  width=width, height=height, device=device)
    return model, cam


def _project(model, cam, cfg):
    return project_gaussians(model.means, model.quats, model.log_scales,
                             model.logit_opacities, model.sh, cam, cfg,
                             sh_degree=3, alive=model.alive)


@pytest.mark.parametrize(
    "n,width,height", [(4096, 256, 192), (70_000, 8160, 4064)],
    ids=["packed_keys", "separate_streams"])
def test_expand_matches_plain(cuda, n, width, height):
    cfg = RasterConfig()
    model, cam = _scene(cuda, n, width, height, fx=0.5 * width)
    with torch.no_grad():
        c = compact_rects(_project(model, cam, cfg), width, height, cfg)
        assert c.packed_keys == (n < 10_000)
        assert int(c.num_pairs) > 0
        before = EXPAND.launches
        got = expand_compacted(c, "cuda")
        want = expand_compacted(c, "torch")
        torch.cuda.synchronize()
    assert EXPAND.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunk_size,trans_eps", [(128, 1e-4), (8, 1e-4),
                                                  (128, 0.0)],
                         ids=["cs128", "cs8_early_exit", "cs128_no_exit"])
def test_forward_matches_plain(cuda, chunk_size, trans_eps):
    cfg = RasterConfig(chunk_size=chunk_size, trans_eps=trans_eps)
    model, cam = _scene(cuda, 4096, 256, 192, opacity=0.99, fx=880.0)
    with torch.no_grad():
        proj = _project(model, cam, cfg)
        b = bin_gaussians(proj, cam.width, cam.height, cfg, impl="cuda")
        sp = b.gather_payload(make_payload(proj))
        before = FORWARD.launches
        got = rasterize_forward_cuda(sp, b.tile_starts, cam.width,
                                     cam.height, cfg)
        want = rasterize_forward_torch(sp, b.tile_starts, cam.width,
                                       cam.height, cfg)
        torch.cuda.synchronize()
    assert FORWARD.launches == before + 1
    got, want = got.cpu().numpy(), want.cpu().numpy()
    for row in range(5):
        assert_images_close(got[:, row], want[:, row], atol=2e-4)
    # A gate flip moves the depth sum by ~alpha_min * depth.
    depth_scale = float(proj.depth[proj.valid].max())
    assert_images_close(got[:, 5] / depth_scale, want[:, 5] / depth_scale,
                        atol=2e-4)
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    starts = b.tile_starts.cpu().numpy().astype(np.int64)
    base = starts[:-1] // chunk_size * chunk_size
    n_chunks = (starts[1:] - base + chunk_size - 1) // chunk_size
    exited = got[:, 6, 0] < n_chunks
    if trans_eps == 0:
        assert not exited.any(), "a tile stopped with early exit off"
    if chunk_size == 8:
        assert exited.any(), "no tile exited early"


@pytest.mark.parametrize("tile_size,tile_row0,tile_rows", [(16, 0, None),
                                                         (32, 2, 3)],
                         ids=["tile16", "strip"])
def test_forward_tiles_and_strips_match_plain(cuda, tile_size, tile_row0,
                                              tile_rows):
    cfg = RasterConfig(tile_size=tile_size)
    model, cam = _scene(cuda, 2048, 256, 192)
    with torch.no_grad():
        proj = _project(model, cam, cfg)
        b = bin_gaussians(proj, cam.width, cam.height, cfg, impl="cuda",
                          tile_row0=tile_row0, tile_rows=tile_rows)
        sp = b.gather_payload(make_payload(proj))
        args = (sp, b.tile_starts, cam.width, cam.height, cfg)
        kw = dict(tile_row0=tile_row0, tile_rows=tile_rows)
        got = rasterize_forward_cuda(*args, **kw).cpu().numpy()
        want = rasterize_forward_torch(*args, **kw).cpu().numpy()
    assert int(b.num_pairs) > 0
    for row in (0, 1, 2, 4):
        assert_images_close(got[:, row], want[:, row], atol=2e-4)
    np.testing.assert_array_equal(got[:, 6], want[:, 6])


def test_render_cuda_matches_torch(cuda):
    model, cam = _scene(cuda, 2048, 320, 240)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    with torch.no_grad():
        a = render(model, cam, background=bg, impl="cuda")
        b = render(model, cam, background=bg, impl="torch")
    assert int(a.overflow) == 0 and int(a.num_pairs) == int(b.num_pairs)
    assert_images_close(a.image.cpu().numpy(), b.image.cpu().numpy())
    assert_images_close(a.transmittance.cpu().numpy(),
                        b.transmittance.cpu().numpy())


def test_render_with_grad_raises(cuda):
    model, cam = _scene(cuda, 256, 128, 128)
    with pytest.raises(NotImplementedError, match="training slice"):
        render(model, cam, impl="cuda")


def test_tile_size_limit(cuda):
    model, cam = _scene(cuda, 256, 128, 128)
    with torch.no_grad(), pytest.raises(ValueError, match="tile_size"):
        render(model, cam, RasterConfig(tile_size=64), impl="cuda")
