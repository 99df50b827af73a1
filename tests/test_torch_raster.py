"""Port parity of the forward rasterizer: the plain version of K1
(`rasterize_forward_torch`), fed the JAX reference's sorted payload and tile
segments, against

* the reference's Pallas forward kernel in interpret mode (unpacked): the
  same aligned chunks, per-tile early exit and (T, 8, PX) row layout. Rows
  0-5 must pass the tests/imgcheck.py budget (logT as the transmittance
  exp(logT), the depth row divided by the scene's largest depth, since a
  gate flip moves it by ~alpha_min * depth) and the stop row must be equal;
* the reference's XLA twin `rasterize_tiles_xla` with trans_eps = 0 (it
  never exits early): the composed image and transmittance.

The two sides compute q in different association orders, so an alpha gate
sitting on a knife edge may flip: hence the outlier budget, never a strict
allclose.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from test_torch_common import limit_torch_threads, np_
from imgcheck import assert_images_close

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.ops.binning import bin_gaussians as j_bin
from gaussiansplat_tpu.ops.pallas.forward import rasterize_forward as j_fwd
from gaussiansplat_tpu.ops.projection import make_payload as j_payload
from gaussiansplat_tpu.ops.projection import project_gaussians as j_project
from gaussiansplat_tpu.ops.tile_raster import image_to_tiles as j_image_to_tiles
from gaussiansplat_tpu.ops.tile_raster import rasterize_tiles_xla
from gaussiansplat_tpu.ops.tile_raster import tiles_to_image as j_tiles_to_image
from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.ops.kernels.rasterize import rasterize_tiles
from gaussiansplat_tpu_torch.ops.tile_raster import (
    alpha_gates,
    image_to_tiles,
    rasterize_forward_torch,
    support_extent,
    tiles_to_image,
)

limit_torch_threads()


def _sorted_inputs(n, width, height, cfg_kw, opacity=0.8, seed=0,
                   tile_row0=0, tile_rows=None, fx=220.0,
                   scale_range=(0.02, 0.08)):
    """The JAX reference's sorted payload and tile segments for a scene."""
    jcfg = JRasterConfig(packed=False, **cfg_kw)
    m = j_random_model(jax.random.PRNGKey(seed), n, sh_degree=3, extent=1.0,
                       opacity=opacity, scale_range=scale_range)
    cam = j_look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=fx, fy=fx,
                    width=width, height=height)

    @jax.jit
    def run(m, cam):
        p = j_project(m.means, m.quats, m.log_scales, m.logit_opacities,
                      m.sh, cam, jcfg, sh_degree=3, alive=m.alive)
        b = j_bin(p, width, height, jcfg, impl="xla",
                  tile_row0=jnp.int32(tile_row0), tile_rows=tile_rows)
        return b.gather_payload(j_payload(p), impl="xla"), b.tile_starts, \
            jnp.max(jnp.where(p.valid, p.depth, 0.0))

    sp, ts, dmax = run(m, cam)
    return np.asarray(sp), np.asarray(ts), float(dmax), jcfg


CASES = [
    dict(cfg=dict(chunk_size=128), n=512, opacity=0.8),
    # Zoomed in, with large opaque splats that cover whole tiles, which then
    # stop early.
    dict(cfg=dict(chunk_size=8), n=1024, opacity=0.99, fx=600.0,
         scale_range=(0.1, 0.2)),
    dict(cfg=dict(chunk_size=8, trans_eps=0.0), n=256, opacity=0.8),
]


@pytest.mark.parametrize("case", CASES, ids=["cs128", "cs8_early_exit",
                                             "cs8_no_exit"])
def test_matches_pallas_interpret(case):
    width = height = 128
    sp, ts, dmax, jcfg = _sorted_inputs(case["n"], width, height, case["cfg"],
                                        opacity=case["opacity"],
                                        fx=case.get("fx", 220.0),
                                        scale_range=case.get("scale_range",
                                                             (0.02, 0.08)))
    payload_t = jnp.concatenate(
        [jnp.asarray(sp).T, jnp.zeros((16, jcfg.chunk_size), jnp.float32)], 1)
    want = np.asarray(jax.jit(lambda p, s: j_fwd(
        p, s, width, height, jcfg, interpret=True, packed=False))(
            payload_t, jnp.asarray(ts)))
    got = np_(rasterize_forward_torch(torch.tensor(sp), torch.tensor(ts),
                                      width, height,
                                      RasterConfig(**case["cfg"])))
    assert got.shape == want.shape
    for row in (0, 1, 2, 4):
        assert_images_close(got[:, row], want[:, row])
    # logT as transmittance: where 1 - alpha is small, d logT / d alpha =
    # -1 / (1 - alpha) turns ULP differences of q into > 1e-4 moves of logT
    # in pixels whose transmittance is already below 1e-5.
    assert_images_close(np.exp(got[:, 3]), np.exp(want[:, 3]))
    assert_images_close(got[:, 5] / dmax, want[:, 5] / dmax)
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    n_chunks = (ts[1:] - ts[:-1] // jcfg.chunk_size * jcfg.chunk_size
                + jcfg.chunk_size - 1) // jcfg.chunk_size
    exited = got[:, 6, 0] < n_chunks
    if case["opacity"] > 0.9:
        assert exited.any(), "scene too thin: no tile exited early"
    if jcfg.trans_eps == 0:
        assert not exited.any()


@pytest.mark.parametrize("chunk_size", [128, 8])
def test_matches_xla_twin(chunk_size):
    width, height = 100, 72
    cfg_kw = dict(chunk_size=chunk_size, trans_eps=0.0)
    sp, ts, _, jcfg = _sorted_inputs(256, width, height, cfg_kw, seed=1)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = jax.jit(lambda p, s: rasterize_tiles_xla(
        p, s, jnp.asarray(bg), width, height, jcfg, max_chunks=256))(
            jnp.asarray(sp), jnp.asarray(ts))
    got = rasterize_tiles(torch.tensor(sp), torch.tensor(ts),
                          torch.tensor(bg), width, height,
                          RasterConfig(**cfg_kw), "torch")
    assert got.image.shape == (height, width, 3)
    assert_images_close(np_(got.image), np.asarray(want.image))
    assert_images_close(np_(got.transmittance), np.asarray(want.transmittance))
    assert int(got.max_chunks_needed) == int(want.max_chunks_needed)


def test_strip_matches_xla_twin():
    width, height = 128, 128
    cfg_kw = dict(trans_eps=0.0)
    sp, ts, _, jcfg = _sorted_inputs(256, width, height, cfg_kw, seed=2,
                                     tile_row0=1, tile_rows=2)
    bg = np.array([0.3, 0.1, 0.2], np.float32)
    want = jax.jit(lambda p, s: rasterize_tiles_xla(
        p, s, jnp.asarray(bg), width, height, jcfg, tile_row0=jnp.int32(1),
        tile_rows=2))(jnp.asarray(sp), jnp.asarray(ts))
    got = rasterize_tiles(torch.tensor(sp), torch.tensor(ts),
                          torch.tensor(bg), width, height,
                          RasterConfig(**cfg_kw), "torch", tile_row0=1,
                          tile_rows=2)
    assert got.image.shape == (64, width, 3)
    assert_images_close(np_(got.image), np.asarray(want.image))


def test_tile_layout_matches_jax():
    img = np.random.default_rng(0).random((72, 100, 3)).astype(np.float32)
    t = image_to_tiles(torch.as_tensor(img), 32)
    np.testing.assert_array_equal(np_(t), np.asarray(j_image_to_tiles(
        jnp.asarray(img), 32)))
    np.testing.assert_array_equal(np_(tiles_to_image(t, 100, 72, 32)), img)
    np.testing.assert_array_equal(
        np_(tiles_to_image(t[..., 0], 100, 72, 32)),
        np.asarray(j_tiles_to_image(jnp.asarray(np_(t)[..., 0]), 100, 72, 32)))


def test_plain_version_is_differentiable():
    sp, ts, _, _ = _sorted_inputs(64, 64, 64, dict(chunk_size=8), seed=3)
    payload = torch.tensor(sp).requires_grad_(True)
    bg = torch.tensor([0.2, 0.4, 0.6], requires_grad=True)
    out = rasterize_tiles(payload, torch.tensor(ts), bg, 64, 64,
                          RasterConfig(chunk_size=8), "torch")
    (out.image.sum() + out.transmittance.sum()).backward()
    assert torch.isfinite(payload.grad).all() and payload.grad.abs().sum() > 0
    assert torch.isfinite(bg.grad).all()


# The support cull of K1 and K2 (csrc/raster_common.cuh) skips a (pixel,
# pair) whose rounded offsets fall outside the pair's extent (the box of
# q <= its cut) without evaluating the gates. It is exact only if it never
# skips a (pixel, pair) that the gates pass; its plain twin
# `support_extent` is held to that here, on a 32x32 tile of pixels, over
# random conics (condition numbers up to 1e6, past the cull's limit),
# opacities down to alpha_min, and means placed so that a pixel sits on the
# q = sigma^2 or the alpha = alpha_min knife edge.

_CFG = RasterConfig()


@st.composite
def _splat_on_an_edge(draw):
    lam1 = 10.0 ** draw(st.floats(-4.0, 0.6))
    lam2 = lam1 / 10.0 ** draw(st.floats(0.0, 6.0))
    th = draw(st.floats(0.0, math.pi))
    cs, sn = math.cos(th), math.sin(th)
    a = lam1 * cs * cs + lam2 * sn * sn
    c = lam1 * sn * sn + lam2 * cs * cs
    b = (lam1 - lam2) * cs * sn
    amin = float(np.float32(_CFG.alpha_min))
    op = draw(st.one_of(st.just(amin), st.floats(amin, amin * (1 + 1e-5)),
                        st.floats(amin, 1.0)))
    edge = draw(st.sampled_from(["sigma", "alpha", "inside"]))
    sigma_sq = _CFG.sigma_radius ** 2
    target = {"sigma": sigma_sq,
              "alpha": min(sigma_sq, 2.0 * math.log(max(op / amin, 1.0))),
              "inside": draw(st.floats(0.0, sigma_sq))}[edge]
    phi = draw(st.floats(0.0, 2 * math.pi))
    ux, uy = math.cos(phi), math.sin(phi)
    dist = math.sqrt(target / (a * ux * ux + 2 * b * ux * uy + c * uy * uy))
    px, py = draw(st.integers(0, 31)), draw(st.integers(0, 31))
    return a, b, c, op, px - dist * ux, py - dist * uy


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(_splat_on_an_edge())
def test_support_extent_holds_every_live_pixel(splat):
    a, b, c, op, mx, my = (torch.tensor([v], dtype=torch.float32) for v in splat)
    idx = torch.arange(32 * 32)
    dx = (idx % 32).to(torch.float32) - mx
    dy = (idx // 32).to(torch.float32) - my
    q, _, live = alpha_gates(a, b, c, op, dx, dy, _CFG)
    qcut, hx, hy = support_extent(a, b, c, op, _CFG)
    inside = (q <= qcut) & (dx.abs() <= hx) & (dy.abs() <= hy)
    assert not bool((live & ~inside).any()), (
        f"{int((live & ~inside).sum())} live pixels outside the extent "
        f"(qcut {float(qcut):.9g}, hx {float(hx):.9g}, hy {float(hy):.9g})")


def test_support_extent_is_tight_and_culls():
    # A well-conditioned conic: the half-widths are those of q = sigma^2
    # within the margin, so the extent culls.
    a, b, c = 0.02, 0.005, 0.01
    t = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    qcut, hx, hy = support_extent(t(a), t(b), t(c), t(0.8), _CFG)
    det = a * c - b * b
    assert float(qcut) == pytest.approx(9.0, rel=3e-4)
    assert float(hx) == pytest.approx(math.sqrt(9.0 * c / det), rel=1e-3)
    assert float(hy) == pytest.approx(math.sqrt(9.0 * a / det), rel=1e-3)
    # Below alpha_min (or at opacity 0) nothing is live: the cut is the
    # margin alone, finite.
    for op in (0.5 / 255, 0.0):
        qcut, hx, _ = support_extent(t(a), t(b), t(c), t(op), _CFG)
        assert float(qcut) == pytest.approx(1e-4)
        assert 0 < float(hx) < 0.1
    # Not positive definite: no cull.
    _, hx, hy = support_extent(t(0.01), t(0.02), t(0.01), t(0.8), _CFG)
    assert math.isinf(float(hx)) and math.isinf(float(hy))
