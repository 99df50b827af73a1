"""Port parity of the 2D screen-space splat family (models/splats2d.py)
against the reference's `gaussiansplat_tpu.models.splats2d`, on the cases of
tests/test_splats2d.py. The reference's splats are drawn from a JAX key and
handed to the port through `splats2d_from_numpy`. The image and gradients
go through the port's plain path on the CPU, against the reference's XLA
render."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imgcheck import assert_images_close
from test_torch_common import assert_ints_close, limit_torch_threads, np_

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.models.splats2d import project_splats2d as j_project
from gaussiansplat_tpu.models.splats2d import random_splats2d as j_random
from gaussiansplat_tpu.models.splats2d import render_splats2d as j_render
from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.models import (
    Splat2DModel,
    project_splats2d,
    random_splats2d,
    render_splats2d,
    splats2d_from_numpy,
)

limit_torch_threads()

JCFG = JRasterConfig(tile_size=32, chunk_size=128, impl="xla")
CFG = RasterConfig(tile_size=32, chunk_size=128, impl="torch")
W = H = 128


def _pair(seed, n, capacity=None, size=W, **kw):
    jm = j_random(jax.random.PRNGKey(seed), n, size, size, capacity=capacity,
                  **kw)
    params = {k: np.asarray(v) for k, v in jm.trainable().items()}
    return jm, splats2d_from_numpy(params, np.asarray(jm.alive), device="cpu")


def test_conic_matches_reference_and_closed_form():
    jm, tm = _pair(0, 64, capacity=80)
    jp = j_project(jm, JCFG, W, H)
    tp = project_splats2d(tm, CFG, W, H)
    want = np.asarray(jp.conic)
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_allclose(np_(tp.conic) / scale, want / scale, atol=1e-6)
    np.testing.assert_allclose(np_(tp.opacity), np.asarray(jp.opacity), atol=1e-6)
    np.testing.assert_array_equal(np_(tp.mean2d), np.asarray(jp.mean2d))
    assert not np_(tp.depth).any()
    theta = np_(tm.thetas)[:16]
    s = np.exp(np_(tm.log_scales).astype(np.float64))[:16]
    for i in range(16):
        c, t = np.cos(theta[i]), np.sin(theta[i])
        R = np.array([[c, -t], [t, c]])
        inv = np.linalg.inv(R @ np.diag(s[i] ** 2) @ R.T
                            + CFG.cov2d_dilation * np.eye(2))
        np.testing.assert_allclose(np_(tp.conic)[i],
                                   [inv[0, 0], inv[0, 1], inv[1, 1]],
                                   rtol=1e-4, atol=1e-5)


def test_integer_fields_match_reference():
    jm, tm = _pair(1, 3000, capacity=3100, scale_range=(0.5, 30.0))
    jp = j_project(jm, JCFG, W, H)
    tp = project_splats2d(tm, CFG, W, H)
    assert_ints_close(np_(tp.radius), np.asarray(jp.radius))
    assert_ints_close(np_(tp.radius_xy), np.asarray(jp.radius_xy))
    same = np_(tp.valid) == np.asarray(jp.valid)
    assert same.mean() >= 0.999 and not np_(tp.valid)[3000:].any()


def test_random_splats2d_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    m = random_splats2d(g, 100, 320, 200, capacity=128, device="cpu")
    assert isinstance(m, Splat2DModel) and m.capacity == 128
    assert int(m.num_alive) == 100 and not m.alive[100:].any()
    assert set(m.trainable()) == {"means2d", "log_scales", "thetas",
                                  "logit_opacities", "colors"}
    mx = m.means2d[:100]
    assert (mx >= 0).all() and (mx[:, 0] <= 320).all() and (mx[:, 1] <= 200).all()
    s = torch.exp(m.log_scales[:100])
    assert (s >= 2.0 - 1e-5).all() and (s <= 10.0 + 1e-5).all()
    np.testing.assert_allclose(np_(torch.sigmoid(m.logit_opacities[:100])),
                               0.7, atol=1e-6)
    again = random_splats2d(torch.Generator().manual_seed(0), 100, 320, 200,
                            capacity=128, device="cpu")
    for k, v in m.trainable().items():
        assert torch.equal(v, getattr(again, k)), k


@pytest.mark.parametrize("n", [64, 600], ids=["sparse", "crowded"])
def test_image_matches_reference(n):
    """Every depth is 0, so a tile composites its pairs in slot order (the
    stable compaction sort): with 600 splats of 2-10 px on 16 tiles, ~40 or
    more overlap in each tile."""
    jm, tm = _pair(2, n)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jout = j_render(jm, W, H, JCFG, background=jnp.asarray(bg))
    with torch.no_grad():
        tout = render_splats2d(tm, W, H, CFG, background=torch.as_tensor(bg))
    assert int(tout.overflow) == 0
    assert int(tout.num_pairs) == int(jout.num_pairs)
    assert tout.image.shape == (H, W, 3) and tout.transmittance.shape == (H, W)
    assert_images_close(np_(tout.image), np.asarray(jout.image))
    assert_images_close(np_(tout.transmittance), np.asarray(jout.transmittance))
    np.testing.assert_array_equal(np_(tout.radii), np.asarray(jout.radii))


def test_dead_slots_do_not_render():
    _, tm = _pair(2, 32, capacity=64)
    with torch.no_grad():
        out = render_splats2d(tm, W, H, CFG)
        tm.alive[16:] = False
        out2 = render_splats2d(tm, W, H, CFG)
    assert float((out2.transmittance - out.transmittance).min()) >= -1e-6


def test_gradients_match_reference():
    jm, tm = _pair(3, 200)
    target = np.random.default_rng(0).random((H, W, 3)).astype(np.float32)

    def jloss(p):
        img = j_render(jm.with_params(p), W, H, JCFG).image
        return jnp.mean((img - target) ** 2)

    jg = jax.jit(jax.grad(jloss))(jm.trainable())
    img = render_splats2d(tm, W, H, CFG).image
    ((img - torch.as_tensor(target)) ** 2).mean().backward()
    for k, p in tm.trainable().items():
        want = np.asarray(jg[k])
        scale = np.abs(want).max()
        assert scale > 0, k
        np.testing.assert_allclose(np_(p.grad) / scale, want / scale,
                                   atol=1e-4, err_msg=k)


def test_adam_fit_follows_reference():
    """A few Adam steps (lr 2e-2) on all five groups toward a rendered
    target: the loss falls, step for step as the reference's does."""
    w = 64
    jt, _ = _pair(4, 24, size=w)
    target = j_render(jt, w, w, JCFG).image
    jm, tm = _pair(5, 24, size=w)

    tx = optax.adam(2e-2)
    params = jm.trainable()
    opt = tx.init(params)

    @jax.jit
    def jstep(params, opt):
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((j_render(jm.with_params(p), w, w, JCFG).image
                                - target) ** 2))(params)
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, upd), opt, loss

    torch_target = torch.as_tensor(np.array(target))
    optim = torch.optim.Adam(tm.trainable().values(), lr=2e-2)
    jl, tl = [], []
    for _ in range(6):
        params, opt, loss = jstep(params, opt)
        jl.append(float(loss))
        optim.zero_grad()
        loss_t = ((render_splats2d(tm, w, w, CFG).image - torch_target) ** 2).mean()
        loss_t.backward()
        optim.step()
        tl.append(float(loss_t.detach()))
    assert tl[-1] < 0.9 * tl[0] and jl[-1] < 0.9 * jl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
