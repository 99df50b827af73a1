"""Port parity of projection and the payload against the JAX reference.

Float fields agree within rtol/atol 1e-5. The integer fields (radius,
radius_xy) and `valid` come from ceil() of transcendental results, which
XLA and PyTorch round differently by an ULP, so they may differ on at most
0.1% of entries, each by at most 1.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_common import assert_ints_close, np_, port_camera, port_model

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.ops.projection import make_payload as j_make_payload
from gaussiansplat_tpu.ops.projection import project_gaussians as j_project
from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.ops.projection import (
    PAYLOAD_DIM,
    make_payload,
    payload_to_projected,
    project_gaussians,
)

FLOAT_FIELDS = ("mean2d", "depth", "conic", "rgb", "opacity")


def _scene(n, seed, width, height, sh_degree=3, eye=(0.5, 0.3, -6.0)):
    jm = j_random_model(jax.random.PRNGKey(seed), n, sh_degree=sh_degree,
                        extent=1.0)
    jc = j_look_at(eye=eye, target=(0, 0, 0), fx=220.0, fy=220.0,
                   width=width, height=height)
    return jm, jc


def _both(jm, jc, sh_degree=3, **cfg_kw):
    jp = jax.jit(lambda m, c: j_project(
        m.means, m.quats, m.log_scales, m.logit_opacities, m.sh, c,
        JRasterConfig(**cfg_kw), sh_degree=sh_degree, alive=m.alive))(jm, jc)
    tm = port_model(jm)
    tp = project_gaussians(tm.means, tm.quats, tm.log_scales,
                           tm.logit_opacities, tm.sh, port_camera(jc),
                           RasterConfig(**cfg_kw), sh_degree=sh_degree,
                           alive=tm.alive)
    return jp, tp


@pytest.mark.parametrize("n,seed,width,height", [
    (1024, 0, 128, 128), (512, 1, 256, 256), (768, 2, 100, 72)])
def test_project_matches_jax(n, seed, width, height):
    jm, jc = _scene(n, seed, width, height)
    # Some gaussians off screen, some dead slots.
    jm = jm.replace(alive=jm.alive.at[::17].set(False))
    jp, tp = _both(jm, jc)
    valid = np.asarray(jp.valid) & np_(tp.valid)
    assert valid.sum() > n // 4
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(np_(getattr(tp, f)), np.asarray(getattr(jp, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert_ints_close(np_(tp.radius), np.asarray(jp.radius))
    assert_ints_close(np_(tp.radius_xy), np.asarray(jp.radius_xy))
    assert_ints_close(np_(tp.valid), np.asarray(jp.valid))


def test_near_far_cull_matches_jax():
    jm, jc = _scene(256, 3, 128, 128, eye=(0.0, 0.0, -1.2))
    jp, tp = _both(jm, jc, far=5.5)
    assert not np.asarray(jp.valid).all()
    np.testing.assert_array_equal(np_(tp.valid), np.asarray(jp.valid))


def test_payload_matches_jax_and_roundtrips():
    jm, jc = _scene(512, 4, 128, 128)
    jp, tp = _both(jm, jc)
    want = np.asarray(j_make_payload(jp))
    got = make_payload(tp)
    assert got.shape == (512, PAYLOAD_DIM)
    # Compare channel by channel on the gaussians whose integer fields agree.
    same = (np_(tp.radius) == np.asarray(jp.radius)) & np.all(
        np_(tp.radius_xy) == np.asarray(jp.radius_xy), axis=1)
    np.testing.assert_allclose(np_(got)[same], want[same], rtol=1e-5, atol=1e-5)
    back = payload_to_projected(got)
    np.testing.assert_array_equal(np_(back.radius), np_(tp.radius))
    np.testing.assert_array_equal(np_(back.radius_xy), np_(tp.radius_xy))
    np.testing.assert_array_equal(np_(back.valid), np_(tp.radius) > 0)


def test_projection_is_differentiable():
    jm, jc = _scene(16, 5, 64, 64)
    tm = port_model(jm)
    p = project_gaussians(tm.means, tm.quats, tm.log_scales,
                          tm.logit_opacities, tm.sh, port_camera(jc),
                          RasterConfig(), sh_degree=3, alive=tm.alive)
    (p.mean2d.sum() + p.conic.sum() + p.rgb.sum()).backward()
    g = tm.means.grad
    assert torch.isfinite(g).all() and g.abs().sum() > 0
