"""Port parity of projection and the payload against the JAX reference,
and of P's per-gaussian twin (ops/kernels/project.py) against the port's
plain projection and payload.

Float fields agree within rtol/atol 1e-5. The integer fields (radius,
radius_xy) and `valid` come from ceil() of transcendental results, which
XLA and PyTorch round differently by an ULP, so they may differ on at most
0.1% of entries, each by at most 1. The twin is held to the same rule (its
sums and numpy's exp and log may round an ULP apart from PyTorch's).
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_common import (
    assert_ints_close,
    limit_torch_threads,
    np_,
    port_camera,
    port_model,
)

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.ops.projection import make_payload as j_make_payload
from gaussiansplat_tpu.ops.projection import project_gaussians as j_project
from gaussiansplat_tpu_torch import render as render_mod
from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.models import random_model
from gaussiansplat_tpu_torch.ops.camera import look_at, make_camera
from gaussiansplat_tpu_torch.ops.kernels.project import (
    project_cuda,
    project_twin,
)
from gaussiansplat_tpu_torch.ops.projection import (
    PAYLOAD_DIM,
    PAYLOAD_RADIUS,
    make_payload,
    payload_to_projected,
    project_gaussians,
)
from gaussiansplat_tpu_torch.utils import logging as spans
from imgcheck import assert_images_close

limit_torch_threads()

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


# P's twin: each case a scene whose rows `special` the case made (culled
# ones must come out invalid on both sides).
TWIN_CASES = ("sh0", "sh1", "sh2", "sh3", "sh3_as_1", "behind_and_near",
              "degenerate_scale", "off_screen", "dead", "faint")


def _twin_case(name, n=1024):
    """(model, camera, cfg, sh_degree, special rows, culled) of a case."""
    degree = int(name[2]) if name.startswith("sh") else 3
    g = torch.Generator().manual_seed(TWIN_CASES.index(name))
    model = random_model(g, n, sh_degree=degree, device="cpu")
    cam = look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=220.0,
                  fy=220.0, width=128, height=96, device="cpu")
    cfg = RasterConfig()
    special = torch.arange(0, n, 3)
    with torch.no_grad():
        model.sh_rest.normal_(0.0, 0.2, generator=g)
        if name == "behind_and_near":
            # A camera at the origin looking down +z: the depth is the
            # mean's z, exactly. Rows behind it, exactly at the near plane
            # and between the two.
            cam = make_camera(np.eye(3), np.zeros(3), 220.0, 220.0, 128, 96,
                              device="cpu")
            model.means[:, 2] += 6.0
            z = torch.tensor([-1.5, cfg.near, 0.5 * cfg.near])
            model.means[special, 2] = z[torch.arange(len(special)) % 3]
        elif name == "degenerate_scale":
            # exp(-60)^2 underflows: a = b = c = 0 without dilation, det 0.
            cfg = RasterConfig(cov2d_dilation=0.0)
            model.log_scales[special] = -60.0
        elif name == "off_screen":
            model.means[special, 0] += 5.0
        elif name == "dead":
            model.alive[special] = False
        elif name == "faint":
            op = 0.5 * cfg.alpha_min
            model.logit_opacities[special] = float(np.log(op / (1 - op)))
    culled = name in ("behind_and_near", "degenerate_scale", "off_screen",
                      "dead", "faint")
    return model, cam, cfg, (1 if name == "sh3_as_1" else degree), special, culled


def _twin_inputs(model):
    return (model.means.detach(), model.quats.detach(),
            model.log_scales.detach(), model.logit_opacities.detach(),
            model.sh_dc.detach(), model.sh_rest.detach(), model.alive)


@pytest.mark.parametrize("name", TWIN_CASES)
def test_project_twin_matches_plain(name):
    """P's twin against project_gaussians + make_payload on the CPU: every
    float channel of every row, the integer fields and `valid` by the
    file's rule, channels 14-15 zero."""
    model, cam, cfg, deg, special, culled = _twin_case(name)
    with torch.no_grad():
        want_p = project_gaussians(model.means, model.quats, model.log_scales,
                                   model.logit_opacities, model.sh, cam, cfg,
                                   sh_degree=deg, alive=model.alive)
        want = make_payload(want_p)
    got, radius, radius_xy, valid = project_twin(*_twin_inputs(model), cam,
                                                 cfg, deg)
    assert got.shape == want.shape == (model.capacity, PAYLOAD_DIM)
    np.testing.assert_allclose(np_(got)[:, :PAYLOAD_RADIUS],
                               np_(want)[:, :PAYLOAD_RADIUS],
                               rtol=1e-5, atol=1e-5)
    assert_ints_close(np_(radius), np_(want_p.radius))
    assert_ints_close(np_(radius_xy), np_(want_p.radius_xy))
    assert_ints_close(np_(valid), np_(want_p.valid))
    np.testing.assert_array_equal(np_(got)[:, PAYLOAD_RADIUS:PAYLOAD_DIM - 2],
                                  np.c_[np_(radius), np_(radius_xy)])
    assert not got[:, PAYLOAD_DIM - 2:].any()
    assert 0 < int(valid.sum())
    if culled:
        assert not valid[special].any() and not want_p.valid[special].any()
        assert (radius[special] == 0).all()


def test_project_cuda_refuses_what_it_does_not_take():
    model, cam, cfg, _, _, _ = _twin_case("sh3", n=64)
    args = _twin_inputs(model)
    with pytest.raises(ValueError, match="CUDA tensors"):
        project_cuda(*args, cam, cfg, 3)
    with pytest.raises(ValueError, match="sh_degree"):
        project_cuda(*args[:5], args[5][:, :9].contiguous(), args[6], cam,
                     cfg, 2)
    with pytest.raises(ValueError, match="sh_rest must have one of"):
        project_cuda(*args[:5], args[5][:, :10].contiguous(), args[6], cam,
                     cfg, 1)
    with pytest.raises(ValueError, match="contiguous"):
        project_cuda(args[0].t().contiguous().t(), *args[1:], cam, cfg, 3)
    with pytest.raises(ValueError, match="int32|bool"):
        project_cuda(*args[:6], args[6].to(torch.int32), cam, cfg, 3)


def test_render_takes_the_kernel_only_without_grad(monkeypatch):
    """render()'s dispatch on the CPU with P's twin in the kernel's place
    and the CUDA backend pretended: the twin runs (counter
    `project_kernel` 1) under inference mode and gives the plain path's
    image; under grad, and with `mean2d_offset`, the plain path runs
    (counter 0) and the twin is not called."""
    from torch.profiler import ProfilerActivity, profile

    model, cam, cfg, _, _, _ = _twin_case("sh3", n=256)
    calls = []

    def twin(*args):
        calls.append(1)
        return project_twin(*args)

    with torch.inference_mode():
        want = render_mod.render(model, cam, RasterConfig(impl="torch"))
    monkeypatch.setattr(render_mod, "resolve_impl", lambda impl, dev: "cuda")
    monkeypatch.setattr(render_mod, "project_cuda", twin)
    spans.RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.inference_mode():
            got = render_mod.render(model, cam, cfg)
        graded = render_mod.render(model, cam, cfg)
        offset = torch.zeros((model.capacity, 2), requires_grad=True)
        with torch.no_grad():
            render_mod.render(model, cam, cfg, mean2d_offset=offset)
    frames = spans.calls("gs.render")
    spans.RECORDER.reset()
    assert len(calls) == 1
    assert [c.counter("project_kernel") for c in frames] == [1, 0, 0]
    assert [[s.name for s in c.spans].count("gs.project")
            for c in frames] == [1, 2, 2]
    assert graded.image.requires_grad
    assert int(got.num_pairs) == int(want.num_pairs) > 0
    assert torch.equal(got.radii, want.radii)
    assert_images_close(np_(got.image), np_(want.image))
    assert_images_close(np_(got.transmittance), np_(want.transmittance))
