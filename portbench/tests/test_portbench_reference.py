"""The plain reference against gaussiansplat_tpu_torch's plain CPU path at a
tiny size: the forward image and transmittance, every parameter group's
gradient of the training loss, and one Adam update.

The early exit is off here (trans_eps = 0) so that both sides composite
the same pairs; the benchmark's cells keep it on, and the reference's
tile-granular exit is checked by test_portbench_counts.py.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig  # noqa: E402
from gaussiansplat_tpu_torch.models.gaussians import GaussianModel  # noqa: E402
from gaussiansplat_tpu_torch.render import render  # noqa: E402
from gaussiansplat_tpu_torch.train import init_train_state, make_train_step  # noqa: E402
from gaussiansplat_tpu_torch.train.loss import photometric_loss  # noqa: E402

from portbench import inputs  # noqa: E402
from portbench.programs import gauss3d  # noqa: E402
from portbench.reference import render as R  # noqa: E402
from portbench.reference import scenes  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402

W, H, FX = 64, 48, 60.0
RASTER = dict(tile_size=16, chunk_size=32, pairs_per_gaussian=8.0,
              max_tiles_per_gaussian=1024, cov2d_dilation=0.3,
              sigma_radius=3.0, tile_cull=True, alpha_min=1 / 255,
              alpha_max=0.999, trans_eps=0.0, near=0.2, far=1e6)
TRAIN = dict(iterations=30000, ssim_lambda=0.2, lr_means=1.6e-4,
             lr_means_final=1.6e-6, lr_quats=1e-3, lr_scales=5e-3,
             lr_opacities=5e-2, lr_sh_dc=2.5e-3, lr_sh_rest=1.25e-4,
             beta1=0.9, beta2=0.999, adam_eps=1e-15)
LEAVES = ref_train.LEAVES


@pytest.fixture(scope="module")
def scene():
    params, alive = scenes.bench_scene(7, 600, 3, 0.8, (0.004, 0.012), W, H,
                                       FX, 0.05, "cpu")
    rot, t = scenes.look_at(scenes.orbit_eye(0.7, 0.2, 4.0), (0, 0, 0),
                            (0, 1, 0))
    pose = inputs.Pose(R=rot, t=t, fx=FX, fy=FX, cx=(W - 1) / 2,
                       cy=(H - 1) / 2, width=W, height=H)
    return params, alive, pose


def _port(params, alive):
    return GaussianModel(**{k: params[k].clone() for k in LEAVES},
                         alive=alive.clone())


def _ref_forward(params, alive, pose, deg=3):
    cam = inputs.ref_camera(pose, "cpu")
    rc = R.Raster.from_dict(RASTER)
    proj = R.project(params, alive, cam, rc, deg)
    img, trans, _ = R.render(proj, cam, rc, torch.zeros(3))
    return img, trans


def test_forward_matches_the_port(scene):
    params, alive, pose = scene
    with torch.no_grad():
        out = render(_port(params, alive), gauss3d.camera(pose, "cpu"),
                     RasterConfig(**RASTER))
    img, trans = _ref_forward(params, alive, pose)
    assert float(img.max()) > 0.1
    np.testing.assert_allclose(out.image.numpy(), img.numpy(), atol=2e-5)
    np.testing.assert_allclose(out.transmittance.numpy(), trans.numpy(),
                               atol=2e-5)


def _target(params, alive, pose):
    noisy = dict(params)
    noisy["sh_dc"] = params["sh_dc"] + 0.3 * torch.randn(
        params["sh_dc"].shape, generator=torch.Generator().manual_seed(3))
    return _ref_forward(noisy, alive, pose)[0]


def test_every_gradient_matches_the_port(scene):
    params, alive, pose = scene
    gt = _target(params, alive, pose)
    m = _port(params, alive)
    out = render(m, gauss3d.camera(pose, "cpu"), RasterConfig(**RASTER))
    photometric_loss(out.image, gt, 0.2).backward()

    cam = inputs.ref_camera(pose, "cpu")
    rc = R.Raster.from_dict(RASTER)
    leaves = {k: params[k].clone().requires_grad_(True) for k in LEAVES}
    proj = R.project(leaves, alive, cam, rc, 3)
    img, _, _ = R.render(proj, cam, rc, torch.zeros(3))
    img.requires_grad_(True)
    (dimg,) = torch.autograd.grad(ref_train.loss_fn(img, gt, 0.2), img)
    dfields = R.raster_backward(proj, proj["fields"], cam, rc, dimg,
                                torch.zeros(3))
    grads = torch.autograd.grad(proj["fields"], list(leaves.values()),
                                grad_outputs=dfields)
    for k, g in zip(LEAVES, grads):
        got = getattr(m, k).grad
        scale = float(g.abs().max())
        assert scale > 0, k
        err = float((got - g).abs().max()) / scale
        assert err < 1e-3, (k, err)


def test_one_adam_update_matches_the_port(scene):
    params, alive, pose = scene
    gt = _target(params, alive, pose)
    extent = ref_train.extent_of(params["means"], alive)
    m = _port(params, alive)
    tcfg = TrainConfig(**{k: TRAIN[k] for k in gauss3d.TRAIN_FIELDS})
    state = init_train_state(m, tcfg, extent)
    step = make_train_step(RasterConfig(**RASTER), tcfg)
    state, met = step(state, gauss3d.camera(pose, "cpu"), gt, 3)

    want = ref_train.follow(params, alive,
                            [(inputs.ref_camera(pose, "cpu"), gt,
                              torch.zeros(3))],
                            R.Raster.from_dict(RASTER), TRAIN, 3, extent, 1)
    assert abs(float(met["loss"]) - want["losses"][0]) < 1e-5
    for k in LEAVES:
        got = float(torch.linalg.vector_norm(getattr(m, k).detach() - params[k]))
        assert math.isclose(got, want["change_norms"][k], rel_tol=2e-3), k
