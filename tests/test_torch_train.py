"""Port parity of the loss, the optimizer and one training step on the CPU.

* `ssim_map`, `ssim`, `l1`, `photometric_loss`, `psnr` and their input
  gradients against the reference on the same numpy images: within 1e-5
  (the SSIM map and the gradients scaled by their largest magnitude). The
  blur runs as a conv here and as banded matmuls there: the same sums in
  another order.
* `position_lr_schedule` at steps 0, iterations / 2 and iterations, and each
  group's lr: within 1e-6 relative (the reference evaluates it in f32).
* `DensifyState.update`: exact.
* The optimizer: the port's Adam, fed the reference's gradients as numpy,
  against optax's updated parameters over two steps: within 1e-6 of the
  parameter, plus 1e-5 of the group's lr for each step taken, plus one f32
  ULP of the parameter. The lr term: optax evaluates the bias corrections 1 - b^t in
  f32, where b2 = 0.999 rounds to 0.99900001, so at step 1 its
  sqrt(1 - b2^t) is 6.4e-6 off the value torch computes in double, and
  every step (~lr) moves by that factor; a parameter near zero has no
  relative headroom for it. The ULP: the last rounding of p + dp.
* One `make_train_step` on each side, the reference on its XLA twin and
  both with trans_eps = 0 (the twin never exits early): the loss within
  rtol 1e-5, the integer metrics equal, every parameter group's gradient
  within 2e-3 of its largest magnitude (the bound of the render gradient
  checks), the new parameters within 1e-6 where |g| > 1e-3 max|g| for the
  group, in the optimizer check's terms (Adam's first step moves each
  entry by ~lr sign(g), so an entry whose gradient is near zero can take
  either sign), and the densification
  statistics within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_common import np_, port_camera, port_model

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.config import TrainConfig as JTrainConfig
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.models.densify import DensifyState as JDensifyState
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.render import render as j_render
from gaussiansplat_tpu.train import loss as j_loss
from gaussiansplat_tpu.train import trainer as j_trainer
from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
from gaussiansplat_tpu_torch.models import random_model
from gaussiansplat_tpu_torch.models.densify import DensifyState
from gaussiansplat_tpu_torch.models.gaussians import PARAM_NAMES
from gaussiansplat_tpu_torch.ops.camera import look_at
from gaussiansplat_tpu_torch.train import (
    init_train_state,
    l1,
    make_optimizer,
    make_train_step,
    photometric_loss,
    position_lr_schedule,
    psnr,
    set_position_lr,
    ssim,
    ssim_map,
)


def _scaled_close(got, want, atol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), what
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol,
                               err_msg=what)


def _assert_params_close(got, want, lr, steps, what):
    """Within 1e-6 |p| + 1e-5 lr per step + one f32 ULP of p."""
    want = np.asarray(want, np.float32)
    tol = 1e-6 * np.abs(want) + 1e-5 * lr * steps + np.spacing(np.abs(want))
    bad = np.abs(np.asarray(got, np.float32) - want) > tol
    assert not bad.any(), f"{what}: {bad.sum()} entries off"


def _images(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((h, w, 3)).astype(np.float32)
    # b correlated with a, so SSIM is far from 0.
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


def test_loss_values_match_jax():
    a, b = _images()
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _scaled_close(np_(ssim_map(ta, tb)), j_loss.ssim_map(ja, jb), 1e-5, "ssim_map")
    for name, got, want in (
            ("ssim", ssim(ta, tb), j_loss.ssim(ja, jb)),
            ("l1", l1(ta, tb), j_loss.l1(ja, jb)),
            ("photometric", photometric_loss(ta, tb, 0.2),
             j_loss.photometric_loss(ja, jb, 0.2)),
            ("psnr", psnr(ta, tb), j_loss.psnr(ja, jb))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert 0.1 < float(ssim(ta, tb)) < 0.99
    assert float(ssim(ta, ta)) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("name", ["ssim", "photometric_loss"])
def test_loss_gradients_match_jax(name):
    a, b = _images(seed=1)
    fn = dict(ssim=ssim, photometric_loss=photometric_loss)[name]
    jfn = getattr(j_loss, name)
    want = np.asarray(jax.grad(lambda x: jfn(x, jnp.asarray(b)))(jnp.asarray(a)))
    x = torch.tensor(a, requires_grad=True)
    fn(x, torch.tensor(b)).backward()
    _scaled_close(np_(x.grad), want, 1e-5, name)


def test_position_lr_schedule_matches_jax():
    cfg, jcfg = TrainConfig(iterations=1000), JTrainConfig(iterations=1000)
    extent = 2.5
    sched = position_lr_schedule(cfg, extent)
    jsched = j_trainer.position_lr_schedule(jcfg, extent)
    for step in (0, 500, 1000, 2000):
        np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=1e-6)
    assert sched(0) == pytest.approx(cfg.lr_means * extent)
    assert sched(1000) == pytest.approx(cfg.lr_means_final * extent)
    m = random_model(torch.Generator().manual_seed(0), 8, device="cpu")
    opt = make_optimizer(m, cfg, extent)
    lrs = {g["name"]: g["lr"] for g in opt.param_groups}
    assert lrs == dict(means=sched(0), quats=cfg.lr_quats,
                       log_scales=cfg.lr_scales,
                       logit_opacities=cfg.lr_opacities,
                       sh_dc=cfg.lr_sh_dc, sh_rest=cfg.lr_sh_rest)
    assert set_position_lr(opt, cfg, extent, 500) == sched(500)
    assert {g["name"]: g["lr"] for g in opt.param_groups}["means"] == sched(500)
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-15


def test_densify_update_matches_jax():
    rng = np.random.default_rng(3)
    c = 64
    js, ts = JDensifyState.zeros(c), DensifyState.zeros(c, device="cpu")
    for _ in range(3):
        g = rng.normal(size=(c, 2)).astype(np.float32)
        r = rng.integers(0, 5, size=c).astype(np.int32)
        js = js.update(jnp.asarray(g), jnp.asarray(r))
        ts = ts.update(torch.tensor(g), torch.tensor(r))
    np.testing.assert_array_equal(np_(ts.grad2d_count), np.asarray(js.grad2d_count))
    np.testing.assert_array_equal(np_(ts.max_radii), np.asarray(js.max_radii))
    np.testing.assert_allclose(np_(ts.grad2d_sum), np.asarray(js.grad2d_sum),
                               rtol=1e-6)


def test_optimizer_matches_optax():
    jm = j_random_model(jax.random.PRNGKey(0), 64, sh_degree=3, extent=1.0)
    cfg, jcfg = TrainConfig(iterations=10), JTrainConfig(iterations=10)
    extent = 1.7
    tx = j_trainer.make_optimizer(jcfg, extent)
    params = jm.trainable()
    opt_state = tx.init(params)
    model = port_model(jm)
    opt = make_optimizer(model, cfg, extent)
    rng = np.random.default_rng(5)
    for step in range(2):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = tx.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k in PARAM_NAMES:
            getattr(model, k).grad = torch.tensor(grads[k])
        set_position_lr(opt, cfg, extent, step)
        opt.step()
        lrs = {g["name"]: g["lr"] for g in opt.param_groups}
        for k in PARAM_NAMES:
            _assert_params_close(np_(getattr(model, k)), params[k], lrs[k],
                                 step + 1, f"{k} after step {step}")


def _train_scene(n=256, size=64, seed=0):
    jm = j_random_model(jax.random.PRNGKey(seed), n, sh_degree=3, extent=1.0)
    jcam = j_look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=220.0,
                     fy=220.0, width=size, height=size)
    gt = np.random.default_rng(seed + 1).random((size, size, 3)).astype(np.float32)
    return jm, jcam, gt


def test_train_step_matches_jax():
    jm, jcam, gt = _train_scene()
    n = jm.capacity
    cfg, jcfg = TrainConfig(), JTrainConfig()
    rcfg = RasterConfig(trans_eps=0.0)
    jrcfg = JRasterConfig(trans_eps=0.0, packed=False, impl="xla")
    extent = 1.3

    def j_loss_fn(params):
        out = j_render(jm.with_params(params), jcam, jrcfg, sh_degree=3,
                       background=jnp.zeros(3), impl="xla")
        return j_loss.photometric_loss(out.image, jnp.asarray(gt), 0.2)

    jgrads = jax.jit(jax.grad(j_loss_fn))(jm.trainable())
    jstate, tx = j_trainer.init_train_state(jm, jcfg, extent)
    jstep = j_trainer.make_train_step(tx, jrcfg, jcfg, impl="xla")
    jstate, jmet = jstep(jstate, jcam, jnp.asarray(gt), sh_degree=3)

    model = port_model(jm)
    old = {k: np_(v).copy() for k, v in model.trainable().items()}
    state = init_train_state(model, cfg, extent)
    assert state.densify.grad2d_sum.device == model.device
    step = make_train_step(rcfg, cfg)
    state, met = step(state, port_camera(jcam), torch.tensor(gt), 3)

    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["psnr"]), float(jmet["psnr"]), rtol=1e-5)
    for k in ("num_pairs", "overflow", "max_chunks", "num_alive"):
        assert int(met[k]) == int(jmet[k]), k
    assert state.step == 1 and int(jstate.step) == 1
    jparams = jstate.model.trainable()
    for k, p in model.trainable().items():
        g, jg = np_(p.grad), np.asarray(jgrads[k])
        _scaled_close(g, jg, 2e-3, f"grad {k}")
        mask = np.abs(jg) > 1e-3 * np.abs(jg).max()
        assert mask.any(), k
        lr = {g_["name"]: g_["lr"] for g_ in state.optimizer.param_groups}[k]
        _assert_params_close(np_(p)[mask], np.asarray(jparams[k])[mask], lr,
                             1, f"params {k}")
        # Every entry moved by at most lr (Adam's first step).
        assert np.abs(np_(p) - old[k]).max() <= 1.01 * lr
    d, jd = state.densify, jstate.densify
    np.testing.assert_array_equal(np_(d.grad2d_count), np.asarray(jd.grad2d_count))
    np.testing.assert_array_equal(np_(d.max_radii), np.asarray(jd.max_radii))
    _scaled_close(np_(d.grad2d_sum), jd.grad2d_sum, 1e-5, "grad2d_sum")
    assert n == model.capacity and float(np_(d.grad2d_sum).max()) > 0


def test_train_step_runs_on_model_device_and_lowers_loss():
    g = torch.Generator().manual_seed(0)
    model = random_model(g, 128, sh_degree=1, device="cpu")
    cam = look_at((0.5, 0.3, -6.0), (0, 0, 0), fx=120.0, fy=120.0, width=48,
                  height=48, device="cpu")
    gt = torch.rand((48, 48, 3), generator=g)
    cfg = TrainConfig(random_background=True)
    state = init_train_state(model, cfg, 1.0)
    assert state.generator.device == model.device
    step = make_train_step(RasterConfig(), cfg)
    losses = []
    for _ in range(4):
        state, met = step(state, cam, gt, 1)
        losses.append(float(met["loss"]))
    assert state.step == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
