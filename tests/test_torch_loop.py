"""Port parity of the training loop and its checkpoints on the CPU.

* `Trainer.fit` against the reference's `Trainer.fit` (on its XLA twin,
  both with trans_eps = 0) over 12 iterations of the reference's
  synthetic scene: densify passes at 4 and 8 (top-fraction, clone only, so
  no random draw), an opacity reset at 8, the SH degree ramping every 3
  steps and evals at 6 and 12. Every logged count equal, the losses and
  eval scores within 1e-4 relative, the final parameters within the
  tolerance of tests/test_torch_train.py `_assert_params_close` for 12
  steps.
* The checkpoint round trip: every tensor of the train state, the
  optimizer's moments and step counts and the generator state restored
  exactly. A run resumed from step 2 equals a straight 4-step run bit for
  bit (6 views: the view order, which restarts from the seed on resume,
  is still in its first epoch).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from test_torch_common import np_, port_camera, port_model
from test_torch_train import _assert_params_close

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.config import TrainConfig as JTrainConfig
from gaussiansplat_tpu.data import synthetic_scene as j_synthetic_scene
from gaussiansplat_tpu.train import Trainer as JTrainer
from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
from gaussiansplat_tpu_torch.data import synthetic_scene
from gaussiansplat_tpu_torch.models import scene_extent
from gaussiansplat_tpu_torch.models.gaussians import PARAM_NAMES
from gaussiansplat_tpu_torch.train import Trainer, init_train_state, make_train_step
from gaussiansplat_tpu_torch.utils import (
    StageTimer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

LOOP_CFG = dict(iterations=12, densify_start=4, densify_every=4,
                densify_end=8, densify_target_fraction=0.25,
                densify_scale_thresh=1e9, opacity_reset_every=8,
                sh_degree=1, sh_increase_every=3, eval_every=6, log_every=1)
COUNTS = ("num_pairs", "overflow", "max_chunks", "num_alive", "cloned",
          "split", "dropped", "pruned")


def test_fit_matches_jax(tmp_path):
    jscene, _ = j_synthetic_scene(
        jax.random.PRNGKey(0), n_gaussians=96, n_train=4, n_test=2, width=64,
        height=64, fx=80.0,
        cfg=JRasterConfig(impl="xla", packed=False))
    jrows, rows = [], []
    jmodel, jmet = JTrainer(
        raster_cfg=JRasterConfig(trans_eps=0.0, packed=False, impl="xla"),
        cfg=JTrainConfig(**LOOP_CFG), impl="xla",
    ).fit(jscene.init_model, jscene.train_views,
          log=lambda it, m: jrows.append((it, m)),
          eval_views=jscene.test_views,
          preview_dir=str(tmp_path / "jax"))

    port = lambda views: [(port_camera(c), torch.tensor(np.asarray(im)))
                          for c, im in views]
    model = port_model(jscene.init_model)
    extent = float(scene_extent(model))
    cfg = TrainConfig(**LOOP_CFG)
    timer = StageTimer()
    out, met = Trainer(raster_cfg=RasterConfig(trans_eps=0.0), cfg=cfg).fit(
        model, port(jscene.train_views),
        log=lambda it, m: rows.append((it, m)),
        eval_views=port(jscene.test_views),
        preview_dir=str(tmp_path / "port"), timer=timer)
    assert out is model

    assert [(it, m.get("kind")) for it, m in rows] == \
        [(it, m.get("kind")) for it, m in jrows]
    assert [it for it, m in rows if m.get("kind") == "eval"] == [6, 12]
    for (it, m), (_, jm) in zip(rows, jrows):
        if m.get("kind") == "eval":
            for k in ("eval_psnr", "eval_ssim", "eval_views"):
                np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
            continue
        assert {k: m.get(k) for k in COUNTS} == {k: jm.get(k) for k in COUNTS}, it
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4,
                                       err_msg=f"{k} at {it}")
    dens = [m for it, m in rows if "cloned" in m]
    assert len(dens) == 2 and all(m["cloned"] > 0 for m in dens)
    assert rows[-2][1]["num_alive"] > rows[0][1]["num_alive"]
    assert (tmp_path / "port" / "preview_000006.png").exists()
    assert len(timer.ms["step"]) == 12 and len(timer.ms["densify"]) == 2
    assert len(timer.ms["eval_view"]) == 4

    np.testing.assert_array_equal(np_(model.alive), np.asarray(jmodel.alive))
    lrs = dict(means=cfg.lr_means * extent, quats=cfg.lr_quats,
               log_scales=cfg.lr_scales, logit_opacities=cfg.lr_opacities,
               sh_dc=cfg.lr_sh_dc, sh_rest=cfg.lr_sh_rest)
    for k in PARAM_NAMES:
        _assert_params_close(np_(getattr(model, k)), getattr(jmodel, k),
                             lrs[k], 12, k)
    np.testing.assert_allclose(met["loss"], jmet["loss"], rtol=1e-4)


def _small_scene(n_train=6):
    scene, _ = synthetic_scene(torch.Generator().manual_seed(1),
                               n_gaussians=48, n_train=n_train, n_test=1,
                               width=32, height=32, fx=40.0, device="cpu")
    return scene


RESUME_CFG = dict(iterations=4, densify_start=2, densify_every=2,
                  densify_end=4, densify_target_fraction=0.3,
                  densify_scale_thresh=0.05, random_background=True,
                  sh_degree=1, sh_increase_every=2, checkpoint_every=2,
                  log_every=1)


def test_checkpoint_roundtrip(tmp_path):
    scene = _small_scene()
    model = copy.deepcopy(scene.init_model)
    cfg = TrainConfig(**RESUME_CFG)
    state = init_train_state(model, cfg, 1.3)
    step = make_train_step(RasterConfig(), cfg)
    for cam, gt in scene.train_views[:2]:
        state, _ = step(state, cam, gt, 1)
    ckpt = str(tmp_path / "ckpts")
    path = save_checkpoint(ckpt, state, state.step)
    assert path.endswith("step_00000002") and latest_step(ckpt) == 2

    fresh = copy.deepcopy(scene.init_model)
    with torch.no_grad():
        fresh.means.add_(1.0)
    template = init_train_state(fresh, TrainConfig(), 2.0)
    restored, at = restore_checkpoint(ckpt, template)
    assert at == 2 and restored is template and restored.model is fresh
    assert restored.step == 2 and restored.extent == 1.3
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    for group in restored.optimizer.param_groups:
        p = group["params"][0]
        assert p is getattr(fresh, group["name"])
        st, want = restored.optimizer.state[p], state.optimizer.state[
            getattr(model, group["name"])]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], want[key]), (group["name"], key)
    for f in ("grad2d_sum", "grad2d_count", "max_radii"):
        assert torch.equal(getattr(restored.densify, f), getattr(state.densify, f))
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())

    missing, at = restore_checkpoint(str(tmp_path / "nope"), state)
    assert at is None and missing is state


def test_resume_equals_straight_run(tmp_path):
    scene = _small_scene()
    cfg = TrainConfig(**RESUME_CFG)
    trainer = Trainer(raster_cfg=RasterConfig(), cfg=cfg)
    straight = copy.deepcopy(scene.init_model)
    rows = []
    _, met = trainer.fit(straight, scene.train_views,
                         log=lambda it, m: rows.append((it, m)))
    assert any("cloned" in m and m["split"] > 0 for _, m in rows)

    ckpt = str(tmp_path / "ckpts")
    first = copy.deepcopy(scene.init_model)
    trainer.fit(first, scene.train_views, iterations=2, ckpt_dir=ckpt)
    assert latest_step(ckpt) == 2
    resumed = copy.deepcopy(scene.init_model)
    rrows = []
    _, rmet = trainer.fit(resumed, scene.train_views, ckpt_dir=ckpt,
                          resume=True, log=lambda it, m: rrows.append((it, m)))
    assert [it for it, _ in rrows] == [3, 4] and latest_step(ckpt) == 4
    for k, v in straight.state_dict().items():
        assert torch.equal(resumed.state_dict()[k], v), k
    assert rmet["loss"] == met["loss"]
