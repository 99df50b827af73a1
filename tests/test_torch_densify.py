"""Port parity of density control on the CPU: `densify_step`, `prune_step`,
`reset_opacity` and the trainer's densify pass against the reference
package on the same numpy inputs (the cases of tests/test_train.py
TestDensify, TestPruneScreen and TestDensifyMoments, plus mixed ones).

Masks, counts, slots and `alive` must be exactly equal and clones
bit-equal; the split samples (a rotation of the drawn normals, computed by
XLA and by PyTorch) within 1e-6. The two normal draws cannot match across
frameworks, so the port's `_densify` is given the reference's draws:
`jax.random.normal(key)` and `jax.random.normal(fold_in(key, 1))`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import np_, port_camera, port_model

from gaussiansplat_tpu.config import TrainConfig as JTrainConfig
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.models import densify as j_densify
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.train import trainer as j_trainer
from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
from gaussiansplat_tpu_torch.models import densify
from gaussiansplat_tpu_torch.models.densify import DensifyState
from gaussiansplat_tpu_torch.models.gaussians import PARAM_NAMES
from gaussiansplat_tpu_torch.train import (
    init_train_state,
    make_densify_fn,
    make_opacity_reset_fn,
    make_train_step,
)

KEY = jax.random.PRNGKey(1)
INFO_KEYS = ("cloned", "split", "dropped")


def _jax_model(n=32, cap=128, kill_every=0):
    m = j_random_model(jax.random.PRNGKey(0), n, sh_degree=1, capacity=cap)
    if kill_every:
        m = m.replace(alive=m.alive.at[::kill_every].set(False))
    return m


def _states(jm, grads, counts=None):
    """The same statistics for both packages from numpy arrays."""
    counts = np.asarray(jm.alive).astype(np.int32) if counts is None else counts
    radii = np.zeros(jm.capacity, np.int32)
    js = j_densify.DensifyState.zeros(jm.capacity).replace(
        grad2d_sum=jnp.asarray(grads, jnp.float32),
        grad2d_count=jnp.asarray(counts))
    ts = DensifyState(grad2d_sum=torch.tensor(grads, dtype=torch.float32),
                      grad2d_count=torch.tensor(counts),
                      max_radii=torch.tensor(radii))
    return js, ts


def _draws(jm):
    shape = jm.means.shape
    eps = np.asarray(jax.random.normal(KEY, shape))
    eps2 = np.asarray(jax.random.normal(jax.random.fold_in(KEY, 1), shape))
    return torch.tensor(eps), torch.tensor(eps2)


def _assert_models_match(tm, jm, exact):
    np.testing.assert_array_equal(np_(tm.alive), np.asarray(jm.alive))
    for k in PARAM_NAMES:
        got, want = np_(getattr(tm, k)), np.asarray(getattr(jm, k))
        if exact or k not in ("means", "log_scales"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)


CASES = {
    # name: (n, cap, kill_every, cfg kwargs, grads(alive, cap))
    "clone_fill": (32, 128, 0, dict(densify_grad_thresh=0.0,
                                    densify_scale_thresh=1e9),
                   lambda a, c: np.where(a, 1.0, 0.0)),
    "split_shrink": (32, 128, 0, dict(densify_grad_thresh=0.0,
                                      densify_scale_thresh=0.0),
                     lambda a, c: np.where(a, 1.0, 0.0)),
    "top_fraction": (32, 128, 0, dict(densify_grad_thresh=1e9,
                                      densify_scale_thresh=1e9,
                                      densify_target_fraction=0.25),
                     lambda a, c: np.where(a, 1e-6 * (np.arange(c) + 1.0), 0.0)),
    "no_eligible": (32, 128, 0, dict(densify_target_fraction=0.25,
                                     densify_scale_thresh=1e9),
                    lambda a, c: np.zeros(c)),
    "saturation": (32, 40, 0, dict(densify_grad_thresh=0.0,
                                   densify_scale_thresh=1e9),
                   lambda a, c: np.where(a, 1.0, 0.0)),
    # ties in the ranking, dead slots between alive ones, clones and
    # splits together, more requests than free slots
    "mixed_ties_saturated": (48, 64, 5, dict(densify_target_fraction=0.9,
                                             densify_scale_thresh=0.05),
                             lambda a, c: np.where(a, 1e-5 * (np.arange(c) % 7),
                                                   0.0)),
    "mixed_threshold": (48, 128, 3, dict(densify_grad_thresh=2.5e-5,
                                         densify_scale_thresh=0.05),
                        lambda a, c: np.where(a, 1e-5 * (np.arange(c) % 7), 0.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_densify_step_matches_jax(case):
    n, cap, kill, kw, grads_fn = CASES[case]
    jm = _jax_model(n, cap, kill)
    grads = grads_fn(np.asarray(jm.alive), cap).astype(np.float32)
    js, ts = _states(jm, grads)
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    fn = jax.jit(lambda m, s, k: j_densify.densify_step(m, s, k, jcfg,
                                                        jnp.float32(1.0)))
    jnew, jstate, jinfo = fn(jm, js, KEY)
    tm = port_model(jm)
    eps, eps2 = _draws(jm)
    tnew, tstate, tinfo = densify._densify(tm, ts, cfg, 1.0, eps, eps2)
    assert tnew is tm
    for k in INFO_KEYS:
        assert tinfo[k] == int(jinfo[k]), k
    np.testing.assert_array_equal(np_(tinfo["touched"]), np.asarray(jinfo["touched"]))
    _assert_models_match(tm, jnew, exact=int(jinfo["split"]) == 0)
    assert int(np_(tstate.grad2d_count).sum()) == 0
    assert float(np_(tstate.grad2d_sum).sum()) == 0.0
    if case == "clone_fill":
        assert int(tm.num_alive) == 64 and tinfo["cloned"] == 32
    if case == "saturation":
        assert int(tm.num_alive) == 40 and tinfo["dropped"] == 24
    if case == "split_shrink":
        assert tinfo["split"] == 32
    if case == "mixed_ties_saturated":
        assert tinfo["cloned"] > 0 and tinfo["split"] > 0 and tinfo["dropped"] > 0


def test_densify_step_draws_from_generator():
    """`densify_step` draws its normals from the generator: the same seed
    gives the same model, and it equals `_densify` given those draws."""
    jm = _jax_model()
    grads = np.where(np.asarray(jm.alive), 1.0, 0.0).astype(np.float32)
    cfg = TrainConfig(densify_grad_thresh=0.0, densify_scale_thresh=0.0)
    a, b = port_model(jm), port_model(jm)
    _, sa = _states(jm, grads)
    _, sb = _states(jm, grads)
    densify.densify_step(a, sa, torch.Generator().manual_seed(3), cfg, 1.0)
    g = torch.Generator().manual_seed(3)
    eps, eps2 = torch.randn((128, 3), generator=g), torch.randn((128, 3), generator=g)
    densify._densify(b, sb, cfg, 1.0, eps, eps2)
    for k in PARAM_NAMES:
        torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=0, atol=0)


@pytest.mark.parametrize("case", ["faint", "screen", "screen_off", "world"])
def test_prune_step_matches_jax(case):
    jm = _jax_model(32, 64)
    max_radii = np.where(np.arange(64) < 5, 500, 10).astype(np.int32)
    kw, big, px = {}, False, None
    if case == "faint":
        jm = jm.replace(logit_opacities=jm.logit_opacities.at[:10].set(-10.0))
    elif case in ("screen", "screen_off"):
        kw = dict(prune_opacity=0.0, prune_radius_frac=1e9)
        big, px = True, (100.0 if case == "screen" else None)
    else:
        kw = dict(prune_opacity=0.0, prune_radius_frac=0.05)
        big, px = True, 1e9
    js = j_densify.DensifyState.zeros(64).replace(max_radii=jnp.asarray(max_radii))
    ts = DensifyState.zeros(64, device="cpu")
    ts.max_radii.copy_(torch.tensor(max_radii))
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    jnew, jinfo = jax.jit(lambda m, s: j_densify.prune_step(
        m, s, jcfg, jnp.float32(1.0), big,
        max_screen_px=None if px is None else jnp.float32(px)))(jm, js)
    tm = port_model(jm)
    _, tinfo = densify.prune_step(tm, ts, cfg, 1.0, big, max_screen_px=px)
    assert tinfo["pruned"] == int(jinfo["pruned"])
    np.testing.assert_array_equal(np_(tm.alive), np.asarray(jnew.alive))
    want = dict(faint=10, screen=5, screen_off=0)
    if case in want:
        assert tinfo["pruned"] == want[case]
    else:
        assert 0 < tinfo["pruned"] < 32


def test_reset_opacity_matches_jax():
    jm = _jax_model(32, 64)
    jm = jm.replace(logit_opacities=jm.logit_opacities.at[40:].set(3.0))
    cfg = TrainConfig()
    jnew = jax.jit(lambda m: j_densify.reset_opacity(m, JTrainConfig()))(jm)
    tm = port_model(jm)
    densify.reset_opacity(tm, cfg)
    np.testing.assert_array_equal(np_(tm.logit_opacities),
                                  np.asarray(jnew.logit_opacities))
    op = torch.sigmoid(tm.logit_opacities[:32])
    assert bool((op <= cfg.opacity_reset_value + 1e-5).all())
    assert bool((tm.logit_opacities[40:] == 3.0).all())   # dead slots kept


def _fake_moments(optimizer, value=1.0):
    for group in optimizer.param_groups:
        p = group["params"][0]
        optimizer.state[p] = dict(step=torch.tensor(1.0),
                                  exp_avg=torch.full_like(p, value),
                                  exp_avg_sq=torch.full_like(p, value))


def test_densify_fn_resets_moments_like_jax():
    """Split-in-place originals and slots whose `alive` flipped get fresh
    Adam moments, at the same rows as the reference's optax leaves; the
    other rows and the step counts are kept."""
    jm = j_random_model(jax.random.PRNGKey(0), 32, sh_degree=1, capacity=128)
    jm = jm.replace(logit_opacities=jm.logit_opacities.at[:3].set(-10.0))
    kw = dict(densify_grad_thresh=0.0, densify_scale_thresh=0.0)
    jstate, tx = j_trainer.init_train_state(jm, JTrainConfig(**kw), extent=1.0)
    grads = np.where(np.asarray(jm.alive), 1.0, 0.0).astype(np.float32)
    js, ts = _states(jm, grads)
    jstate = jstate.replace(
        opt_state=jax.tree_util.tree_map(
            lambda x: jnp.ones_like(x) if hasattr(x, "shape") and x.ndim >= 1
            else x, jstate.opt_state),
        densify=js)
    jnew, jinfo = j_trainer.make_densify_fn(tx, JTrainConfig(**kw))(
        jstate, jnp.float32(1.0), False, jnp.float32(1e9))
    jzero = np.zeros(128, bool)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jnew.opt_state)
              if hasattr(x, "shape") and x.ndim >= 1 and x.shape[0] == 128]
    assert leaves
    for leaf in leaves:
        jzero |= (leaf.reshape(128, -1) == 0).all(1)

    model = port_model(jm)
    state = init_train_state(model, TrainConfig(**kw), 1.0)
    state.densify = ts
    _fake_moments(state.optimizer)
    state, info = make_densify_fn(TrainConfig(**kw))(state, 1.0, False, 1e9)
    for k in ("cloned", "split", "dropped", "pruned"):
        assert info[k] == int(jinfo[k]), k
    assert info["split"] == 32 and info["pruned"] == 6
    np.testing.assert_array_equal(np_(model.alive), np.asarray(jnew.model.alive))
    for group in state.optimizer.param_groups:
        p = group["params"][0]
        assert p is getattr(model, group["name"])
        st = state.optimizer.state[p]
        assert float(st["step"]) == 1.0
        for key in ("exp_avg", "exp_avg_sq"):
            zero = (np_(st[key]).reshape(128, -1) == 0).all(1)
            np.testing.assert_array_equal(zero, jzero, err_msg=group["name"])
            assert (np_(st[key])[~zero] == 1.0).all()
    # split originals, and new copies that stayed alive (the faint
    # originals' copies were placed and pruned again: no flip, no reset)
    assert jzero[:32].all() and jzero[35:64].all()
    assert not jzero[32:35].any() and not jzero[64:].any()


def test_densify_keeps_optimizer_params_and_new_slots_train():
    """After a densify pass every optimizer group still holds the model's
    own parameter, and the next step moves a newly placed clone."""
    jm = j_random_model(jax.random.PRNGKey(2), 32, sh_degree=1, capacity=64)
    jcam = j_look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=120.0,
                     fy=120.0, width=48, height=48)
    model, cam = port_model(jm), port_camera(jcam)
    gt = torch.rand((48, 48, 3), generator=torch.Generator().manual_seed(0))
    cfg = TrainConfig(densify_grad_thresh=0.0, densify_scale_thresh=1e9)
    state = init_train_state(model, cfg, 1.0)
    step = make_train_step(RasterConfig(), cfg)
    for _ in range(2):
        state, _ = step(state, cam, gt, 1)
    visible = np_(state.densify.grad2d_count) > 0
    state, info = make_densify_fn(cfg)(state, 1.0, False, None)
    assert info["cloned"] == int(visible.sum()) > 0
    for group in state.optimizer.param_groups:
        assert group["params"][0] is getattr(model, group["name"])
    new = np.nonzero(np_(model.alive))[0][32:]
    before = np_(model.means).copy()
    state = make_opacity_reset_fn(cfg)(state)
    state, _ = step(state, cam, gt, 1)
    moved = np.abs(np_(model.means)[new] - before[new]).max(1) > 0
    assert moved.any()
