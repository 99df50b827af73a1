"""The port's sharded paths (gaussiansplat_tpu_torch.parallel) in 2 and 4
gloo processes on the CPU, against the reference's `gaussiansplat_tpu.
parallel` on the same mesh shape (the 8-device CPU mesh of conftest.py) and
against the port's own single-device `render` / train step. The cases of
tests/test_parallel.py: the tile-sharded render (tile 2 and 4), uneven rows
rejected, the (data=2, tile=2) L1 step, the halo-SSIM objective (tile 2
and 4), and a (data=2, tile=2) run whose replicas stay bit-equal. Beside
them, uneven strips (3 tile rows over 2 ranks, `u2`), which the reference's
sharded paths reject: the render and the halo-SSIM step against the port's
single device.

This file is also the ranks' entry point (tests/gloo_ranks.py): the ranks
import neither JAX nor the reference package.
"""

import sys

import numpy as np
import torch

from gloo_ranks import close_scaled as _close_scaled
from gloo_ranks import run_jobs, worker_main

W = 64
PARAMS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc", "sh_rest")
# The cases each job runs, in order (one process group per job).
JOBS = {2: ["render_t2", "halo_t2", "render_u2", "halo_u2"],
        4: ["render_t4", "halo_t4", "l1_d2t2", "steps_d2t2"]}
MESHES = {"render_t2": (1, 2), "halo_t2": (1, 2), "render_t4": (1, 4),
          "halo_t4": (1, 4), "l1_d2t2": (2, 2), "steps_d2t2": (2, 2),
          "render_u2": (1, 2), "halo_u2": (1, 2)}
# Uneven strips: 80 rows are 3 tile rows of 32 (the last half padding),
# 2 and 1 over the two ranks.
UNEVEN_H = 80
N_STEPS = 3


def _raster_cfg():
    from gaussiansplat_tpu_torch.config import RasterConfig

    return RasterConfig(tile_size=32, chunk_size=128, impl="torch")


def _train_cfg(case):
    from gaussiansplat_tpu_torch.config import TrainConfig

    if case.startswith("halo"):
        return TrainConfig(iterations=10, random_background=False, ssim_lambda=0.2)
    if case.startswith("l1"):
        return TrainConfig(iterations=10, random_background=False, ssim_lambda=0.0)
    return TrainConfig(iterations=10, random_background=True, ssim_lambda=0.2)


def _port(inp, case):
    """The case's model, stacked cameras and targets from the inputs."""
    from gaussiansplat_tpu_torch.models import from_numpy_params
    from gaussiansplat_tpu_torch.ops.camera import camera_from_numpy

    model = from_numpy_params({k: inp[f"{case}/{k}"] for k in PARAMS},
                              inp[f"{case}/alive"], device="cpu")
    cams = []
    for i in range(int(inp[f"{case}/n_cams"])):
        c = lambda k: inp[f"{case}/cam{i}/{k}"]
        wh = c("wh")
        cams.append(camera_from_numpy(c("R"), c("t"), c("fx"), c("fy"),
                                      c("cx"), c("cy"), int(wh[0]), int(wh[1]),
                                      device="cpu"))
    gts = torch.as_tensor(inp[f"{case}/gts"]) if f"{case}/gts" in inp else None
    return model, cams, gts


def _run_case(case, inp):
    """One case on this rank; returns its results as numpy arrays."""
    from gaussiansplat_tpu_torch.parallel import (
        TILE_AXIS, make_mesh, make_sharded_train_step,
        make_tile_sharded_render, pad_targets, stack_cameras)
    from gaussiansplat_tpu_torch.parallel.mesh import all_reduce
    from gaussiansplat_tpu_torch.train import init_train_state

    mesh = make_mesh(*MESHES[case])
    cfg = _raster_cfg()
    model, cams, gts = _port(inp, case)
    out = {}
    if case.startswith("render"):
        cam = cams[0]
        f = make_tile_sharded_render(mesh, cfg, cam.width, cam.height, 1)
        img, trans = f(model, cam, torch.tensor([0.1, 0.2, 0.3]))
        (img ** 2).sum().backward()
        out.update(image=img.detach().numpy(), trans=trans.detach().numpy())
        for k, p in model.trainable().items():
            out[f"grad/{k}"] = all_reduce(p.grad, "sum",
                                          mesh.group(TILE_AXIS)).numpy()
        return out
    tcfg = _train_cfg(case)
    state = init_train_state(model, tcfg, extent=1.0)
    h = cams[0].height
    step = make_sharded_train_step(mesh, cfg, tcfg, W, h, 1,
                                   return_grads=True)
    targets = pad_targets(gts, h, cfg.tile_size, mesh.tile)
    out["padded_rows"] = np.int64(targets.shape[1])
    for i in range(N_STEPS if case.startswith("steps") else 1):
        state, met = step(state, stack_cameras(cams), targets)
        out[f"loss{i}"] = met["loss"].numpy()
        out[f"psnr{i}"] = met["psnr"].numpy()
        out[f"overflow{i}"] = met["overflow"].numpy()
        out[f"params{i}"] = torch.cat(
            [p.detach().reshape(-1) for p in model.trainable().values()]).numpy()
    for k, g in met["grads"].items():
        out[f"grad/{k}"] = g.numpy()
    out["step"] = np.int64(state.step)
    out["max_radii"] = state.densify.max_radii.numpy()
    out["grad2d_sum"] = state.densify.grad2d_sum.numpy()
    return out


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:], JOBS, _run_case))


# ---------------------------------------------------------------------------
# The tests (the test process imports JAX; the ranks never do).
# ---------------------------------------------------------------------------

import pytest  # noqa: E402


def _jax_setup(n, width, height, seed=0):
    import jax

    from gaussiansplat_tpu.models import random_model
    from gaussiansplat_tpu.ops import look_at

    model = random_model(jax.random.PRNGKey(seed), n, sh_degree=1, extent=1.0)
    cam = look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=220.0, fy=220.0,
                  width=width, height=height)
    return model, cam


def _second_cam(width, height):
    from gaussiansplat_tpu.ops import look_at

    return look_at(eye=(-0.4, 0.6, -5.5), target=(0, 0, 0), fx=220.0,
                   fy=220.0, width=width, height=height)


def _cases():
    """Every case's reference model, cameras and targets (targets from a
    numpy seed)."""
    rng = np.random.default_rng(3)
    cases = {}
    for t in (2, 4):
        cases[f"render_t{t}"] = (*_jax_setup(192, 128, 128), None)
        m, cam = _jax_setup(96, W, 32 * t * 2)
        cases[f"halo_t{t}"] = (m, [cam], rng.random((1, 32 * t * 2, W, 3),
                                                   dtype=np.float32))
    m, cam = _jax_setup(96, W, W)
    gts = rng.random((2, W, W, 3), dtype=np.float32)
    cases["l1_d2t2"] = (m, [cam, _second_cam(W, W)], gts)
    cases["steps_d2t2"] = cases["l1_d2t2"]
    cases["render_u2"] = _jax_setup(192, 128, UNEVEN_H)
    m, cam = _jax_setup(96, W, UNEVEN_H)
    cases["halo_u2"] = (m, [cam], rng.random((1, UNEVEN_H, W, 3),
                                             dtype=np.float32))
    for k, v in cases.items():
        if k.startswith("render"):
            cases[k] = (v[0], [v[1]], None)
    return cases


def _arrays(cases):
    arrays = {}
    for case, (m, cams, gts) in cases.items():
        for k, v in m.trainable().items():
            arrays[f"{case}/{k}"] = np.asarray(v)
        arrays[f"{case}/alive"] = np.asarray(m.alive)
        arrays[f"{case}/n_cams"] = np.int64(len(cams))
        for i, c in enumerate(cams):
            for k in ("R", "t", "fx", "fy", "cx", "cy"):
                arrays[f"{case}/cam{i}/{k}"] = np.asarray(getattr(c, k))
            arrays[f"{case}/cam{i}/wh"] = np.array([c.width, c.height])
        if gts is not None:
            arrays[f"{case}/gts"] = gts
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both jobs (2 and 4 ranks, started together) and the inputs they
    were given."""
    cases = _cases()
    return cases, run_jobs(__file__, JOBS, tmp_path_factory.mktemp("gloo"),
                           _arrays(cases))


def _jax_cfg():
    from gaussiansplat_tpu.config import RasterConfig

    return RasterConfig(tile_size=32, chunk_size=128, impl="xla")


def _case(kind, ntile):
    """The case of `kind` at `ntile` strips; `u2` is the uneven case."""
    return f"{kind}_{ntile}" if ntile == "u2" else f"{kind}_t{ntile}"


@pytest.mark.parametrize("ntile", [2, 4, "u2"])
def test_tile_sharded_render(runs, ntile):
    import jax
    import jax.numpy as jnp

    from gaussiansplat_tpu.parallel import make_mesh, make_tile_sharded_render
    from gaussiansplat_tpu_torch.render import render
    from test_torch_common import port_camera, port_model

    cases, results = runs
    case = _case("render", ntile)
    jm, (jcam,), _ = cases[case]
    tm = port_model(jm)
    out = render(tm, port_camera(jcam), _raster_cfg(), sh_degree=1,
                 background=torch.tensor([0.1, 0.2, 0.3]))
    (out.image ** 2).sum().backward()
    single = {k: p.grad.numpy() for k, p in tm.trainable().items()}
    images, transes = [out.image.detach().numpy()], [out.transmittance.detach().numpy()]
    if ntile != "u2":
        bg = jnp.array([0.1, 0.2, 0.3])
        f = jax.jit(make_tile_sharded_render(make_mesh(data=1, tile=ntile),
                                             _jax_cfg(), jcam.width,
                                             jcam.height, 1))
        jimg, jtrans = f(jm, jcam, bg)
        images.append(np.asarray(jimg))
        transes.append(np.asarray(jtrans))
    for r, res in enumerate(results[case]):
        assert res["image"].shape == (jcam.height, jcam.width, 3)
        for want in images:
            np.testing.assert_allclose(res["image"], want, atol=1e-5)
        for want in transes:
            np.testing.assert_allclose(res["trans"], want, atol=1e-5)
        _close_scaled({k: res[f"grad/{k}"] for k in single}, single, 1e-4,
                      f"rank {r} strip grads summed over the tile group")


def test_uneven_rows_rejected():
    from gaussiansplat_tpu_torch.parallel import (
        Mesh, make_sharded_train_step, make_tile_sharded_render)
    from gaussiansplat_tpu_torch.config import TrainConfig

    # Uneven strips are built (3 tile rows over 2 ranks: 2 and 1); fewer
    # tile rows than strips are rejected.
    mesh = Mesh(1, 2, 0, None, None, None)          # shape only: no group
    make_tile_sharded_render(mesh, _raster_cfg(), 96, 96, 1)       # 3 rows
    make_sharded_train_step(mesh, _raster_cfg(), TrainConfig(), 96, 96, 1)
    mesh = Mesh(1, 4, 0, None, None, None)
    with pytest.raises(ValueError, match="cannot make a strip"):
        make_tile_sharded_render(mesh, _raster_cfg(), 96, 96, 1)
    with pytest.raises(ValueError, match="cannot make a strip"):
        make_sharded_train_step(mesh, _raster_cfg(), TrainConfig(), 96, 96, 1)


def _jax_sharded_step(case, jm, jcams, gts, data, tile, tcfg_kw):
    import jax.numpy as jnp

    from gaussiansplat_tpu.config import TrainConfig
    from gaussiansplat_tpu.parallel import (make_mesh, make_sharded_train_step,
                                            pad_targets, stack_cameras)
    from gaussiansplat_tpu.train import init_train_state

    tcfg = TrainConfig(iterations=10, **tcfg_kw)
    state, tx = init_train_state(jm, tcfg, extent=1.0)
    h = jcams[0].height
    step = make_sharded_train_step(make_mesh(data=data, tile=tile), tx,
                                   _jax_cfg(), tcfg, W, h, sh_degree=1,
                                   return_grads=True)
    _, met = step(state, stack_cameras(jcams),
                  pad_targets(jnp.asarray(gts), h, 32, tile))
    return float(met["loss"]), {k: np.asarray(v) for k, v in met["grads"].items()}


def test_l1_step_data2_tile2(runs):
    """One (data=2, tile=2) step of pure L1 (exactly decomposable over
    strips): the summed gradients against the reference's sharded step and
    the port's single device on the mean-of-views loss."""
    from gaussiansplat_tpu_torch.render import render
    from gaussiansplat_tpu_torch.train.loss import photometric_loss
    from test_torch_common import port_camera, port_model

    cases, results = runs
    jm, jcams, gts = cases["l1_d2t2"]
    jloss, jgrads = _jax_sharded_step("l1", jm, jcams, gts, 2, 2,
                                      dict(random_background=False,
                                           ssim_lambda=0.0))
    tm = port_model(jm)
    loss = 0.5 * sum(
        photometric_loss(render(tm, port_camera(c), _raster_cfg(),
                                sh_degree=1).image, torch.as_tensor(g), 0.0)
        for c, g in zip(jcams, gts))
    loss.backward()
    single = {k: p.grad.numpy() for k, p in tm.trainable().items()}
    for r, res in enumerate(results["l1_d2t2"]):
        got = {k: res[f"grad/{k}"] for k in PARAMS}
        _close_scaled(got, jgrads, 1e-4, f"rank {r} vs reference")
        _close_scaled(got, single, 1e-4, f"rank {r} vs single device")
        np.testing.assert_allclose(res["loss0"], jloss, rtol=1e-6)
        assert int(res["step"]) == 1 and int(res["overflow0"]) == 0
        assert res["max_radii"].max() > 0 and res["grad2d_sum"].max() > 0


@pytest.mark.parametrize("ntile", [2, 4, "u2"])
def test_halo_ssim_objective(runs, ntile):
    """L1 + DSSIM at ssim_lambda 0.2: with the 5-row halo exchange the
    strip-sharded loss is the single-device loss (1e-6) and so are its
    gradients (1e-4 of each group's largest entry); the targets are padded
    to the strips' last tile row."""
    from gaussiansplat_tpu_torch.config import TrainConfig
    from gaussiansplat_tpu_torch.train import init_train_state, make_train_step
    from test_torch_common import port_camera, port_model

    cases, results = runs
    case = _case("halo", ntile)
    jm, jcams, gts = cases[case]
    wants, jgrads = [], None
    if ntile != "u2":
        jloss, jgrads = _jax_sharded_step("halo", jm, jcams, gts, 1, ntile,
                                          dict(random_background=False,
                                               ssim_lambda=0.2))
        wants.append(jloss)
    tcfg = TrainConfig(iterations=10, random_background=False, ssim_lambda=0.2)
    tm = port_model(jm)
    state = init_train_state(tm, tcfg, extent=1.0)
    _, met = make_train_step(_raster_cfg(), tcfg)(
        state, port_camera(jcams[0]), torch.as_tensor(gts[0]), 1)
    single = {k: p.grad.numpy() for k, p in tm.trainable().items()}
    wants.append(float(met["loss"]))
    for r, res in enumerate(results[case]):
        assert int(res["padded_rows"]) == -(-gts.shape[1] // 32) * 32
        for want in wants:
            np.testing.assert_allclose(float(res["loss0"]), want, atol=1e-6)
        got = {k: res[f"grad/{k}"] for k in PARAMS}
        if jgrads is not None:
            _close_scaled(got, jgrads, 1e-4, f"rank {r} vs reference")
        _close_scaled(got, single, 1e-4, f"rank {r} vs single device")
        np.testing.assert_allclose(float(res["psnr0"]), float(met["psnr"]),
                                   rtol=1e-5)


def test_replicas_stay_bit_equal(runs):
    """Several (data=2, tile=2) steps with random backgrounds: after every
    step the parameters of all four ranks are equal bit for bit, and the
    loss is finite."""
    _, results = runs
    ranks = results["steps_d2t2"]
    for i in range(N_STEPS):
        first = ranks[0][f"params{i}"]
        assert np.isfinite(ranks[0][f"loss{i}"])
        for r in ranks[1:]:
            assert np.array_equal(r[f"params{i}"].view(np.int32),
                                  first.view(np.int32)), f"step {i}"
    assert not np.array_equal(ranks[0]["params0"], ranks[0][f"params{N_STEPS - 1}"])
    assert int(ranks[0]["step"]) == N_STEPS
