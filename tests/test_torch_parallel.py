"""The port's sharded paths (gaussiansplat_tpu_torch.parallel) in 2 and 4
gloo processes on the CPU, against the reference's `gaussiansplat_tpu.
parallel` on the same mesh shape (the 8-device CPU mesh of conftest.py) and
against the port's own single-device `render` / train step. The cases of
tests/test_parallel.py: the tile-sharded render (tile 2 and 4), uneven rows
rejected, the (data=2, tile=2) L1 step, the halo-SSIM objective (tile 2
and 4), and a (data=2, tile=2) run whose replicas stay bit-equal.

This file is also the ranks' entry point:

    python tests/test_torch_parallel.py --worker JOB --rank R --world N \
        --init file:///path/store --inputs in.npz --out DIR

The ranks import neither JAX nor the reference package: the test process
writes every input as numpy to `in.npz`, and each rank writes its results
to DIR/JOB_rank<R>.npz. They rendezvous through a FileStore (no ports),
run one thread each and wait at most `TIMEOUT_S` on any collective.
"""

import argparse
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 90
W = 64
PARAMS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc", "sh_rest")
# The cases each job runs, in order (one process group per job).
JOBS = {2: ["render_t2", "halo_t2"], 4: ["render_t4", "halo_t4", "l1_d2t2",
                                       "steps_d2t2"]}
MESHES = {"render_t2": (1, 2), "halo_t2": (1, 2), "render_t4": (1, 4),
          "halo_t4": (1, 4), "l1_d2t2": (2, 2), "steps_d2t2": (2, 2)}
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


def worker_main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=args.init, rank=args.rank,
                            world_size=args.world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        inp = dict(np.load(args.inputs))
        res = {}
        for case in JOBS[args.world]:
            for k, v in _run_case(case, inp).items():
                res[f"{case}/{k}"] = v
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "gaussiansplat_tpu")]
        if bad:
            raise AssertionError(f"a rank imported {bad[:5]}")
        np.savez(os.path.join(args.out, f"{args.worker}_rank{args.rank}.npz"),
                 **res)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]))


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
    for k, v in cases.items():
        if k.startswith("render"):
            cases[k] = (v[0], [v[1]], None)
    return cases


def _write_inputs(path, cases):
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
    np.savez(path, **arrays)


def _launch(world, tmp, inputs):
    """Run job `world` in `world` processes; the results of each rank."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    store = tmp / f"store{world}"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         f"w{world}", "--rank", str(r), "--world", str(world), "--init",
         f"file://{store}", "--inputs", str(inputs), "--out", str(tmp)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    return procs


def _wait(procs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=4 * TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both jobs (2 and 4 ranks, started together) and the inputs they
    were given."""
    tmp = tmp_path_factory.mktemp("gloo")
    cases = _cases()
    inputs = tmp / "in.npz"
    _write_inputs(inputs, cases)
    procs = {w: _launch(w, tmp, inputs) for w in JOBS}
    for w in JOBS:
        _wait(procs[w])
    results = {}
    for w, names in JOBS.items():
        ranks = [dict(np.load(tmp / f"w{w}_rank{r}.npz")) for r in range(w)]
        for case in names:
            results[case] = [{k[len(case) + 1:]: v for k, v in rk.items()
                              if k.startswith(case + "/")} for rk in ranks]
    return cases, results


def _close_scaled(got, want, atol, what):
    for k in want:
        w = np.asarray(want[k])
        scale = np.abs(w).max() + 1e-8
        np.testing.assert_allclose(np.asarray(got[k]) / scale, w / scale,
                                   atol=atol, err_msg=f"{what}: {k}")


def _jax_cfg():
    from gaussiansplat_tpu.config import RasterConfig

    return RasterConfig(tile_size=32, chunk_size=128, impl="xla")


@pytest.mark.parametrize("ntile", [2, 4])
def test_tile_sharded_render(runs, ntile):
    import jax
    import jax.numpy as jnp

    from gaussiansplat_tpu.parallel import make_mesh, make_tile_sharded_render
    from gaussiansplat_tpu_torch.render import render
    from test_torch_common import port_camera, port_model

    cases, results = runs
    jm, (jcam,), _ = cases[f"render_t{ntile}"]
    bg = jnp.array([0.1, 0.2, 0.3])
    f = jax.jit(make_tile_sharded_render(make_mesh(data=1, tile=ntile),
                                         _jax_cfg(), jcam.width, jcam.height, 1))
    jimg, jtrans = f(jm, jcam, bg)
    tm = port_model(jm)
    out = render(tm, port_camera(jcam), _raster_cfg(), sh_degree=1,
                 background=torch.tensor([0.1, 0.2, 0.3]))
    (out.image ** 2).sum().backward()
    single = {k: p.grad.numpy() for k, p in tm.trainable().items()}
    for r, res in enumerate(results[f"render_t{ntile}"]):
        assert res["image"].shape == (jcam.height, jcam.width, 3)
        for want in (np.asarray(jimg), out.image.detach().numpy()):
            np.testing.assert_allclose(res["image"], want, atol=1e-5)
        for want in (np.asarray(jtrans), out.transmittance.detach().numpy()):
            np.testing.assert_allclose(res["trans"], want, atol=1e-5)
        _close_scaled({k: res[f"grad/{k}"] for k in single}, single, 1e-4,
                      f"rank {r} strip grads summed over the tile group")


def test_uneven_rows_rejected():
    from gaussiansplat_tpu_torch.parallel import (
        Mesh, make_sharded_train_step, make_tile_sharded_render)
    from gaussiansplat_tpu_torch.config import TrainConfig

    mesh = Mesh(1, 2, 0, None, None, None)          # shape only: no group
    with pytest.raises(ValueError, match="divide"):
        make_tile_sharded_render(mesh, _raster_cfg(), 96, 96, 1)   # 3 rows
    with pytest.raises(ValueError, match="divide"):
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


@pytest.mark.parametrize("ntile", [2, 4])
def test_halo_ssim_objective(runs, ntile):
    """L1 + DSSIM at ssim_lambda 0.2: with the 5-row halo exchange the
    strip-sharded loss is the single-device loss (1e-6) and so are its
    gradients (1e-4 of each group's largest entry)."""
    from gaussiansplat_tpu_torch.config import TrainConfig
    from gaussiansplat_tpu_torch.train import init_train_state, make_train_step
    from test_torch_common import port_camera, port_model

    cases, results = runs
    jm, jcams, gts = cases[f"halo_t{ntile}"]
    jloss, jgrads = _jax_sharded_step("halo", jm, jcams, gts, 1, ntile,
                                      dict(random_background=False,
                                           ssim_lambda=0.2))
    tcfg = TrainConfig(iterations=10, random_background=False, ssim_lambda=0.2)
    tm = port_model(jm)
    state = init_train_state(tm, tcfg, extent=1.0)
    _, met = make_train_step(_raster_cfg(), tcfg)(
        state, port_camera(jcams[0]), torch.as_tensor(gts[0]), 1)
    single = {k: p.grad.numpy() for k, p in tm.trainable().items()}
    for r, res in enumerate(results[f"halo_t{ntile}"]):
        for want in (jloss, float(met["loss"])):
            np.testing.assert_allclose(float(res["loss0"]), want, atol=1e-6)
        got = {k: res[f"grad/{k}"] for k in PARAMS}
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
