"""The port's gaussian-axis sharding (parallel/gauss_shard.py,
gauss_train.py, depth_ring.py, gauss2d.py, the collective helpers of
parallel/mesh.py and the counter of utils/comm_bytes.py) in 2, 3 and 4
gloo processes on the CPU, against the reference's `gaussiansplat_tpu.
parallel` on the same mesh shapes (the 8-device CPU mesh of conftest.py):

  * the collective helpers and their autograd transposes, and the bytes
    the counter records for each;
  * the gauss-sharded render at D = 2 and 4 (image 1e-5) and its gradients
    (each rank's block against the slice of the reference's, 2e-3 of each
    group's largest entry);
  * one gauss-sharded training step at D = 2 (loss, parameters, densify
    radii), whose all_to_all bytes equal `capacity.ici_bytes_per_step`;
  * the depth ring at D = 2 and 4 (doubling hops) and 3 (rotations):
    image 2e-4, gradients 2e-3, an empty scene equal to the background,
    bytes equal to `capacity.ici_bytes_per_step_ring`;
  * one (data, gauss) = (2, 2) step: loss, gradients, parameters, and the
    data replicas bit-equal.

This file is also the ranks' entry point (tests/gloo_ranks.py).
"""

import sys

import numpy as np
import torch

from gloo_ranks import close_scaled, run_jobs, worker_main

PARAMS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc", "sh_rest")
N, SIZE, SMALL = 192, 128, 64
# The cases each job runs, in order (one process group per job).
JOBS = {2: ["comm", "gs2", "step2", "ring2"], 3: ["ring3"],
        4: ["gs4", "ring4", "d2g2"]}
BG = (0.15, 0.25, 0.35)
OPS = ("all-to-all", "collective-permute", "all-reduce", "all-gather",
       "broadcast", "total")


def _cfg(**kw):
    from gaussiansplat_tpu_torch.config import RasterConfig

    return RasterConfig(tile_size=32, chunk_size=128, impl="torch", **kw)


def _tcfg():
    from gaussiansplat_tpu_torch.config import TrainConfig

    return TrainConfig(random_background=False, ssim_lambda=0.2)


def _model(inp, alive=True):
    from gaussiansplat_tpu_torch.models import from_numpy_params

    a = inp["scene/alive"] if alive else np.zeros_like(inp["scene/alive"])
    return from_numpy_params({k: inp[f"scene/{k}"] for k in PARAMS}, a,
                             device="cpu")


def _cam(inp, name):
    from gaussiansplat_tpu_torch.ops.camera import camera_from_numpy

    c = lambda k: inp[f"{name}/{k}"]
    wh = c("wh")
    return camera_from_numpy(c("R"), c("t"), c("fx"), c("fy"), c("cx"),
                             c("cy"), int(wh[0]), int(wh[1]), device="cpu")


def _grads(model):
    return {f"grad/{k}": p.grad.numpy() for k, p in model.trainable().items()}


def _bytes(counter):
    b = counter.bytes()
    return np.array([b.get(op, 0) for op in OPS], np.int64)


def _comm_case(inp):
    """Every helper on known tensors, and the autograd transposes."""
    import torch.distributed as dist

    from gaussiansplat_tpu_torch.parallel import GAUSS_AXIS, make_gauss_mesh
    from gaussiansplat_tpu_torch.parallel import mesh as pm
    from gaussiansplat_tpu_torch.utils.comm_bytes import count_collectives

    g = make_gauss_mesh().group(GAUSS_AXIS)
    r = dist.get_rank()
    x = torch.as_tensor(inp[f"comm/x{r}"])
    w = torch.as_tensor(inp[f"comm/w{r}"])
    out = {}
    with count_collectives() as c:
        out["a2a"] = pm.all_to_all(x, g).numpy()
        out["perm"] = pm.permute(x, [(0, 1), (1, 0)], g).numpy()
        out["perm_one"] = pm.permute(x, [(1, 0)], g).numpy()
        out["bcast"] = pm.broadcast(x, 1, g).numpy()
        out["sum"] = pm.all_reduce(x, "sum", g).numpy()
        out["gather"] = torch.stack(pm.all_gather(x, g)).numpy()
    out["bytes"] = _bytes(c)
    for name, fn in (("a2a", lambda t: pm.AllToAll.apply(t, g)),
                     ("perm", lambda t: pm.Permute.apply(t, [(0, 1), (1, 0)], g)),
                     ("bcast", lambda t: pm.Broadcast.apply(t, 0, g))):
        xg = x.clone().requires_grad_(True)
        (fn(xg) * w).sum().backward()
        out[f"dx_{name}"] = xg.grad.numpy()
    return out


def _run_case(case, inp):
    """One case on this rank; returns its results as numpy arrays."""
    import hashlib

    from gaussiansplat_tpu_torch.parallel import (
        init_gauss_sharded_state, make_depth_ring_render, make_gauss2d_train_step,
        make_gauss_mesh, make_gauss_sharded_render, make_gauss_sharded_train_step,
        make_mesh2d, plan_gauss_sharded, shard_model, stack_cameras)
    from gaussiansplat_tpu_torch.parallel.capacity import (
        ici_bytes_per_step, ici_bytes_per_step_ring)
    from gaussiansplat_tpu_torch.utils.comm_bytes import count_collectives

    if case == "comm":
        return _comm_case(inp)
    bg = torch.tensor(BG)
    gt = torch.as_tensor(inp["gt"])
    out = {}
    if case.startswith("gs"):
        mesh = make_gauss_mesh()
        sm = shard_model(_model(inp), mesh)
        f = make_gauss_sharded_render(mesh, _cfg(), SIZE, SIZE, 1,
                                      send_cap=N // mesh.tile)
        img, trans, aux = f(sm, _cam(inp, "cam"), bg, with_aux=True)
        ((img - gt) ** 2).mean().backward()
        out.update(image=img.detach().numpy(), trans=trans.detach().numpy(),
                   **{k: aux[k].numpy() for k in ("overflow", "pack_overflow",
                                                  "bin_overflow")},
                   **_grads(sm))
    elif case == "step2":
        mesh = make_gauss_mesh()
        plan = plan_gauss_sharded(N, 2, SIZE, SIZE, 1, _cfg(), send_fraction=1.0)
        state = init_gauss_sharded_state(_model(inp), mesh, _tcfg(), 1.0)
        step = make_gauss_sharded_train_step(mesh, _cfg(), _tcfg(), SIZE, SIZE,
                                             1, send_cap=plan.send_cap,
                                             return_grads=True)
        with count_collectives() as c:
            state, met = step(state, _cam(inp, "cam"), gt)
        out.update(loss=met["loss"].numpy(), overflow=met["overflow"].numpy(),
                   num_alive=met["num_alive"].numpy(), bytes=_bytes(c),
                   ici=np.int64(ici_bytes_per_step(plan)),
                   max_radii=state.densify.max_radii.numpy(),
                   **{f"param/{k}": p.detach().numpy()
                      for k, p in state.model.trainable().items()},
                   **{f"grad/{k}": g.numpy() for k, g in met["grads"].items()})
    elif case.startswith("ring"):
        mesh = make_gauss_mesh()
        cfg = _cfg(trans_eps=0.0)
        f = make_depth_ring_render(mesh, cfg, SIZE, SIZE, 1)
        sm = shard_model(_model(inp), mesh)
        with count_collectives() as c:
            img, trans = f(sm, _cam(inp, "cam"), bg)
            ((img - gt) ** 2).mean().backward()
        _, _, aux = f(sm, _cam(inp, "cam"), bg, with_aux=True)
        empty, empty_t = f(shard_model(_model(inp, alive=False), mesh),
                           _cam(inp, "cam"), bg)
        out.update(image=img.detach().numpy(), trans=trans.detach().numpy(),
                   overflow=aux["overflow"].numpy(), bytes=_bytes(c),
                   ring=np.int64(ici_bytes_per_step_ring(N, mesh.tile, SIZE, SIZE)),
                   empty=empty.detach().numpy(), empty_t=empty_t.detach().numpy(),
                   **_grads(sm))
    elif case == "d2g2":
        mesh = make_mesh2d(2, 2)
        state = init_gauss_sharded_state(_model(inp), mesh, _tcfg(), 1.0)
        step = make_gauss2d_train_step(mesh, _cfg(), _tcfg(), SMALL, SMALL, 1,
                                       send_cap=N // 2, return_grads=True)
        cams = stack_cameras([_cam(inp, "v0"), _cam(inp, "v1")])
        state, met = step(state, cams, torch.as_tensor(inp["gts"]))
        flat = torch.cat([p.detach().reshape(-1)
                          for p in state.model.trainable().values()])
        out.update(loss=met["loss"].numpy(), overflow=met["overflow"].numpy(),
                   digest=np.frombuffer(hashlib.sha256(
                       flat.numpy().tobytes()).digest(), np.uint8),
                   **{f"param/{k}": p.detach().numpy()
                      for k, p in state.model.trainable().items()},
                   **{f"grad/{k}": g.numpy() for k, g in met["grads"].items()})
    return out


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:], JOBS, _run_case))


# ---------------------------------------------------------------------------
# The tests (the test process imports JAX; the ranks never do).
# ---------------------------------------------------------------------------

import pytest  # noqa: E402


def _jax_cam(eye, fx, size):
    from gaussiansplat_tpu.ops import look_at

    return look_at(eye=eye, target=(0, 0, 0), fx=fx, fy=fx, width=size,
                   height=size)


def _cam_arrays(name, c):
    out = {f"{name}/{k}": np.asarray(getattr(c, k))
           for k in ("R", "t", "fx", "fy", "cx", "cy")}
    out[f"{name}/wh"] = np.array([c.width, c.height])
    return out


@pytest.fixture(scope="module")
def setup():
    """The reference scene, cameras and targets (targets from a numpy seed)."""
    import jax

    from gaussiansplat_tpu.models import random_model

    rng = np.random.default_rng(5)
    model = random_model(jax.random.PRNGKey(0), N, sh_degree=1, extent=1.0)
    cam = _jax_cam((0.5, 0.3, -6.0), 220.0, SIZE)
    views = [_jax_cam((0.4 * i - 0.2, 0.3, -6.0), 110.0, SMALL) for i in range(2)]
    gt = rng.random((SIZE, SIZE, 3), dtype=np.float32)
    gts = rng.random((2, SMALL, SMALL, 3), dtype=np.float32)
    comm = {f"comm/{k}{r}": rng.standard_normal((4, 3)).astype(np.float32)
            for k in ("x", "w") for r in range(2)}
    return dict(model=model, cam=cam, views=views, gt=gt, gts=gts, comm=comm)


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    arrays = {f"scene/{k}": np.asarray(v)
              for k, v in setup["model"].trainable().items()}
    arrays["scene/alive"] = np.asarray(setup["model"].alive)
    arrays.update(_cam_arrays("cam", setup["cam"]))
    for i, v in enumerate(setup["views"]):
        arrays.update(_cam_arrays(f"v{i}", v))
    arrays.update(gt=setup["gt"], gts=setup["gts"], **setup["comm"])
    return run_jobs(__file__, JOBS, tmp_path_factory.mktemp("gauss"), arrays)


def _jcfg(**kw):
    from gaussiansplat_tpu.config import RasterConfig

    return RasterConfig(tile_size=32, chunk_size=128, impl="xla", **kw)


def _slices(tree, nd, r):
    """Rank r's block of every leaf (the P("gauss") layout)."""
    out = {}
    for k, v in tree.items():
        v = np.asarray(v)
        n = v.shape[0] // nd
        out[k] = v[r * n:(r + 1) * n]
    return out


def test_collective_helpers_and_transposes(runs, setup):
    """all_to_all / permute / broadcast / all_reduce / all_gather values,
    the bytes the counter records (hlo_comm conventions at D = 2), and each
    autograd Function's backward as the transposed collective."""
    x = [setup["comm"][f"comm/x{r}"] for r in range(2)]
    w = [setup["comm"][f"comm/w{r}"] for r in range(2)]
    b = 4 * 3 * 4      # one (4, 3) f32 operand
    want_bytes = {"all-to-all": b // 2, "collective-permute": b,
                  "all-reduce": b, "all-gather": b, "broadcast": b // 2}
    want_bytes["total"] = sum(want_bytes.values())
    for r, res in enumerate(runs["comm"]):
        np.testing.assert_array_equal(
            res["a2a"], np.concatenate([x[0][2 * r:2 * r + 2],
                                        x[1][2 * r:2 * r + 2]]))
        np.testing.assert_array_equal(res["perm"], x[1 - r])
        np.testing.assert_array_equal(res["perm_one"],
                                      x[1] if r == 0 else np.zeros_like(x[0]))
        np.testing.assert_array_equal(res["bcast"], x[1])
        np.testing.assert_allclose(res["sum"], x[0] + x[1], rtol=1e-6)
        np.testing.assert_array_equal(res["gather"], np.stack(x))
        # The rank that sends twice (perm and perm_one) records both sends.
        got = dict(zip(OPS, res["bytes"].tolist()))
        want = dict(want_bytes)
        if r == 1:
            want["collective-permute"] += b
            want["total"] += b
        assert got == want, (r, got)
        np.testing.assert_array_equal(
            res["dx_a2a"], np.concatenate([w[0][2 * r:2 * r + 2],
                                           w[1][2 * r:2 * r + 2]]))
        np.testing.assert_array_equal(res["dx_perm"], w[1 - r])
        np.testing.assert_array_equal(res["dx_bcast"],
                                      w[0] if r == 0 else np.zeros_like(w[0]))


def _jax_gauss_render(setup, nd, loss=True):
    import jax
    import jax.numpy as jnp

    from gaussiansplat_tpu.parallel import (make_gauss_mesh,
                                            make_gauss_sharded_render,
                                            shard_model)

    mesh = make_gauss_mesh(nd)
    sm = shard_model(setup["model"], mesh)
    f = make_gauss_sharded_render(mesh, _jcfg(), SIZE, SIZE, 1, send_cap=N // nd)
    bg, gt = jnp.array(BG), jnp.asarray(setup["gt"])
    img, trans = jax.jit(f)(sm, setup["cam"], bg)

    def lossf(params):
        im, _ = f(sm.with_params(params), setup["cam"], bg)
        return jnp.mean((im - gt) ** 2)

    grads = jax.jit(jax.grad(lossf))(sm.trainable())
    return np.asarray(img), np.asarray(trans), grads


@pytest.mark.parametrize("nd", [2, 4])
def test_gauss_sharded_render_matches_reference(runs, setup, nd):
    jimg, jtrans, jgrads = _jax_gauss_render(setup, nd)
    for r, res in enumerate(runs[f"gs{nd}"]):
        assert res["image"].shape == (SIZE, SIZE, 3)
        np.testing.assert_allclose(res["image"], jimg, atol=1e-5)
        np.testing.assert_allclose(res["trans"], jtrans, atol=1e-5)
        for k in ("overflow", "pack_overflow", "bin_overflow"):
            assert int(res[k]) == 0, k
        close_scaled({k: res[f"grad/{k}"] for k in PARAMS},
                     _slices(jgrads, nd, r), 2e-3, f"rank {r} of {nd}")


def test_gauss_sharded_step_matches_reference(runs, setup):
    """One step at D = 2 against the reference's gauss-sharded step: loss
    (1e-5 relative), the parameters after Adam and the gradients (2e-3 of
    each group's largest entry, per rank's block), the densify radii; the
    counter's all_to_all bytes over the step equal the closed form."""
    import jax
    import jax.numpy as jnp

    from gaussiansplat_tpu.config import TrainConfig
    from gaussiansplat_tpu.parallel import (init_gauss_sharded_state,
                                            make_gauss_mesh,
                                            make_gauss_sharded_render,
                                            make_gauss_sharded_train_step,
                                            shard_model)
    from gaussiansplat_tpu.train.loss import photometric_loss

    tcfg = TrainConfig(random_background=False, ssim_lambda=0.2)
    mesh = make_gauss_mesh(2)
    gt = jnp.asarray(setup["gt"])
    sm = shard_model(setup["model"], mesh)
    f = make_gauss_sharded_render(mesh, _jcfg(), SIZE, SIZE, 1, send_cap=N // 2)

    def lossf(p):
        im, _ = f(sm.with_params(p), setup["cam"], jnp.zeros((3,)))
        return photometric_loss(im, gt, 0.2)

    jgrads = jax.jit(jax.grad(lossf))(sm.trainable())
    state, tx = init_gauss_sharded_state(setup["model"], mesh, tcfg, extent=1.0)
    step = make_gauss_sharded_train_step(mesh, tx, _jcfg(), tcfg, SIZE, SIZE,
                                         sh_degree=1, send_cap=N // 2)
    state2, met = step(state, setup["cam"], gt)
    params = state2.model.trainable()
    for r, res in enumerate(runs["step2"]):
        np.testing.assert_allclose(float(res["loss"]), float(met["loss"]),
                                   rtol=1e-5)
        assert int(res["overflow"]) == 0
        assert int(res["num_alive"]) == int(np.asarray(setup["model"].alive).sum())
        close_scaled({k: res[f"grad/{k}"] for k in PARAMS},
                     _slices(jgrads, 2, r), 2e-3, f"rank {r} grads")
        close_scaled({k: res[f"param/{k}"] for k in PARAMS},
                     _slices(params, 2, r), 2e-3, f"rank {r} params")
        np.testing.assert_array_equal(
            res["max_radii"], _slices({"r": state2.densify.max_radii}, 2, r)["r"])
        got = dict(zip(OPS, res["bytes"].tolist()))
        assert got["all-to-all"] == int(res["ici"]) == 2 * 1 * (N // 2) * 64


def _jax_ring(setup, nd):
    import jax
    import jax.numpy as jnp

    from gaussiansplat_tpu.parallel.depth_ring import make_depth_ring_render
    from gaussiansplat_tpu.parallel.gauss_shard import make_gauss_mesh, shard_model

    mesh = make_gauss_mesh(nd)
    f = make_depth_ring_render(mesh, _jcfg(trans_eps=0.0), SIZE, SIZE, 1)
    sm = shard_model(setup["model"], mesh)
    bg, gt = jnp.array(BG), jnp.asarray(setup["gt"])
    img, trans = jax.jit(f)(sm, setup["cam"], bg)

    def lossf(params):
        im, _ = f(sm.with_params(params), setup["cam"], bg)
        return jnp.mean((im - gt) ** 2)

    return np.asarray(img), np.asarray(trans), jax.jit(jax.grad(lossf))(
        sm.trainable())


@pytest.mark.parametrize("nd", [2, 3, 4])
def test_depth_ring_matches_reference(runs, setup, nd):
    """Doubling hops at D = 2 and 4, rotations at D = 3: image and
    transmittance within 2e-4 (the reference's own tolerance), gradients
    within 2e-3, the same frame on every rank, an empty scene equal to the
    background, and the counter's bytes over the render and its backward
    equal to the closed form."""
    jimg, jtrans, jgrads = _jax_ring(setup, nd)
    ranks = runs[f"ring{nd}"]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["image"], jimg, atol=2e-4)
        np.testing.assert_allclose(res["trans"], jtrans, atol=2e-4)
        np.testing.assert_array_equal(res["image"], ranks[0]["image"])
        assert int(res["overflow"]) == 0
        close_scaled({k: res[f"grad/{k}"] for k in PARAMS},
                     _slices(jgrads, nd, r), 2e-3, f"rank {r} of {nd}")
        np.testing.assert_allclose(res["empty"],
                                   np.broadcast_to(BG, (SIZE, SIZE, 3)), atol=1e-6)
        np.testing.assert_allclose(res["empty_t"], 1.0, atol=1e-6)
        got = dict(zip(OPS, res["bytes"].tolist()))
        assert got["total"] == int(res["ring"]), got


def test_gauss2d_step_matches_reference(runs, setup):
    """(data, gauss) = (2, 2): the batch-mean loss against the reference's
    2D step, each rank's gradient block against the reference's gradient of
    the same loss (2e-3 of each group's largest entry), the parameters
    after the step, and the two data replicas of each gauss block
    bit-equal."""
    import jax
    import jax.numpy as jnp

    from gaussiansplat_tpu.config import TrainConfig
    from gaussiansplat_tpu.parallel import (make_gauss2d_render,
                                            make_gauss2d_train_step,
                                            make_mesh2d, shard_model_2d,
                                            stack_cameras)
    from gaussiansplat_tpu.train import init_train_state
    from gaussiansplat_tpu.train.loss import photometric_loss

    tcfg = TrainConfig(random_background=False, ssim_lambda=0.2)
    mesh = make_mesh2d(2, 2)
    sm = shard_model_2d(setup["model"], mesh)
    cams = stack_cameras(setup["views"])
    gts = jnp.asarray(setup["gts"])
    render_fn = make_gauss2d_render(mesh, _jcfg(), SMALL, SMALL, 1,
                                    send_cap=N // 2)

    def loss2d(params):
        imgs, _ = render_fn(sm.with_params(params), cams, jnp.zeros((3,)))
        return jnp.mean(jax.vmap(
            lambda im, g: photometric_loss(im, g, 0.2))(imgs, gts))

    jgrads = jax.jit(jax.grad(loss2d))(sm.trainable())
    state, tx = init_train_state(sm, tcfg, extent=1.0)
    step = make_gauss2d_train_step(mesh, tx, _jcfg(), tcfg, SMALL, SMALL, 1,
                                   send_cap=N // 2)
    state2, met = step(state, cams, gts)
    params = state2.model.trainable()
    ranks = runs["d2g2"]
    for r, res in enumerate(ranks):
        g = r % 2                       # the gauss index (minor axis)
        np.testing.assert_allclose(float(res["loss"]), float(met["loss"]),
                                   rtol=1e-5)
        assert int(res["overflow"]) == 0
        close_scaled({k: res[f"grad/{k}"] for k in PARAMS},
                     _slices(jgrads, 2, g), 2e-3, f"rank {r} grads")
        close_scaled({k: res[f"param/{k}"] for k in PARAMS},
                     _slices(params, 2, g), 2e-3, f"rank {r} params")
    for g in range(2):
        assert np.array_equal(ranks[g]["digest"], ranks[2 + g]["digest"]), g
    assert not np.array_equal(ranks[0]["digest"], ranks[1]["digest"])
