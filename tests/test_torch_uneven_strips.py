"""Uneven strips of the port's sharded paths (parallel/render.py
`strip_bounds`, parallel/gauss_shard.py, gauss_train.py) against the plain
reference of the benchmark (portbench/reference/), on seeded random
scenes:

  * the strip bounds, and fewer tile rows than strips rejected;
  * with equal strips, the strip router and the strip gather bit-equal
    to their forms before uneven strips (one strip height; the strips
    concatenated);
  * the gauss-sharded step on 4 gloo ranks over 10 tile rows (3, 3, 2, 2)
    and on 3 over 7 (3, 2, 2): the image and transmittance on every rank,
    every rank's gradient rows against the reference's same rows, and one
    Adam update;
  * the step's spans and counters under the profiler: the one-card
    step's names and the exchange's, `sent_rows` equal to what the pack
    gives, `send_slots` to strips x send_cap, `exchange_bytes` to
    `capacity.ici_bytes_per_step`;
  * the reference with its tile blocks dealt over 4 ranks
    (portbench/reference/sharded_train.py) against itself in one process.

This file is also the ranks' entry point (tests/gloo_ranks.py).
"""

import sys

import numpy as np
import torch

from gloo_ranks import run_jobs, worker_main

PARAMS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc", "sh_rest")
N, W, FX = 6000, 96, 150.0
HEIGHT = {4: 160, 3: 112}          # 10 and 7 tile rows of 16 px
JOBS = {4: ["uneven4", "ref4"], 3: ["uneven3"]}
BG = (0.15, 0.25, 0.35)
RASTER = dict(tile_size=16, chunk_size=32, pairs_per_gaussian=8.0,
              max_tiles_per_gaussian=1024, cov2d_dilation=0.3,
              sigma_radius=3.0, tile_cull=True, alpha_min=1 / 255,
              alpha_max=0.999, trans_eps=0.0, near=0.2, far=1e6)
TRAIN = dict(iterations=30000, ssim_lambda=0.2, lr_means=1.6e-4,
             lr_means_final=1.6e-6, lr_quats=1e-3, lr_scales=5e-3,
             lr_opacities=5e-2, lr_sh_dc=2.5e-3, lr_sh_rest=1.25e-4,
             beta1=0.9, beta2=0.999, adam_eps=1e-15)
STEP_SPANS = {"gs.step", "gs.render", "gs.project", "gs.pack", "gs.exchange",
              "gs.bin", "gs.gather", "gs.raster", "gs.strips", "gs.loss",
              "gs.backward", "gs.raster.bwd", "gs.gather.bwd",
              "gs.exchange.bwd", "gs.optimizer"}


def _camera(inp, h):
    from gaussiansplat_tpu_torch.ops.camera import make_camera

    return make_camera(inp["cam/R"], inp["cam/t"], FX, FX, W, h,
                       cx=(W - 1) / 2, cy=(h - 1) / 2, device="cpu")


def _ref_case(inp):
    """The benchmark's reference following two steps with its tile blocks
    dealt over the ranks (portbench/reference/sharded_train.py)."""
    import torch.distributed as dist

    from portbench.reference import render as R
    from portbench.reference import sharded_train

    nd, r = dist.get_world_size(), dist.get_rank()
    cam = R.Camera(R=torch.as_tensor(inp["cam/R"]), t=torch.as_tensor(inp["cam/t"]),
                   fx=FX, fy=FX, cx=(W - 1) / 2, cy=(HEIGHT[nd] - 1) / 2,
                   width=W, height=HEIGHT[nd])
    view = (cam, torch.as_tensor(inp[f"gt{nd}"]), torch.zeros(3))
    params = {k: torch.as_tensor(inp[f"scene/{k}"]) for k in PARAMS}
    local = N // nd
    want = sharded_train.follow(
        params, torch.as_tensor(inp["scene/alive"]), [view, view],
        R.Raster.from_dict(RASTER), TRAIN, 3, float(inp["extent"]), 2,
        count=True, group=dist.group.WORLD, keep=(r * local, (r + 1) * local))
    return dict(losses=np.array(want["losses"]),
                grad_norms=np.array([want["grad_norms"][k] for k in PARAMS]),
                change_norms=np.array([want["change_norms"][k] for k in PARAMS]),
                counts=np.array([(c.pairs, c.inside, c.live)
                                 for c in want["counts"]]),
                **{f"first/{k}": v.numpy()
                   for k, v in want["first_grads"].items()})


def _run_case(case, inp):
    """One rank of the gauss-sharded render and step over uneven strips."""
    import torch.distributed as dist

    if case == "ref4":
        return _ref_case(inp)

    from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
    from gaussiansplat_tpu_torch.models.gaussians import GaussianModel
    from gaussiansplat_tpu_torch.ops.projection import (make_payload,
                                                        project_gaussians)
    from gaussiansplat_tpu_torch.parallel import (
        GAUSS_AXIS, init_gauss_sharded_state, make_gauss_mesh,
        make_gauss_sharded_render, make_gauss_sharded_train_step,
        plan_gauss_sharded, shard_model, strip_bounds)
    from gaussiansplat_tpu_torch.parallel.capacity import ici_bytes_per_step
    from gaussiansplat_tpu_torch.parallel.gauss_shard import pack_by_strip
    from gaussiansplat_tpu_torch.parallel.mesh import all_gather
    from gaussiansplat_tpu_torch.parallel.render import _GatherStrips
    from gaussiansplat_tpu_torch.utils.logging import calls

    nd = dist.get_world_size()
    h = HEIGHT[nd]
    cfg = RasterConfig(**RASTER, impl="torch")
    tcfg = TrainConfig(**{k: TRAIN[k] for k in TRAIN if not k.startswith(
        ("beta", "adam"))})
    model = GaussianModel(**{k: torch.as_tensor(inp[f"scene/{k}"])
                             for k in PARAMS},
                          alive=torch.as_tensor(inp["scene/alive"]))
    mesh = make_gauss_mesh()
    group, index = mesh.group(GAUSS_AXIS), mesh.axis_index(GAUSS_AXIS)
    cam = _camera(inp, h)
    plan = plan_gauss_sharded(N, nd, W, h, 3, cfg, send_fraction=1.0)
    out = {}

    render = make_gauss_sharded_render(mesh, cfg, W, h, 3,
                                       send_cap=plan.send_cap)
    with torch.no_grad():
        img, trans, aux = render(shard_model(model, mesh), cam,
                                 torch.tensor(BG), with_aux=True)
    out.update(image=img.numpy(), trans=trans.numpy(),
               overflow=aux["overflow"].numpy())

    # The strip gather over equal strips against its form before bounds:
    # the strips concatenated, and this rank's rows of the cotangent.
    x = torch.arange(6.0 * 5).reshape(6, 5) + 100 * index
    xg = x.clone().requires_grad_(True)
    y = _GatherStrips.apply(xg, group, index, [6 * i for i in range(nd + 1)])
    w = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)
    (y * w).sum().backward()
    out["gather_equal"] = np.array([
        torch.equal(y.detach(), torch.cat(all_gather(x, group))),
        torch.equal(xg.grad, w[6 * index:6 * (index + 1)])])

    state = init_gauss_sharded_state(model, mesh, tcfg,
                                     float(inp["extent"]))
    step = make_gauss_sharded_train_step(mesh, cfg, tcfg, W, h, 3,
                                         send_cap=plan.send_cap,
                                         return_grads=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        state, met = step(state, cam, torch.as_tensor(inp[f"gt{nd}"]))
    call = calls("gs.step")[-1]
    local = shard_model(model, mesh)
    with torch.no_grad():
        proj = project_gaussians(local.means, local.quats, local.log_scales,
                                 local.logit_opacities, local.sh, cam, cfg,
                                 sh_degree=3, alive=local.alive)
        _, _, entries = pack_by_strip(
            make_payload(proj), [b * 16 for b in strip_bounds(h // 16, nd)],
            plan.send_cap, 2 * local.capacity)
    names = {s.name for s in call.spans}
    out.update(
        loss=met["loss"].numpy(), step_overflow=met["overflow"].numpy(),
        pack_overflow=met["pack_overflow"].numpy(),
        spans_ok=np.array(names == STEP_SPANS),
        sent_rows=np.int64(call.counter("sent_rows")),
        entries=np.int64(entries),
        send_slots=np.int64(call.counter("send_slots")),
        slots_want=np.int64(nd * plan.send_cap),
        exchange_bytes=np.int64(call.counter("exchange_bytes")),
        ici=np.int64(ici_bytes_per_step(plan)),
        **{f"grad/{k}": g.numpy() for k, g in met["grads"].items()},
        **{f"param/{k}": p.detach().numpy()
           for k, p in state.model.trainable().items()})
    return out


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:], JOBS, _run_case))


# ---------------------------------------------------------------------------
# The tests (the ranks never import JAX).
# ---------------------------------------------------------------------------

import pytest  # noqa: E402

from gaussiansplat_tpu_torch.parallel import strip_bounds  # noqa: E402
from gaussiansplat_tpu_torch.parallel.render import check_strips  # noqa: E402
from test_torch_common import limit_torch_threads  # noqa: E402

limit_torch_threads()


@pytest.mark.parametrize("tiles_y,n,want", [
    (34, 4, [0, 9, 18, 26, 34]), (10, 4, [0, 3, 6, 8, 10]),
    (7, 3, [0, 3, 5, 7]), (8, 4, [0, 2, 4, 6, 8]), (4, 4, [0, 1, 2, 3, 4]),
    (5, 1, [0, 5])])
def test_strip_bounds(tiles_y, n, want):
    from gaussiansplat_tpu_torch.config import RasterConfig

    assert strip_bounds(tiles_y, n) == want
    assert check_strips(RasterConfig(tile_size=16), 16 * tiles_y - 3, n) == want
    if n > 1:
        with pytest.raises(ValueError, match="cannot make a strip"):
            check_strips(RasterConfig(tile_size=16), 16 * (n - 1), n)


def _pack_by_strip_before(payload, n_strips, strip_h, send_cap, expand_cap):
    """The strip router as it was before uneven strips: one strip height."""
    from gaussiansplat_tpu_torch.ops.projection import PAYLOAD_MY, PAYLOAD_RY
    from gaussiansplat_tpu_torch.parallel.gauss_shard import pack_to_destinations

    i32 = torch.int32
    n = payload.shape[0]
    mean_y = payload[:, PAYLOAD_MY].detach()
    ry = payload[:, PAYLOAD_RY].detach()
    s0 = torch.clamp(torch.floor((mean_y - ry) / strip_h), 0, n_strips).to(i32)
    s1 = torch.clamp(torch.floor((mean_y + ry) / strip_h) + 1, 0,
                     n_strips).to(i32)
    s1 = torch.where(ry > 0, torch.maximum(s1, s0), s0)
    counts = (s1 - s0).long()
    ends = torch.cumsum(counts, 0)
    total = ends[-1]
    expand_overflow = torch.clamp(total - expand_cap, min=0)
    pos = torch.arange(expand_cap)
    ids = torch.clamp(torch.searchsorted(ends, pos, right=True), max=n - 1)
    k = pos - (ends - counts)[ids]
    in_range = (pos < torch.clamp(total, max=expand_cap)) & (k >= 0) & (k < counts[ids])
    dest = torch.where(in_range, s0[ids].long() + k, n_strips)
    send, send_overflow = pack_to_destinations(payload, dest, ids, n_strips,
                                               send_cap)
    return send, (expand_overflow + send_overflow).to(i32)


@pytest.mark.parametrize("n_strips,strip_h,send_cap", [
    (4, 40, 300), (3, 96, 300), (4, 40, 60)])
def test_equal_strips_pack_bit_equal_to_before(n_strips, strip_h, send_cap):
    """Payload rows whose extents end on, one float step either side of,
    and between the strip edges (and off the frame): the same send buffer
    and the same drops as the router of one strip height."""
    from gaussiansplat_tpu_torch.ops.projection import PAYLOAD_MY, PAYLOAD_RY
    from gaussiansplat_tpu_torch.parallel.gauss_shard import pack_by_strip

    g = torch.Generator().manual_seed(n_strips * strip_h + send_cap)
    h = n_strips * strip_h
    payload = torch.randn((600, 16), generator=g)
    payload[:, PAYLOAD_MY] = torch.rand(600, generator=g) * (h + 60) - 30
    payload[:, PAYLOAD_RY] = torch.rand(600, generator=g) * strip_h
    payload[::7, PAYLOAD_RY] = 0.0
    edges = torch.tensor([float(k * strip_h) for k in range(n_strips + 1)])
    tops = torch.cat([edges, torch.nextafter(edges, edges - 1),
                      torch.nextafter(edges, edges + 1)])
    m = tops.numel()
    payload[:m, PAYLOAD_RY] = 2.5
    payload[:m, PAYLOAD_MY] = tops + 2.5          # the extent's top on an edge
    payload[m:2 * m, PAYLOAD_RY] = 2.5
    payload[m:2 * m, PAYLOAD_MY] = tops - 2.5     # its bottom on an edge
    want = _pack_by_strip_before(payload, n_strips, strip_h, send_cap, 1200)
    got = pack_by_strip(payload, [k * strip_h for k in range(n_strips + 1)],
                        send_cap, 1200)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def _ref_camera(h, rot, t):
    from portbench.inputs import Pose, ref_camera

    return ref_camera(Pose(R=rot, t=t, fx=FX, fy=FX, cx=(W - 1) / 2,
                           cy=(h - 1) / 2, width=W, height=h), "cpu")


@pytest.fixture(scope="module")
def setup():
    """A bench scene, a camera and each height's target (the reference's
    render of a copy with noise on the colours)."""
    from portbench.reference import render as R
    from portbench.reference import scenes
    from portbench.reference.train import extent_of

    params, alive = scenes.bench_scene(11, N, 3, 0.8, (0.004, 0.012), W, 160,
                                       FX, 0.05, "cpu")
    rot, t = scenes.look_at(scenes.orbit_eye(0.9, 0.15, 4.0), (0, 0, 0),
                            (0, 1, 0))
    rc = R.Raster.from_dict(RASTER)
    noisy = dict(params)
    noisy["sh_dc"] = params["sh_dc"] + 0.3 * torch.randn(
        params["sh_dc"].shape, generator=torch.Generator().manual_seed(3))
    gts = {}
    for nd, h in HEIGHT.items():
        cam = _ref_camera(h, rot, t)
        gts[nd] = R.render(R.project(noisy, alive, cam, rc, 3), cam, rc)[0]
    return dict(params=params, alive=alive, rot=rot, t=t, rc=rc, gts=gts,
                extent=extent_of(params["means"], alive))


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    arrays = {f"scene/{k}": v.numpy() for k, v in setup["params"].items()}
    arrays["scene/alive"] = setup["alive"].numpy()
    arrays.update({"cam/R": setup["rot"], "cam/t": setup["t"],
                   "extent": np.float32(setup["extent"])})
    arrays.update({f"gt{nd}": g.numpy() for nd, g in setup["gts"].items()})
    return run_jobs(__file__, JOBS, tmp_path_factory.mktemp("uneven"), arrays)


def _reference(setup, nd):
    from portbench.reference import render as R
    from portbench.reference import sharded_train

    h = HEIGHT[nd]
    cam = _ref_camera(h, setup["rot"], setup["t"])
    proj = R.project(setup["params"], setup["alive"], cam, setup["rc"], 3)
    img, trans, _ = R.render(proj, cam, setup["rc"], torch.tensor(BG))
    want = sharded_train.follow(
        setup["params"], setup["alive"],
        [(cam, setup["gts"][nd], torch.zeros(3))], setup["rc"], TRAIN, 3,
        setup["extent"], 1)
    return img.numpy(), trans.numpy(), want


@pytest.mark.parametrize("nd", [4, 3])
def test_uneven_step_matches_reference(runs, setup, nd):
    """Every rank's frame, its block of the first gradient (2e-3 of the
    leaf's largest entry) and, over the ranks' blocks, one Adam update
    (each leaf's change within 2e-3 of the reference's)."""
    img, trans, want = _reference(setup, nd)
    assert float(img.std()) > 0.02
    ranks = runs[f"uneven{nd}"]
    local = N // nd
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["image"], img, atol=2e-5)
        np.testing.assert_allclose(res["trans"], trans, atol=2e-5)
        assert int(res["overflow"]) == 0 and int(res["step_overflow"]) == 0
        assert int(res["pack_overflow"]) == 0
        for k in PARAMS:
            ref = want["first_grads"][k].numpy()
            scale = float(np.abs(ref).max())
            assert scale > 0, k
            err = np.abs(res[f"grad/{k}"] - ref[r * local:(r + 1) * local]).max()
            assert err / scale < 2e-3, (r, k, err / scale)
        np.testing.assert_allclose(float(res["loss"]), want["losses"][0],
                                   rtol=1e-5)
    for k in PARAMS:
        after = np.concatenate([res[f"param/{k}"] for res in ranks])
        change = float(np.linalg.norm(after - setup["params"][k].numpy()))
        assert abs(change - want["change_norms"][k]) <= 2e-3 * want["change_norms"][k], k


def test_uneven_step_spans_and_counters(runs):
    """The step under the profiler opens the one-card step's spans and the
    exchange's; `sent_rows` is the pack's entry count, `send_slots` strips
    x send_cap, and `exchange_bytes` (forward and backward) the closed
    form's; the strip gather over equal strips is the strips concatenated
    and, backward, this rank's rows."""
    for r, res in enumerate(runs["uneven4"]):
        assert bool(res["spans_ok"]), r
        assert int(res["sent_rows"]) == int(res["entries"]) > 0, r
        assert int(res["send_slots"]) == int(res["slots_want"]), r
        assert int(res["exchange_bytes"]) == int(res["ici"]) > 0, r
        assert res["gather_equal"].all(), r


def test_reference_dealt_over_ranks_matches_one_process(runs, setup):
    """Two steps of the reference with its tile blocks dealt over 4 ranks:
    every rank's losses, norms and counts, and its rows of the first
    gradient, as the same steps in one process."""
    from portbench.reference import sharded_train

    cam = _ref_camera(HEIGHT[4], setup["rot"], setup["t"])
    view = (cam, setup["gts"][4], torch.zeros(3))
    want = sharded_train.follow(setup["params"], setup["alive"], [view, view],
                                setup["rc"], TRAIN, 3, setup["extent"], 2,
                                count=True)
    local = N // 4
    for r, res in enumerate(runs["ref4"]):
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=1e-6)
        np.testing.assert_allclose(
            res["grad_norms"], [want["grad_norms"][k] for k in PARAMS],
            rtol=1e-5)
        np.testing.assert_allclose(
            res["change_norms"], [want["change_norms"][k] for k in PARAMS],
            rtol=1e-5)
        assert res["counts"].tolist() == [[c.pairs, c.inside, c.live]
                                          for c in want["counts"]]
        for k in PARAMS:
            ref = want["first_grads"][k].numpy()
            np.testing.assert_allclose(
                res[f"first/{k}"], ref[r * local:(r + 1) * local],
                atol=1e-5 * float(np.abs(ref).max()), err_msg=f"{r} {k}")
