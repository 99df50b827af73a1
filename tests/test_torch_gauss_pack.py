"""Single-process parts of the port's gaussian-axis sharding against the
reference: the destination packs of the strip and depth-slab routers
(per-destination row multisets, overflow counts exactly equal), the depth
bins and slab bounds (integer-equal), the shard layout, the one-rank gauss
and ring renders against `render()`, the default send capacity, the mesh
error cases and the multi-process view feeding."""

import numpy as np
import pytest
import torch

from test_torch_common import limit_torch_threads, port_camera, port_model

limit_torch_threads()

N, SIZE = 192, 128


def _jax_scene(n=N, seed=0):
    import jax

    from gaussiansplat_tpu.models import random_model
    from gaussiansplat_tpu.ops import look_at

    model = random_model(jax.random.PRNGKey(seed), n, sh_degree=1, extent=1.0)
    cam = look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=220.0, fy=220.0,
                  width=SIZE, height=SIZE)
    return model, cam


def _jax_payload(model, cam):
    from gaussiansplat_tpu.config import RasterConfig
    from gaussiansplat_tpu.ops.projection import make_payload, project_gaussians

    proj = project_gaussians(model.means, model.quats, model.log_scales,
                             model.logit_opacities, model.sh, cam,
                             RasterConfig(tile_size=32, chunk_size=128),
                             sh_degree=1, alive=model.alive)
    return np.array(make_payload(proj)), proj


def _rows(send):
    """Each destination's rows, sorted lexicographically (a multiset)."""
    send = np.asarray(send)
    return [r[np.lexsort(r.T[::-1])] for r in send]


def _assert_same_packs(got, want, what):
    (gs, gof), (ws, wof) = got, want
    assert int(gof) == int(wof), f"{what}: overflow {int(gof)} != {int(wof)}"
    assert gs.shape == ws.shape
    for d, (a, b) in enumerate(zip(_rows(gs), _rows(ws))):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: destination {d}")


@pytest.mark.parametrize("send_cap", [64, 24, 5])
def test_pack_to_destinations_matches_reference(send_cap):
    """Random destinations (the drop value among them) and row ids; 24 and
    5 rows per destination overflow. Rows are distinct, so the multisets
    fix which rows were kept only where nothing overflows; past send_cap
    the kept rows depend on the order within a destination (the
    reference's one-key sort need not be stable; the port's is), so there
    the rows must come from the destination's own entries."""
    from gaussiansplat_tpu.parallel.gauss_shard import (
        pack_to_destinations as j_pack)
    from gaussiansplat_tpu_torch.parallel.gauss_shard import pack_to_destinations

    rng = np.random.default_rng(send_cap)
    n, m, nd = 50, 120, 4
    payload = rng.standard_normal((n, 16)).astype(np.float32)
    dest = rng.integers(0, nd + 1, m).astype(np.int32)
    ids = rng.integers(0, n, m).astype(np.int32)
    want = j_pack(payload, dest, ids, nd, send_cap)
    got = pack_to_destinations(torch.as_tensor(payload), torch.as_tensor(dest),
                               torch.as_tensor(ids), nd, send_cap)
    counts = np.bincount(dest, minlength=nd + 1)[:nd]
    assert int(got[1]) == int(want[1]) == int(np.maximum(counts - send_cap, 0).sum())
    for d in range(nd):
        g, w = np.asarray(got[0][d]), np.asarray(want[0][d])
        k = min(counts[d], send_cap)
        assert not g[k:].any() and not np.asarray(w[k:]).any()
        pool = payload[ids[dest == d]]
        if counts[d] <= send_cap:
            _assert_same_packs((g[None], 0), (w[None], 0), f"dest {d}")
        for row in g[:k]:
            assert (pool == row).all(1).any(), f"dest {d}: foreign row"
    # The port keeps the first send_cap entries of each run, in entry order.
    for d in range(nd):
        first = payload[ids[dest == d][:send_cap]]
        np.testing.assert_array_equal(np.asarray(got[0][d][:len(first)]), first)


@pytest.mark.parametrize("n_strips,send_cap,expand_cap", [
    (4, 192, 384), (2, 192, 384), (4, 40, 384), (4, 192, 100), (8, 192, 384)])
def test_pack_by_strip_matches_reference(n_strips, send_cap, expand_cap):
    """The strip router on a real projected payload: duplication into every
    strip a gaussian's y-extent spans, the ry > 0 rule, exchange overflow
    (send_cap 40) and expansion overflow (expand_cap 100)."""
    from gaussiansplat_tpu.parallel.gauss_shard import pack_by_strip as j_pack
    from gaussiansplat_tpu_torch.parallel.gauss_shard import pack_by_strip

    payload, _ = _jax_payload(*_jax_scene())
    strip_h = SIZE // n_strips
    want = j_pack(payload, n_strips, strip_h, send_cap, expand_cap)
    got = pack_by_strip(torch.as_tensor(payload),
                        [s * strip_h for s in range(n_strips + 1)], send_cap,
                        expand_cap)[:2]
    if int(want[1]) == 0:
        _assert_same_packs(got, want, "strips")
    else:
        assert int(got[1]) == int(want[1])
        # Which rows survive an overflow depends on the order (see above);
        # the row counts per destination agree.
        for a, b in zip(np.asarray(got[0]), np.asarray(want[0])):
            assert a.any(1).sum() == np.asarray(b).any(1).sum()


def test_pack_by_slab_matches_reference():
    from gaussiansplat_tpu.parallel.depth_ring import pack_by_slab as j_pack
    from gaussiansplat_tpu_torch.parallel.depth_ring import pack_by_slab

    rng = np.random.default_rng(1)
    payload = rng.standard_normal((N, 16)).astype(np.float32)
    slab = rng.integers(0, 4, N).astype(np.int32)     # 3 slabs + drop
    for cap in (80, 50):
        want = j_pack(payload, slab, 3, cap)
        got = pack_by_slab(torch.as_tensor(payload), torch.as_tensor(slab), 3, cap)
        assert int(got[1]) == int(want[1])
        if cap == 80:
            _assert_same_packs(got, want, "slabs")


def test_depth_bins_and_slab_bounds_are_integer_equal():
    """Depth bins over the whole clamped range, and the equal-count slab
    bounds for 2-8 slabs (the reference inside a one-device shard_map)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from gaussiansplat_tpu.parallel import depth_ring as jdr
    from gaussiansplat_tpu.parallel.gauss_shard import make_gauss_mesh
    from gaussiansplat_tpu_torch.parallel.depth_ring import (
        _depth_bin, depth_slab_bounds)

    rng = np.random.default_rng(2)
    depth = np.exp(rng.uniform(np.log(1e-3), np.log(1e6), 4096)).astype(np.float32)
    depth[:4] = [1e-2, 1e5, 0.0, -1.0]
    np.testing.assert_array_equal(_depth_bin(torch.as_tensor(depth)).numpy(),
                                  np.asarray(jdr._depth_bin(jnp.asarray(depth))))
    # A scene-like depth spread: a few units around 6, some culled.
    depth = (6.0 + rng.standard_normal(2048)).astype(np.float32)
    valid = rng.random(2048) > 0.1
    mesh = make_gauss_mesh(1)
    for n_slabs in (2, 3, 4, 8):
        f = jax.jit(shard_map(
            lambda d, v: jdr.depth_slab_bounds(d, v, n_slabs, "gauss"),
            mesh=mesh, in_specs=(P(), P()), out_specs=P()))
        want = np.asarray(f(jnp.asarray(depth), jnp.asarray(valid)))
        got = depth_slab_bounds(torch.as_tensor(depth), torch.as_tensor(valid),
                                n_slabs, None).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{n_slabs} slabs")


def test_shard_model_blocks():
    """Gauss index r of D holds rows [r C / D, (r + 1) C / D) of every
    buffer; D must divide the capacity."""
    from gaussiansplat_tpu_torch.parallel import GAUSS_AXIS, DATA_AXIS, Mesh, shard_model

    model = port_model(_jax_scene()[0])
    for nd in (2, 3, 4):
        blocks = [shard_model(model, Mesh(1, nd, r, None, None, None,
                                          (DATA_AXIS, GAUSS_AXIS)))
                  for r in range(nd)]
        for k, v in model.trainable().items():
            torch.testing.assert_close(
                torch.cat([b.trainable()[k] for b in blocks]), v.detach(),
                rtol=0, atol=0)
        assert torch.equal(torch.cat([b.alive for b in blocks]), model.alive)
    with pytest.raises(ValueError, match="divide"):
        shard_model(model, Mesh(1, 5, 0, None, None, None, (DATA_AXIS, GAUSS_AXIS)))


def test_one_rank_renders_match_render():
    """A gauss mesh of one rank (no process group): the strip exchange and
    the ring reduce to render() (the exchange exactly; the ring within
    2e-4), gradients included."""
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.parallel import (
        make_depth_ring_render, make_gauss_mesh, make_gauss_sharded_render,
        shard_model)
    from gaussiansplat_tpu_torch.render import render

    jm, jcam = _jax_scene()
    cam = port_camera(jcam)
    bg = torch.tensor([0.15, 0.25, 0.35])
    for name, cfg, atol in (("strip", RasterConfig(32, 128, impl="torch"), 0.0),
                            ("ring", RasterConfig(32, 128, impl="torch",
                                                  trans_eps=0.0), 2e-4)):
        mesh = make_gauss_mesh()
        sm = shard_model(port_model(jm), mesh)
        if name == "strip":
            # The default send_cap: the plan sizes a one-rank exchange
            # for every gaussian.
            f = make_gauss_sharded_render(mesh, cfg, SIZE, SIZE, 1)
        else:
            f = make_depth_ring_render(mesh, cfg, SIZE, SIZE, 1)
        img, trans = f(sm, cam, bg)
        (img ** 2).sum().backward()
        tm = port_model(jm)
        ref = render(tm, cam, cfg, sh_degree=1, background=bg)
        (ref.image ** 2).sum().backward()
        torch.testing.assert_close(img, ref.image, rtol=0, atol=atol)
        torch.testing.assert_close(trans, ref.transmittance, rtol=0, atol=atol)
        for k, p in sm.trainable().items():
            want = tm.trainable()[k].grad
            scale = float(want.abs().max()) + 1e-8
            assert float((p.grad - want).abs().max()) <= 2e-3 * scale, (name, k)


def test_one_device_exchange_drops_no_row():
    """At D = 1 the one strip receives every visible gaussian. The
    reference's default exchange (send_fraction 0.5 at every D) drops half
    of a 256-gaussian scene; the port's plan sizes it for all of them."""
    import jax
    import jax.numpy as jnp

    from gaussiansplat_tpu.config import RasterConfig as JCfg
    from gaussiansplat_tpu.parallel import make_gauss_mesh as j_mesh
    from gaussiansplat_tpu.parallel import make_gauss_sharded_render as j_render
    from gaussiansplat_tpu.parallel import shard_model as j_shard
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.parallel import (
        make_gauss_mesh, make_gauss_sharded_render, shard_model)

    jm, jcam = _jax_scene(n=256)
    bg = (0.15, 0.25, 0.35)
    mesh = j_mesh(1)
    jf = j_render(mesh, JCfg(tile_size=32, chunk_size=128, impl="xla"), SIZE,
                  SIZE, 1)
    _, _, aux = jax.jit(lambda m, c, b: jf(m, c, b, with_aux=True))(
        j_shard(jm, mesh), jcam, jnp.array(bg))
    assert int(aux["pack_overflow"]) == 128
    mesh = make_gauss_mesh()
    f = make_gauss_sharded_render(mesh, RasterConfig(32, 128, impl="torch"),
                                  SIZE, SIZE, 1)
    with torch.no_grad():
        _, _, aux = f(shard_model(port_model(jm), mesh), port_camera(jcam),
                      torch.tensor(bg), with_aux=True)
    assert int(aux["pack_overflow"]) == 0 and int(aux["overflow"]) == 0


def test_tiny_send_cap_overflows_and_warns(capsys):
    """A send_cap far below a strip's load drops rows without failing:
    the image stays finite, `pack_overflow` counts the drops and
    `check_overflow` reports them on stderr."""
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.parallel import (
        make_gauss_mesh, make_gauss_sharded_render, shard_model)

    jm, jcam = _jax_scene()
    mesh = make_gauss_mesh()
    f = make_gauss_sharded_render(mesh, RasterConfig(32, 128, impl="torch"),
                                  SIZE, SIZE, 1, send_cap=8,
                                  check_overflow=True)
    with torch.no_grad():
        img, _, aux = f(shard_model(port_model(jm), mesh), port_camera(jcam),
                        torch.zeros(3), with_aux=True)
    assert torch.isfinite(img).all()
    assert int(aux["pack_overflow"]) > 0
    assert int(aux["overflow"]) == int(aux["pack_overflow"]) + int(aux["bin_overflow"])
    assert f"exchange dropped {int(aux['pack_overflow'])} payload rows" in \
        capsys.readouterr().err


def test_default_send_cap_comes_from_the_plan():
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.parallel import (DATA_AXIS, GAUSS_AXIS, Mesh,
                                                  make_gauss_sharded_render,
                                                  plan_gauss_sharded)

    cfg = RasterConfig()
    for nd, frac in ((2, 0.5), (4, 0.5), (4, 0.8)):
        mesh = Mesh(1, nd, 0, None, None, None, (DATA_AXIS, GAUSS_AXIS))
        f = make_gauss_sharded_render(mesh, cfg, 1920, 1152, 3,
                                      send_fraction=frac)
        plan = plan_gauss_sharded(1_000_000, nd, 1920, 1152, 3, cfg,
                                  send_fraction=frac)
        assert f.resolve_send_cap(1_000_000) == plan.send_cap
    assert make_gauss_sharded_render(mesh, cfg, 1920, 1152, 3, send_cap=7) \
        .resolve_send_cap(1_000_000) == 7


def test_mesh_errors():
    """Fewer tile rows than strips, a 2D mesh or a global mesh that does
    not match the world, and a gauss renderer given a camera of another
    size."""
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.parallel import (
        DATA_AXIS, GAUSS_AXIS, Mesh, make_depth_ring_render, make_gauss2d_render,
        make_gauss_mesh, make_gauss_sharded_render, make_mesh2d, shard_model)
    from gaussiansplat_tpu_torch.parallel.multihost import make_global_mesh

    cfg = RasterConfig(32, 128, impl="torch")
    mesh2 = Mesh(1, 2, 0, None, None, None, (DATA_AXIS, GAUSS_AXIS))
    make_gauss_sharded_render(mesh2, cfg, 96, 96, 1)         # 3 tile rows
    with pytest.raises(ValueError, match="cannot make a strip"):
        make_gauss_sharded_render(mesh2, cfg, 96, 32, 1)      # 1 tile row
    with pytest.raises(ValueError, match="cannot make a strip"):
        make_gauss2d_render(Mesh(2, 2, 0, None, None, None,
                                 (DATA_AXIS, GAUSS_AXIS)), cfg, 96, 32, 1)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh2d(2, 2)                                        # no group
    with pytest.raises(ValueError):
        make_global_mesh(data=2, tile=1)
    with pytest.raises(ValueError):
        make_global_mesh(tile=3)
    assert make_global_mesh().shape == {"data": 1, "tile": 1}
    jm, jcam = _jax_scene()
    f = make_depth_ring_render(make_gauss_mesh(), cfg, 64, 64, 1)
    with pytest.raises(ValueError, match="built for 64x64"):
        f(shard_model(port_model(jm), make_gauss_mesh()), port_camera(jcam),
          torch.zeros(3))


def test_process_views_match_reference(monkeypatch):
    """The same (process count, process index, step) picks the same views
    as the reference's global sample index."""
    import jax

    from gaussiansplat_tpu.parallel import multihost as jmh
    from gaussiansplat_tpu_torch.parallel.multihost import process_views

    views = list(range(7))
    for world, batch in ((1, 2), (2, 1), (4, 2), (3, 3)):
        for rank in range(world):
            monkeypatch.setattr(jax, "process_count", lambda: world)
            monkeypatch.setattr(jax, "process_index", lambda: rank)
            for step in (0, 1, 5):
                assert process_views(views, batch, step, world, rank) == \
                    jmh.process_views(views, batch, step), (world, rank, step)
    assert process_views(views, 2, 3) == [6, 0]      # one process by default


def test_pack_gradient_is_the_kept_rows_scatter():
    """The pack's backward adds each kept slot's cotangent into its source
    row and nothing from the padding slots, which read rows of their own
    (not one shared row, whose serial accumulation was seconds a step at
    8M gaussians)."""
    from gaussiansplat_tpu_torch.parallel.gauss_shard import pack_to_destinations

    g = torch.Generator().manual_seed(4)
    payload = torch.randn((50, 16), generator=g).requires_grad_(True)
    dest = torch.randint(0, 4, (80,), generator=g)            # 3 dests + drop
    ids = torch.randint(0, 50, (80,), generator=g)
    send, _ = pack_to_destinations(payload, dest, ids, 3, 40)
    cot = torch.randn(send.shape, generator=g)
    (send * cot).sum().backward()
    want = torch.zeros_like(payload)
    for d in range(3):
        rows = ids[dest == d][:40]
        want.index_add_(0, rows, cot[d, :len(rows)])
    torch.testing.assert_close(payload.grad, want, rtol=0, atol=1e-6)
