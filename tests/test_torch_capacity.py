"""The port's capacity plan (parallel/capacity.py), its out-of-memory
bisection and the collective-bytes counter (utils/comm_bytes.py): the
closed forms against the arrays the port really allocates, and the
counter's conventions against the reference's `utils/hlo_comm.py`."""

import numpy as np
import pytest
import torch

from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
from gaussiansplat_tpu_torch.models import random_model
from gaussiansplat_tpu_torch.parallel import capacity as cap
from gaussiansplat_tpu_torch.utils import comm_bytes as cb


def _model(n, sh_degree):
    return random_model(torch.Generator().manual_seed(0), n,
                        sh_degree=sh_degree, device="cpu")


@pytest.mark.parametrize("sh_degree", [1, 3])
def test_params_and_optimizer_bytes_match_real_state(sh_degree):
    """`params_bytes` equals the model's real buffers (the bool alive mask
    included); `optimizer_bytes` equals the Adam moments after one step
    (the per-parameter step counters are host scalars, not device memory)."""
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.train import init_train_state, make_train_step

    plan = cap.plan_gauss_sharded(1000, 4, 64, 64, sh_degree=sh_degree)
    model = _model(plan.local_capacity, sh_degree)
    real = sum(t.nbytes for t in model.parameters()) + model.alive.nbytes
    assert plan.params_bytes == real
    state = init_train_state(model, TrainConfig(), extent=1.0)
    cam = look_at((0, 0, -4), (0, 0, 0), fx=60.0, fy=60.0, width=64, height=64,
                  device="cpu")
    make_train_step(RasterConfig(impl="torch"), TrainConfig())(
        state, cam, torch.zeros((64, 64, 3)), sh_degree)
    moments = [v for st in state.optimizer.state.values()
               for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")]
    assert len(moments) == 12
    assert plan.optimizer_bytes == sum(m.nbytes for m in moments)
    assert cap.plan_gauss_sharded(1000, 4, 64, 64, sh_degree,
                                  with_optimizer=False).optimizer_bytes == 0


def test_exchange_and_strip_streams_match_allocations():
    """The send buffer `pack_by_strip` allocates (and the all_to_all's
    receive buffer of the same shape), and one strip's binning of the
    arrivals: its pair capacity and the depth-ordered payload table."""
    from gaussiansplat_tpu_torch.ops.binning import bin_gaussians
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.ops.projection import (
        make_payload, payload_to_projected, project_gaussians)
    from gaussiansplat_tpu_torch.parallel.gauss_shard import pack_by_strip

    cfg = RasterConfig(tile_size=32, chunk_size=128, impl="torch")
    nd, w, h = 2, 128, 128
    plan = cap.plan_gauss_sharded(512, nd, w, h, sh_degree=1, cfg=cfg)
    model = _model(plan.local_capacity, 1)
    cam = look_at((0, 0, -6), (0, 0, 0), fx=220.0, fy=220.0, width=w, height=h,
                  device="cpu")
    proj = project_gaussians(model.means, model.quats, model.log_scales,
                             model.logit_opacities, model.sh, cam, cfg, 1,
                             model.alive)
    send, _, _ = pack_by_strip(make_payload(proj),
                               [s * h // nd for s in range(nd + 1)],
                               plan.send_cap, 2 * plan.local_capacity)
    assert send.shape == (nd, plan.send_cap, 16)
    assert plan.exchange_bytes == 2 * send.nbytes
    flat = send.reshape(-1, 16)
    b = bin_gaussians(payload_to_projected(flat), w, h, cfg, tile_row0=0,
                      tile_rows=2, capacity=cap.arrival_pair_capacity(
                          cfg, nd, plan.send_cap))
    pair_cap = b.sorted_ranks.shape[0]
    streams = b.sorted_ranks.nbytes + b.sorted_tiles.nbytes + b.sorted_pos.nbytes
    assert streams == 3 * 4 * pair_cap
    gathered = b.gather_payload(flat, "torch")
    assert plan.raster_bytes == (flat.nbytes + 4 * 4 * pair_cap
                                 + 2 * gathered.nbytes)


def _allocated(fn):
    """(bytes still allocated after fn(), peak over it), from the
    profiler's memory events on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn()
    events = sorted((e.start_ns(), e.nbytes())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "[memory]")
    now = peak = 0
    for _, b in events:
        now += b
        peak = max(peak, now)
    return now, peak


def test_compaction_bytes_are_the_binnings_peak():
    """`compaction_bytes` a row is the peak of the binning's compaction
    (the tile-survivor masks) over the rows it bins, at 1920x1080."""
    from gaussiansplat_tpu_torch.ops.binning import compact_rects
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.ops.projection import (
        make_payload, payload_to_projected, project_gaussians)

    cfg = RasterConfig(tile_size=32, chunk_size=128, impl="torch")
    n = 50_000
    model = _model(n, 1)
    cam = look_at((0, 0, -6), (0, 0, 0), fx=220.0, fy=220.0, width=1920,
                  height=1080, device="cpu")
    with torch.no_grad():
        rows = payload_to_projected(make_payload(project_gaussians(
            model.means, model.quats, model.log_scales, model.logit_opacities,
            model.sh, cam, cfg, 1, model.alive)))
    _, peak = _allocated(lambda: compact_rects(rows, 1920, 1080, cfg,
                                               tile_rows=34))
    plan = cap.plan_gauss_sharded(4 * n, 4, 1920, 1080, 1, cfg,
                                  send_fraction=0.25)
    assert plan.compaction_bytes == 4 * plan.send_cap * round(peak / n)


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_projection_bytes_are_what_its_backward_keeps(sh_degree):
    """`projection_bytes` a gaussian is what `project_gaussians` and
    `make_payload` leave allocated for the backward, the payload and the
    model's SH concatenation included."""
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.ops.projection import (
        make_payload, project_gaussians)

    cfg = RasterConfig(tile_size=32, chunk_size=128, impl="torch")
    n = 50_000
    model = _model(n, sh_degree)
    cam = look_at((0, 0, -6), (0, 0, 0), fx=220.0, fy=220.0, width=1920,
                  height=1080, device="cpu")
    kept = []
    left, _ = _allocated(lambda: kept.append(make_payload(project_gaussians(
        model.means, model.quats, model.log_scales, model.logit_opacities,
        model.sh, cam, cfg, sh_degree, model.alive))))
    assert kept[0].requires_grad
    plan = cap.plan_gauss_sharded(n, 1, 64, 64, sh_degree)
    assert plan.projection_bytes == n * round(left / n)


def test_plan_is_monotonic_and_placement_consistent():
    totals = [cap.plan_gauss_sharded(n, 4, 1920, 1088).total_bytes
              for n in (10**5, 10**6, 10**7)]
    assert totals == sorted(totals) and len(set(totals)) == 3
    per_card = [cap.plan_gauss_sharded(8_000_000, d, 1920, 1088).params_bytes
                for d in (1, 2, 4, 8)]
    assert per_card == sorted(per_card, reverse=True)
    # min_devices_for plans a D-card mesh at twice an even strip's share.
    plan = lambda n, d: cap.plan_gauss_sharded(
        n, d, 1920, 1088, send_fraction=min(1.0, 2.0 / d))
    for n in (2_000_000, 30_000_000, 200_000_000):
        d = cap.min_devices_for(n, 1920, 1088)
        assert plan(n, d).fits()
        if d > 1:
            assert not plan(n, d // 2).fits()
    with pytest.raises(ValueError):
        cap.min_devices_for(10**12, 1920, 1088, max_devices=4)
    top = cap.max_gaussians_per_chip(1920, 1080)
    fits = lambda n: cap.plan_gauss_sharded(
        n, 1, 1920, 1080, send_fraction=1.0).fits()
    assert fits(top) and not fits(top + (1 << 16))
    roomy = cap.max_gaussians_per_chip(1920, 1080,
                                       hbm_bytes=cap.HBM_NOMINAL_BYTES)
    assert roomy >= top


def test_one_card_plan_sends_every_gaussian():
    """A one-card mesh has one strip: its exchange is sized for every
    gaussian whatever send_fraction asks (the reference's would drop half
    at its default), so a plan's D = 1 and the measured ceiling agree."""
    assert cap.plan_gauss_sharded(1000, 1, 64, 64, send_fraction=0.5).send_cap \
        == 1000
    assert cap.plan_gauss_sharded(1000, 2, 64, 64, send_fraction=0.5).send_cap \
        == 250
    one = cap.plan_gauss_sharded(30_000_000, 1, 1920, 1088)
    assert one == cap.plan_gauss_sharded(30_000_000, 1, 1920, 1088,
                                         send_fraction=1.0)
    assert not one.fits() and cap.min_devices_for(30_000_000, 1920, 1088) >= 2


def test_plan_follows_raster_config_and_summary():
    tight = cap.plan_gauss_sharded(10**6, 8, 1920, 1088,
                                   cfg=RasterConfig(pairs_per_gaussian=2.0))
    roomy = cap.plan_gauss_sharded(10**6, 8, 1920, 1088,
                                   cfg=RasterConfig(pairs_per_gaussian=4.0))
    assert roomy.raster_bytes > tight.raster_bytes
    s = cap.plan_gauss_sharded(30_000_000, 8, 1920, 1088).summary()
    assert "30.0M" in s and "8 chips" in s and "GiB" in s


def test_collective_byte_rules():
    """The strip exchange moves 2 (D-1) send_cap 64 B a step; the ring's
    terms at a power of two and not; the schedule rule picks the lesser."""
    plan = cap.plan_gauss_sharded(30_000_000, 8, 1920, 1088)
    assert cap.ici_bytes_per_step(plan) == 2 * 7 * plan.send_cap * 16 * 4
    assert cap.ici_bytes_per_step(cap.plan_gauss_sharded(10**6, 1, 64, 64)) == 0
    assert [cap.ring_hops(d) for d in (1, 2, 3, 4, 5, 8)] == [0, 1, 2, 2, 4, 3]
    img = 64 * 32 * 16
    got = cap.ici_bytes_per_step_ring(3000, 3, 64, 32)
    a2a = 2 * 2 * max(2 * 1000 // 3, 256) * 64
    want = a2a + 2 * 2 * img + 2 / 3 * img + 2 * (2 / 3) * 2048
    assert got == int(round(want))
    rule = cap.preferred_gauss_schedule(30_000_000, 8, 1920, 1088)
    assert rule["preferred"] == ("ring" if rule["ring_bytes"] < rule["strip_bytes"]
                                 else "strip")


def test_weak_scaling_needs_measured_rates():
    with pytest.raises(TypeError):
        cap.predicted_weak_scaling(3_750_000, 1920, 1088, [1, 2])
    rows = cap.predicted_weak_scaling(3_750_000, 1920, 1088, [1, 2, 4, 8],
                                      step_ms_per_million=40.0, link_gbps=200.0)
    effs = [r["predicted_efficiency"] for r in rows]
    assert effs[0] == 1.0 and all(a >= b for a, b in zip(effs, effs[1:]))
    slow = cap.predicted_weak_scaling(3_750_000, 1920, 1088, [8],
                                      step_ms_per_million=40.0, link_gbps=1.0)
    assert slow[0]["predicted_efficiency"] < effs[-1]


def test_hbm_budget_is_the_cards():
    assert cap.HBM_NOMINAL_BYTES == 80 << 30
    assert 0 < cap.HBM_EFFECTIVE_BYTES < cap.HBM_NOMINAL_BYTES
    assert cap.HBM_SLACK >= 1.0
    assert "H100" in cap.HBM_CARD and " W" in cap.HBM_CARD


def _threshold_probe(limit, inconclusive=()):
    seen = []

    def probe(n):
        seen.append(n)
        if inconclusive == "all" or n in inconclusive:
            return None
        return n <= limit
    return probe, seen


@pytest.mark.parametrize("seed", [1_000_000, 4_000_000, 20_000_000])
def test_bisection_brackets_the_ceiling(seed):
    probe, seen = _threshold_probe(5_000_000)
    out = cap.bisect_ceiling(probe, seed, max_probes=16, resolution=0.03)
    assert seen[0] == seed
    assert out["fit"] <= 5_000_000 < out["oom"]
    assert out["oom"] - out["fit"] <= 0.03 * out["fit"]
    assert [n for n, _ in out["probes"]] == seen


def test_bisection_inconclusive_probes_move_nothing():
    """A first probe that times out does not end the search; a failure
    other than out-of-memory is neither a fit nor an OOM."""
    probe, seen = _threshold_probe(5_000_000, inconclusive=(8_000_000,))
    out = cap.bisect_ceiling(probe, 8_000_000, max_probes=12)
    assert out["probes"][0] == (8_000_000, None)
    assert out["fit"] <= 5_000_000 < out["oom"] < 8_000_000
    probe, seen = _threshold_probe(0, inconclusive="all")
    out = cap.bisect_ceiling(probe, 8_000_000, max_probes=4)
    assert out["fit"] is None and out["oom"] is None and len(seen) == 4
    assert seen == sorted(seen, reverse=True)


def test_comm_byte_conventions():
    """Each op's per-device factor at D = 4, one record per op, and a
    record of its own group size; the same numbers as the reference's
    hlo_comm on the equivalent HLO."""
    from gaussiansplat_tpu.utils.hlo_comm import collective_bytes as hlo_bytes

    b = 8 * 100 * 16 * 4
    recs = [(cb.ALL_TO_ALL, b), (cb.ALL_REDUCE, 512), (cb.PERMUTE, 256),
            (cb.PERMUTE, 256), (cb.ALL_GATHER, 1024), (cb.REDUCE_SCATTER, 1000),
            (cb.BROADCAST, 400)]
    got = cb.collective_bytes(recs, 4)
    assert got[cb.ALL_TO_ALL] == int(3 / 4 * b)
    assert got[cb.ALL_REDUCE] == int(2 * 3 / 4 * 512)
    assert got[cb.PERMUTE] == 512
    assert got[cb.ALL_GATHER] == 768 and got[cb.REDUCE_SCATTER] == 750
    assert got[cb.BROADCAST] == 300
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    hlo = """
  %a2a = f32[8,100,16]{2,1,0} all-to-all(f32[8,100,16]{2,1,0} %p), dims={0}
  %ar = bf16[256]{0} all-reduce(bf16[256]{0} %q), to_apply=%add
  %cp.1 = (f32[64]{0}, f32[64]{0}) collective-permute(f32[64]{0} %r, f32[64]{0} %s)
"""
    want = hlo_bytes(hlo, 4)
    assert {k: got[k] for k in want if k != "total"} == {
        k: v for k, v in want.items() if k != "total"}
    # A record carries its own group size; a group of one moves nothing.
    assert cb.collective_bytes([(cb.ALL_TO_ALL, 800, 2)], 8)["total"] == 400
    assert cb.collective_bytes([(cb.ALL_REDUCE, 800, 1)], 8)["total"] == 0
    assert cb.collective_bytes([], 4) == {"total": 0}


def test_counter_scopes():
    """Counters record only inside their block, nested ones both;
    `compiled_collective_bytes` runs the function once under a counter."""
    cb.record(cb.ALL_TO_ALL, 100, 2)                  # no counter active
    with cb.count_collectives() as outer:
        cb.record(cb.ALL_TO_ALL, 100, 2)
        with cb.count_collectives() as inner:
            cb.record(cb.BROADCAST, 40, 4)
    assert outer.records == [(cb.ALL_TO_ALL, 100, 2), (cb.BROADCAST, 40, 4)]
    assert inner.bytes() == {cb.BROADCAST: 30, "total": 30}
    calls = []

    def fn(x):
        calls.append(x)
        cb.record(cb.PERMUTE, x, 2)
        return x + 1

    got, out = cb.compiled_collective_bytes(fn, 2, 64)
    assert out == 65 and calls == [64]
    assert got == {cb.PERMUTE: 64, "total": 64}


def test_identity_helpers_record_nothing():
    """Groups of one rank (no process group): every helper is the identity
    and moves no bytes."""
    from gaussiansplat_tpu_torch.parallel import mesh as pm

    x = torch.arange(6.0).reshape(2, 3)
    with cb.count_collectives() as c:
        assert torch.equal(pm.all_to_all(x, None), x)
        assert torch.equal(pm.permute(x, [(0, 0)], None), x)
        assert torch.equal(pm.broadcast(x, 0, None), x)
        assert torch.equal(pm.all_reduce(x, "sum", None), x)
        xg = x.clone().requires_grad_(True)
        (pm.AllToAll.apply(xg, None) * 2 + pm.Broadcast.apply(xg, 0, None)
         + pm.Permute.apply(xg, [(0, 0)], None)).sum().backward()
    assert c.records == []
    np.testing.assert_array_equal(xg.grad.numpy(), np.full((2, 3), 4.0))
