"""The port's spans and counters (utils/logging.py) on the CPU at a tiny
size: off without a profiler and bit-neutral under one; the layers of a
render and of a training step with their parents and call ids, the
binning's counters, host stamps on the profiler's clock, and the ring's
bound. Device times are held on the card in tests/test_torch_gpu.py."""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
from gaussiansplat_tpu_torch.models import random_model
from gaussiansplat_tpu_torch.ops.camera import look_at
from gaussiansplat_tpu_torch.render import render
from gaussiansplat_tpu_torch.train import init_train_state, make_train_step
from gaussiansplat_tpu_torch.utils import logging as spans

from test_torch_common import limit_torch_threads

limit_torch_threads()

RENDER_CHILDREN = {"gs.project", "gs.bin", "gs.gather", "gs.raster"}


@pytest.fixture(autouse=True)
def fresh():
    spans.RECORDER.reset()
    yield
    spans.RECORDER.reset()


def _scene(n=128, size=48, seed=0):
    g = torch.Generator().manual_seed(seed)
    model = random_model(g, n, sh_degree=1, device="cpu")
    cam = look_at((0.5, 0.3, -6.0), (0, 0, 0), fx=120.0, fy=120.0,
                  width=size, height=size, device="cpu")
    gt = torch.rand((size, size, 3), generator=g)
    return model, cam, gt


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _render_and_grads():
    model, cam, _ = _scene()
    for p in model.trainable().values():
        p.requires_grad_(True)
    out = render(model, cam, RasterConfig())
    (out.image.sum() + out.transmittance.sum()).backward()
    return out, {k: p.grad for k, p in model.trainable().items()}


def _train_steps(steps=2):
    model, cam, gt = _scene()
    state = init_train_state(model, TrainConfig(), 1.0)
    step = make_train_step(RasterConfig(), TrainConfig())
    for _ in range(steps):
        state, met = step(state, cam, gt, 1)
    return state, met


def _by_name(call):
    return {s.name: s for s in call.spans}


def test_off_records_nothing_and_changes_no_bit():
    assert spans.span("gs.a") is spans.span("gs.b")
    out, grads = _render_and_grads()
    state, met = _train_steps()
    assert spans.calls() == []
    (pout, pgrads), _ = _profiled(_render_and_grads)
    (pstate, pmet), _ = _profiled(_train_steps)
    assert len(spans.calls("gs.render")) == 1
    assert len(spans.calls("gs.step")) == 2
    assert torch.equal(out.image, pout.image)
    assert torch.equal(out.transmittance, pout.transmittance)
    for k in grads:
        assert torch.equal(grads[k], pgrads[k]), k
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, pstate.model.state_dict()[k]), k
    for k in met:
        assert torch.equal(met[k], pmet[k]), k


def test_render_spans_and_counters():
    model, cam, _ = _scene()
    cfg = RasterConfig()

    def frame():
        with torch.inference_mode():
            return render(model, cam, cfg)

    out, _ = _profiled(frame)
    (call,) = spans.calls()
    top = call.spans[0]
    assert top.name == "gs.render" and top.parent is None
    # The projection's span opens twice: the projection, then the payload.
    assert [s.name for s in call.spans[1:]] == [
        "gs.project", "gs.bin", "gs.project", "gs.gather", "gs.raster"]
    assert all(s.parent is top and s.call is call for s in call.spans[1:])
    assert call.counter("pairs") == int(out.num_pairs) > 0
    assert call.counter("pair_slots") == cfg.pair_capacity(model.capacity)
    # P (the projection kernel) runs on the card only.
    assert call.counter("project_kernel") == 0
    # Host-only on the CPU: no device times to read.
    assert top.device_ms is None and call.self_ms("gs.gather") is None


def _tile_strip_frame(model, cam, cfg):
    from gaussiansplat_tpu_torch.parallel import make_mesh, make_tile_sharded_render
    from gaussiansplat_tpu_torch.parallel.render import strip_pair_capacity

    f = make_tile_sharded_render(make_mesh(1, 1), cfg, cam.width, cam.height, 1)
    return (lambda: f(model, cam, torch.zeros(3)),
            strip_pair_capacity(cfg, model.capacity, 1),
            ["gs.project", "gs.bin", "gs.project", "gs.gather", "gs.raster",
             "gs.strips", "gs.strips"])


def _depth_ring_frame(model, cam, cfg):
    from gaussiansplat_tpu_torch.parallel import (make_depth_ring_render,
                                                  make_gauss_mesh)

    send_cap = 256
    f = make_depth_ring_render(make_gauss_mesh(), cfg, cam.width, cam.height,
                               1, send_cap=send_cap)
    # The payload is made with the projection, before the exchange.
    return (lambda: f(model, cam, torch.zeros(3)),
            cfg.pair_capacity(send_cap),
            ["gs.project", "gs.bin", "gs.gather", "gs.raster"])


def _splats2d_frame(model, cam, cfg):
    from gaussiansplat_tpu_torch.models.splats2d import (random_splats2d,
                                                         render_splats2d)

    splats = random_splats2d(torch.Generator().manual_seed(1), 96, cam.width,
                             cam.height, device="cpu")
    return (lambda: render_splats2d(splats, cam.width, cam.height, cfg),
            cfg.pair_capacity(splats.capacity),
            ["gs.project", "gs.bin", "gs.project", "gs.gather", "gs.raster"])


@pytest.mark.parametrize("path", [_tile_strip_frame, _depth_ring_frame,
                                  _splats2d_frame],
                         ids=["tile_strip", "depth_ring", "splats2d"])
def test_other_render_paths_record_the_pipeline_spans(path):
    """The tile strip, the depth ring and 2D splats run the render
    pipeline of `render()`: under their `gs.render`, the binning's span
    with its counters, then the gather's and the raster's."""
    model, cam, _ = _scene()
    cfg = RasterConfig()
    frame, slots, names = path(model, cam, cfg)

    def traced():
        with torch.inference_mode():
            return frame()

    _profiled(traced)
    (call,) = spans.calls()
    top = call.spans[0]
    assert top.name == "gs.render" and top.parent is None
    assert [s.name for s in call.spans[1:]] == names
    assert all(s.parent is top for s in call.spans[1:])
    assert call.counter("pairs") > 0
    assert call.counter("pair_slots") == slots


def test_train_step_spans_share_the_call():
    _profiled(lambda: _train_steps(2))
    got = spans.calls("gs.step")
    assert [c.id for c in got] == sorted({c.id for c in got})
    for call in got:
        s = _by_name(call)
        assert {"gs.render", "gs.loss", "gs.backward", "gs.optimizer",
                "gs.raster.bwd", "gs.gather.bwd"} | RENDER_CHILDREN <= set(s)
        for name in ("gs.render", "gs.loss", "gs.backward", "gs.optimizer"):
            assert s[name].parent is s["gs.step"], name
        for name in RENDER_CHILDREN:
            assert s[name].parent is s["gs.render"], name
        for name in ("gs.raster.bwd", "gs.gather.bwd"):
            assert s[name].parent is s["gs.backward"], name
            assert s[name].call is call
            assert s["gs.backward"].t0_ns <= s[name].t0_ns
            assert s[name].t1_ns <= s["gs.backward"].t1_ns


def test_a_span_on_another_thread_joins_the_open_call():
    """Autograd runs a CUDA backward on a device thread of its own: a span
    opened there, with no span open on its thread, still belongs to the
    step that waits in backward, and so does a counter it adds."""
    def backward_thread():
        with spans.span("gs.raster.bwd"):
            spans.count("rows", 3)
            with spans.span("gs.inner"):
                pass

    def step():
        with spans.span("gs.step"):
            with spans.span("gs.backward"):
                t = threading.Thread(target=backward_thread)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        with spans.span("gs.next"):
            pass

    _profiled(step)
    first, second = spans.calls()
    s = _by_name(first)
    assert s["gs.raster.bwd"].parent is s["gs.backward"]
    assert s["gs.inner"].parent is s["gs.raster.bwd"]
    assert {x.call for x in first.spans} == {first}
    assert first.counter("rows") == 3
    # The next top-level span starts a call of its own.
    assert second.spans[0].name == "gs.next" and second.id == first.id + 1


def test_host_stamps_on_the_profiler_clock():
    _, prof = _profiled(lambda: _train_steps(1))
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("gs."):
            events.setdefault(e.name(), []).append(e)
    (call,) = spans.calls()
    assert len(call.spans) == sum(len(v) for v in events.values())
    for name, evs in events.items():
        mine = [s for s in call.spans if s.name == name]
        assert len(mine) == len(evs), name
        for s, e in zip(mine, sorted(evs, key=lambda e: e.start_ns())):
            assert abs(s.t0_ns - e.start_ns()) < 1_000_000, name
            assert abs(s.t1_ns - e.end_ns()) < 1_000_000, name
            assert s.t0_ns <= s.t1_ns


def test_the_ring_keeps_4096_calls():
    keep = spans.RECORDER.keep
    assert keep == 4096

    def many():
        for _ in range(keep + 5):
            with spans.span("gs.tick"):
                spans.count("n", 1)

    _profiled(many)
    got = spans.calls("gs.tick")
    assert len(got) == keep
    # The newest `keep`: the first five calls were let go.
    last = got[-1].id
    assert [c.id for c in got] == list(range(last - keep + 1, last + 1))
    assert sum(c.counter("n") for c in got) == keep
