"""Port parity of utils/resilience and the exact resume of `Trainer.fit`.

* The reference's five tests (tests/test_resilience.py) against the port:
  the render and its gradients bitwise deterministic on the reference's
  scene (192 gaussians, SH 1, 128x128) through the plain versions; the
  reference's strings classified as the reference classifies them; restart
  then success, real bugs propagating and giving up after `max_restarts`,
  each for both packages' `run_resilient`.
* The card's own failures, built on the CPU: the allocator's
  out-of-memory and a lost peer or store are transient; a CUDA error that
  poisons the context and an aborted NCCL communicator are not, whatever
  their text says.
* `run_resilient` around `Trainer.fit`, re-entered with the model object
  the failed attempt trained, ends bit-equal to a straight run.
"""

import copy

import jax
import pytest
import torch
import torch.distributed as dist

from test_torch_common import port_camera, port_model

from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.utils import is_transient as j_is_transient
from gaussiansplat_tpu.utils import run_resilient as j_run_resilient
from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
from gaussiansplat_tpu_torch.data import synthetic_scene
from gaussiansplat_tpu_torch.render import render
from gaussiansplat_tpu_torch.train import Trainer
from gaussiansplat_tpu_torch.utils import is_transient, run_resilient

RUNNERS = pytest.mark.parametrize("runner", [run_resilient, j_run_resilient],
                                  ids=["port", "reference"])


def test_render_and_grads_bitwise_deterministic():
    jmodel = j_random_model(jax.random.PRNGKey(0), 192, sh_degree=1, extent=1.0)
    jcam = j_look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=220.0,
                     fy=220.0, width=128, height=128)
    model, cam = port_model(jmodel), port_camera(jcam)
    cfg = RasterConfig(tile_size=32, chunk_size=128)
    params = list(model.trainable().values())

    def loss_and_grad():
        img = render(model, cam, cfg, sh_degree=1, impl="torch").image
        loss = torch.mean(img ** 2)
        return loss.detach(), img.detach(), torch.autograd.grad(loss, params)

    l1, img1, g1 = loss_and_grad()
    l2, img2, g2 = loss_and_grad()
    assert bool(img1.any())
    assert torch.equal(img1, img2)
    assert torch.equal(l1, l2)
    for name, a, b in zip(model.trainable(), g1, g2):
        assert torch.equal(a, b), name
    assert all(bool(g.any()) for g in g1)


@pytest.mark.parametrize("exc, transient", [
    # The reference's strings, and XLA's other status words.
    (RuntimeError("ABORTED: TPU backend error"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), True),
    (RuntimeError("UNAVAILABLE: worker preempted"), True),
    (RuntimeError("INTERNAL: Failed to execute XLA Runtime executable"), True),
    (RuntimeError("DEADLINE_EXCEEDED: barrier timed out"), True),
    (ValueError("bad shape"), False),
])
def test_is_transient_classification(exc, transient):
    assert is_transient(exc) is transient
    assert j_is_transient(exc) is transient


@pytest.mark.parametrize("exc, transient", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), True),
    (dist.DistNetworkError("Connection reset by peer"), True),
    (dist.DistStoreError("Timed out after 300 seconds waiting for clients"),
     True),
    (torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered INTERNAL"), False),
    (torch.AcceleratorError("CUDA error: device-side assert triggered "
                            "UNAVAILABLE"), False),
    (dist.DistBackendError("NCCL error in: ProcessGroupNCCL.cpp, unhandled "
                           "system error ABORTED"), False),
    (RuntimeError("CUDA error: CUBLAS_STATUS_INTERNAL_ERROR when calling "
                  "cublasCreate(handle)"), False),
    (ValueError("bad shape"), False),
])
def test_is_transient_card_errors(exc, transient):
    assert is_transient(exc) is transient


@RUNNERS
def test_run_resilient_restarts_then_succeeds(runner):
    calls = []

    def fit(x, resume=False):
        calls.append(resume)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: worker preempted")
        return x * 2

    out = runner(fit, 21, max_restarts=3, backoff_s=0.0,
                 on_restart=lambda a, e: None)
    assert out == 42
    assert calls == [False, True, True]  # retries resume from checkpoint


@RUNNERS
def test_run_resilient_propagates_real_bugs(runner):
    calls = []

    def fit(resume=False):
        calls.append(resume)
        raise ValueError("genuine bug")

    with pytest.raises(ValueError):
        runner(fit, max_restarts=5, backoff_s=0.0)
    assert calls == [False]


@RUNNERS
def test_run_resilient_gives_up_after_max_restarts(runner):
    calls = []

    def fit(resume=False):
        calls.append(resume)
        raise RuntimeError("UNAVAILABLE: persistent outage")

    with pytest.raises(RuntimeError):
        runner(fit, max_restarts=2, backoff_s=0.0,
               on_restart=lambda a, e: None)
    assert calls == [False, True, True]


def test_run_resilient_restarts_on_oom_and_releases_frames():
    """An out-of-memory restarts; the failed attempt's locals are let go
    before the retry (what the caching allocator then hands back), even
    though `on_restart` keeps the exception and with it the traceback."""
    import weakref

    refs, calls = [], []

    class Held:
        pass

    def fit(resume=False):
        held = Held()
        refs.append(weakref.ref(held))
        calls.append(resume)
        if not resume:
            raise torch.OutOfMemoryError("CUDA out of memory.")
        assert refs[0]() is None, "the failed attempt's frame is still held"
        return len(calls)

    kept = []
    assert run_resilient(fit, backoff_s=0.0,
                         on_restart=lambda a, e: kept.append(e)) == 2
    assert calls == [False, True]
    assert [type(e) for e in kept] == [torch.OutOfMemoryError]


RESTART_CFG = dict(iterations=6, densify_start=2, densify_every=2,
                   densify_end=6, densify_target_fraction=0.3,
                   densify_scale_thresh=0.05, random_background=True,
                   sh_degree=1, sh_increase_every=2, checkpoint_every=2,
                   log_every=1)


def test_restart_of_the_trained_model_equals_straight_run(tmp_path):
    """A transient error after step 5; the retry gets the model object the
    failed attempt trained and densified, resumes from the step-4
    checkpoint with its extent, densifies at 6 and ends bit-equal."""
    scene, _ = synthetic_scene(torch.Generator().manual_seed(1),
                               n_gaussians=48, n_train=8, n_test=1, width=32,
                               height=32, fx=40.0, device="cpu")
    trainer = Trainer(raster_cfg=RasterConfig(), cfg=TrainConfig(**RESTART_CFG))
    straight = copy.deepcopy(scene.init_model)
    _, met = trainer.fit(straight, scene.train_views)

    model = copy.deepcopy(scene.init_model)
    rows, failed = [], []

    def log(it, m):
        rows.append((it, m))
        if it == 5 and not failed:
            failed.append(it)
            raise RuntimeError("UNAVAILABLE: worker preempted")

    restarts = []
    out, rmet = run_resilient(
        trainer.fit, model, scene.train_views, log=log,
        ckpt_dir=str(tmp_path / "ckpts"), backoff_s=0.0,
        on_restart=lambda a, e: restarts.append(a))
    assert restarts == [1] and out is model
    assert [it for it, _ in rows] == [1, 2, 3, 4, 5, 5, 6]
    assert [it for it, m in rows if "cloned" in m] == [2, 4, 6]
    assert rows[-1][1]["split"] > 0
    assert int(model.num_alive) > 48
    for k, v in straight.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert rmet["loss"] == met["loss"]
