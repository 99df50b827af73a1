"""The port's multi-process entry points (parallel/multihost.py) in two
processes started as torchrun starts them: `initialize` from MASTER_ADDR /
MASTER_PORT / RANK / WORLD_SIZE / LOCAL_RANK (gloo, idempotent), the
global mesh and its host-locality check, `global_batch`, and `replicate`
making every rank's model and Adam state equal to rank 0's. In this
process: `initialize` with no backend raises where no card is visible.

This file is also the ranks' entry point:
`python tests/test_torch_multihost.py OUT_DIR` with the environment set.
"""

import hashlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def worker(out_dir: str) -> int:
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
    from gaussiansplat_tpu_torch.models import random_model
    from gaussiansplat_tpu_torch.ops.camera import look_at
    from gaussiansplat_tpu_torch.parallel import multihost as mh
    from gaussiansplat_tpu_torch.train import init_train_state, make_train_step

    mh.initialize(backend="gloo", timeout_s=90)
    mh.initialize(backend="gloo")                 # idempotent
    try:
        rank = dist.get_rank()
        mesh = mh.make_global_mesh()              # (2, 1): data over ranks
        try:
            mh.make_global_mesh(data=1, tile=2)   # tile across hosts
            local_rejected = False
        except ValueError:
            local_rejected = True
        # A different model (and Adam state) on every rank, then rank 0's.
        model = random_model(torch.Generator().manual_seed(rank), 64,
                             sh_degree=1, device="cpu")
        state = init_train_state(model, TrainConfig(), extent=1.0)
        cam = look_at((0, 0, -4), (0, 0, 0), fx=40.0, fy=40.0, width=32,
                      height=32, device="cpu")
        make_train_step(RasterConfig(tile_size=16, chunk_size=32, impl="torch"),
                        TrainConfig())(state, cam, torch.zeros((32, 32, 3)), 1)
        moments = [v for st in state.optimizer.state.values()
                   for v in st.values()]
        before = _digest(list(model.parameters()) + moments)
        mh.replicate(mesh, model, state.optimizer)
        after = _digest(list(model.parameters()) + [model.alive] + moments)
        views = [(cam, torch.full((32, 32, 3), float(i))) for i in range(5)]
        mine = mh.process_views(views, 1, 3, mesh.data, mesh.data_index)
        cams, gts = mh.global_batch(mesh, mine, 32, 16)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 world=dist.get_world_size(), rank=rank, mesh=mesh.data,
                 local_rejected=local_rejected, before=before, after=after,
                 gts_shape=np.array(gts.shape), gts_stride0=gts.stride(0),
                 cams_fx=cams.fx.numpy(), view=float(gts[mesh.data_index].max()))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1]))

from test_torch_common import limit_torch_threads  # noqa: E402

limit_torch_threads()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_initialize_from_environment_and_replicate(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", LOCAL_WORLD_SIZE="1", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp_path)], cwd=ROOT,
        env=dict(env, RANK=str(r), LOCAL_RANK="0"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert [int(r["rank"]) for r in res] == [0, 1]
    assert all(int(r["world"]) == 2 and int(r["mesh"]) == 2 for r in res)
    assert all(bool(r["local_rejected"]) for r in res)
    assert str(res[0]["before"]) != str(res[1]["before"])
    assert str(res[0]["after"]) == str(res[1]["after"])
    for r in res:
        # Two entries on the leading axis, held once (an expanded view).
        assert r["gts_shape"].tolist() == [2, 32, 32, 3]
        assert int(r["gts_stride0"]) == 0 and r["cams_fx"].shape == (2,)
    # Step 3 with 2 feeders of one view: sample indices 6 and 7 of 5 views.
    assert [float(r["view"]) for r in res] == [1.0, 2.0]


def test_initialize_without_a_card_needs_gloo_asked_for(monkeypatch):
    """With no backend given, `initialize` takes NCCL and so needs a card:
    where CUDA is not available it raises before any process group is made
    (no silent gloo over host memory); gloo runs only when asked for."""
    import torch.distributed as dist

    from gaussiansplat_tpu_torch.parallel import multihost as mh

    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"backend": "nccl"}):
        try:
            mh.initialize(init_method="file:///nonexistent", world_size=1,
                          rank=0, **kw)
        except RuntimeError as e:
            assert "backend='gloo'" in str(e) and "CUDA" in str(e)
        else:
            raise AssertionError(f"initialize({kw}) did not raise")
    assert not dist.is_initialized()
