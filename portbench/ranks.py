"""A cell on several cards: one process for each card on this host, and
the host channel through which the ranks share one window.

`launch` starts the ranks through torch's elastic launcher, as
`torchrun --standalone` would: its agent hosts the job's TCP store and
gives each rank torchrun's environment (MASTER_ADDR, MASTER_PORT,
TORCHELASTIC_USE_AGENT_STORE, RANK, LOCAL_RANK, WORLD_SIZE), so that the
program brings up its own process group on that store
(`parallel.multihost.initialize()`). When a rank fails the agent ends
every rank, and `launch` raises `JobFailed` with that rank's traceback.

The ranks meet through the same store, under keys of their own (`Group`),
which also limits each stage of a rank's run: a rank that stalls exits
with its threads' stacks, and so ends the job. A one-card cell runs in
run.py's own process through `SOLO`, and starts no other.
"""

from __future__ import annotations

import ctypes
import datetime
import faulthandler
import os
import pickle
import signal
import tempfile
from typing import Optional

# The harness's keys in the job's store, apart from the process group's.
PREFIX = "portbench"
SETUP_LIMIT_S = 600.0
WINDOW_MARGIN_S = 120.0
CHECK_LIMIT_S = 300.0


class Solo:
    """The one rank of a one-card cell: it decides alone."""

    rank, world = 0, 1

    def barrier(self, name: str) -> None:
        pass

    def decide(self, i: int, go: bool) -> bool:
        return go

    def gather(self, obj) -> list:
        return [obj]


SOLO = Solo()


class JobFailed(Exception):
    """A rank of the job failed; the message ends with its traceback."""


class Group:
    """One rank of a job, on the agent's TCP store. Rank 0 decides, call by
    call, whether the window goes on (`decide`); the others wait for that
    decision before each call, so every rank makes the same calls. The
    store is the host's, so the channel adds no device synchronisation.
    `tag` keeps the keys of one run apart from another's in one job.

    Each stage has a limit: the window's open SETUP_LIMIT_S after the
    group is made, its drain the window and WINDOW_MARGIN_S after the open,
    the results CHECK_LIMIT_S after the drain. A rank that has not passed
    a stage within its limit, wherever it waits (on a peer, in the
    program's own collectives, on its card), prints its threads' stacks
    and exits (faulthandler), and so ends the job."""

    def __init__(self, seconds: float, tag: str = "") -> None:
        from torch.distributed import PrefixStore, TCPStore

        env = os.environ
        self.rank, self.world = int(env["RANK"]), int(env["WORLD_SIZE"])
        self.limits = dict(open=SETUP_LIMIT_S, drained=seconds + WINDOW_MARGIN_S,
                           out=CHECK_LIMIT_S)
        # Above every stage's limit, so that the stage's limit ends a wait.
        wait = datetime.timedelta(seconds=sum(self.limits.values()))
        self.store = PrefixStore(f"{PREFIX}{tag}", TCPStore(
            env["MASTER_ADDR"], int(env["MASTER_PORT"]), is_master=False,
            timeout=wait))
        self._until("open")

    def _until(self, stage: str) -> None:
        faulthandler.dump_traceback_later(self.limits[stage], exit=True)

    def barrier(self, name: str) -> None:
        """Wait until every rank has arrived at `name` (open or drained)."""
        if self.store.add(f"{name}/in", 1) == self.world:
            self.store.set(f"{name}/out", b"1")
        self.store.wait([f"{name}/out"])
        self._until(dict(open="drained", drained="out")[name])

    def decide(self, i: int, go: bool) -> bool:
        """Whether call i is made: rank 0's `go`, on every rank."""
        if self.rank == 0:
            self.store.set(f"go/{i}", b"1" if go else b"0")
            return go
        return self.store.get(f"go/{i}") == b"1"

    def gather(self, obj) -> Optional[list]:
        """Every rank's `obj` on rank 0 (rank 0's first); None elsewhere."""
        if self.rank:
            self.store.set(f"out/{self.rank}", pickle.dumps(obj))
            faulthandler.cancel_dump_traceback_later()
            return None
        got = [obj] + [pickle.loads(self.store.get(f"out/{r}"))
                       for r in range(1, self.world)]
        faulthandler.cancel_dump_traceback_later()
        return got


def start_rank(launcher: int, device: str) -> str:
    """Set up a rank that ranks.launch started: have the kernel kill it
    when its launcher exits (PR_SET_PDEATHSIG), exit at once if it already
    has, and on cards take cuda:LOCAL_RANK. Returns the rank's device."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != launcher:
        os._exit(1)
    if device != "cuda":
        return device
    import torch

    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    return f"cuda:{local}"


def close_group() -> None:
    """End the process group the program brought up, if it did."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def launch(world: int, fn, args: tuple):
    """Run fn(*args) as `world` ranks on this host and wait for them; rank
    0's return value, or JobFailed."""
    from torch.distributed.elastic.multiprocessing import DefaultLogsSpecs
    from torch.distributed.elastic.multiprocessing.errors import ChildFailedError
    from torch.distributed.launcher.api import LaunchConfig, elastic_launch

    with tempfile.TemporaryDirectory(prefix="portbench-ranks-") as tmp:
        config = LaunchConfig(
            min_nodes=1, max_nodes=1, nproc_per_node=world,
            run_id=f"portbench-{os.getpid()}", rdzv_backend="c10d",
            rdzv_endpoint="127.0.0.1:0", rdzv_configs=dict(is_host=True),
            max_restarts=0, monitor_interval=0.1, start_method="spawn",
            logs_specs=DefaultLogsSpecs(log_dir=tmp))
        try:
            return elastic_launch(config, fn)(*args)[0]
        except ChildFailedError as e:
            rank, f = e.get_first_failure()
            msg = f.message
            if isinstance(msg, dict):
                msg = msg.get("extraInfo", {}).get("py_callstack") or msg["message"]
            elif f.exitcode > 0:
                msg = ("no traceback: its standard error is above (a rank "
                       "past a stage's limit prints 'Timeout' and its stacks)")
            raise JobFailed(f"portbench: rank {rank} failed (exit {f.exitcode})\n"
                            f"{msg.rstrip()}") from None
