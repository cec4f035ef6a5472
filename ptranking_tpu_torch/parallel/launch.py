"""Starting the ranks of a data-parallel run on one host.

`run_ranks(fn, world_size, args)` spawns `world_size` processes, each a rank
of a new process group (gloo, or NCCL for CUDA), calls `fn(*args)` in each
and returns the ranks' results in rank order. It is how `python -m
ptranking_tpu_torch.ltr -mesh data=W` starts its W ranks when no launcher
(torchrun) made them, as the JAX CLI creates its W devices itself. `fn`
must be a module-level function of a module that imports no jax: a spawned
rank imports it afresh.

Every group has a timeout (`DEFAULT_TIMEOUT_S`, read at each call): a
collective that waits longer fails its rank. `join_timeout_s` bounds the
whole run (`DEFAULT_JOIN_TIMEOUT_S`, none by default: a k-fold run may
take hours, and the collective timeout already ends a deadlock). When a
rank fails, the others are stopped and its traceback is raised here; a rank
whose parent died exits. Ranks other than 0 print nothing.
`one_rank_group()` makes a group of this process alone (the W = 1 mesh).
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import pickle
import shutil
import socket
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0
DEFAULT_JOIN_TIMEOUT_S: Optional[float] = None


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_group(rank: int, world_size: int, port: int, backend: str, device_type: str,
               timeout_s: float, card: Optional[int] = None):
    """This process as rank `rank` of a group at tcp://localhost:port; a CUDA
    rank first takes card `card`, by default rank % device_count."""
    if device_type == "cuda":
        torch.cuda.set_device(card if card is not None else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


@contextlib.contextmanager
def one_rank_group(device_type: str = "cpu", card: Optional[int] = None):
    """A process group of this process alone while active (on CUDA, an NCCL
    group on card `card`, by default 0)."""
    init_group(0, 1, free_port(), backend_for(device_type), device_type, DEFAULT_TIMEOUT_S,
               card)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _exit_with_parent(parent: int):
    """Ends this process once its parent has died (a killed launcher leaves
    no rank waiting on a collective)."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def _rank_main(rank, world_size, port, backend, device_type, timeout_s, fn, args, out_dir,
               parent):
    code = 0
    threading.Thread(target=_exit_with_parent, args=(parent,), daemon=True).start()
    try:
        if rank:
            sys.stdout = open(os.devnull, "w")
        if device_type == "cpu":
            # CPU ranks (tests, rehearsals) share the host's cores; one
            # thread a rank keeps gloo's collectives from waiting on the others
            torch.set_num_threads(1)
        init_group(rank, world_size, port, backend, device_type, timeout_s)
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except Exception:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        code = 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(code)


def run_ranks(fn: Callable[..., Any], world_size: int, args: Sequence = (),
              device_type: str = "cpu", backend: Optional[str] = None,
              timeout_s: Optional[float] = None,
              join_timeout_s: Optional[float] = None) -> List[Any]:
    """fn(*args) on each of `world_size` spawned ranks of one group; their
    results in rank order. A rank that fails, or a run past
    `join_timeout_s`, stops every rank and raises here. The timeouts default
    to DEFAULT_TIMEOUT_S and DEFAULT_JOIN_TIMEOUT_S as they are at the
    call."""
    backend = backend or backend_for(device_type)
    timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    join_timeout_s = DEFAULT_JOIN_TIMEOUT_S if join_timeout_s is None else join_timeout_s
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} NCCL ranks need {world_size} cards; "
                         f"{torch.cuda.device_count()} are visible")
    out_dir = tempfile.mkdtemp(prefix="ptranking_ranks_")
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, port, backend, device_type, timeout_s, fn,
                               tuple(args), out_dir, os.getpid()))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
        while any(p.exitcode is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(out_dir, procs, failed))
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks did not finish in {join_timeout_s} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(_failure(out_dir, procs, failed))
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.exitcode is None and p.pid is not None:
                p.kill()
            if p.pid is not None:
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)


def _failure(out_dir: str, procs, failed: List[int]) -> str:
    """The failed ranks' exit codes and tracebacks."""
    parts = []
    for r in failed:
        path = os.path.join(out_dir, f"rank{r}.err")
        tb = open(path).read() if os.path.exists(path) else "(no traceback)"
        parts.append(f"rank {r} exited with code {procs[r].exitcode}:\n{tb}")
    return "\n".join(parts)
