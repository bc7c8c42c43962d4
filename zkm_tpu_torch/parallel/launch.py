"""Run a function on `world` ranks, each its own process.

The counterpart of `scripts/multihost_demo.py`'s spawning and
`jax.distributed.initialize`.  `launch(fn, world, args, backend=...)`
starts the ranks with the `spawn` start method (never fork: the parent
may hold a CUDA context), joins each to one process group of `backend`
through a `file://` rendezvous in a fresh temporary directory (no port to
clash under pytest-xdist), with `timeout` as the group's limit, and
returns `[fn(*args) on rank 0, ..., on rank world - 1]`.  `fn` lays the
group out with `sharding.make_mesh`, which checks the backend.

It raises `LaunchError` when a rank raises, exits without a result or
outlives `timeout` seconds; the other ranks are then terminated at once,
so a collective that waits for a dead rank fails the launch instead of
hanging it.  `fn` must be importable by name (a module-level function),
and so must its arguments and result be picklable.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Sequence


class LaunchError(RuntimeError):
    pass


def _rank_main(fn, rank, world, backend, init, timeout, threads, args,
               results):
    import torch
    import torch.distributed as dist
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:                   # reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world: int, args: Sequence = (),
           timeout: float = 300.0, threads: int = 0,
           backend: str = "gloo") -> List:
    """fn(*args) on ranks 0..world-1 of a `backend` process group; their
    results in rank order.  `timeout` bounds the whole launch (and each
    rank's process group); `threads` sets each rank's torch CPU threads
    (0: leave torch's)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="zkm_launch_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, init, timeout,
                               threads, tuple(args), results),
                         name=f"rank{r}")
             for r in range(world)]
    deadline = time.monotonic() + timeout
    got, failure = {}, None
    try:
        for p in procs:
            p.start()
        while len(got) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world)) - set(got))
                failure = f"ranks {missing} outlived the {timeout:.0f} s limit"
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a rank may have put its result just before exiting
                    try:
                        rank, ok, out = results.get(timeout=1.0)
                    except queue.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                        break
                else:
                    continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} raised:\n{out}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
            p.join(timeout=max(1.0, deadline - time.monotonic())
                   if failure is None else 5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise LaunchError(failure)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise LaunchError(f"ranks exited nonzero after their results: {bad}")
    return [got[r] for r in range(world)]
