"""Run a function on several local gloo ranks, within a deadline.

``run_ranks(fn, world, *args, **kwargs)`` spawns ``world`` processes
(the ``spawn`` start method: each imports ``fn`` by its module path, so
``fn`` lives in an importable module), joins them into one gloo group on
a ``FileStore`` in a temporary directory, calls ``fn(*args, **kwargs)``
on each with one CPU thread, and returns every rank's result in rank
order.  A rank that raises fails the call with its traceback; when the
deadline passes first, every rank still running is killed and the call
raises ``TimeoutError``, so a hung rendezvous or collective cannot hold
its caller.  The multi-rank tests of the sharded fleet run through it.

``torchrun(args, nproc, ...)`` launches ``torch.distributed.run`` the
same way, under a deadline that kills its whole session, and
``python -m repro_torch.distributed.ranks JOBS OUT`` is a rank body for
it: it runs a list of functions named by import path and writes each
rank's results to a file.
"""
from __future__ import annotations

import contextlib
import importlib
import io
import json
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def _rank_main(rank: int, world: int, store_path: str, call_path: str,
               results) -> None:
    torch.set_num_threads(1)
    try:
        with open(call_path, "rb") as f:
            fn, args, kwargs = pickle.load(f)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        try:
            out = ("ok", fn(*args, **kwargs))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        out = ("error", traceback.format_exc())
    # plain pickle: tensors travel by value, not through shared memory
    # that would vanish with this process
    results.put((rank, pickle.dumps(out)))


def run_ranks(fn: Callable, world: int, *args, deadline_s: float = 120.0,
              **kwargs) -> List[Any]:
    """``fn(*args, **kwargs)`` on ``world`` gloo ranks: the results in
    rank order.  Raises ``RuntimeError`` naming a rank that failed, or
    ``TimeoutError`` after killing the ranks still running at
    ``deadline_s`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    procs = []
    got = {}
    try:
        store = os.path.join(tmp, "store")
        # the call goes through a file: a process object larger than a
        # pipe's buffer would hold each start until that rank had
        # imported enough to read it, one rank after another
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, args, kwargs), f)
        for r in range(world):
            p = ctx.Process(target=_rank_main,
                            args=(r, world, store, call, results),
                            daemon=True)
            p.start()
            procs.append(p)
        deadline = time.monotonic() + deadline_s
        # drain the queue before joining: a child blocks on a full pipe
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{fn.__name__} on {world} ranks: ranks "
                    f"{sorted(set(range(world)) - set(got))} did not finish "
                    f"within {deadline_s} s")
            try:
                r, blob = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"{fn.__name__}: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result") from None
                continue
            got[r] = pickle.loads(blob)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    failed = [(r, v) for r, (status, v) in sorted(got.items())
              if status != "ok"]
    if failed:
        r, tb = failed[0]
        raise RuntimeError(f"{fn.__name__} failed on rank {r}:\n{tb}")
    return [got[r][1] for r in range(world)]


# -- jobs under torchrun -----------------------------------------------------

def run_jobs(jobs_path: str, out_dir: str) -> None:
    """The body of ``python -m repro_torch.distributed.ranks JOBS OUT``
    on each rank of a ``torchrun`` launch: runs every job of the JSON
    list at ``JOBS`` (``{"name", "fn": "module:function", "kwargs"}``)
    in turn, with one CPU thread, and writes this rank's results to
    ``OUT/rank<r>.pkl``: by name, the function's value as numpy (or the
    error it raised, as text) and what it printed."""
    torch.set_num_threads(1)
    with open(jobs_path) as f:
        jobs = json.load(f)
    results = {}
    for job in jobs:
        mod, name = job["fn"].split(":")
        fn = getattr(importlib.import_module(mod), name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                value, error = to_host(fn(**job["kwargs"])), None
            except Exception as e:  # noqa: BLE001 — recorded for the caller
                value, error = None, f"{type(e).__name__}: {e}"
        results[job["name"]] = {"value": value, "error": error,
                                "stdout": buf.getvalue()}
    rank = int(os.environ.get("RANK", 0))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def to_host(tree):
    """A result tree with its tensors as numpy arrays (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)


def torchrun(args: List[str], nproc: int, deadline_s: float, cwd: str,
             env: dict):
    """``python -m torch.distributed.run --standalone --nproc-per-node
    nproc ARGS`` in a session of its own: (exit code, stdout, stderr).
    At ``deadline_s`` the whole session (launcher and ranks) is killed
    and ``TimeoutError`` raised."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", *args]
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=deadline_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise TimeoutError(f"torchrun {' '.join(args)} on {nproc} ranks did "
                           f"not finish within {deadline_s} s") from None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, out, err


if __name__ == "__main__":
    run_jobs(sys.argv[1], sys.argv[2])
