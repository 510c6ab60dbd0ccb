"""Start W ranks of a ``torch.distributed`` group as processes on this host.

The caller names the backend and the device; nothing here picks either:
gloo on the CPU (the tests), and on a card NCCL for one rank or gloo over
CUDA tensors for several ranks that share it (NCCL refuses two ranks on
one device). The ranks meet at a ``TCPStore`` on a free localhost port.

:func:`run_ranks` spawns one process a rank, calls ``fn(group, *args)`` in
each with the default group initialized, and returns the ranks' return
values in rank order (they cross processes by pickling: return host
values). A rank that raises, or dies, fails the whole call: the others are
stopped and the first rank's traceback is raised. :func:`single_rank`
makes a group of one in the calling process.
"""

from __future__ import annotations

import contextlib
import datetime
import queue as queue_lib
import socket
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check(backend: str, device: str, world: int) -> torch.device:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    dev = torch.device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    if backend == "nccl" and world > 1:
        raise ValueError("nccl refuses two ranks on one card; use gloo over "
                         "CUDA tensors for several ranks on one device")
    return dev


def _init(backend, dev, rank, world, port, timeout_s):
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(rank, world, backend, device, port, timeout_s, threads, fn,
               args, results):
    try:
        torch.set_num_threads(threads)
        _init(backend, torch.device(device), rank, world, port, timeout_s)
        try:
            out = fn(dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, *, backend: str, device: str, args=(),
              timeout_s: float = 600.0, threads: int = 1):
    """``[fn(group, *args) on rank r for r in range(world)]``, each rank a
    spawned process. ``fn`` and ``args`` must pickle (a module-level
    function; host values). Raises if a rank raises, exits without a
    result, or ``timeout_s`` passes; every process is stopped before it
    returns or raises."""
    _check(backend, device, world)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, device, port, timeout_s,
                               threads, fn, tuple(args), results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, failure = {}, None
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
    try:
        while len(out) < world and failure is None:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                failure = f"ranks timed out after {timeout_s} s"
                break
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in out]
                if dead:
                    # a rank that died without a word; give its report, if
                    # any, a moment to arrive
                    try:
                        rank, ok, val = results.get(timeout=5.0)
                    except queue_lib.Empty:
                        failure = (f"rank {dead[0]} died (exit code "
                                   f"{procs[dead[0]].exitcode}) without a "
                                   "result")
                        break
                else:
                    continue
            if ok:
                out[rank] = val
            else:
                failure = f"rank {rank} raised:\n{val}"
    finally:
        for p in procs:
            p.join(timeout=30.0 if failure is None else 1.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        results.close()
    if failure is None:
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            failure = f"rank {bad[0]} exited with code {procs[bad[0]].exitcode}"
    if failure is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, "
                           f"world={world}, backend={backend}): {failure}")
    return [out[r] for r in range(world)]


@contextlib.contextmanager
def single_rank(backend: str, device: str, timeout_s: float = 600.0):
    """A default process group of one rank in this process (NCCL on a card
    for the single-rank path, or gloo); yields the group and destroys it
    on exit."""
    dev = _check(backend, device, 1)
    _init(backend, dev, 0, 1, free_port(), timeout_s)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


__all__ = ["BACKENDS", "free_port", "run_ranks", "single_rank"]
