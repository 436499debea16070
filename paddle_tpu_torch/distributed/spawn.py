"""``paddle.distributed.spawn`` of the port: ``nprocs`` ranks as
processes of the ``spawn`` start method, with the launcher's
environment (``launch/main.py``) and a rendezvous store that this
process hosts on a port the system picks.

``func`` is sent to the children by its import path, so it must be a
module-level function of a module the children may import (a test that
imports JAX starts its ranks from a function of ``paddle_tpu_torch``,
which imports none).
"""
from __future__ import annotations

import multiprocessing
import os
import time
import traceback

from .launch.main import host_store, rank_env


def _entry(func, args, env, rank, queue):
    os.environ.update(env)
    try:
        result = func(*args)
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    queue.put((rank, True, result))


def spawn(func, args=(), nprocs=1, join=True, daemon=False, timeout=600,
          devices=None):
    """Run ``func(*args)`` as ranks 0..nprocs-1 (``devices``: each
    rank's card, as the launcher's ``--devices``) and return the ranks'
    return values in rank order. When a rank raises or dies, the others
    are stopped and ``RuntimeError`` carries its traceback; past
    ``timeout`` seconds, ``TimeoutError``. ``join=False`` (returning
    before the ranks end) is not ported."""
    if not join:
        raise NotImplementedError("spawn(join=False) is not ported")
    ctx = multiprocessing.get_context("spawn")
    store = host_store(nprocs)
    queue = ctx.SimpleQueue()
    devices = devices or [None] * nprocs
    procs = [ctx.Process(target=_entry, daemon=daemon, args=(
        func, args, rank_env(r, nprocs, store.port, devices[r]), r, queue))
        for r in range(nprocs)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < nprocs:
            if not queue.empty():
                rank, ok, value = queue.get()
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
                results[rank] = value
                continue
            dead = [(i, p.exitcode) for i, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and i not in results]
            if dead and queue.empty():
                raise RuntimeError(f"spawn: rank {dead[0][0]} exited with "
                                   f"{dead[0][1]} and no result")
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn: {nprocs - len(results)} ranks "
                                   f"still running after {timeout} s")
            time.sleep(0.02)
    finally:
        for p in procs:
            p.join(timeout=30 if len(results) == nprocs else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [results[r] for r in range(nprocs)]
