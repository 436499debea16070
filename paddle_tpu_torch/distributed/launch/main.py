"""``python -m paddle_tpu_torch.distributed.launch`` — start a job of
one process per rank on this node (counterpart of the reference's
``distributed/launch/main.py``).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \\
        [--devices 0,1,...] [--log_dir log] script.py [args...]

The controller hosts the job's rendezvous store (a ``TCPStore`` on a
port the system picks, so concurrent jobs never race for one) and
starts ``script.py`` N times with both environment contracts: the
reference's (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_MASTER``) and torch's (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, and
``TORCHELASTIC_USE_AGENT_STORE=True``, which tells every rank that the
store is the controller's). ``--devices`` names each rank's card
(``FLAGS_selected_gpus``, which ``init_parallel_env`` binds); one card
may be named for several ranks (``--devices 0,0``), which only gloo
accepts. Each worker's output goes to ``<log_dir>/workerlog.<rank>``.
When a worker fails, the controller stops the others and exits with its
code, printing the end of its log; stopped itself (SIGTERM, SIGINT), it
stops every worker first.

Not ported: several nodes (``--nnodes`` above 1, ``--master``), the
elastic modes (``--max_restart`` above 0, ``--elastic_level``) and the
reference's own store rendezvous (``store.py``).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

import torch.distributed as dist


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.distributed.launch",
                                description="start one process per rank")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--devices", default=None,
                   help="each rank's card, comma-separated (default: "
                   "rank i on card i)")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--job_id", default="default")
    p.add_argument("--nnodes", default="1")
    p.add_argument("--master", default=None)
    p.add_argument("--rank", type=int, default=-1)
    p.add_argument("--max_restart", type=int, default=0)
    p.add_argument("--elastic_level", type=int, default=-1)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _refuse_unported(args):
    if str(args.nnodes) != "1" or args.master or args.rank > 0:
        raise NotImplementedError(
            "launch: jobs over several nodes (--nnodes, --master, --rank) "
            "and their store rendezvous are not ported yet; one node only")
    if args.max_restart > 0 or args.elastic_level >= 1:
        raise NotImplementedError(
            "launch: the elastic modes (--max_restart, --elastic_level) "
            "are not ported yet")


def rank_env(rank, world, port, device=None):
    """The environment of rank ``rank`` of a one-node job of ``world``
    ranks whose store listens on ``127.0.0.1:port``, in both contracts;
    ``device`` is the rank's card (None: its local rank's)."""
    env = {
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_LOCAL_RANK": str(rank),
        "PADDLE_CURRENT_ENDPOINT": f"127.0.0.1:{6070 + rank}",
        "PADDLE_TRAINER_ENDPOINTS": ",".join(
            f"127.0.0.1:{6070 + r}" for r in range(world)),
        "PADDLE_MASTER": f"127.0.0.1:{port}",
        "PADDLE_NNODES": "1",
        "PADDLE_NODE_RANK": "0",
        "RANK": str(rank),
        "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(world),
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port),
        "TORCHELASTIC_USE_AGENT_STORE": "True",
    }
    if device is not None:
        env["FLAGS_selected_gpus"] = str(device)
    return env


def host_store(world):
    """The job's rendezvous store, on a port the system picks."""
    return dist.TCPStore("127.0.0.1", 0, world_size=world, is_master=True,
                         wait_for_workers=False)


def _package_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def _tail(path, n=4000):
    with open(path, "rb") as f:
        return f.read().decode(errors="replace")[-n:]


def _stop(procs):
    for proc, _ in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + 10
    for proc, _ in procs:
        try:
            proc.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _exit_on_signals():
    """SIGTERM and SIGINT end the controller through ``SystemExit``,
    so that it stops its workers on the way out."""
    def handler(signum, _frame):
        raise SystemExit(128 + signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, handler)


def launch(argv=None) -> int:
    """Run the job; returns its exit code (the first failing worker's,
    else 0)."""
    args = parse_args(argv)
    _refuse_unported(args)
    n = args.nproc_per_node
    devices = args.devices.split(",") if args.devices else [None] * n
    if len(devices) != n:
        raise ValueError(f"launch: --devices names {len(devices)} cards "
                         f"for {n} ranks")
    store = host_store(n)
    os.makedirs(args.log_dir, exist_ok=True)
    root = _package_root()
    procs = []
    rc, failed = 0, None
    try:
        for rank in range(n):
            env = dict(os.environ)
            env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
            env["PADDLE_JOB_ID"] = args.job_id
            env.update(rank_env(rank, n, store.port, devices[rank]))
            log = os.path.join(args.log_dir, f"workerlog.{rank}")
            with open(log, "wb") as logf:
                proc = subprocess.Popen(
                    [sys.executable, args.training_script,
                     *args.training_script_args],
                    env=env, stdout=logf, stderr=subprocess.STDOUT)
            procs.append((proc, log))
        while rc == 0 and any(p.poll() is None for p, _ in procs):
            time.sleep(0.1)
            for proc, log in procs:
                if proc.poll() not in (None, 0):
                    rc, failed = proc.returncode, log
                    break
        if rc == 0:
            rc, failed = next(((p.returncode, log) for p, log in procs
                               if p.returncode), (0, None))
    finally:
        _stop(procs)
    if failed is not None:
        sys.stderr.write(f"launch: a worker exited with {rc}; the end of "
                         f"{failed}:\n{_tail(failed)}\n")
    del store
    return rc


def main():
    _exit_on_signals()
    sys.exit(launch())
