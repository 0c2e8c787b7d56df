"""Per-node spawner — ``python -m deepspeed_tpu_torch.launcher.launch``
(counterpart of ``deepspeed_tpu/launcher/launch.py``; reference
``deepspeed/launcher/launch.py``).

One process per GPU: ``--nproc_per_node`` workers, worker ``i`` of node
``--node_rank`` given ``LOCAL_RANK=i``, ``RANK=node_rank * nproc + i``,
``WORLD_SIZE=nnodes * nproc`` and ``MASTER_ADDR`` / ``MASTER_PORT`` (or
``--init_method``, e.g. ``file:///shared/rendezvous``, passed on as
``DSTPU_COORDINATOR_ADDRESS``), each running the user script in-process
through ``runpy``. The script's ``initialize()`` (or
``comm.init_distributed()``) starts the process group from them: NCCL on
``cuda:{LOCAL_RANK}``, or gloo for ``device="cpu"``.

The rc contract of the JAX launcher holds: a worker whose script raises an
exception carrying an int ``exit_code`` exits with that code (an
integrity abort's 118, a stall's 117); the launcher's rc is the first
non-zero worker rc (a worker killed by signal N counts as 128 + N), and
once a worker fails the others are stopped, since they would wait in
their next collective for ever.

The heartbeat channel and the init watchdog of the JAX launcher wait for
the run-side resilience work (ROADMAP.md item 4.3): asking for them
(``--heartbeat_dir``, ``DSTPU_HEARTBEAT_DIR``) raises.
"""

from __future__ import annotations

import argparse
import os
import runpy
import signal
import socket
import subprocess
import sys
import time

_RESILIENCE = ("the heartbeat channel and the watchdog of the launcher "
               "(run-side resilience, ROADMAP item 4.3) are not ported to "
               "deepspeed_tpu_torch yet (see ROADMAP.md)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="deepspeed_tpu_torch.launcher.launch")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="workers on this node, one per GPU")
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--master_addr", default="127.0.0.1")
    p.add_argument("--master_port", type=int, default=0,
                   help="0: a free local port (one node only)")
    p.add_argument("--init_method", default=None,
                   help="rendezvous URL for every worker (tcp://host:port "
                        "or file://path), in place of MASTER_ADDR / "
                        "MASTER_PORT")
    p.add_argument("--init_timeout", type=float, default=0.0,
                   help="bound on each worker's rendezvous, seconds "
                        "(0 = wait for ever)")
    p.add_argument("--heartbeat_dir", default=None, help=argparse.SUPPRESS)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("user_script")
    p.add_argument("user_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_worker(script: str, script_args) -> None:
    """Run the user script as ``__main__`` in this process, keeping the rc
    contract: an exception with an int ``exit_code`` exits with it."""
    sys.argv = [script] + list(script_args)
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit:
        raise
    except Exception as e:
        code = getattr(e, "exit_code", None)
        if isinstance(code, int) and 0 < code < 256:
            import traceback
            traceback.print_exc()
            sys.exit(code)
        raise


def _rc(returncode: int) -> int:
    return 128 - returncode if returncode < 0 else returncode


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.heartbeat_dir or os.environ.get("DSTPU_HEARTBEAT_DIR"):
        raise NotImplementedError(_RESILIENCE)
    if args.worker:
        run_worker(args.user_script, args.user_args)
        return 0
    if args.nproc_per_node < 1 or args.nnodes < 1 or \
            not 0 <= args.node_rank < args.nnodes:
        raise ValueError(f"bad world: nnodes={args.nnodes} node_rank="
                         f"{args.node_rank} nproc_per_node="
                         f"{args.nproc_per_node}")
    port = args.master_port
    if not port and args.init_method is None:
        if args.nnodes > 1:
            raise ValueError("--master_port (or --init_method) is required "
                             "with more than one node")
        port = _free_port()
    world = args.nnodes * args.nproc_per_node
    procs = []
    for local in range(args.nproc_per_node):
        env = dict(os.environ,
                   RANK=str(args.node_rank * args.nproc_per_node + local),
                   LOCAL_RANK=str(local), WORLD_SIZE=str(world),
                   MASTER_ADDR=args.master_addr, MASTER_PORT=str(port))
        if args.init_method:
            env["DSTPU_COORDINATOR_ADDRESS"] = args.init_method
        if args.init_timeout > 0:
            env["DSTPU_INIT_TIMEOUT"] = str(args.init_timeout)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
             "--worker", args.user_script] + list(args.user_args), env=env))
    rc = 0
    try:
        live = list(procs)
        while live:
            for p in list(live):
                r = p.poll()
                if r is None:
                    continue
                live.remove(p)
                if r != 0 and rc == 0:
                    rc = _rc(r)
                    for q in live:          # they would hang in a collective
                        q.send_signal(signal.SIGTERM)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
