"""Per-node bootstrap — ``python -m deepspeed_tpu_torch.launcher.launch``
(counterpart of ``deepspeed_tpu/launcher/launch.py``; reference
``deepspeed/launcher/launch.py``).

One process per GPU. The node's workers are ``--nproc_per_node`` (or,
under the runner, this host's slots in ``--world_info``): worker ``i``
gets ``LOCAL_RANK=i``, ``RANK`` = the slots of the hosts before this one
+ ``i``, ``WORLD_SIZE`` = every host's slots, and ``MASTER_ADDR`` /
``MASTER_PORT`` from ``--coordinator host:port`` or ``--master_addr`` /
``--master_port`` (or ``--init_method``, e.g. ``file:///shared/rdv``,
passed on as ``DSTPU_COORDINATOR_ADDRESS``). Each runs the user script
through ``runpy``; the script's ``initialize()`` (or
``comm.init_distributed()``) starts the process group from them: NCCL on
``cuda:{LOCAL_RANK}``, or gloo for ``device="cpu"``. The runner's command
line (``--node_rank``, ``--nnodes``, ``--coordinator``, ``--world_info``)
is the JAX launcher's; ``--node_rank -1`` takes the rank from the
scheduler's environment or the host's place in ``world_info``.

A node of one worker runs it in this process, as the JAX launcher runs
its one process a host: signals and the exit code are the script's own.
A node of several forks them; SIGTERM is forwarded to every worker (their
preemption handlers save and exit 114), and a worker dies with this
process.

The rc contract of the JAX launcher holds: a worker whose script raises an
exception carrying an int ``exit_code`` exits with that code (an
integrity abort's 118, a stall's 117); the launcher's rc is the first
non-zero worker rc (a worker killed by signal N counts as 128 + N), and
once a worker fails the others are stopped, since they would wait in
their next collective for ever.

The heartbeat channel (``--heartbeat_dir`` or ``DSTPU_HEARTBEAT_DIR``):
each worker's record starts attesting INIT before the script runs (and
before the rendezvous its ``initialize()`` makes), names the host in the
runner's hostfile vocabulary, and is handed to the engine, which adopts
it. A clean end stamps EXIT; an integrity abort also stamps the
``INTEGRITY`` flag. ``--init_timeout`` (``DSTPU_INIT_TIMEOUT``) bounds
the rendezvous with the init watchdog (``runtime/watchdog.py``
``init_deadline``, applied in ``comm.init_distributed``): past it the
worker dumps its stacks and exits 117.
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


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="deepspeed_tpu_torch.launcher.launch")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="workers on this node, one per GPU (default: this "
                        "host's slots in --world_info, else 1)")
    p.add_argument("--node_rank", type=int, default=0,
                   help="-1 = autodetect from the scheduler env "
                        "(OMPI/SLURM/PMI rank) or hostname-in-world_info")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--master_addr", default="127.0.0.1")
    p.add_argument("--master_port", type=int, default=0,
                   help="0: a free local port (one node only)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (the runner's form of "
                        "--master_addr / --master_port)")
    p.add_argument("--world_info", default="",
                   help="base64 host->slots map (ranks, worker counts and "
                        "the host's name in the heartbeat records)")
    p.add_argument("--init_method", default=None,
                   help="rendezvous URL for every worker (tcp://host:port "
                        "or file://path), in place of MASTER_ADDR / "
                        "MASTER_PORT")
    p.add_argument("--init_timeout", type=float,
                   default=float(os.environ.get("DSTPU_INIT_TIMEOUT", "0")
                                 or 0),
                   help="bound on each worker's rendezvous, seconds "
                        "(0 = wait for ever); past it the worker dumps "
                        "its stacks and exits the stall rc")
    p.add_argument("--heartbeat_dir", default=None,
                   help="shared directory of per-rank liveness records "
                        "(exported to the workers as DSTPU_HEARTBEAT_DIR)")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("user_script")
    p.add_argument("user_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def resolve_node_rank(args) -> int:
    """-1 -> the scheduler's rank variable (mpirun / srun set one a
    process) or the host's position in world_info (the pdsh path, where
    every node gets the same command)."""
    if args.node_rank >= 0:
        return args.node_rank
    for var in ("OMPI_COMM_WORLD_RANK", "SLURM_PROCID", "PMI_RANK",
                "PMIX_RANK", "MV2_COMM_WORLD_RANK", "MPIRUN_RANK"):
        if var in os.environ:
            return int(os.environ[var])
    if args.world_info:
        from .runner import decode_world_info
        hosts = list(decode_world_info(args.world_info))
        name = socket.gethostname()
        short = name.split(".")[0]
        for i, h in enumerate(hosts):
            # exact or FQDN-vs-shortname match only: a prefix match would
            # give worker-1 and worker-10 the same rank
            if h == name or h == short or h.split(".")[0] == name:
                return i
    raise RuntimeError(
        "cannot autodetect node_rank: no scheduler rank env var and the "
        "hostname is not in world_info")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_worker(script: str, script_args) -> None:
    """Run the user script as ``__main__`` in this process with the rank's
    heartbeat record around it, keeping the rc contract: an exception with
    an int ``exit_code`` exits with it."""
    from ..runtime import heartbeat as hb
    rank = int(os.environ.get("RANK", "0") or 0)
    writer = hb.HeartbeatWriter.from_env(rank=rank)
    if writer is not None:
        # attesting INIT before the script's rendezvous; the engine's
        # from_env adopts this writer (one refresher per rank file)
        writer.write(hb.PHASE_INIT, 0, force=True)
        hb.set_process_writer(writer)
    sys.argv = [script] + list(script_args)
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        if writer is not None and e.code in (0, None):
            writer.stamp_terminal(hb.PHASE_EXIT, lock_timeout=5.0)
        raise
    except Exception as e:
        code = getattr(e, "exit_code", None)
        if isinstance(code, int) and 0 < code < 256:
            import traceback
            traceback.print_exc()
            if writer is not None:
                from ..runtime.sentinel import INTEGRITY_EXIT_CODE
                if code == INTEGRITY_EXIT_CODE:
                    # keeps an rc-118 abort visible in `health` (a bare
                    # EXIT reads as a clean run) without naming a host
                    writer.add_flag("INTEGRITY", lock_timeout=5.0)
                # a no-op when a terminal verdict (STALLED) already stands
                writer.stamp_terminal(hb.PHASE_EXIT, lock_timeout=5.0)
            sys.exit(code)
        raise
    if writer is not None:
        # a clean end without engine.close(): conclude the record so a
        # frozen non-terminal phase cannot read as silence
        writer.stamp_terminal(hb.PHASE_EXIT, lock_timeout=5.0)


def _rc(returncode: int) -> int:
    return 128 - returncode if returncode < 0 else returncode


def _die_with_parent() -> None:
    """In a forked worker: SIGKILL when the launcher dies (a supervisor's
    SIGKILL of the launcher must not orphan its workers)."""
    try:
        import ctypes
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _layout(args, node_rank: int):
    """(workers on this node, world size, first rank, host name or None)."""
    if args.world_info:
        from .runner import decode_world_info
        info = decode_world_info(args.world_info)
        hosts = list(info)
        if not 0 <= node_rank < len(hosts):
            raise ValueError(f"node_rank {node_rank} outside world_info's "
                             f"{len(hosts)} hosts")
        counts = [len(info[h]) for h in hosts]
        nproc = args.nproc_per_node or counts[node_rank]
        if args.nproc_per_node:
            counts = [nproc] * len(hosts)
        return nproc, sum(counts), sum(counts[:node_rank]), hosts[node_rank]
    nproc = args.nproc_per_node or 1
    return nproc, args.nnodes * nproc, node_rank * nproc, None


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.heartbeat_dir:
        os.environ["DSTPU_HEARTBEAT_DIR"] = os.path.abspath(
            args.heartbeat_dir)
        os.makedirs(os.environ["DSTPU_HEARTBEAT_DIR"], exist_ok=True)
    if args.worker:
        run_worker(args.user_script, args.user_args)
        return 0
    node_rank = resolve_node_rank(args) if args.nnodes > 1 else \
        max(args.node_rank, 0)
    nproc, world, base, host = _layout(args, node_rank)
    if nproc < 1 or args.nnodes < 1 or not 0 <= node_rank < args.nnodes:
        raise ValueError(f"bad world: nnodes={args.nnodes} node_rank="
                         f"{node_rank} nproc_per_node={nproc}")
    addr, port = args.master_addr, args.master_port
    if args.coordinator:
        addr, _, p = args.coordinator.rpartition(":")
        port = int(p)
    if not port and args.init_method is None:
        if args.nnodes > 1:
            raise ValueError("--master_port (or --init_method) is required "
                             "with more than one node")
        port = _free_port()
    common = dict(WORLD_SIZE=str(world), MASTER_ADDR=addr,
                  MASTER_PORT=str(port))
    if host is not None:
        # records name hosts in the hostfile's vocabulary (blacklists and
        # attribution compare against it), not gethostname()'s
        from ..runtime.heartbeat import HEARTBEAT_HOST_ENV
        common[HEARTBEAT_HOST_ENV] = host
    if args.init_method:
        common["DSTPU_COORDINATOR_ADDRESS"] = args.init_method
    if args.init_timeout > 0:
        common["DSTPU_INIT_TIMEOUT"] = str(args.init_timeout)
    if nproc == 1:
        os.environ.update(common, RANK=str(base), LOCAL_RANK="0")
        run_worker(args.user_script, args.user_args)
        return 0
    procs = []
    for local in range(nproc):
        env = dict(os.environ, **common, RANK=str(base + local),
                   LOCAL_RANK=str(local))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
             "--worker", args.user_script] + list(args.user_args), env=env,
            preexec_fn=_die_with_parent))

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)
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
