"""Multi-node launcher CLI — ``python -m
deepspeed_tpu_torch.launcher.runner`` (counterpart of ``deepspeed_tpu/launcher/runner.py``, the JAX package's
``dstpu``; the reference's ``deepspeed``/``ds`` CLI).

Capability parity with ``deepspeed/launcher/runner.py`` (hostfile parsing,
--include/--exclude filters, single-node exec, multi-node per-host dispatch):
each host runs one ``launcher/launch.py`` bootstrap, which forks one worker
per GPU slot with RANK/LOCAL_RANK/WORLD_SIZE and the coordinator as
MASTER_ADDR/MASTER_PORT; the script's ``initialize()`` starts the process
group from them. Remote dispatch uses ssh (the reference's PDSH runner,
multinode_runner.py:45) built as an argv list. The supervisors, the
elastic agent and ``health`` are the JAX package's, on the port's
heartbeat channel.

Hostfile syntax is the reference's:
    worker-1 slots=4
    worker-2 slots=4
and --include/--exclude use `host:slot1,slot2@host2:...` filters
(runner.py:386-418).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import shlex
import sys
from collections import OrderedDict
from typing import Dict, List, Optional

DSTPU_ENV_FILE = ".deepspeed_env"


def parse_hostfile(lines) -> "OrderedDict[str, int]":
    """'host slots=N' per line -> {host: N}; '#' comments allowed."""
    resource_pool: "OrderedDict[str, int]" = OrderedDict()
    for raw in lines:
        line = raw.split("#")[0].strip()
        if not line:
            continue
        try:
            host, slots_str = line.split()
            key, val = slots_str.split("=")
            if key != "slots":
                raise ValueError
            slots = int(val)
        except ValueError:
            raise ValueError(f"invalid hostfile line: {raw!r} "
                             "(expected 'hostname slots=N')")
        if host in resource_pool:
            raise ValueError(f"duplicate host {host} in hostfile")
        resource_pool[host] = slots
    return resource_pool


def fetch_hostfile(path: Optional[str]) -> "OrderedDict[str, int]":
    if not path or not os.path.isfile(path):
        return OrderedDict()
    with open(path) as f:
        return parse_hostfile(f)


def _parse_filter(s: str) -> Dict[str, Optional[List[int]]]:
    """'host1:0,2@host2' -> {host1: [0,2], host2: None (all slots)}."""
    out: Dict[str, Optional[List[int]]] = {}
    for part in s.split("@"):
        if not part:
            continue
        if ":" in part:
            host, slots = part.split(":")
            out[host] = [int(x) for x in slots.split(",") if x != ""]
        else:
            out[part] = None
    return out


def parse_inclusion_exclusion(resource_pool: Dict[str, int],
                              include_str: str = "",
                              exclude_str: str = "") -> "OrderedDict[str, List[int]]":
    """Apply --include/--exclude filters (reference: parse_resource_filter)."""
    active: "OrderedDict[str, List[int]]" = OrderedDict(
        (h, list(range(n))) for h, n in resource_pool.items())
    if include_str and exclude_str:
        raise ValueError("--include and --exclude are mutually exclusive")
    if include_str:
        wanted = _parse_filter(include_str)
        for h in wanted:
            if h not in active:
                raise ValueError(f"included host {h} not in hostfile")
        active = OrderedDict(
            (h, wanted[h] if wanted[h] is not None else list(range(resource_pool[h])))
            for h in wanted)
        for h, slots in active.items():
            bad = [s for s in slots if s >= resource_pool[h]]
            if bad:
                raise ValueError(f"host {h} has no slots {bad}")
    elif exclude_str:
        banned = _parse_filter(exclude_str)
        for h, slots in banned.items():
            if h not in active:
                raise ValueError(f"excluded host {h} not in hostfile")
            if slots is None:
                del active[h]
            else:
                active[h] = [s for s in active[h] if s not in slots]
                if not active[h]:
                    del active[h]
    return active


def encode_world_info(active: Dict[str, List[int]]) -> str:
    return base64.urlsafe_b64encode(
        json.dumps(active).encode()).decode()


def decode_world_info(blob: str) -> Dict[str, List[int]]:
    return json.loads(base64.urlsafe_b64decode(blob.encode()).decode())


def build_launch_cmd(host_idx: int, num_hosts: int, coordinator: str,
                     port: int, world_info: str, user_script: str,
                     user_args: List[str]) -> List[str]:
    """Per-host command: one launch.py bootstrap per host, which starts
    the host's workers (one per GPU slot of ``world_info``)."""
    return [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
            f"--node_rank={host_idx}",
            f"--nnodes={num_hosts}",
            f"--coordinator={coordinator}:{port}",
            f"--world_info={world_info}",
            user_script] + list(user_args)


def build_ssh_cmd(host: str, remote_cmd: List[str],
                  env_exports: Dict[str, str],
                  connect_timeout: int = 15) -> List[str]:
    """ssh argv for one rank. ``-o ConnectTimeout`` bounds the connect
    phase (a dead host fails fast instead of hanging the dispatch), and
    the remote shell prints the supervisor's started sentinel BEFORE
    exec'ing the bootstrap — the line that marks this rank non-retryable
    (see supervisor.STARTED_SENTINEL)."""
    from .supervisor import STARTED_SENTINEL
    exports = " ".join(f"export {k}={shlex.quote(v)};"
                       for k, v in env_exports.items())
    return ["ssh", "-o", "StrictHostKeyChecking=no",
            "-o", f"ConnectTimeout={int(connect_timeout)}", host,
            f"cd {shlex.quote(os.getcwd())}; {exports} "
            f"echo {STARTED_SENTINEL}; exec " +
            " ".join(shlex.quote(c) for c in remote_cmd)]


def collect_env_exports() -> Dict[str, str]:
    """Env vars forwarded to workers (reference: runner.py:508-563 exports
    NCCL_*/PYTHON* + .deepspeed_env file). The DSTPU_ prefix carries the
    launcher's own contract — coordinator overrides, DSTPU_CHAOS fault
    specs, DSTPU_INIT_TIMEOUT — which previously never reached remote
    hosts."""
    exports = {}
    for key, val in os.environ.items():
        if key.startswith(("NCCL_", "CUDA_", "TORCH_", "DSTPU_",
                           "PYTHONPATH")):
            exports[key] = val
    if os.path.isfile(DSTPU_ENV_FILE):
        with open(DSTPU_ENV_FILE) as f:
            for line in f:
                line = line.strip()
                if line and "=" in line and not line.startswith("#"):
                    k, v = line.split("=", 1)
                    exports[k] = v
    return exports


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch.launcher.runner",
        description="deepspeed_tpu_torch multi-host launcher")
    p.add_argument("-H", "--hostfile", default="/job/hostfile")
    p.add_argument("-i", "--include", default="")
    p.add_argument("-e", "--exclude", default="")
    p.add_argument("--num_nodes", type=int, default=-1)
    p.add_argument("--master_port", type=int, default=29500)
    p.add_argument("--master_addr", default="")
    p.add_argument("--launcher", default="ssh",
                   choices=["ssh", "local", "pdsh", "openmpi", "slurm",
                            "mvapich"])
    p.add_argument("--autotuning", default="", choices=["", "run", "tune"],
                   help="search ds_configs instead of launching directly "
                        "(reference: deepspeed --autotuning)")
    p.add_argument("--deepspeed_config", default="",
                   help="base ds_config for --autotuning mode")
    # -- run supervision (round-4; docs/RESILIENCE.md) -----------------------
    p.add_argument("--elastic", action="store_true",
                   help="supervise the run under DSElasticAgent: relaunch "
                        "on membership change, resume (uncounted) on "
                        "preemption rc 114, restart crashed/stalled runs "
                        "up to --max-restarts")
    p.add_argument("--max-restarts", "--max_restarts", type=int, default=100,
                   dest="max_restarts",
                   help="elastic: crash/stall restart budget (preemptions "
                        "are not counted)")
    p.add_argument("--min-nodes", "--min_nodes", type=int, default=1,
                   dest="min_nodes",
                   help="elastic: wait until the hostfile lists at least "
                        "this many nodes before (re)launching")
    p.add_argument("--check-interval", "--check_interval", type=float,
                   default=1.0, dest="check_interval",
                   help="elastic: hostfile/worker poll interval, seconds")
    p.add_argument("--grace-secs", "--grace_secs", type=float, default=30.0,
                   dest="grace_secs",
                   help="teardown grace: SIGTERM -> this many seconds (the "
                        "preemption handlers' checkpoint window) -> SIGKILL")
    p.add_argument("--connect-retries", "--connect_retries", type=int,
                   default=3, dest="connect_retries",
                   help="retries for ssh CONNECT-phase failures (a rank "
                        "that started user code is never retried)")
    p.add_argument("--connect-timeout", "--connect_timeout", type=int,
                   default=15, dest="connect_timeout",
                   help="ssh -o ConnectTimeout per dispatch attempt")
    p.add_argument("--log-dir", "--log_dir", default="", dest="log_dir",
                   help="persist each rank's prefixed stdout/stderr to "
                        "<log_dir>/<host>.rank<k>.log alongside the live "
                        "prefixed stream (local ranks switch to captured "
                        "pipes); truncated per run, appended across "
                        "connect retries. Scheduler backends "
                        "(pdsh/slurm) demultiplex their merged stream by "
                        "the per-rank prefix into <log_dir>/<key>.log")
    # -- heartbeat channel (round-6; docs/RESILIENCE.md) ---------------------
    p.add_argument("--heartbeat-dir", "--heartbeat_dir", default="",
                   dest="heartbeat_dir",
                   help="shared directory for per-rank liveness records "
                        "(exported to workers as DSTPU_HEARTBEAT_DIR); "
                        "enables launcher-side per-rank liveness on EVERY "
                        "backend incl. pdsh/slurm/openmpi, blacklist-"
                        "driven degraded resume under --elastic, and "
                        "`dstpu health <dir>`")
    p.add_argument("--heartbeat-timeout", "--heartbeat_timeout", type=float,
                   default=0.0, dest="heartbeat_timeout",
                   help="seconds of heartbeat silence (a rank that stops "
                        "attesting liveness) before the supervisor tears "
                        "the launch down as a stall (rc 117); 0 disables "
                        "silence detection (records still written)")
    p.add_argument("user_script")
    p.add_argument("user_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def health_main(argv) -> int:
    """``dstpu health <heartbeat-dir>`` — the operator's one-glance pod
    view: per-rank phase, step, RATE (the rolling step_ms wall-time
    gauge, round 15 — '-' for records predating it), record age, host,
    pid, pipeline STAGE (MPMD stage workers stamp it, round 13), phase
    GAUGES (SERVE stamps queue-depth / active-lane load) and
    integrity/straggler FLAGS from the
    heartbeat channel. Works on a serving fleet's per-replica channel
    (serving/fleet.py) and an MPMD pipeline's per-stage channel
    (runtime/pipe/mpmd) exactly as on a training world's per-rank one. Exit 0 when every rank is live or
    concluded cleanly, 1 when any rank's last word is STALLED, any rank
    carries an integrity flag (e.g. ``SDC`` — its host's numbers cannot
    be trusted), or the channel is empty (nothing attesting = nothing
    provably alive)."""
    import time as _time
    from ..runtime import heartbeat as hb
    from ..runtime.straggler import STRAGGLER_FLAG
    p = argparse.ArgumentParser(prog="dstpu health")
    p.add_argument("heartbeat_dir")
    p.add_argument("--stale-after", type=float, default=60.0,
                   help="flag records older than this many seconds")
    a = p.parse_args(argv)
    records = hb.read_heartbeats(a.heartbeat_dir)
    if not records:
        print(f"no heartbeat records under {a.heartbeat_dir}")
        return 1
    now = _time.time()
    rows = [("RANK", "STAGE", "HOST", "PHASE", "STEP", "RATE", "AGE", "PID",
             "GAUGES", "FLAGS", "")]
    bad = False
    for rank in sorted(records):
        rec = records[rank]
        age = hb.record_age(rec, now)
        phase = str(rec.get("phase"))
        # phase-specific load gauges (SERVE: queue depth / active lanes)
        # so a serving rank's health line answers "how loaded", not just
        # "alive" — a fleet replica pinned at queue>0 active=0 is wedged
        # admission, visible here before any timeout fires
        gauges = rec.get("gauges") or {}
        # pipeline STAGE (MPMD stage workers stamp it, round 13 —
        # mirrors the round-12 role=PREFILL/DECODE gauge): its own
        # column, because "which stage died" is the first question a
        # pipeline operator asks
        stage = gauges.get("stage")
        stage_txt = str(stage) if stage is not None else "-"
        # RATE: the rolling per-step wall-time gauge (round 15,
        # runtime/straggler.py) — the one-glance answer to "is this rank
        # DRAGGING the synchronous world" that liveness alone can never
        # give. '-' for records predating the gauge; rc semantics
        # unchanged (a slow rank is the straggler detector's verdict to
        # make, not this view's)
        step_ms = gauges.get("step_ms")
        rate_txt = f"{float(step_ms):.0f}ms" if step_ms is not None else "-"
        gtxt = ",".join(f"{k}={gauges[k]}" for k in sorted(gauges)
                        if k not in ("stage", "step_ms")) or "-"
        flags = ",".join(rec.get("flags") or ()) or "-"
        note = ""
        if phase == hb.PHASE_STALLED:
            note, bad = "wedged (rc 117)", True
        elif phase == hb.PHASE_PREEMPTED:
            note = "preempted (rc 114)"
        elif phase == hb.PHASE_EXIT:
            # a flagged EXIT is a concluded integrity ABORT, not a clean run
            note = "" if rec.get("flags") else "clean exit"
        elif age > a.stale_after:
            note, bad = f"SILENT > {a.stale_after:.0f}s", True
        rec_flags = rec.get("flags") or []
        if STRAGGLER_FLAG in rec_flags:
            # a slow host is operator news even while alive and stepping
            note = (note + "; " if note else "") + "straggler (slow host)"
            bad = True
        if any(f != STRAGGLER_FLAG for f in rec_flags):
            note = (note + "; " if note else "") + "integrity flags (rc 118)"
            bad = True
        rows.append((str(rank), stage_txt, str(rec.get("host")), phase,
                     str(rec.get("step")), rate_txt, f"{age:.1f}s",
                     str(rec.get("pid")), gtxt, flags, note))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return 1 if bad else 0


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "health":
        sys.exit(health_main(argv[1:]))
    if argv and argv[0] == "comm-plan":
        # record (item 5.3) / inspect a collective plan (docs/COMM.md; the
        # comm_plan config section reads it)
        from ..comm_plan.cli import main as comm_plan_main
        sys.exit(comm_plan_main(argv[1:]))
    args = parse_args(argv)
    if args.autotuning:
        raise NotImplementedError(
            "--autotuning: autotuning/ is not ported to deepspeed_tpu_torch "
            "yet (see ROADMAP.md item 5)")
    if args.elastic:
        sys.exit(run_elastic(args))
    pool = fetch_hostfile(args.hostfile)
    if not pool:
        # single node, all local chips
        cmd = [sys.executable, args.user_script] + args.user_args
        os.execvpe(cmd[0], cmd, os.environ.copy())
        return
    active = parse_inclusion_exclusion(pool, args.include, args.exclude)
    if args.num_nodes > 0:
        active = OrderedDict(list(active.items())[:args.num_nodes])
    exports = collect_env_exports()
    _apply_heartbeat_exports(args, exports)
    if args.launcher in ("pdsh", "openmpi", "slurm", "mvapich"):
        # scheduler backends run as ONE process, but no longer as an
        # UNSUPERVISED one: BackendSupervisor adds heartbeat-driven
        # per-rank liveness, the backend's own kill path on first
        # confirmed failure, and rc 114/117 reconstruction (round 6)
        sys.exit(build_backend_supervisor(active, args, exports).run())
    # ssh/local: concurrent per-rank supervision — first failure tears the
    # world down, connect failures retry, rc 114 survives aggregation
    # (reference: launch.py terminate_process_tree, rebuilt fail-fast)
    sys.exit(build_world_supervisor(active, args, exports).run())


def _apply_heartbeat_exports(args, exports: Dict[str, str]) -> None:
    """--heartbeat-dir reaches every worker as DSTPU_HEARTBEAT_DIR (the
    DSTPU_ prefix already rides collect_env_exports to remote hosts) and
    the launcher's own environment (loopback ranks + backend schedulers
    inherit it)."""
    hb_dir = getattr(args, "heartbeat_dir", "") or ""
    if not hb_dir:
        return
    hb_dir = os.path.abspath(hb_dir)
    os.makedirs(hb_dir, exist_ok=True)
    exports["DSTPU_HEARTBEAT_DIR"] = hb_dir
    os.environ["DSTPU_HEARTBEAT_DIR"] = hb_dir


def _backend_runner_env(args, active, exports):
    """(runner, env) for a scheduler backend launch."""
    from .multinode_runner import build_runner
    hosts = list(active)
    coordinator = args.master_addr or hosts[0]
    world_info = encode_world_info(active)
    runner = build_runner(args.launcher, args, world_info)
    if not runner.backend_exists():
        sys.exit(f"launcher backend '{args.launcher}' not found in PATH")
    env = {"DSTPU_WORLD_INFO": world_info,
           "DSTPU_COORDINATOR": coordinator,
           "DSTPU_MASTER_PORT": str(args.master_port), **exports}
    return runner, env


def _backend_cmd(args, active, exports) -> List[str]:
    """ONE scheduler command — the backend fans out itself (reference:
    multinode_runner.py get_cmd per backend)."""
    runner, env = _backend_runner_env(args, active, exports)
    return runner.get_cmd(env, active)


def build_backend_supervisor(active: "OrderedDict[str, List[int]]", args,
                             exports: Dict[str, str]):
    """A not-yet-started BackendSupervisor over one scheduler command,
    wired with the backend's own kill path and output routing."""
    from .supervisor import BackendSupervisor
    runner, env = _backend_runner_env(args, active, exports)
    hosts = {h: active[h] for h in active}
    return BackendSupervisor(
        runner.get_cmd(env, hosts),
        kill_cmd=runner.get_kill_cmd(env, hosts),
        heartbeat_dir=getattr(args, "heartbeat_dir", "") or None,
        heartbeat_timeout=getattr(args, "heartbeat_timeout", 0.0),
        grace_secs=getattr(args, "grace_secs", 30.0),
        log_dir=getattr(args, "log_dir", "") or None,
        route_line=runner.route_line,
        backend=runner.name,
        rank_hosts=list(hosts))


_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


def build_world_supervisor(active: "OrderedDict[str, List[int]]", args,
                           exports: Dict[str, str]):
    """A started-but-not-yet-running RunSupervisor over the active world:
    one RankSpec per host (ssh dispatch unless --launcher local or the
    host is loopback)."""
    from .supervisor import RankSpec, RunSupervisor
    hosts = list(active)
    coordinator = args.master_addr or hosts[0]
    world_info = encode_world_info(active)
    specs = []
    for idx, host in enumerate(hosts):
        remote_cmd = build_launch_cmd(idx, len(hosts), coordinator,
                                      args.master_port, world_info,
                                      args.user_script, args.user_args)
        if args.launcher == "local" or host in _LOCAL_HOSTS:
            # exports (incl. .deepspeed_env entries that may not be in the
            # launcher's own environ) still reach loopback ranks, which
            # have no ssh command line to carry them
            specs.append(RankSpec(host, remote_cmd, remote=False,
                                  env=exports))
        else:
            specs.append(RankSpec(
                host,
                build_ssh_cmd(host, remote_cmd, exports,
                              connect_timeout=args.connect_timeout),
                remote=True))
    return RunSupervisor(specs,
                         grace_secs=args.grace_secs,
                         connect_retries=args.connect_retries,
                         log_dir=getattr(args, "log_dir", "") or None,
                         heartbeat_dir=getattr(args, "heartbeat_dir", "")
                         or None,
                         heartbeat_timeout=getattr(args, "heartbeat_timeout",
                                                   0.0))


def elastic_active_world(args, members: List[str]
                         ) -> "OrderedDict[str, List[int]]":
    """The world one elastic (re)launch covers: the agent's confirmed
    membership, narrowed by the same --include/--exclude/--num_nodes
    filters the non-elastic path applies (an operator excluding a flaky
    host must stay excluded across every relaunch)."""
    pool = fetch_hostfile(args.hostfile)
    if pool:
        filtered = parse_inclusion_exclusion(pool, args.include,
                                             args.exclude)
    else:
        # no/unreadable hostfile: the agent already fell back to localhost
        filtered = OrderedDict((h, [0]) for h in members)
    active = OrderedDict(
        (h, filtered[h]) for h in members if h in filtered)
    if args.num_nodes > 0:
        active = OrderedDict(list(active.items())[:args.num_nodes])
    return active


def run_elastic(args) -> int:
    """dstpu --elastic: DSElasticAgent supervising the RunSupervisor (ssh/
    local) or the BackendSupervisor (scheduler backends — same facade,
    same rc contract since round 6).

    The agent polls the hostfile and relaunches on membership change; the
    rc contract does the rest — 114 (preemption) resumes without touching
    --max-restarts, the stall rc and crashes count against it. With a
    heartbeat channel the agent also quarantines repeatedly-failing hosts
    and re-forms a SMALLER world from the survivors (degraded resume),
    publishing it to <hostfile>.active — which is also the hostfile the
    scheduler backends launch over, so a blacklisted host leaves their
    worlds too."""
    from ..elasticity.elastic_agent import DSElasticAgent

    active_hostfile = (args.hostfile + ".active"
                       if os.path.isfile(args.hostfile) else None)

    def launch(members):
        active = elastic_active_world(args, members)
        if not active:
            sys.exit("dstpu --elastic: every confirmed member is excluded "
                     "by --include/--exclude; nothing to launch")
        exports = collect_env_exports()
        _apply_heartbeat_exports(args, exports)
        if args.launcher in ("pdsh", "openmpi", "slurm", "mvapich"):
            backend_args = args
            if active_hostfile and os.path.isfile(active_hostfile):
                # the scheduler must fan out over the DEGRADED world, not
                # the operator's full hostfile
                backend_args = argparse.Namespace(**vars(args))
                backend_args.hostfile = active_hostfile
            return build_backend_supervisor(active, backend_args,
                                            exports).start()
        return build_world_supervisor(active, args, exports).start()

    agent = DSElasticAgent(launch, args.hostfile,
                           max_restarts=args.max_restarts,
                           min_nodes=args.min_nodes,
                           check_interval=args.check_interval,
                           teardown_grace=args.grace_secs,
                           heartbeat_dir=getattr(args, "heartbeat_dir", "")
                           or None,
                           heartbeat_timeout=getattr(args,
                                                     "heartbeat_timeout",
                                                     0.0),
                           active_hostfile=active_hostfile)
    return agent.run()


if __name__ == "__main__":
    main()
