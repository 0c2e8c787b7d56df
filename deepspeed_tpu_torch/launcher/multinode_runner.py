"""Multinode runners — pluggable remote-dispatch backends for the runner
(counterpart of ``deepspeed_tpu/launcher/multinode_runner.py``; command
building only: nothing here dials a host beyond the local one).

Capability parity with the reference's ``launcher/multinode_runner.py``
(MultiNodeRunner ABC + PDSH/OpenMPI/Slurm/MVAPICH runners building the
per-backend launch command). Each runner turns (environment exports, active
resource pool, user command) into ONE argv the scheduler executes: one
``launcher/launch.py`` bootstrap per host, which starts that host's
workers, one per GPU slot of its ``world_info`` entry.

Round-6 supervision contract: besides ``get_cmd`` each runner now
describes its OWN teardown and observability surfaces so
``launcher.supervisor.BackendSupervisor`` can treat the scheduler like a
supervised world instead of an opaque Popen:

- ``get_kill_cmd``: the backend-native way to reach the REMOTE ranks
  (``scancel`` the allocation, ``pdsh -w ... pkill`` the bootstraps) —
  signaling the local scheduler process alone may orphan them;
- ``route_line``: demultiplex the scheduler's merged output stream into
  per-rank/host keys (``pdsh`` prefixes ``host:``, ``srun --label``
  prefixes ``taskid:``) for ``--log-dir`` persistence.
"""

from __future__ import annotations

import os
import re
import shlex
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple


class MultiNodeRunner(ABC):
    name = "base"

    def __init__(self, args, world_info_base64: str = ""):
        self.args = args
        self.world_info_base64 = world_info_base64
        self.user_arguments = list(getattr(args, "user_args", []))
        self.user_script = getattr(args, "user_script", "")
        self.exports: Dict[str, str] = {}

    def add_export(self, key: str, var: str) -> None:
        self.exports[key.strip()] = str(var).strip()

    @abstractmethod
    def get_cmd(self, environment: Dict[str, str],
                active_resources: Dict[str, int]) -> List[str]:
        ...

    def backend_exists(self) -> bool:
        return True

    def get_kill_cmd(self, environment: Dict[str, str],
                     active_resources: Dict[str, int]
                     ) -> Optional[List[str]]:
        """Backend-native teardown argv reaching the REMOTE ranks, or
        None when signaling the scheduler process is already sufficient
        (mpirun propagates SIGTERM to its children)."""
        return None

    def route_line(self, line: str) -> Optional[Tuple[str, str]]:
        """(log key, payload) for one merged-output line, or None when
        this backend's stream carries no per-rank attribution."""
        return None

    def _user_cmd(self, environment: Dict[str, str],
                  active_resources: Dict[str, int]) -> List[str]:
        """Per-node bootstrap through launch.py (torch.distributed rendezvous;
        rank autodetected from the scheduler env or world_info hostname) —
        running the raw script would leave nnodes disconnected trainings."""
        import sys
        coordinator = environment.get("DSTPU_COORDINATOR", "localhost")
        port = environment.get("DSTPU_MASTER_PORT", "29500")
        return ([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
                 "--node_rank=-1",
                 f"--nnodes={len(active_resources)}",
                 f"--coordinator={coordinator}:{port}",
                 f"--world_info={self.world_info_base64}",
                 self.user_script] + self.user_arguments)


#: the per-host bootstrap every backend dispatches — the pattern the
#: pdsh kill path pkills (killing the bootstrap tears down the user
#: script it exec'd into; matching the module name avoids collateral)
_BOOTSTRAP_PATTERN = "deepspeed_tpu_torch.launcher.launch"


class PDSHRunner(MultiNodeRunner):
    """reference: multinode_runner.py:45 — pdsh fanout over the host list."""

    name = "pdsh"

    def backend_exists(self) -> bool:
        import shutil
        return shutil.which("pdsh") is not None

    def get_cmd(self, environment, active_resources):
        env_exports = "".join(
            f"export {k}={shlex.quote(v)}; "
            for k, v in {**environment, **self.exports}.items())
        hosts = ",".join(active_resources)
        return (["pdsh", "-S", "-f", "1024", "-w", hosts,
                 env_exports + "cd " + shlex.quote(os.getcwd()) + "; "]
                + self._user_cmd(environment, active_resources))

    def get_kill_cmd(self, environment, active_resources):
        hosts = ",".join(active_resources)
        return ["pdsh", "-S", "-w", hosts,
                f"pkill -TERM -f {_BOOTSTRAP_PATTERN}"]

    #: pdsh prefixes every forwarded line with "host: "
    _PREFIX = re.compile(r"^(\S+?): (.*\n?)$")

    def route_line(self, line):
        m = self._PREFIX.match(line)
        return (m.group(1), m.group(2)) if m else None


class OpenMPIRunner(MultiNodeRunner):
    """reference: multinode_runner.py:116 — mpirun with one proc per host.
    No kill_cmd: mpirun forwards SIGTERM to every remote rank itself."""

    name = "openmpi"

    def backend_exists(self) -> bool:
        import shutil
        return shutil.which("mpirun") is not None

    def get_cmd(self, environment, active_resources):
        total = len(active_resources)
        cmd = ["mpirun", "-n", str(total), "--hostfile",
               getattr(self.args, "hostfile", "/job/hostfile"),
               "--map-by", "ppr:1:node",   # ONE bootstrap per host
               "--mca", "btl", "^openib",
               "--mca", "btl_tcp_if_include", "eth0"]
        for k, v in {**environment, **self.exports}.items():
            cmd += ["-x", f"{k}={v}"]
        return cmd + self._user_cmd(environment, active_resources)


class SlurmRunner(MultiNodeRunner):
    """reference: multinode_runner.py:171 — srun over the allocation."""

    name = "slurm"

    def backend_exists(self) -> bool:
        import shutil
        return shutil.which("srun") is not None

    def get_cmd(self, environment, active_resources):
        total = len(active_resources)
        cmd = ["srun", "-n", str(total), "--ntasks-per-node=1",
               # per-rank attribution in the merged stream ("taskid: ")
               # — what route_line demultiplexes for --log-dir
               "--label",
               # the filtered pool IS the node list (the include syntax's
               # ':slot' parts are not valid slurm node names)
               "--nodelist", ",".join(active_resources)]
        exports = ",".join(f"{k}={v}" for k, v in
                           {**environment, **self.exports}.items())
        if exports:
            cmd += [f"--export=ALL,{exports}"]
        return cmd + self._user_cmd(environment, active_resources)

    def get_kill_cmd(self, environment, active_resources):
        # inside an allocation (sbatch/salloc) SLURM_JOB_ID names the job
        # scancel can reach every node of; outside one there is nothing
        # to cancel beyond the srun process itself
        job_id = environment.get("SLURM_JOB_ID",
                                 os.environ.get("SLURM_JOB_ID", ""))
        if not job_id:
            return None
        return ["scancel", "--signal=TERM", job_id]

    #: srun --label prefixes every line with "taskid: "
    _PREFIX = re.compile(r"^(\d+): (.*\n?)$")

    def route_line(self, line):
        m = self._PREFIX.match(line)
        return (f"rank{m.group(1)}", m.group(2)) if m else None


class MVAPICHRunner(OpenMPIRunner):
    """reference: multinode_runner.py:218 — mpirun_rsh with MV2 env; the
    relevant delta from OpenMPI is the launcher binary + the MV2_*
    environment the reference validates/injects (force TCP-friendly
    defaults; debug backtraces on)."""

    name = "mvapich"

    #: env the reference's runner injects when absent (mvapich needs the
    #: MV2_* family set explicitly; unlike OpenMPI there is no -x flag —
    #: mpirun_rsh takes bare K=V argv pairs)
    MV2_DEFAULTS = {"MV2_SMP_USE_CMA": "0",
                    "MV2_DEBUG_SHOW_BACKTRACE": "1"}

    def backend_exists(self) -> bool:
        import shutil
        return shutil.which("mpirun_rsh") is not None

    def get_cmd(self, environment, active_resources):
        total = len(active_resources)
        cmd = ["mpirun_rsh", "-np", str(total), "-hostfile",
               getattr(self.args, "hostfile", "/job/hostfile")]
        env = {**self.MV2_DEFAULTS, **environment, **self.exports}
        for k, v in env.items():
            cmd.append(f"{k}={v}")
        return cmd + self._user_cmd(environment, active_resources)


RUNNERS = {"pdsh": PDSHRunner, "openmpi": OpenMPIRunner, "slurm": SlurmRunner,
           "mvapich": MVAPICHRunner}


def build_runner(launcher: str, args, world_info_base64: str = ""
                 ) -> MultiNodeRunner:
    if launcher not in RUNNERS:
        raise ValueError(f"unknown launcher '{launcher}' "
                         f"(have {sorted(RUNNERS)} + ssh/local built-ins)")
    return RUNNERS[launcher](args, world_info_base64)
