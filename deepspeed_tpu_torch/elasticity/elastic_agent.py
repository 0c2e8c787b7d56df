"""Elastic agent — restart training on membership change or worker failure
(counterpart of ``deepspeed_tpu/elasticity/elastic_agent.py``).

Capability parity with the reference's ``elasticity/elastic_agent.py:23``
(DSElasticAgent over torch-elastic's LocalElasticAgent: monitor workers,
re-rendezvous and restart on scale-up/down) without the torch rendezvous
store: membership is the hostfile (the thing cluster managers actually
mutate), the agent polls it, and on change — or on worker crash, up to
``max_restarts`` — it terminates the run and relaunches with the new world,
re-deriving the elastic batch config (elasticity.compute_elastic_config's
HCN math) for the new node count. Training resumes from the engine's own
checkpoints (topology-free by construction).

Preemption contract (round-3): a worker that exits with
:data:`PREEMPTION_EXIT_CODE` — what ``engine.install_preemption_handler``
does after its emergency save — is a RESUME, not a crash: the agent
relaunches immediately and does NOT count it against ``max_restarts``
(preemptions at multi-host scale would exhaust any budget).

Stall contract (round-4): a worker the stall watchdog shot
(``runtime.watchdog.STALL_EXIT_CODE``) DOES count against
``max_restarts`` — a wedge is a failure mode, and unbounded relaunching
of a run that wedges deterministically would burn the pod forever. The
agent tracks it separately (``stalls``) so operators can tell "restarted
because wedged" from "restarted because crashed". The run the agent
monitors may be a single worker Popen, a launcher-side ``RunSupervisor``
or a scheduler-side ``BackendSupervisor`` (duck-typed:
poll/wait/terminate/kill), which is how ``dstpu --elastic`` stacks
agent-over-supervisor-over-ranks on every launcher.

Degraded-world contract (round-6): when a COUNTED failure carries host
attribution — the supervisor's ``failed_hosts()`` facade method, plus
heartbeat evidence (``heartbeat_dir``: ranks whose last word is STALLED
or whose record went stale) — the agent strikes those hosts; a host
reaching ``blacklist_after`` strikes is QUARANTINED and the next world
is re-formed from the survivors, so losing a host costs one restart
instead of the run. Quarantine never shrinks the world below
``min_nodes``: when it would, the weakest candidate is paroled instead
(a flaky host beats no pod at all). The surviving world is published to
``active_hostfile`` ("host slots=N" lines, atomic rewrite) for operators
and for scheduler backends that fan out from a hostfile.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Dict, List, Optional

from ..launcher.runner import fetch_hostfile
from ..utils.logging import log_dist, logger

MEMBERSHIP_CHANGED = object()       # monitor sentinel; never equals an rc

#: Exit code meaning "I was preempted but checkpointed; relaunch me and
#: don't count this against max_restarts". Chosen outside the shell's
#: conventional 126-165 signal range and Python's 0-2. Re-exported from
#: the single-source contract module so the literal lives in one place.
from ..exit_codes import PREEMPTION_EXIT_CODE  # noqa: E402


class DSElasticAgent:
    def __init__(self,
                 launch_fn: Callable[[List[str]], subprocess.Popen],
                 hostfile: str,
                 max_restarts: int = 100,
                 check_interval: float = 1.0,
                 min_nodes: int = 1,
                 confirm_polls: int = 2,
                 teardown_grace: float = 30.0,
                 heartbeat_dir: Optional[str] = None,
                 heartbeat_timeout: float = 0.0,
                 blacklist_after: int = 2,
                 active_hostfile: Optional[str] = None):
        """launch_fn(active_hosts) -> Popen for one training run.

        ``confirm_polls``: how many CONSECUTIVE identical polls must agree
        before a hostfile difference counts as a membership change — an
        atomic rewrite of the hostfile mid-poll (truncate+write, or a brief
        unlink during rename) must not look like a rescale.

        ``teardown_grace``: how long a membership-change terminate() may
        take before the agent SIGKILLs — must COVER the run's own
        SIGTERM->grace->SIGKILL window (RunSupervisor's grace_secs, i.e.
        the emergency-checkpoint budget), or the agent's kill races the
        in-flight preemption saves it exists to protect.

        ``heartbeat_dir`` + ``blacklist_after``: degraded-world resume —
        see the module docstring. ``heartbeat_timeout`` (optional) also
        counts ranks whose last record LAGS the channel's freshest record
        by more than that many seconds at failure time as evidence
        against their host (never wall-clock age: by read time the dead
        world has frozen every record)."""
        self.launch_fn = launch_fn
        self.hostfile = hostfile
        self.max_restarts = max_restarts
        self.check_interval = check_interval
        self.min_nodes = min_nodes
        self.confirm_polls = max(1, confirm_polls)
        self.teardown_grace = float(teardown_grace)
        self.heartbeat_dir = heartbeat_dir
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.blacklist_after = max(1, int(blacklist_after))
        self.active_hostfile = active_hostfile
        self.restarts = 0
        self.membership_changes = 0
        self.preemptions = 0
        self.stalls = 0
        self.strikes: Dict[str, int] = {}
        self.blacklisted: set = set()

    def _members(self) -> List[str]:
        pool = self._read_members()
        members = pool if pool else ["localhost"]
        survivors = [h for h in members if h not in self.blacklisted]
        if len(survivors) < self.min_nodes:
            # quarantine must not starve the pod below min_nodes: parole
            # the least-struck hosts back in rather than waiting forever
            parole = sorted((h for h in members if h in self.blacklisted),
                            key=lambda h: self.strikes.get(h, 0))
            while len(survivors) < self.min_nodes and parole:
                host = parole.pop(0)
                self.blacklisted.discard(host)
                self.strikes[host] = 0
                logger.warning(
                    "elastic agent: paroling blacklisted host %s — the "
                    "surviving world would drop below min_nodes=%d",
                    host, self.min_nodes)
                survivors = [h for h in members
                             if h not in self.blacklisted]
        return survivors

    def _read_members(self) -> Optional[List[str]]:
        """Hostfile membership, or None on a transient failure (unreadable
        or empty mid-rewrite) — callers must treat None as 'no evidence',
        never as 'the cluster shrank to nothing'."""
        try:
            pool = fetch_hostfile(self.hostfile)
        except (OSError, ValueError) as e:
            logger.warning("elastic agent: transient hostfile read failure "
                           "(%s); keeping current membership", e)
            return None
        return list(pool) if pool else None

    # ------------------------------------------------------ degraded world

    def _publish_active_world(self, members: List[str]) -> None:
        """Atomically rewrite the active hostfile with the surviving
        world ("host slots=N"; slots looked up from the operator's
        hostfile, defaulting to 1) — the file scheduler backends fan out
        from and operators watch."""
        if not self.active_hostfile:
            return
        try:
            pool = fetch_hostfile(self.hostfile)
        except (OSError, ValueError):
            pool = {}
        lines = "".join(f"{h} slots={pool.get(h, 1)}\n" for h in members)
        try:
            tmp = self.active_hostfile + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(lines)
            os.replace(tmp, self.active_hostfile)
        except OSError as e:
            logger.warning("elastic agent: cannot publish active hostfile "
                           "%s: %s", self.active_hostfile, e)

    def _failure_evidence(self, proc, members: List[str]) -> List[str]:
        """Hosts implicated in a counted failure: the supervisor's own
        attribution first, then the heartbeat channel (ranks whose last
        word is STALLED, or whose record went stale)."""
        from ..runtime import heartbeat as hb
        from ..runtime.straggler import HOST_NAMING_FLAGS
        implicated: List[str] = []
        # the world ranks were ACTUALLY assigned over: launch_fn may narrow
        # the agent's confirmed membership further (--include/--exclude/
        # --num_nodes), so rank->host recovery must index the launched
        # world — both supervisors expose it as rank_hosts — or rank 1's
        # evidence lands on an innocent filtered-out neighbor
        launched = list(getattr(proc, "rank_hosts", None) or members)

        def _rec_host(rec: dict):
            # records SHOULD carry hostfile-vocabulary names (launch.py
            # exports DSTPU_HEARTBEAT_HOST), but a record written by an
            # out-of-band worker self-reports gethostname(); the shared
            # recovery falls back to the rank's position in the launched
            # world so the evidence still lands on a strikable member
            return hb.rec_host(rec, launched, known_hosts=members)

        failed_hosts = getattr(proc, "failed_hosts", None)
        if callable(failed_hosts):
            try:
                implicated.extend(h for h in failed_hosts()
                                  if h and h not in implicated)
            except Exception as e:      # attribution is best-effort
                logger.warning("elastic agent: failed_hosts() raised: %s", e)
        if self.heartbeat_dir:
            for rec in hb.terminal_records(self.heartbeat_dir).values():
                if rec.get("phase") == hb.PHASE_STALLED:
                    host = _rec_host(rec)
                    if host and host not in implicated:
                        implicated.append(host)
            # host-naming flags: SDC (the cross-replica audit aborts
            # EVERY rank with the same rc, but only the implicated
            # rank's record carries the flag) and STRAGGLER (the
            # relative-slowness detector's self-verdict — the rank's
            # rc-117 exit names nobody, the flag names the slow host).
            # Strike that host, not the whole world
            for flag in HOST_NAMING_FLAGS:
                for rec in hb.flagged_ranks(self.heartbeat_dir,
                                            flag=flag).values():
                    host = _rec_host(rec)
                    if host and host not in implicated:
                        implicated.append(host)
            if self.heartbeat_timeout > 0:
                # post-mortem staleness: the world is DOWN by the time the
                # agent reads the channel, so every record is frozen and
                # wall-clock age would implicate the whole (innocent)
                # world — the same frozen-record bug RunSupervisor's
                # at-detection snapshot exists to avoid. A rank that went
                # silent BEFORE the world died instead LAGS the freshest
                # record by more than the timeout; measure against that.
                records = hb.read_heartbeats(self.heartbeat_dir)
                freshest = max((float(r.get("ts", 0.0))
                                for r in records.values()), default=0.0)
                for rec in records.values():
                    if rec.get("phase") in hb.TERMINAL_PHASES:
                        continue
                    lag = freshest - float(rec.get("ts", 0.0))
                    if lag > self.heartbeat_timeout:
                        host = _rec_host(rec)
                        if host and host not in implicated:
                            implicated.append(host)
        return [h for h in implicated if h in members]

    def _record_failures(self, proc, members: List[str]) -> None:
        for host in self._failure_evidence(proc, members):
            self.strikes[host] = self.strikes.get(host, 0) + 1
            if self.strikes[host] >= self.blacklist_after and \
                    host not in self.blacklisted:
                self.blacklisted.add(host)
                logger.error(
                    "elastic agent: quarantining host %s after %d failure "
                    "strike(s) — the next world re-forms from the "
                    "survivors", host, self.strikes[host])

    # -------------------------------------------------------------- monitor

    def run(self) -> int:
        """Supervise until a run exits 0 (or restarts are exhausted).
        Returns the final exit code (reference: _invoke_run's monitor loop,
        elastic_agent.py:115)."""
        while True:
            members = self._members()
            if len(members) < self.min_nodes:
                logger.warning("elastic agent: %d nodes < min %d; waiting",
                               len(members), self.min_nodes)
                time.sleep(self.check_interval)
                continue
            self._publish_active_world(members)
            log_dist(f"elastic agent: launching over {len(members)} nodes "
                     f"(restart {self.restarts}, "
                     f"{len(self.blacklisted)} quarantined)", ranks=[0])
            if self.heartbeat_dir:
                # evidence for the PREVIOUS attempt was read in
                # _record_failures; scope the channel to this attempt so
                # a stale STALLED record can't re-strike a host or turn a
                # clean relaunch's rc into 117
                from ..runtime import heartbeat as hb
                hb.clear_channel(self.heartbeat_dir)
            proc = self.launch_fn(members)
            rc = self._monitor(proc, members)
            if rc == 0:
                return 0
            if rc is MEMBERSHIP_CHANGED:
                self.membership_changes += 1
                continue                      # membership change: relaunch
            if rc == PREEMPTION_EXIT_CODE:
                # graceful preemption: the worker checkpointed on SIGTERM
                # and asked to be resumed — not a failure
                self.preemptions += 1
                log_dist(f"elastic agent: worker preempted (rc={rc}); "
                         f"resuming (preemption {self.preemptions}, not "
                         "counted against max_restarts)", ranks=[0])
                continue
            from ..runtime.watchdog import STALL_EXIT_CODE
            if rc == STALL_EXIT_CODE:
                # the watchdog shot a wedged worker: restart, but COUNT it
                # — a deterministic wedge must not relaunch forever
                self.stalls += 1
                logger.warning("elastic agent: worker stalled (rc=%d, "
                               "stall %d); restarting (counted against "
                               "max_restarts)", rc, self.stalls)
            # counted failure: strike the implicated hosts so a repeat
            # offender is quarantined and the world re-forms without it
            self._record_failures(proc, members)
            self.restarts += 1
            if self.restarts > self.max_restarts:
                logger.error("elastic agent: max_restarts exceeded (rc=%d)",
                             rc)
                return rc

    def _monitor(self, proc: subprocess.Popen, members: List[str]):
        """Poll worker + membership. Returns the worker rc, or the
        MEMBERSHIP_CHANGED sentinel when the hostfile changed (a distinct
        object — a signal-killed worker's negative rc must count as a crash,
        not a rescale).

        A candidate membership change must repeat for ``confirm_polls``
        consecutive polls before it triggers a restart; transient states
        (unreadable/empty hostfile, a half-written rewrite that happens to
        parse) reset the confirmation counter."""
        pending: Optional[List[str]] = None
        agree = 0
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc
            observed = self._read_members()
            if observed is not None:
                observed = [h for h in observed
                            if h not in self.blacklisted]
            if observed is None or observed == members:
                pending, agree = None, 0
            else:
                if observed == pending:
                    agree += 1
                else:
                    pending, agree = observed, 1
                # checked on EVERY differing poll, including the first —
                # confirm_polls=1 means restart on first confirmed read
                if agree >= self.confirm_polls:
                    log_dist("elastic agent: membership changed — restarting",
                             ranks=[0])
                    proc.terminate()
                    try:
                        # +10s headroom: the run's OWN teardown — the
                        # backend kill-path call (bounded <= 5s), then
                        # grace for emergency checkpoints, then SIGKILL —
                        # must finish before the agent escalates
                        proc.wait(timeout=self.teardown_grace + 10.0)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
                    return MEMBERSHIP_CHANGED
            time.sleep(self.check_interval)
