"""One fleet replica as a supervised OS PROCESS (counterpart of
``deepspeed_tpu/serving/replica_worker.py``).

The thread fleet runs replica engines as threads sharing the hub
process; ``serving.fleet.placement: "process"`` moves each replica into
its own process, where a replica death is a PROCESS death and the blast
radius is one OS process (its CUDA context, pool and weights die with
it), not one thread's good behaviour. This module is the worker.

Contract (the hub side lives in serving/procfleet.py):

* weights arrive via CHECKPOINT LOAD (``--params`` npz written by the
  hub with runtime/checkpointing.save_tree; the worker takes the
  model's parameter shapes from ``init_params`` on the meta device and
  fills them with ``load_tree``) — no live tensors cross the process
  boundary; the engine serves on ``--device`` (the hub's device);
* the request/token streams ride the transfer fabric
  (``runtime/fabric``): one :class:`SocketEndpoint` dialing the hub's
  star, hello ``{"ident": "replica-N"}``, generation-fenced frames,
  bounded redial on mid-stream loss — a link partition is NOT worker
  death, the worker redials into a fresh hub generation and keeps
  serving;
* token emission is CUMULATIVE: every ``prog``/``done`` frame carries
  ALL tokens this leg generated plus the ``base`` (emitted-prefix
  length) from the dispatch, so duplicated or replayed frames are
  idempotent at the hub — the exactly-once ledger is hub-side
  arithmetic, not wire discipline;
* liveness rides the heartbeat channel: SERVE records with
  queue/active/pool_used/pid gauges every loop iteration (``dstpu
  health`` shows per-process replica rows); silence or process exit is
  the ONLY death verdict the hub accepts;
* SIGTERM stamps PREEMPTED and exits rc 114 (the preemption contract);
  a ``stop`` command exits rc 0;
* every ``prog`` / ``done`` frame carries the process's kernel launch
  counts (``launches``: {wrapper name: count}), so the hub can show that
  the child's path ran the kernels.

Chaos: the worker traverses the same gates the thread fleet does
(``serve.replica_kill`` / ``serve.replica_hang`` / ``serve.replica_slow``
keyed by replica index, where ``kill`` mode — os._exit(13) — means
what it says) plus the fabric's ``net.*`` failpoints on every
frame. Specs ride DSTPU_CHAOS in the env, armed by the hub for the
FIRST spawn only (StageWorkerSpec.env_first semantics: a one-shot crash
spec must not re-arm in the restarted process).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time
from typing import Any, Dict, Optional


# --------------------------------------------------------------- wire helpers
# (shared with the hub: procfleet.py imports cfg_to_dict — the worker
# owns the config wire format because it is the one that must rebuild)

def cfg_to_dict(cfg) -> Dict[str, Any]:
    """TransformerConfig -> JSON-safe dict (dtype by name, e.g.
    ``"bfloat16"``; tuples serialize as lists and are restored by
    :func:`cfg_from_dict`)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).replace("torch.", "")
    return d


def cfg_from_dict(d: Dict[str, Any]):
    import torch
    from ..models.transformer import TransformerConfig

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    d = {k: tup(v) for k, v in d.items()}
    d["dtype"] = getattr(torch, d["dtype"])
    return TransformerConfig(**d)


def launch_counts() -> Dict[str, int]:
    """This process's serving-kernel launch counts (paged attention and
    quant_matmul wrappers' ``launches``)."""
    from ..ops.paged_attention import paged_attention
    from ..ops.quant_matmul import quant_matmul
    return {"paged_attention": paged_attention.launches,
            "quant_matmul": quant_matmul.launches}


# ------------------------------------------------------------------- the loop

def run_worker(args) -> int:
    from ..runtime.heartbeat import PHASE_EXIT, HeartbeatWriter

    idx = int(args.replica)
    hb = None
    if args.hb_dir:
        # refresh fast enough that a long load never reads as silence
        # under the fleet's heartbeat_timeout (the writer's default 15s
        # refresher loses that race against a 10s timeout)
        hb = HeartbeatWriter(args.hb_dir, rank=idx,
                             min_interval=float(args.hb_interval),
                             refresh_interval=1.0)
    # everything past the writer's birth runs under its terminal-stamp
    # finally: a crash during model load / warmup must stamp EXIT, not
    # strand a stale INIT record the hub has to time out on
    try:
        return _run_worker_inner(args, idx, hb)
    finally:
        if hb is not None:
            hb.stamp_terminal(PHASE_EXIT, lock_timeout=2.0)


def _run_worker_inner(args, idx, hb) -> int:
    import torch

    from ..exit_codes import PREEMPTION_EXIT_CODE
    from ..models.transformer import init_params
    from ..runtime.checkpointing import load_tree
    from ..runtime.fabric import (ChannelClosed, ChannelTimeout,
                                  RedialPolicy, SocketEndpoint)
    from ..runtime.heartbeat import PHASE_INIT, PHASE_PREEMPTED, PHASE_SERVE
    from ..testing import chaos
    from .engine import ServingEngine
    from .scheduler import FINISHED

    if hb is not None:
        hb.write(PHASE_INIT, 0, force=True, extra={"pid": os.getpid()})

    def on_sigterm(signum, frame):
        if hb is not None:
            hb.write(PHASE_PREEMPTED, 0, force=True, lock_timeout=2.0,
                     extra={"pid": os.getpid()})
        os._exit(PREEMPTION_EXIT_CODE)

    signal.signal(signal.SIGTERM, on_sigterm)

    with open(args.model_json) as f:
        cfg = cfg_from_dict(json.load(f))
    with open(args.serving_json) as f:
        scfg_d = json.load(f)
    # the template: load_tree restores BY NAME and shape, so the worker
    # re-derives the model's parameter layout (shapes only, no values)
    like = init_params(cfg, None, device="meta")
    params = load_tree(args.params, like)
    eng = ServingEngine(cfg, params, serving=scfg_d, device=args.device)
    del params

    # warm OFF the serving path before saying "ready": kernel libraries
    # loaded (the hub built them), allocator and library handles warmed —
    # a restart that serves cold would pay that on a real request. A
    # warm-up that raises exits the worker: the hub records the death
    warm = eng.submit([1, 2, 3], 2)
    while not warm.done:
        eng.step()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    # frames report launches made after the warm-up: the serving path's
    warm_launches = launch_counts()

    ep = SocketEndpoint(
        (args.hub_host, int(args.hub_port)), f"replica-{idx}",
        hello={"replica": idx, "pid": os.getpid()},
        redial=RedialPolicy(attempts=int(args.redial_attempts),
                            base=0.05, dial_timeout=5.0),
        fence=True)
    try:
        return _serve_loop(args, idx, hb, ep, eng, chaos,
                           ChannelTimeout, ChannelClosed, FINISHED,
                           PHASE_SERVE, warm_launches)
    finally:
        # the ready-send and first stamp can raise too: the endpoint
        # closes on EVERY exit, not just the serve loop's
        try:
            ep.close()
        except OSError:
            pass


def _serve_loop(args, idx, hb, ep, eng, chaos, ChannelTimeout,
                ChannelClosed, FINISHED, PHASE_SERVE, warm_launches) -> int:
    ep.send({"cmd": "ready", "pid": os.getpid()}, key=str(idx))

    def served_launches() -> Dict[str, int]:
        return {k: v - warm_launches.get(k, 0)
                for k, v in launch_counts().items()}

    inflight: Dict[int, tuple] = {}    # rid -> (engine req, base)
    reported: Dict[int, int] = {}      # rid -> tokens already framed
    pending_done: Dict[int, dict] = {}  # rid -> done frame, until acked
    last_resend = time.monotonic()

    def flush(final_only: bool = False) -> None:
        """Emit cumulative prog/done frames for every tracked request.
        Cumulative + base means a frame lost to a redial (or duplicated
        by one) costs nothing: the next frame carries the superset.
        Done frames are AT-LEAST-ONCE: re-sent until the hub acks (the
        hub's apply is idempotent), so a conclusion lost to a torn
        stream cannot strand its request RUNNING forever."""
        nonlocal last_resend
        for rid in list(inflight):
            er, base = inflight[rid]
            toks = [int(t) for t in er.output_tokens]
            if er.done:
                frame = {"cmd": "done", "rid": rid, "base": base,
                         "state": er.state,
                         "error": getattr(er, "error", None),
                         "toks": toks, "launches": served_launches()}
                pending_done[rid] = frame
                ep.send(frame, key=str(idx))
                del inflight[rid]
                reported.pop(rid, None)
            elif not final_only and len(toks) > reported.get(rid, 0):
                ep.send({"cmd": "prog", "rid": rid, "base": base,
                         "toks": toks, "launches": served_launches()},
                        key=str(idx))
                reported[rid] = len(toks)
        now = time.monotonic()
        if pending_done and now - last_resend > 0.25:
            last_resend = now
            for frame in list(pending_done.values()):
                ep.send(frame, key=str(idx))

    def stamp() -> None:
        if hb is not None:
            gauges = {"queue": eng.scheduler.pending, "active": eng.active,
                      "pool_used": eng.pool.used_count, "pid": os.getpid(),
                      "replica": idx}
            if eng.device.type == "cuda":
                import torch
                # this process's peak device memory, for the hub's view
                gauges["peak_mb"] = round(
                    torch.cuda.max_memory_allocated(eng.device) / 2**20)
            hb.write(PHASE_SERVE, eng.steps, extra=gauges)

    stamp()
    rc = 0
    try:
        while True:
            chaos.failpoint("serve.replica_hang", key=str(idx))
            chaos.failpoint("serve.replica_kill", key=str(idx))
            chaos.failpoint("serve.replica_slow", key=str(idx))
            # drain every queued hub frame before stepping
            while True:
                try:
                    meta, _ = ep.recv(timeout=0.0, key=str(idx))
                except ChannelTimeout:
                    break
                cmd = meta.get("cmd")
                if cmd == "stop":
                    raise SystemExit(0)
                if cmd == "ack":
                    pending_done.pop(int(meta["rid"]), None)
                    continue
                if cmd == "cancel":
                    # hub-side preemption: withdraw the lane
                    # or queued entry and FORGET the rid — the hub
                    # already owns the emitted ledger and requeues the
                    # request elsewhere; any frame this leg still sends
                    # for the rid is dropped by the hub's replica guard
                    rid = int(meta["rid"])
                    pair = inflight.pop(rid, None)
                    reported.pop(rid, None)
                    pending_done.pop(rid, None)
                    if pair is not None and not pair[0].done:
                        eng.cancel_request(pair[0], timeout=5.0)
                    continue
                if cmd == "serve":
                    rid = int(meta["rid"])
                    if rid in inflight or rid in pending_done:
                        continue        # re-dispatch after a redial for
                        #                 work this leg already has/served
                    emitted = [int(t) for t in meta.get("emitted", [])]
                    budget = int(meta["max_new_tokens"]) - len(emitted)
                    if budget <= 0:
                        ep.send({"cmd": "done", "rid": meta["rid"],
                                 "base": len(emitted), "state": FINISHED,
                                 "error": None, "toks": []}, key=str(idx))
                        continue
                    er = eng.submit(
                        list(meta["prompt"]) + emitted, budget,
                        temperature=float(meta.get("temperature", 0.0)),
                        eos_token_id=meta.get("eos"),
                        deadline_s=meta.get("deadline_s"))
                    inflight[int(meta["rid"])] = (er, len(emitted))
            if eng.has_work:
                eng.step()
            else:
                time.sleep(0.005)
            flush()                     # progress frames + done re-sends
            stamp()
    except SystemExit as e:
        rc = int(e.code or 0)
        try:
            flush(final_only=True)      # concluded work outlives the stop
        except OSError:
            pass
    except ChannelClosed:
        # hub gone and the redial ladder exhausted: nothing to serve
        # into — exit clean; the hub (if any) holds the requeue ledger
        rc = 0
    return rc


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dstpu fleet replica worker")
    p.add_argument("--replica", type=int, required=True)
    p.add_argument("--hub-host", default="127.0.0.1")
    p.add_argument("--hub-port", type=int, required=True)
    p.add_argument("--params", required=True, help="flat-npz weights")
    p.add_argument("--model-json", required=True)
    p.add_argument("--serving-json", required=True)
    p.add_argument("--hb-dir", default="")
    p.add_argument("--hb-interval", type=float, default=0.25)
    p.add_argument("--device", default="cuda",
                   help="the device the replica serves on (the hub's)")
    p.add_argument("--redial-attempts", type=int, default=4)
    return p.parse_args(argv)


def main(argv=None) -> int:
    return run_worker(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
