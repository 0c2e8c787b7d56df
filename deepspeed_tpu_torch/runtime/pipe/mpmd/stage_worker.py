"""One MPMD pipeline stage as a supervised OS process (counterpart of
``deepspeed_tpu/runtime/pipe/mpmd/stage_worker.py``).

``python -m deepspeed_tpu_torch.runtime.pipe.mpmd.stage_worker --stage S
...`` runs stage S of a pp-stage pipeline: it connects to the driver's
transfer star (:class:`~.channel.SocketChannel`), walks its own
instruction stream each training step with the in-process interpreter
(``executor.MPMDPipeline`` over ``stages=[S]``: the same per-stage math
as one process holding every stage), applies its LOCAL optimizer at each
step boundary, and checkpoints its own state every ``--save-interval``
steps through the durable-tag machinery of ``runtime/checkpointing.py``
(staging dir, digests, completion marker, atomic publish), which is also
what a RESTARTED stage restores from. It runs on ``cuda:{LOCAL_RANK}``
unless ``--device cpu`` is given.

Supervision plugs into the existing substrate:

* every step stamps a STAGE-tagged heartbeat (phase STEP, gauges
  ``{"stage": S, "step_ms": ...}``) — ``health`` shows the STAGE column;
* a StallWatchdog bounds the step cadence (``--stall-timeout``): a wedged
  stage exits rc 117 with a STALLED record; waits at the transfer
  barrier are the channel's business (``--barrier-timeout``), so the
  watchdog is suspended across them;
* SIGTERM stamps PREEMPTED and exits rc 114;
* transfer faults (``pipe.xfer``) surface as IOError -> rc 1 (a counted
  crash the driver restarts).

Park/resync (the one-stage-restart protocol driven by ``driver.py``):
when a peer dies the driver parks the survivors — a park control frame
surfaces mid-recv as ``ParkSignal`` or at the step top — and each
survivor abandons its in-flight step (no optimizer update was applied,
so nothing needs undoing), acks, and waits. After the dead stage
restarts from its newest durable tag, the driver broadcasts
``resync(step=k)``; every survivor restores its own state at tag k and
training replays from step k, each micro-batch's update applied exactly
once. A survivor parked past ``--park-timeout`` exits rc 117.

Specs. The built-in ``toy`` spec (tanh-MLP stages and a linear head,
data drawn per (seed, step)) draws its parameters from the same
``np.random.RandomState(seed)`` stream as the JAX package's toy, so both
packages' toys train the same numbers. ``--spec module:attr`` names a
callable of the parsed args returning one of two dicts:

* ``{"stage_fn", "loss_fn", "stage_init", "head_init", "data"}`` — the
  JAX contract: ``stage_fn(params, x, extra, stage)``,
  ``loss_fn(head_params, y, labels, ctx)``, trees of tensors, and
  ``data(step) -> (micros [n_micro, mb, ...], labels [n_micro, ...])``;
* ``{"module", "data"}`` — a ``models.pipeline.PipelinedTransformer``
  built with ``stage=S`` (the embedding on stage 0, the head and the loss
  on the last) and ``data(step) -> {"input_ids": [n_micro, mb, S]}``.

Either may add ``"optimizer"`` (an ``ops.optimizers.Optimizer``; default
Adam at ``--lr``) and ``"dtype"``: the compute dtype the parameters are
cast to after the fp32 master is taken from them (a module given in f32
with ``"dtype": torch.bfloat16`` trains bf16 on an fp32 master, as the
engine does); a 16-bit module without it trains an fp32 master from its
16-bit values.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import signal
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ....exit_codes import PREEMPTION_EXIT_CODE


def toy_spec(args) -> Dict[str, Any]:
    """Deterministic toy pipeline: pp tanh-MLP stages and a linear head
    over H-dim activations. Every field derives from (--seed, step), so
    two runs — or one run crossing a restart — see identical parameters
    and data."""
    H, mb = args.hidden, args.mb
    f32 = torch.float32
    rng = np.random.RandomState(args.seed)
    stage_inits = []
    for _ in range(args.pp):
        stage_inits.append({
            "w": torch.tensor(rng.randn(H, H) * 0.3, dtype=f32),
            "b": torch.tensor(rng.randn(H) * 0.1, dtype=f32)})
    head_init = {"v": torch.tensor(rng.randn(H) * 0.5, dtype=f32)}

    def stage_fn(p, x, extra, stage):
        return torch.tanh(x @ p["w"] + p["b"])

    def loss_fn(head_p, y, lab, ctx):
        return torch.mean((y @ head_p["v"] - lab) ** 2)

    def data(step):
        drng = np.random.default_rng(args.seed * 100003 + step)
        micros = torch.tensor(drng.standard_normal((args.n_micro, mb, H)),
                              dtype=f32)
        labels = torch.tensor(drng.standard_normal((args.n_micro, mb)),
                              dtype=f32)
        return micros, labels

    return {"stage_fn": stage_fn, "loss_fn": loss_fn,
            "stage_init": stage_inits[args.stage], "head_init": head_init,
            "data": data}


def _load_spec(args):
    if args.spec == "toy":
        return toy_spec(args)
    mod, _, attr = args.spec.partition(":")
    return getattr(importlib.import_module(mod), attr)(args)


# ---------------------------------------------------------------- programs


class _TreeStage:
    """A stage of a ``stage_fn`` spec: its parameter tree (and the head's
    on the last stage) and one step's walk over the channel."""

    def __init__(self, spec, args, device):
        from .executor import MPMDPipeline, tree_leaves
        self.s, self.pp, self.args = args.stage, args.pp, args
        self.last = self.s == self.pp - 1
        self.data = spec["data"]
        self.device = device

        def own(tree):
            return {k: v.detach().to(device).requires_grad_(True)
                    for k, v in tree.items()}
        self.stage_tree = own(spec["stage_init"])
        self.head_tree = own(spec["head_init"]) if self.last else {}
        self.params: List[torch.Tensor] = tree_leaves(self.stage_tree) + \
            tree_leaves(self.head_tree)
        self.pipe = MPMDPipeline(spec["stage_fn"], spec["loss_fn"],
                                 pp=self.pp, schedule=args.schedule,
                                 stages=[self.s], channel=None)

    def bind(self, chan) -> None:
        """The stage's transfer seam (dialed once the resume step is
        known: its hello carries it)."""
        self.pipe.channel = chan

    def step(self, k: int):
        micros, labels = self.data(k)
        trees: List[Optional[dict]] = [None] * self.pp
        trees[self.s] = self.stage_tree
        first = self.s == 0
        loss, _aux, grads, hgrads, _dm = self.pipe.value_and_grad(
            trees, self.head_tree,
            micros.to(self.device) if first else None,
            labels.to(self.device) if self.last else None,
            n_micro=self.args.n_micro,
            boundary=(tuple(micros.shape[1:]), micros.dtype, self.device))
        gs = list(grads[self.s]) + list(hgrads)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(self.params, gs)]
        return gs, (float(loss) if self.last else None)


class _ModuleStage:
    """A stage of a ``module`` spec: the ``PipelinedTransformer``'s
    parameters and its ``pipeline_value_and_grad`` over the channel."""

    def __init__(self, spec, args, device):
        self.module = spec["module"].to(device)
        if self.module.stage != args.stage or self.module.pp != args.pp:
            raise ValueError(
                f"spec module holds stage {self.module.stage} of "
                f"{self.module.pp}; this worker runs stage {args.stage} of "
                f"{args.pp}")
        if self.module.cfg.tie_embeddings:
            raise ValueError(
                "a stage worker trains its own parameters only: a model "
                "whose head shares the embedding (tie_embeddings) needs "
                "the shared leaf's grads summed over the stages, which the "
                "socket star does not carry; untie it")
        self.chan, self.args, self.device = None, args, device
        self.last = args.stage == args.pp - 1
        self.data = spec["data"]
        named = [(n, p) for n, p in self.module.named_parameters()
                 if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]

    def bind(self, chan) -> None:
        self.chan = chan

    def step(self, k: int):
        micros = self.data(k)
        loss, grads = self.module.pipeline_value_and_grad(
            micros, schedule=self.args.schedule, channel=self.chan)
        gs = [grads[n] if n in grads else torch.zeros_like(
            p, dtype=torch.float32) for n, p in zip(self.names, self.params)]
        return gs, (float(loss) if self.last else None)


# ------------------------------------------------------------- checkpoints

_TAG = "global_step"


def _save_stage_state(ckpt_dir: str, done: int, state) -> None:
    """Durable per-stage save: stage into ``<tag>.tmp``, digests and
    completion marker, atomic publish, ``latest``."""
    from ...checkpointing import (META_FILE, STAGING_SUFFIX, publish_tag,
                                  quarantine_staging, save_tree,
                                  write_completion_marker, write_latest)
    tag = f"{_TAG}{done}"
    stage_dir = os.path.join(ckpt_dir, tag + STAGING_SUFFIX)
    os.makedirs(stage_dir, exist_ok=True)
    try:
        save_tree(state, os.path.join(stage_dir, "model_states.npz"))
        with open(os.path.join(stage_dir, META_FILE), "w") as f:
            json.dump({"step": done, "stage_checkpoint": True}, f)
        write_completion_marker(stage_dir, num_shards=1)
        publish_tag(ckpt_dir, tag)
    except BaseException as e:
        # a torn save must not strand <tag>.tmp where the next save would
        # merge fresh shards into stale ones
        quarantine_staging(stage_dir, reason=f"stage save failed: {e!r}")
        raise
    write_latest(ckpt_dir, tag)


def _load_stage_state(ckpt_dir: str, like, tag: Optional[str] = None):
    """(state, steps_done) from ``tag`` or the newest intact tag (digests
    checked, torn tags skipped); (None, 0) when nothing is restorable."""
    from ...checkpointing import load_tree, resolve_load_tag, verify_tag
    if tag is None:
        try:
            tag = resolve_load_tag(ckpt_dir)
        except (FileNotFoundError, OSError, RuntimeError, ValueError):
            return None, 0
    elif verify_tag(os.path.join(ckpt_dir, tag)) is not None:
        raise IOError(f"resync tag {tag} failed verification")
    state = load_tree(os.path.join(ckpt_dir, tag, "model_states.npz"), like)
    return state, int(tag[len(_TAG):])


# ------------------------------------------------------------------ worker


def launch_counts() -> Dict[str, int]:
    """This process's flash kernel launches (the train step's kernels)."""
    from ....ops import flash_attention as fa
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv.launches}


def run_worker(args) -> int:
    from ....ops.optimizers import adam
    from ....testing import chaos
    from ....utils.device import resolve_device
    from ...heartbeat import (HEARTBEAT_DIR_ENV, PHASE_EXIT, PHASE_PREEMPTED,
                              PHASE_STALLED, PHASE_STEP, HeartbeatWriter)
    from ...straggler import STEP_MS_GAUGE, StepClock
    from ...watchdog import STALL_EXIT_CODE, StallWatchdog
    from .channel import (ChannelClosed, ChannelTimeout, ParkSignal,
                          SocketChannel)

    s = args.stage
    device = resolve_device(args.device if args.device != "cuda" else
                            f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    hb = None
    if os.environ.get(HEARTBEAT_DIR_ENV):
        hb = HeartbeatWriter(os.environ[HEARTBEAT_DIR_ENV], rank=s)

    def on_sigterm(signum, frame):
        if hb is not None:
            # a direct terminal write keeps the STAGE gauge on the record
            hb.write(PHASE_PREEMPTED, 0, force=True, lock_timeout=2.0,
                     extra={"stage": s})
        os._exit(PREEMPTION_EXIT_CODE)

    signal.signal(signal.SIGTERM, on_sigterm)
    watchdog = None
    if args.stall_timeout > 0:
        watchdog = StallWatchdog(args.stall_timeout, heartbeat=hb).start()

    def waiting():
        return (watchdog.suspended() if watchdog is not None
                else contextlib.nullcontext())

    spec = _load_spec(args)
    opt = spec.get("optimizer") or adam(lr=args.lr)
    stage = (_ModuleStage if "module" in spec else _TreeStage)(
        spec, args, device)
    params = stage.params
    dtype = spec.get("dtype")
    cast = dtype is not None and any(p.dtype != dtype for p in params)
    master = [p.detach().to(torch.float32).clone()
              if p.dtype != torch.float32 or cast else p.detach()
              for p in params]
    if cast:
        with torch.no_grad():
            for p in params:
                p.data = p.data.to(dtype)
    aliased = all(m.data_ptr() == p.data_ptr()
                  for m, p in zip(master, params))
    opt_state = opt.init(master)
    slots = sorted(opt_state)

    def state_of(done: int) -> Dict[str, Any]:
        st: Dict[str, Any] = {f"master/{i}": m for i, m in enumerate(master)}
        for slot in slots:
            st.update({f"opt/{slot}/{i}": t
                       for i, t in enumerate(opt_state[slot])})
        st["step"] = np.asarray([done], np.int64)
        return st

    def restore(st) -> None:
        with torch.no_grad():
            for i, m in enumerate(master):
                m.copy_(st[f"master/{i}"])
            for slot in slots:
                for i, t in enumerate(opt_state[slot]):
                    t.copy_(st[f"opt/{slot}/{i}"])
            if not aliased:
                for p, m in zip(params, master):
                    p.copy_(m)

    restored, done = _load_stage_state(args.ckpt_dir, state_of(0))
    if restored is not None:
        restore(restored)
        done = int(np.asarray(restored["step"]).reshape(-1)[0])
    else:
        # durable step-0 state: a resync to step 0 must be restorable
        _save_stage_state(args.ckpt_dir, 0, state_of(0))
        done = 0
    step_clock = StepClock()
    chan = SocketChannel((args.driver_host, args.driver_port), s,
                         resume_step=done, timeout=args.barrier_timeout,
                         waiting=waiting)
    stage.bind(chan)

    def park_and_resync():
        """The survivor half of one-stage restart: ack the park, wait
        (bounded) for resync, restore this stage at the resync step."""
        chan.send_control({"cmd": "parked", "stage": s})
        if watchdog is not None:
            watchdog.suspend()
        try:
            ctrl = chan.wait_control("resync", timeout=args.park_timeout)
        except ChannelTimeout:
            if hb is not None:
                hb.write(PHASE_STALLED, 0, force=True, lock_timeout=2.0,
                         extra={"stage": s})
            sys.exit(STALL_EXIT_CODE)
        finally:
            if watchdog is not None:
                watchdog.resume()
        r = int(ctrl["step"])
        # the new generation: frames of the abandoned step are stale
        chan.generation = int(ctrl.get("gen", chan.generation + 1))
        st, _ = _load_stage_state(args.ckpt_dir, state_of(0),
                                  tag=f"{_TAG}{r}")
        restore(st)
        chan.clear_data()
        # the parked window is not a step of the step_ms gauge
        step_clock.reset()
        print("mpmd_park: " + json.dumps({"stage": s, "resync_step": r,
                                          "gen": chan.generation,
                                          "t": time.time()}), flush=True)
        return r

    k = done
    while k < args.steps:
        ctrl = chan.poll_control(0.0)
        if ctrl is not None:
            if ctrl.get("cmd") == "stop":
                break
            if ctrl.get("cmd") == "park":
                k = park_and_resync()
                continue
        # keyed by stage: ``match=1`` takes out stage 1 only
        chaos.failpoint("pipe.stage_kill", key=str(s))
        gauge = step_clock.mark()
        if hb is not None:
            extra = {"stage": s}
            if gauge is not None:
                extra[STEP_MS_GAUGE] = gauge
            hb.write(PHASE_STEP, k, extra=extra)
        t0 = time.perf_counter()
        sent, recv, wait_s = chan.bytes_sent, chan.bytes_recv, chan.wait_s
        launched = launch_counts()
        try:
            grads, loss = stage.step(k)
        except ParkSignal:
            k = park_and_resync()
            continue
        except ChannelTimeout:
            # at the transfer barrier past the deadline, with no word from
            # the driver: the stall contract
            if hb is not None:
                hb.write(PHASE_STALLED, k, force=True, lock_timeout=2.0,
                         extra={"stage": s})
            return STALL_EXIT_CODE
        except ChannelClosed:
            return 1
        with torch.no_grad():
            opt.update(grads, opt_state, master, k)
            if not aliased:
                for p, m in zip(params, master):
                    p.copy_(m)
        del grads
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if watchdog is not None:
            watchdog.beat(step=k)
        k += 1
        if args.save_interval > 0 and k % args.save_interval == 0:
            _save_stage_state(args.ckpt_dir, k, state_of(k))
        rec = {"step": k - 1, "stage": s, "t": time.time(),
               "ms": 1e3 * (time.perf_counter() - t0),
               "bytes_sent": chan.bytes_sent - sent,
               "bytes_recv": chan.bytes_recv - recv,
               "wait_ms": 1e3 * (chan.wait_s - wait_s),
               "launches": {n: c - launched[n]
                            for n, c in launch_counts().items()}}
        print("mpmd_stage_step: " + json.dumps(rec), flush=True)
        if loss is not None:
            print(f'mpmd_step: {{"step": {k - 1}, "loss": {loss:.8f}}}',
                  flush=True)

    chan.send_control({"cmd": "done", "stage": s})
    if watchdog is not None:
        watchdog.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    print("mpmd_launches: " + json.dumps(
        {"stage": s, "launches": launch_counts(), "peak_bytes": peak}),
        flush=True)
    if hb is not None:
        hb.write(PHASE_EXIT, k, force=True, lock_timeout=2.0,
                 extra={"stage": s})
    chan.close()
    return 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="mpmd.stage_worker")
    p.add_argument("--stage", type=int, required=True)
    p.add_argument("--pp", type=int, required=True)
    p.add_argument("--n-micro", type=int, default=4, dest="n_micro")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--schedule", default="1f1b", choices=["gpipe", "1f1b"])
    p.add_argument("--driver-host", default="127.0.0.1", dest="driver_host")
    p.add_argument("--driver-port", type=int, required=True,
                   dest="driver_port")
    p.add_argument("--ckpt-dir", required=True, dest="ckpt_dir")
    p.add_argument("--save-interval", type=int, default=1,
                   dest="save_interval")
    p.add_argument("--spec", default="toy",
                   help="'toy' or module:attr returning the spec dict")
    p.add_argument("--device", default="cuda",
                   help="cuda (cuda:{LOCAL_RANK}) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--hidden", type=int, default=8)
    p.add_argument("--mb", type=int, default=2)
    p.add_argument("--park-timeout", type=float, default=60.0,
                   dest="park_timeout")
    p.add_argument("--barrier-timeout", type=float, default=60.0,
                   dest="barrier_timeout")
    p.add_argument("--stall-timeout", type=float, default=0.0,
                   dest="stall_timeout",
                   help="watchdog step deadline; 0 = unbounded")
    return p.parse_args(argv)


def main(argv=None) -> int:
    return run_worker(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
