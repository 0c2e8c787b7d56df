"""DeepSpeedEngine — the config-driven training engine (counterpart of
``deepspeed_tpu/runtime/engine.py``), in one process or data parallel
across the ranks of a ``torch.distributed`` process group.

What is ported, with the JAX engine's semantics:

* precision: bf16 or fp16 compute parameters with an fp32 master (the
  module holds the compute parameters and autograd differentiates them,
  as the JAX engine differentiates its compute-dtype params), fp32
  training (the parameters are the master), and pure bf16
  (``bf16.master_weights: false``: bf16 parameters and Adam moments);
  ``data_types.grad_accum_dtype``; the fp16 ``LossScaler``;
* the optimizer from the config section (or a client ``Optimizer``) and
  the schedule, read at the optimizer step count;
* ``train_batch``: the global batch split [gas, micro] on the host, each
  micro-batch's grads accumulated, then the step tail (``_finalize_step``):
  divide by gas x loss scale, the overflow check, the global grad norm,
  clipping by clip / (norm + 1e-6), the lr and the update; a skipped
  step keeps parameters, master and moments and does not advance the
  step; skipped-step and non-finite-streak counters;
* ``forward`` / ``backward`` / ``step`` (the micro-batch API), ``eval_batch``
  and the getters;
* checkpoints (``save_checkpoint`` / ``load_checkpoint``, the sync or
  async writer of the ``checkpoint`` section with its retention and
  verified loads, ``save_16bit_model``, ``load_module_state_dict``): the
  JAX package's files, read and written by path — a ``Transformer``'s
  per-block parameters, fp32 master and Adam moments stacked into the
  scan layout's ``[L, ...]`` leaves on save and copied back slice by slice
  on load, so a checkpoint crosses between the two packages;
* the ``activation_checkpointing`` section: a user module's call becomes
  one checkpointed region under the "dots" policy (the in-tree
  ``Transformer`` remats per block through its own ``remat`` knob).

The update runs in place once the step is known not to skip: the
overflow flag and the grad norm come to the host together, one read per
step, where the JAX engine keeps both inside its compiled step.

The ``sparse_attention`` section is wired into the model as the JAX
engine wires it (:func:`wire_attention_config`): the ``Transformer``'s
``attention_impl`` becomes "sparse" and its config carries the parsed
section, so every layer runs the block-sparse kernels.

ZeRO stages 0-3: without a process group the engine holds the whole
state in one process (partitioning over one rank is the identity, as for
the JAX engine on one chip). Whenever a process group is initialized,
even of one rank, it runs data parallel over the mesh's ZeRO axes
(``runtime/zero/partition.py``): each rank takes its ``micro`` rows of
every ``[W x micro]`` micro-batch of the global batch (as the JAX engine
splits ``[gas, W x micro]``); stage 0 all-reduces the grads, stages 1-2
shard the master and moments (stage 2 reduce-scatters the grads), stage
3 also shards the compute parameters and gathers them around each
block's forward and backward; the step tail's overflow flag, grad norm
and loss come from one all-reduce; checkpoints are saved sharded, each
rank writing its own pieces. An engine given a model on ``meta``
(``zero.Init``) fills each rank's slabs straight from the model's seeded
values, one leaf at a time.

Everything else that a config can enable and this engine does not
implement raises ``NotImplementedError`` naming ROADMAP.md: CPU/NVMe
offload (and ``activation_checkpointing.cpu_checkpointing``), the 1-bit
optimizers, comm_plan, compression_training, the integrity sentinel,
progressive layer drop, curriculum / data efficiency, eigenvalue,
sequence / tensor / pipeline parallelism (and ``mpu``), monitors and the
other aux sections. Not ported either: the preemption handler and
emergency save, the sentinel's audited-clean resume and the offload load
path (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..config.config import DeepSpeedConfig, load_config
from ..ops.optimizers import Optimizer, build_optimizer
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from . import checkpointing as ckpt_lib
from .loss_scaler import LossScaler, LossScaleState
from .lr_schedules import LRScheduler, build_schedule

_LATER = "is not ported to deepspeed_tpu_torch yet (see ROADMAP.md)"
_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}
_GRAD_ACCUM = {"fp32": torch.float32, "float32": torch.float32,
               "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
               "fp16": torch.float16, "float16": torch.float16}


def _default_loss_fn(outputs, batch):
    """The model returns the scalar loss (loss = engine(batch))."""
    return outputs


def _any_enabled(node) -> bool:
    """True if a parsed section dict holds ``"enabled": true`` anywhere."""
    if isinstance(node, dict):
        if node.get("enabled") is True:
            return True
        return any(_any_enabled(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return any(_any_enabled(v) for v in node)
    return False


def unported_sections(config: DeepSpeedConfig) -> List[str]:
    """The enabled sections of ``config`` this engine does not implement."""
    c = config
    z = c.zero_optimization
    off = [o for o in (z.offload_optimizer, z.offload_param)
           if o is not None and o.device in ("cpu", "nvme")]
    act = c.activation_checkpointing
    wd = c.watchdog
    checks = {
        "zero_optimization offload (offload_optimizer / offload_param)":
            bool(off),
        "zero_optimization.zero_quantized_weights": z.zero_quantized_weights,
        "comm_plan": c.comm_plan.enabled,
        "compression_training": _any_enabled(
            c.compression_training.model_dump()),
        "quantize_training": _any_enabled(c.quantize_training),
        "integrity (training sentinel)": (
            c.integrity.enabled or c.integrity.audit_interval > 0
            or c.integrity.nonfinite_abort_after > 0),
        "progressive_layer_drop": c.progressive_layer_drop.enabled,
        "curriculum_learning": c.curriculum_learning.enabled,
        "data_efficiency": c.data_efficiency.enabled,
        "eigenvalue": c.eigenvalue.enabled,
        "sequence_parallel (sp_size > 1)": c.sequence_parallel.sp_size > 1,
        "tensor_parallel (tp_size > 1)": c.tensor_parallel.tp_size > 1,
        "pipeline (stages > 1)": c.pipeline.stages > 1,
        "moe": c.moe.enabled,
        "activation_checkpointing.cpu_checkpointing (host offload, "
        "ROADMAP item 5.2)": act.cpu_checkpointing,
        "watchdog": any(t > 0 for t in (
            wd.stall_timeout, wd.compile_timeout, wd.restore_timeout,
            wd.save_timeout)),
        "straggler": c.straggler.enabled,
        "amp": c.amp.enabled,
        "sparse_gradients": c.sparse_gradients,
        "monitors (tensorboard / wandb / csv_monitor)": (
            c.tensorboard.enabled or c.wandb.enabled or c.csv_monitor.enabled),
        "flops_profiler": c.flops_profiler.enabled,
        "autotuning": c.autotuning.enabled,
        "elasticity": c.elasticity.enabled,
    }
    return [name for name, on in checks.items() if on]


def wire_attention_config(model: nn.Module, config: DeepSpeedConfig):
    """Map the ``sparse_attention`` section onto the model's
    ``attention_impl`` (the JAX engine's ``wire_attention_config``;
    reference: runtime/config.py:270-453). The ``Transformer``'s config is
    replaced in place, on the module and on every block, with
    ``attention_impl="sparse"`` and the parsed section as a sorted tuple.

    Unknown sparse or sequence-parallel modes, a model without a
    ``TransformerConfig`` and a conflicting hand-set ``attention_impl``
    raise ``ValueError``: a parsed section silently running dense attention
    is a wrong answer. ``sequence_parallel.sp_size > 1`` never reaches
    here (the engine raises for it as an unported section)."""
    sp = config.sequence_parallel
    if sp.mode not in ("ring", "ulysses"):
        raise ValueError(
            f"sequence_parallel.mode '{sp.mode}' is not supported; "
            "expected 'ring' or 'ulysses'")
    sa = config.sparse_attention
    if sa is None:
        return model
    from ..models.transformer import TransformerConfig
    from ..ops.sparse_attention import SPARSITY_CONFIGS
    if sa.mode not in SPARSITY_CONFIGS:
        raise ValueError(f"unknown sparse attention mode '{sa.mode}'; "
                         f"have {sorted(SPARSITY_CONFIGS)}")
    mcfg = getattr(model, "cfg", None)
    if not isinstance(mcfg, TransformerConfig):
        raise ValueError(
            "the sparse_attention config section requires the in-tree "
            "transformer family (models.build_model); this model has no "
            "TransformerConfig to wire the layout into")
    if mcfg.attention_impl not in ("auto", "sparse"):
        raise ValueError(
            f"sparse_attention config conflicts with the model's hand-set "
            f"attention_impl='{mcfg.attention_impl}'")
    if not isinstance(getattr(model, "blocks", None), nn.ModuleList):
        raise ValueError(f"cannot rebuild model {type(model).__name__} with "
                         "attention_impl='sparse'")
    items = tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in sa.model_dump().items()))
    new_cfg = dataclasses.replace(mcfg, attention_impl="sparse",
                                  sparse_attention=items)
    model.cfg = new_cfg
    for blk in model.blocks:
        blk.cfg = new_cfg
    log_dist("attention config wired: attention_impl='sparse'", ranks=[0])
    return model


class DeepSpeedEngine:
    """``model``: an ``nn.Module`` whose ``forward(batch[, train=])``
    returns outputs that ``loss_fn(outputs, batch)`` turns into the scalar
    loss (default: the outputs are the loss), typically the port's
    ``Transformer``. ``model_parameters``: a flax-layout numpy tree for a
    ``Transformer`` (``models.convert.module_from_jax``); default the
    module's own parameters. ``device``: default CUDA; ``"cpu"`` runs the
    kernels' plain versions."""

    def __init__(self,
                 model: nn.Module,
                 config=None,
                 model_parameters=None,
                 loss_fn: Optional[Callable] = None,
                 optimizer: Optional[Optimizer] = None,
                 lr_scheduler=None,
                 mpu=None,
                 device=None):
        self.config: DeepSpeedConfig = load_config(config)
        bad = unported_sections(self.config)
        if bad:
            raise NotImplementedError(
                f"ds_config sections {bad}: enabled, but the section " + _LATER)
        if mpu is not None:
            raise NotImplementedError(
                "mpu (an external model-parallel unit; tensor / pipeline "
                "parallelism, ROADMAP item 4.1) " + _LATER)
        if not isinstance(model, nn.Module):
            raise TypeError("model must be a torch.nn.Module (e.g. "
                            "models.transformer.build_model(...)[0])")
        from .. import comm
        comm.configure(self.config.comms_logger)
        self.device = resolve_device(device)
        self.mesh = None
        dp_rank, dp_world = 0, 1
        if comm.is_initialized():
            from ..parallel.mesh import (ZERO_AXES, build_mesh_from_config,
                                         get_global_mesh)
            import torch.distributed as dist
            backend = dist.get_backend()
            if (backend == "nccl") != (self.device.type == "cuda"):
                raise ValueError(
                    f"process group backend {backend!r} with device "
                    f"{self.device}: NCCL serves CUDA and gloo the CPU; "
                    "start the group for the engine's device "
                    "(comm.init_distributed(device=...))")
            self.mesh = get_global_mesh()
            if self.mesh is None or \
                    self.mesh.world_size != comm.get_world_size():
                self.mesh = build_mesh_from_config(self.config)
            dp_world = self.mesh.axes_size(ZERO_AXES)
            dp_rank = self.mesh.axis_rank(ZERO_AXES)
        self.config.resolve_batch_sizes(dp_world_size=dp_world)
        self.dp_world_size, self.dp_rank = dp_world, dp_rank

        # precision ----------------------------------------------------------
        self.compute_dtype = _DTYPES[self.config.precision_dtype]
        self.keep_master = self.compute_dtype != torch.float32
        self._pure_bf16 = (self.config.bf16.enabled
                           and not self.config.bf16.master_weights)
        if self._pure_bf16:
            self.keep_master = False
        gad = (self.config.data_types.grad_accum_dtype or "fp32").lower()
        if gad not in _GRAD_ACCUM:
            raise ValueError(
                f"data_types.grad_accum_dtype '{gad}' is not supported; "
                f"expected one of {sorted(_GRAD_ACCUM)}")
        self.grad_accum_dtype = _GRAD_ACCUM[gad]
        fp16 = self.config.fp16
        self.loss_scaler = LossScaler(
            static_scale=fp16.loss_scale,
            initial_scale_power=fp16.initial_scale_power,
            scale_window=fp16.loss_scale_window,
            min_scale=fp16.min_loss_scale,
            hysteresis=fp16.hysteresis,
            enabled=fp16.enabled)

        # model --------------------------------------------------------------
        if model_parameters is not None:
            from ..models.convert import module_from_jax
            cfg = getattr(model, "cfg", None)
            if cfg is None:
                raise ValueError("model_parameters (a flax-layout tree) needs "
                                 "a models.transformer.Transformer model")
            model = module_from_jax(model_parameters, cfg)
        # the sparse_attention section rewires the model's attention_impl
        model = wire_attention_config(model, self.config)
        self.module = model
        self.loss_fn = loss_fn or _default_loss_fn
        try:
            self._takes_train = "train" in inspect.signature(
                model.forward).parameters
        except (TypeError, ValueError):
            self._takes_train = False
        from .. import zero
        # a model built under zero.Init is on meta: its values come one
        # leaf at a time, each rank keeping its slabs
        values = (zero.init_values(model, self.device)
                  if any(p.is_meta for p in model.parameters()) else None)
        self.dp = None
        if self.mesh is None and values is not None:
            zero.materialize(model, values)
        if self.mesh is None:
            model.to(self.device)
        self._remat_apply = self._activation_checkpointing(model)
        self._params = [p for p in model.parameters() if p.requires_grad]
        if self.mesh is not None:
            from .zero.partition import ZeroPartition
            from .zero.stages import ZeroShardingPolicy
            z = self.config.zero_optimization
            policy = ZeroShardingPolicy(
                z.stage, self.mesh,
                param_persistence_threshold=z.param_persistence_threshold)
            self.dp = ZeroPartition(
                model, self._params, policy, dp_rank, dp_world,
                self.compute_dtype,
                torch.float32 if self.keep_master else self.compute_dtype,
                self.grad_accum_dtype, self.device, values)
            model.to(self.device)       # buffers: the parameters are placed
            self._params = self.dp.params
            self.master: List[torch.Tensor] = self.dp.masters
            self.dp.install_gathers()
        else:
            for p in self._params:                     # the master, fp32
                p.data = p.data.to(torch.float32)
            self.master = []
            if self.keep_master:
                self.master = [p.detach().clone() for p in self._params]
            if self.compute_dtype != torch.float32:
                for p in self._params:
                    p.data = p.data.to(self.compute_dtype)

        # optimizer ----------------------------------------------------------
        opt_cfg = self.config.optimizer
        if optimizer is not None:
            if not isinstance(optimizer, Optimizer):
                raise TypeError(
                    "optimizer must be a deepspeed_tpu_torch.ops.optimizers."
                    "Optimizer (e.g. ops.optimizers.adamw(lr=...)); got "
                    f"{type(optimizer)}")
            self.optimizer: Optional[Optimizer] = optimizer
            self.base_lr = (float(opt_cfg.params.get("lr", 1e-3))
                            if opt_cfg else 1e-3)
        elif opt_cfg is not None:
            self.optimizer = build_optimizer(opt_cfg.type, opt_cfg.params)
            self.base_lr = float(opt_cfg.params.get("lr", 1e-3))
        else:
            self.optimizer = None
            self.base_lr = 0.0
        if self._pure_bf16 and (self.optimizer is None or
                                self.optimizer.name not in ("adam", "adamw")):
            raise ValueError(
                "bf16.master_weights=false (pure-bf16 state) supports "
                "Adam/AdamW only; got optimizer "
                f"'{self.optimizer.name if self.optimizer else None}'")
        self.opt_state: Dict[str, List[torch.Tensor]] = (
            self.optimizer.init(self._master())
            if self.optimizer is not None else {})

        # lr schedule --------------------------------------------------------
        self.lr_fn = None
        if lr_scheduler is not None:
            self.lr_scheduler = lr_scheduler
            if isinstance(lr_scheduler, LRScheduler):
                self.lr_fn = lr_scheduler.fn
        elif self.config.scheduler is not None and self.config.scheduler.type:
            self.lr_fn = build_schedule(self.config.scheduler.type,
                                        self.config.scheduler.params)
            self.lr_scheduler = LRScheduler(self.lr_fn)
        else:
            self.lr_scheduler = None

        # state --------------------------------------------------------------
        self.step_count = 0                 # optimizer steps applied
        self.scale_state = self.loss_scaler.init()
        self._skipped_steps = 0
        self.nonfinite_streak = 0
        self.global_steps = 0
        self.micro_steps = 0
        self._accum: Optional[List[torch.Tensor]] = None
        self._accum_losses: List[torch.Tensor] = []
        self._micro_count = 0
        self._pending = None
        self._train_mode = True
        self._last_metrics: Dict[str, Any] = {}
        self._step_t0 = None
        # global batches consumed since data start (one a step), kept in
        # the checkpoint's client_state
        self.data_position = 0
        self._ckpt_cache = None             # see _ckpt_leaves
        where = ("one process" if self.dp is None else
                 f"data parallel over {dp_world} rank(s)")
        log_dist(f"DeepSpeedEngine initialized: ZeRO stage "
                 f"{self.config.zero_optimization.stage} ({where}), "
                 f"dtype {self.config.precision_dtype}, device {self.device}, "
                 f"batch {self.config.train_batch_size} (micro "
                 f"{self.config.train_micro_batch_size_per_gpu} x gas "
                 f"{self.config.gradient_accumulation_steps})", ranks=[0])

    # ---------------------------------------------------------------- helpers

    def _master(self) -> List[torch.Tensor]:
        """The tensors the optimizer updates: the fp32 master, or the
        parameters themselves (fp32 training, pure bf16); in a process
        group, this rank's slabs of them."""
        if self.dp is not None or self.keep_master:
            return self.master
        return [p.data for p in self._params]

    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._to_device(v) for v in batch)
        if isinstance(batch, (np.ndarray, torch.Tensor)):
            return torch.as_tensor(batch, device=self.device)
        return batch

    def _activation_checkpointing(self, model: nn.Module):
        """The ``activation_checkpointing`` section (JAX engine
        :295-331): for the in-tree ``Transformer`` with ``remat`` on, the
        model already segments per block; any other model's call becomes
        one checkpointed region under the selective "dots" policy. Returns
        that wrapped call, or None."""
        act = self.config.activation_checkpointing
        if not (act.partition_activations or act.number_checkpoints):
            return None
        if getattr(getattr(model, "cfg", None), "remat", False):
            return None
        from . import act_checkpoint
        act_checkpoint.configure(
            partition_activations=act.partition_activations,
            contiguous_checkpointing=act.contiguous_memory_optimization,
            num_checkpoints=act.number_checkpoints,
            checkpoint_in_cpu=act.cpu_checkpointing, profile=act.profile)
        log_dist("activation checkpointing: engine-level remat of the "
                 "model's call (policy=dots)", ranks=[0])
        return act_checkpoint.remat(
            lambda batch, kw: model(batch, **kw), policy_name="dots")

    def _apply(self, batch, train: bool):
        kw = {"train": train} if self._takes_train else {}
        if self._remat_apply is not None and train:
            return self._remat_apply(batch, kw)
        return self.module(batch, **kw)

    def _micro_backward(self, loss: torch.Tensor) -> None:
        """Backward of the scaled loss; the compute-dtype grads, cast to
        grad_accum_dtype, are added into the accumulator."""
        (loss.to(torch.float32) * self.scale_state.scale).backward()
        if self.dp is not None:
            self.dp.after_backward()
            self._accum = self.dp.accum
            return
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        if self._accum is None:     # takes over p.grad when dtypes agree
            self._accum = [g.to(self.grad_accum_dtype) for g in grads]
        else:
            for a, g in zip(self._accum, grads):
                a.add_(g.to(self.grad_accum_dtype))
        for p in self._params:
            p.grad = None

    def _current_lr(self) -> float:
        if self.lr_fn is None and self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "get_lr"):
            return float(self.lr_scheduler.get_lr()[0])
        return self.base_lr

    def _finalize_step(self, n_micro: int, losses: List[torch.Tensor]
                       ) -> Dict[str, Any]:
        """The step tail: unscale, overflow check, global norm, clip,
        optimize, loss-scale and skip bookkeeping."""
        denom = float(n_micro) * self.scale_state.scale
        grads = self._accum
        self._accum = None
        if self.dp is not None:
            # this rank's slabs; flag, norm and loss from one all-reduce
            grads = self.dp.step_grads(denom)
            finite_h, sq_h, loss_h = self.dp.step_stats(grads, losses)
        else:
            if all(g.dtype == torch.float32 for g in grads):
                torch._foreach_div_(grads, denom)
            else:
                grads = [g.to(torch.float32) / denom for g in grads]
            finite = torch.stack([torch.isfinite(g).all()
                                  for g in grads]).all()
            sq = torch.stack(torch._foreach_norm(grads)).square().sum()
            loss = torch.stack([x.detach().to(torch.float32)
                                for x in losses]).mean()
            # one host read a step: the overflow flag, the norm and the loss
            finite_h, sq_h, loss_h = torch.stack(
                [finite.to(torch.float32), sq, loss]).tolist()
        overflow = finite_h != 1.0
        norm = float(np.sqrt(sq_h)) if sq_h >= 0 else float("nan")
        skip = overflow
        clip = self.config.gradient_clipping
        lr = (float(self.lr_fn(self.step_count)) if self.lr_fn is not None
              else self._current_lr())
        if not skip:
            if clip > 0:
                coef = min(clip / (norm + 1e-6), 1.0)
                torch._foreach_mul_(grads, coef)
            master = self._master()
            self.optimizer.update(grads, self.opt_state, master,
                                  self.step_count, lr_t=lr)
            if self.dp is not None:
                self.dp.refresh_params()
            elif self.keep_master:
                for p, m in zip(self._params, master):
                    p.data.copy_(m)
        del grads
        old_scale = self.scale_state.scale
        self.scale_state = self.loss_scaler.update(self.scale_state, overflow)
        self.nonfinite_streak = self.nonfinite_streak + 1 if skip else 0
        self._skipped_steps += int(skip)
        self.step_count += 0 if skip else 1
        return {"loss": loss_h, "grad_norm": norm, "lr": lr,
                "overflow": skip, "loss_scale": old_scale,
                "nonfinite_streak": self.nonfinite_streak}

    def _after_step(self, metrics: Dict[str, Any]) -> None:
        self.global_steps += 1
        self.data_position += 1
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self._last_metrics = metrics
        if self.global_steps % self.config.steps_per_print == 0:
            msg = (f"step={self.global_steps} loss={metrics['loss']:.4f} "
                   f"lr={metrics['lr']:.3e} "
                   f"grad_norm={metrics['grad_norm']:.3f}")
            if self.config.wall_clock_breakdown and self._step_t0:
                msg += (f" train_batch_ms="
                        f"{1e3 * (time.perf_counter() - self._step_t0):.2f}")
            log_dist(msg, ranks=[0])

    # ------------------------------------------------------------ public API

    def train_batch(self, batch) -> Dict[str, Any]:
        """One global batch: gas x (forward + backward) of micro-batches,
        then the optimizer step. The batch's leading dim is
        train_batch_size; it is split [gas, W x micro] on the host, and
        this rank takes its contiguous ``micro`` rows of each (W = 1
        without a process group). Every rank is given the same global
        batch. Returns the metrics dict (loss, grad_norm, lr, overflow,
        loss_scale, nonfinite_streak) as host numbers; in a process group
        the loss is the global batch's."""
        if self.optimizer is None:
            raise RuntimeError(
                "engine has no optimizer: add an 'optimizer' section to the "
                "config or pass optimizer= to initialize()")
        if self._accum is not None or self._pending is not None:
            raise RuntimeError("train_batch() in the middle of a "
                               "forward/backward accumulation window")
        self._step_t0 = time.perf_counter()
        gas = self.config.gradient_accumulation_steps
        tb = self.config.train_batch_size

        def split(x, i):
            if isinstance(x, dict):
                return {k: split(v, i) for k, v in x.items()}
            if x.shape[0] != tb:
                raise ValueError(f"batch leading dim {x.shape[0]} != "
                                 f"train_batch_size {tb}")
            m = tb // (gas * self.dp_world_size)
            lo = (i * self.dp_world_size + self.dp_rank) * m
            return x[lo:lo + m]

        self.module.train()
        losses = []
        for i in range(gas):
            micro = self._to_device(split(batch, i))
            loss = self.loss_fn(self._apply(micro, True), micro)
            self._micro_backward(loss)
            losses.append(loss.detach())
            self.micro_steps += 1
        metrics = self._finalize_step(gas, losses)
        self._after_step(metrics)
        return metrics

    def eval_batch(self, batch):
        """The model's outputs on ``batch`` in eval mode, without grads."""
        self.module.eval()
        with torch.no_grad():
            return self._apply(self._to_device(batch), False)

    def train(self, mode: bool = True):
        """Training mode for the micro-batch API: forward() keeps the graph
        for backward()."""
        self._train_mode = bool(mode)
        return self

    def eval(self):
        return self.train(False)

    def forward(self, batch):
        """Loss of one micro-batch. In training mode (the default) the
        graph is kept for backward(); in eval mode it runs without
        grads."""
        batch = self._to_device(batch)
        if not self._train_mode:
            self.module.eval()
            with torch.no_grad():
                return self.loss_fn(self._apply(batch, False), batch)
        self.module.train()
        loss = self.loss_fn(self._apply(batch, True), batch)
        self._pending = loss
        return loss

    __call__ = forward

    def backward(self, loss=None):
        """Accumulate the grads of the last training forward's micro-batch
        (``loss`` defaults to it)."""
        if loss is None:
            loss = self._pending
        if loss is None:
            raise RuntimeError("backward() called before a training forward()")
        self._pending = None
        self._micro_backward(loss)
        self._accum_losses.append(loss.detach())
        self._micro_count += 1
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._micro_count >= self.config.gradient_accumulation_steps

    def step(self):
        """Apply the optimizer at the gas boundary; no-op otherwise."""
        if not self.is_gradient_accumulation_boundary():
            return None
        if self.optimizer is None:
            raise RuntimeError("engine has no optimizer")
        metrics = self._finalize_step(self._micro_count, self._accum_losses)
        self._accum_losses = []
        self._micro_count = 0
        self._after_step(metrics)
        return metrics

    def get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_lr()
        return [self.base_lr]

    def get_global_grad_norm(self) -> float:
        m = self._last_metrics.get("grad_norm")
        return float(m) if m is not None else 0.0

    def get_loss_scale(self) -> float:
        return float(self.scale_state.scale)

    @property
    def skipped_steps(self) -> int:
        return self._skipped_steps

    @property
    def train_batch_size(self):
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self.config.zero_optimization.stage

    def module_state_dict(self) -> Dict[str, np.ndarray]:
        """Name-keyed numpy view of the parameters: a ``Transformer``'s in
        the flax paths of the scan layout (``blocks/attn_qkv/kernel``
        [L, ...]), any other module's under its own parameter names."""
        if self.dp is not None:             # whole, for the copy
            with self.dp.gathered(self._params):
                return self._module_state_dict()
        return self._module_state_dict()

    def _module_state_dict(self) -> Dict[str, np.ndarray]:
        from ..models.transformer import Transformer
        if isinstance(self.module, Transformer):
            from ..models.convert import module_to_jax
            flat = {}

            def walk(node, prefix):
                for k, v in node.items():
                    if isinstance(v, dict):
                        walk(v, prefix + k + "/")
                    else:
                        flat[prefix + k] = v
            walk(module_to_jax(self.module), "")
            return flat
        return {n: p.detach().float().cpu().numpy()
                for n, p in self.module.named_parameters()}

    # ------------------------------------------------------------ checkpoints

    def _ckpt_leaves(self):
        """(params, master, moments) of the checkpoint as flat dicts of
        ``checkpointing.Leaf`` over the live tensors, keyed by the JAX
        package's paths: a ``Transformer``'s ``blocks.<i>.<leaf>.<name>``
        parameters (and their master and moments) stack into one
        ``blocks/<leaf>/<name>`` leaf; every other parameter keeps its
        own path (a ``Transformer``'s flax path, any other module's
        ``named_parameters`` name). Built once: the tensors are updated in
        place for the engine's life. In a process group each leaf is this
        rank's slab (``Leaf.split``: the parameter's pdim, the master's and
        moments' mdim), and the master is listed even where the
        checkpoint's master aliases the parameters: a load fills it from
        them."""
        if self._ckpt_cache is not None:
            return self._ckpt_cache
        from ..models.transformer import Transformer
        flax = isinstance(self.module, Transformer)
        index = {id(p): i for i, p in enumerate(self._params)}
        groups: Dict[str, list] = {}
        for name, p in self.module.named_parameters():
            parts = name.split(".")
            if flax and parts[0] == "blocks":
                path = "/".join(["blocks"] + parts[2:])
            else:
                path = "/".join(parts) if flax else name
            groups.setdefault(path, []).append(p)
        stacked = {path: flax and path.startswith("blocks/")
                   for path in groups}
        def split(p, kind):
            if self.dp is None or id(p) not in index:
                return None
            e = self.dp.entries[index[id(p)]]
            dim = e.pdim if kind == "param" else e.mdim
            return (None if dim is None
                    else (dim, self.dp_rank, self.dp_world_size))

        params = {path: ckpt_lib.Leaf(ps if stacked[path] else ps[0],
                                      stacked[path], split(ps[0], "param"))
                  for path, ps in groups.items()}

        def over(tensors):
            return {path: ckpt_lib.Leaf(
                [tensors[index[id(p)]] for p in ps] if stacked[path]
                else tensors[index[id(ps[0])]], stacked[path],
                split(ps[0], "master"))
                for path, ps in groups.items() if id(ps[0]) in index}

        master = (over(self.master)
                  if self.keep_master or self.dp is not None else None)
        moments = {f"{slot}/{path}": leaf
                   for slot in sorted(self.opt_state)
                   for path, leaf in over(self.opt_state[slot]).items()}
        self._ckpt_cache = (params, master, moments)
        return self._ckpt_cache

    def _ckpt_state(self) -> ckpt_lib.TrainState:
        params, master, moments = self._ckpt_leaves()
        return ckpt_lib.TrainState(
            params=params, master=master, opt_state=moments,
            step=self.step_count, skipped_steps=self._skipped_steps,
            nonfinite_streak=self.nonfinite_streak,
            loss_scale=self.scale_state.scale,
            scale_good_steps=self.scale_state.good_steps,
            scale_hysteresis=self.scale_state.hysteresis)

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None) -> str:
        """Write ``{save_dir}/{tag}`` (default ``global_step<N>``) in the
        JAX package's format through the ``checkpoint`` section's writer
        (sync, or ``async_save``); returns the tag's directory."""
        if not hasattr(self, "checkpoint_engine"):
            from ..checkpoint.engine import build_checkpoint_engine
            self.checkpoint_engine = build_checkpoint_engine(self.config)
        return self._save_checkpoint_with(self.checkpoint_engine, save_dir,
                                          tag, client_state)

    def _save_checkpoint_with(self, ckpt_engine, save_dir: str,
                              tag: Optional[str],
                              client_state: Optional[dict] = None) -> str:
        """The save with a given writer: ``global_steps``,
        ``data_position`` and the scheduler's ``state_dict`` join
        ``client_state``. In fp32 and pure-bf16 training the master is the
        parameters (``master_aliases_params``)."""
        if self._accum is not None or self._pending is not None:
            raise RuntimeError("save_checkpoint() in the middle of a "
                               "forward/backward accumulation window")
        tag = tag or f"global_step{self.global_steps}"
        client_state = dict(client_state or {})
        client_state["global_steps"] = self.global_steps
        client_state["data_position"] = self.data_position
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                     "state_dict"):
            client_state["lr_scheduler"] = self.lr_scheduler.state_dict()
        ckpt = self.config.checkpoint
        state = self._ckpt_state()
        if not self.keep_master:            # the file's master is params
            state.master = None
        save = (ckpt_lib.save_checkpoint if self.dp is None
                else ckpt_lib.save_checkpoint_sharded)
        return save(save_dir, tag, state, client_state,
                    master_aliases_params=not self.keep_master,
                    ckpt_engine=ckpt_engine, keep_last=ckpt.keep_last,
                    keep_every=ckpt.keep_every)

    def wait_for_checkpoints(self):
        """Durability barrier for async checkpointing; no-op with the sync
        writer. A truthy ``CommitResult`` on success; on failure it names
        the failed paths."""
        if hasattr(self, "checkpoint_engine"):
            return self.checkpoint_engine.commit("all")
        return True

    def close(self):
        """Drain and stop the async checkpoint writer (idempotent)."""
        if hasattr(self, "checkpoint_engine"):
            return self.checkpoint_engine.close()
        return True

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_module_only: bool = False):
        """Load a tag written by either package into this engine's live
        tensors (``tag=None``: the newest intact one, rolling back over
        corrupt tags; ``checkpoint.verify_load`` checks digests). The
        parameters, master, moments and the step / skip / loss-scale
        counters are restored; ``global_steps``, ``data_position`` and the
        scheduler too unless ``load_module_only``. Returns (load_dir,
        client_state)."""
        if self._accum is not None or self._pending is not None:
            raise RuntimeError("load_checkpoint() in the middle of a "
                               "forward/backward accumulation window")
        state, client_state = ckpt_lib.load_checkpoint(
            load_dir, tag, self._ckpt_state(),
            verify=self.config.checkpoint.verify_load)
        self.step_count = state.step
        self._skipped_steps = state.skipped_steps
        self.nonfinite_streak = state.nonfinite_streak
        self.scale_state = LossScaleState(
            scale=state.loss_scale, good_steps=state.scale_good_steps,
            hysteresis=state.scale_hysteresis)
        if not load_module_only:
            self.global_steps = client_state.get("global_steps", 0)
            # one global batch a step unless the checkpoint recorded better
            self.data_position = client_state.get("data_position",
                                                  self.global_steps)
            if self.lr_scheduler is not None and \
                    "lr_scheduler" in client_state:
                self.lr_scheduler.load_state_dict(client_state["lr_scheduler"])
        return load_dir, client_state

    def save_16bit_model(self, save_dir: str,
                         save_filename: str = "pytorch_model.npz") -> str:
        """The parameters in their compute dtype, name-keyed, in one npz
        (loadable by ``InferenceEngine.load_checkpoint`` of either
        package); in a process group they are gathered and rank 0 writes.
        Returns its path."""
        import os
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, save_filename)
        if self.dp is None:
            ckpt_lib.save_16bit_model(self._ckpt_state(), path)
            return path
        from .. import comm
        with self.dp.gathered(self._params):
            whole = {k: ckpt_lib.Leaf(leaf.parts if leaf.stacked
                                      else leaf.parts[0], leaf.stacked)
                     for k, leaf in self._ckpt_leaves()[0].items()}
            if self.dp_rank == 0:
                ckpt_lib.save_tree(whole, path)
        comm.barrier()
        return path

    def load_module_state_dict(self, state_dict: Dict[str, Any],
                               strict: bool = True) -> None:
        """Load weights only (the inverse of ``module_state_dict``): each
        present key is copied into the parameters and, with an fp32
        master, into the master too (else the next step would recompute
        the parameters from a stale master). Optimizer state and counters
        are untouched. ``strict=False`` keeps the current values of
        missing keys and ignores unexpected ones."""
        params, master, _ = self._ckpt_leaves()
        if strict:
            missing = sorted(set(params) - set(state_dict))
            unexpected = sorted(set(state_dict) - set(params))
            if missing or unexpected:
                raise KeyError(
                    f"state_dict mismatch: missing={missing[:5]} "
                    f"unexpected={unexpected[:5]} (strict=True)")
        for key, leaf in params.items():
            if key not in state_dict:
                continue
            value = ckpt_lib.to_tensor(state_dict[key])
            leaf.write(value)
            if master is not None and key in master:
                master[key].write(value)
