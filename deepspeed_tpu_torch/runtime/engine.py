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

Sequence parallelism (``sequence_parallel.sp_size > 1``, in a process
group): the ranks of a ``seq`` group take the same samples and each
keeps its chunk of every sequence (:meth:`DeepSpeedEngine._seq_chunk`);
the ``Transformer`` attends through ``parallel/ring_attention.py``; each
rank's loss is its share of the samples' mean, so gradients and the loss
are summed over ``seq`` and averaged over the data ranks. Dropout masks
come from seeds per step, micro-batch and data and seq rank
(:meth:`DeepSpeedEngine._dropout_seed`).

Mixture of experts (the ``moe`` section, with a model built with
``moe_experts``): ``ep_size`` splits the mesh's ``expert`` axis, each
rank holding its share of every expert leaf (``runtime/zero/
partition.py``); a ``make_moe_loss`` loss takes the model's ``(logits,
aux)``, each training call gets a gating seed per step, micro-batch and
rank (top-2's noise, :meth:`DeepSpeedEngine._gating_seed`), and the
metrics carry the step's mean ``aux``.

Tensor parallelism (``tensor_parallel.tp_size`` and
``sharding_rules=cfg.tp_rules()`` on a ``Transformer``, in a process
group): the mesh's ``model`` ranks share their samples, each holds its
shards of the TP leaves (``utils.partitioning``) and runs the Megatron
layers; ZeRO works on each rank's shards over the ZeRO axes only
(``runtime/zero/partition.py``); the step's flag, norm and loss reduce
over the whole group (a leaf whole on the model axis counted once). With
the in-tree losses the logits stay vocab-parallel (no rank forms [B, S,
V]); any other loss_fn gets them gathered. The TP layers run whenever a
process group is up and the rules are given, a model axis of one
included; ``sharding_rules=None`` keeps every weight whole on every
rank. MoE composes with it (the expert kernels' columns and rows over
``model`` within each rank's experts, ``moe/layer.py``), and so does
sequence parallelism (ring or Ulysses over each ``(data, model)``
coordinate's ``seq`` group, on the rank's local heads).

Run-side resilience (the JAX engine's hooks): the ``integrity``
section's ``TrainingSentinel`` (rung 1 skips a step whose raw grad norm
passes its ceiling, through the overflow skip's path; rung 2 rolls back
to the newest intact tag without rewinding ``data_position``; rung 3
raises ``TrainingIntegrityError``, rc 118), the cross-replica SDC audit
(:func:`state_checksum` of the leaves every data-parallel replica holds
whole, all-gathered over ``data`` through the counted comm facade), the
``watchdog`` section's phase deadlines with the rank's heartbeat record
(``DSTPU_HEARTBEAT_DIR``), the ``straggler`` detector,
:meth:`DeepSpeedEngine.install_preemption_handler` (SIGTERM -> emergency
save -> rc 114), the audited-clean resume and
:meth:`DeepSpeedEngine.fast_forward_dataloader`. The ``elasticity``
section is parsed and read by the runner's elastic agent, as in the JAX
package. The ``run.*`` and ``sentinel.*`` failpoints of
``testing/chaos.py`` fire at the train-batch entry.

Quantized training and compressed communication (the JAX engine's
wiring): ``compression_training`` and ``quantize_training`` (MoQ) become
one spec of transforms that the forward applies to the stacked leaves at
the optimizer step count (:meth:`DeepSpeedEngine._compress`);
``activation_quantization`` sets the model's ``activation_quant``
(:func:`wire_low_precision`); ``eigenvalue`` gives
:meth:`DeepSpeedEngine.compute_eigenvalue` and ``moq_rescale``.
``comm_plan`` resolves, at initialize, the grad sync's wire format
(override, plan, heuristic; outside :func:`grad_sync_envelope` it
degrades to exact with a warning): a quantized or chunked step has each
rank accumulate its own gradients over the micro-batches and sync each
leaf once (``comm.planned_grad_sync``), and the accuracy guard latches
a lossy format back to exact. The plan context is active around the
model's forward, where the MoE layer reads it for its queue exchange;
ZeRO-3 leaves gather in chunks (``overlap``) or in int8 under
``zero_quantized_weights`` (qwZ). The metrics carry ``grad_sync_algo``.

Everything else that a config can enable and this engine does not
implement raises ``NotImplementedError`` naming ROADMAP.md: CPU/NVMe
offload (and ``activation_checkpointing.cpu_checkpointing``), the 1-bit
optimizers, progressive layer drop, curriculum / data efficiency,
``mpu``, monitors and the other aux sections; so do compression under
TP, EP, a pipeline or ZeRO-3 in a process group, and
``compute_eigenvalue`` across ranks. Pipelines run in the ``PipelineEngine``
(``runtime/pipe/engine.py``), a subclass that ``initialize`` picks for a
``models.pipeline.PipelinedTransformer``; this engine refuses
``pipeline.stages > 1`` for any other model. Not ported either: the
offload load path (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..config.config import DeepSpeedConfig, load_config
from ..ops.optimizers import Optimizer, build_optimizer
from ..testing import chaos
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from . import checkpointing as ckpt_lib
from . import heartbeat as hb
from . import sentinel as sentinel_lib
from . import straggler as straggler_lib
from .sentinel import TrainingIntegrityError, TrainingSentinel
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


def _scale_floats(batch, factor):
    """``batch`` with every floating-point feature scaled by ``factor``
    (the ``sentinel.spike`` poisoned batch; integer ids pass through)."""
    if isinstance(batch, dict):
        return {k: _scale_floats(v, factor) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_scale_floats(v, factor) for v in batch)
    if isinstance(batch, torch.Tensor) and batch.is_floating_point():
        return batch * factor
    if isinstance(batch, np.ndarray) and np.issubdtype(batch.dtype,
                                                       np.floating):
        return batch * factor
    return batch


_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
_CHUNK = 1 << 24


def state_checksum(tensors: List[torch.Tensor]) -> int:
    """Bit-exact checksum of ``tensors`` (the JAX engine's audit
    program): each element's bits as an unsigned word, weighted by its
    position + 1 (two swapped elements cannot cancel), summed mod 2^32.
    Computed on the tensors' device in chunks; one host read."""
    total = None
    mask = 0xFFFFFFFF
    for t in tensors:
        flat = t.detach().reshape(-1)
        if flat.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        size = flat.element_size()
        words = flat.view(_WORDS[size])
        wmask = (1 << (8 * size)) - 1       # the word as unsigned
        for lo in range(0, words.numel(), _CHUNK):
            u = words[lo:lo + _CHUNK].to(torch.int64) & wmask
            w = torch.arange(lo + 1, lo + 1 + u.numel(), dtype=torch.int64,
                             device=u.device)
            part = ((u * w) & mask).sum() & mask
            total = part if total is None else (total + part) & mask
    return 0 if total is None else int(total.item())


def _flax_module(module: nn.Module) -> bool:
    """Whether ``module``'s parameters take the scan Transformer's flax
    paths (the ``Transformer``, the ``PipelinedTransformer``)."""
    from ..models.transformer import Transformer
    return isinstance(module, Transformer) or bool(
        getattr(module, "flax_layout", False))


def _leaf_path(name: str, flax: bool) -> str:
    """The checkpoint path of a parameter: a ``Transformer``'s
    ``blocks.<i>.<leaf>.<name>`` share the stacked ``blocks/<leaf>/<name>``
    and its other parameters take their flax path; any other module's
    keep their ``named_parameters`` name."""
    parts = name.split(".")
    if flax and parts[0] == "blocks":
        return "/".join(["blocks"] + parts[2:])
    return "/".join(parts) if flax else name


def unported_sections(config: DeepSpeedConfig) -> List[str]:
    """The enabled sections of ``config`` this engine does not implement."""
    c = config
    z = c.zero_optimization
    off = [o for o in (z.offload_optimizer, z.offload_param)
           if o is not None and o.device in ("cpu", "nvme")]
    act = c.activation_checkpointing
    checks = {
        "zero_optimization offload (offload_optimizer / offload_param)":
            bool(off),
        "progressive_layer_drop": c.progressive_layer_drop.enabled,
        "curriculum_learning": c.curriculum_learning.enabled,
        "data_efficiency": c.data_efficiency.enabled,
        "activation_checkpointing.cpu_checkpointing (host offload, "
        "ROADMAP item 5.2)": act.cpu_checkpointing,
        "amp": c.amp.enabled,
        "sparse_gradients": c.sparse_gradients,
        "monitors (tensorboard / wandb / csv_monitor)": (
            c.tensorboard.enabled or c.wandb.enabled or c.csv_monitor.enabled),
        "flops_profiler": c.flops_profiler.enabled,
        "autotuning": c.autotuning.enabled,
    }
    return [name for name, on in checks.items() if on]


def wire_attention_config(model: nn.Module, config: DeepSpeedConfig):
    """Map the ``sparse_attention`` and ``sequence_parallel`` sections onto
    the model's ``attention_impl`` (the JAX engine's
    ``wire_attention_config``; reference: runtime/config.py:270-453). The
    ``Transformer``'s config is replaced in place, on the module and on
    every block: ``attention_impl="sparse"`` with the parsed section as a
    sorted tuple, or, with ``sequence_parallel.sp_size > 1`` and
    ``attention_impl="auto"``, the section's ``mode`` ("ring" or
    "ulysses").

    Unknown sparse or sequence-parallel modes, the two sections together,
    ``sparse_attention`` on a model without a ``TransformerConfig`` and a
    conflicting hand-set ``attention_impl`` raise ``ValueError``: a parsed
    section silently running dense attention is a wrong answer. A model
    without a ``TransformerConfig`` under sequence parallelism, or a
    hand-set impl other than ring / ulysses, warns as in the JAX
    package."""
    sp = config.sequence_parallel
    if sp.mode not in ("ring", "ulysses"):
        raise ValueError(
            f"sequence_parallel.mode '{sp.mode}' is not supported; "
            "expected 'ring' or 'ulysses'")
    sa = config.sparse_attention
    from ..ops.sparse_attention import SPARSITY_CONFIGS
    if sa is not None and sa.mode not in SPARSITY_CONFIGS:
        raise ValueError(f"unknown sparse attention mode '{sa.mode}'; "
                         f"have {sorted(SPARSITY_CONFIGS)}")
    wants_sp = sp.sp_size > 1
    if sa is None and not wants_sp:
        return model
    from ..models.transformer import TransformerConfig
    mcfg = getattr(model, "cfg", None)
    if not isinstance(mcfg, TransformerConfig):
        if sa is not None:
            raise ValueError(
                "the sparse_attention config section requires the in-tree "
                "transformer family (models.build_model); this model has no "
                "TransformerConfig to wire the layout into")
        log_dist("sequence_parallel.sp_size > 1 with a non-in-tree model: "
                 "attention_impl cannot be auto-selected", ranks=[0],
                 level=logging.WARNING)
        return model
    updates = {}
    if sa is not None:
        if wants_sp:
            raise ValueError(
                "sparse_attention and sequence_parallel.sp_size > 1 cannot "
                "be combined (the layout-skip kernel is not sequence-"
                "parallel); drop one of the two sections")
        if mcfg.attention_impl not in ("auto", "sparse"):
            raise ValueError(
                f"sparse_attention config conflicts with the model's "
                f"hand-set attention_impl='{mcfg.attention_impl}'")
        items = tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in sa.model_dump().items()))
        updates = {"attention_impl": "sparse", "sparse_attention": items}
    elif mcfg.attention_impl == "auto":
        updates = {"attention_impl": sp.mode}
    elif mcfg.attention_impl in ("ring", "ulysses") \
            and mcfg.attention_impl != sp.mode:
        raise ValueError(
            f"sequence_parallel.mode='{sp.mode}' conflicts with the "
            f"model's hand-set attention_impl='{mcfg.attention_impl}'")
    elif mcfg.attention_impl not in ("ring", "ulysses"):
        # an explicit flash/reference/sparse impl wins, but the user asked
        # for sequence parallelism: do not leave the section silently dead
        log_dist(f"sequence_parallel.sp_size={sp.sp_size} with hand-set "
                 f"attention_impl='{mcfg.attention_impl}': no {sp.mode} "
                 "attention will run; set attention_impl='auto' to let the "
                 "config section select it", ranks=[0],
                 level=logging.WARNING)
    if not updates:
        return model
    blocks = getattr(model, "blocks", None)
    if not isinstance(blocks, (nn.ModuleList, nn.ModuleDict)):
        raise ValueError(f"cannot rebuild model {type(model).__name__} with "
                         f"attention_impl='{updates['attention_impl']}'")
    new_cfg = dataclasses.replace(mcfg, **updates)
    model.cfg = new_cfg
    for blk in (blocks.values() if isinstance(blocks, nn.ModuleDict)
                else blocks):
        blk.cfg = new_cfg
    log_dist(f"attention config wired: attention_impl="
             f"'{new_cfg.attention_impl}'", ranks=[0])
    return model


def wire_low_precision(model: nn.Module, config: DeepSpeedConfig):
    """Map ``compression_training.activation_quantization`` onto the
    model's ``activation_quant`` (the JAX engine's
    ``wire_low_precision``): the ``Transformer``'s config is replaced in
    place, on the module and on every block, with
    ``activation_quant="int8"``.

    The low-precision step is an experiment, not a default: it requires
    the integrity sentinel (``integrity.enabled``), so that a quantized
    step that degrades the loss rides the skip -> rollback -> abort
    ladder; a model built with ``activation_quant`` is held to the same
    gate. Bit widths other than 8, a schedule offset, a model without a
    ``TransformerConfig`` and a conflicting hand-set ``activation_quant``
    raise, with the JAX engine's words."""
    act = (config.compression_training.model_dump()
           .get("activation_quantization") or {})
    shared = act.get("shared_parameters") or {}
    from ..models.transformer import TransformerConfig
    mcfg = getattr(model, "cfg", None)
    if not shared.get("enabled", False):
        if isinstance(mcfg, TransformerConfig) and mcfg.activation_quant \
                and not config.integrity.enabled:
            raise ValueError(
                "activation_quant is a gated experiment: enable the "
                "integrity sentinel (config.integrity.enabled) so bad "
                "quantized steps hit the skip/rollback ladder")
        return model
    if int(shared.get("schedule_offset", 0)):
        raise NotImplementedError(
            "activation_quantization.schedule_offset is not supported for "
            "the low-precision step (the quant lives inside the model, "
            "which does not see the step counter)")
    bits_list = [int((g.get("params") or {}).get("bits", 8))
                 for g in (act.get("different_groups") or {}).values()]
    bits = min(bits_list) if bits_list else 8
    if bits != 8:
        raise ValueError(
            f"activation_quantization bits={bits}: only 8 (blockwise int8 "
            "fake-quant; fp8 emulation rides the model knob "
            "activation_quant='fp8')")
    if not isinstance(mcfg, TransformerConfig):
        raise ValueError(
            "activation_quantization requires the in-tree transformer "
            "family (models.build_model); this model has no "
            "TransformerConfig to wire activation_quant into")
    if not config.integrity.enabled:
        raise ValueError(
            "activation_quantization is a gated experiment: enable the "
            "integrity sentinel (config.integrity.enabled) so bad "
            "quantized steps hit the skip/rollback ladder")
    if mcfg.activation_quant not in (None, "int8"):
        raise ValueError(
            f"activation_quantization conflicts with the model's hand-set "
            f"activation_quant={mcfg.activation_quant!r}")
    blocks = getattr(model, "blocks", None)
    if not isinstance(blocks, nn.ModuleList):
        raise ValueError(
            f"cannot rebuild model {type(model).__name__} with "
            "activation_quant='int8'")
    new_cfg = dataclasses.replace(mcfg, activation_quant="int8")
    model.cfg = new_cfg
    for blk in blocks:
        blk.cfg = new_cfg
    log_dist("low-precision experiment wired: activation_quant='int8' "
             "(sentinel-gated)", ranks=[0])
    return model


def grad_sync_envelope(compression: bool, stage: int,
                       shape: Dict[str, int]):
    """(whether the comm plan's explicit grad sync, once a step, can
    replace the per-micro-batch reduction, why not): the JAX engine's
    envelope (:1056-1091) case by case. Data parallelism, optionally with
    TP, at ZeRO 0-2 and without compression; ``shape``: the mesh's axis
    sizes."""
    if compression:
        return False, ("compression_training is not threaded through "
                       "the stacked-grads step")
    if stage > 2:
        return False, ("ZeRO-3 shards compute params; the stacked "
                       "local-grad layout needs them whole per rank")
    if shape["expert"] != 1:
        return False, ("mesh axis 'expert' has size "
                       f"{shape['expert']}: expert-param "
                       "grads must not be mean-reduced over it")
    for ax in ("seq", "pipe"):
        if shape[ax] != 1:
            return False, (f"mesh axis '{ax}' has size {shape[ax]} "
                           "(data parallelism, optionally with TP, "
                           "required)")
    if shape["data"] <= 1:
        return False, "a single DP rank has nothing to sync"
    return True, ""


class DeepSpeedEngine:
    """``model``: an ``nn.Module`` whose ``forward(batch[, train=])``
    returns outputs that ``loss_fn(outputs, batch)`` turns into the scalar
    loss (default: the outputs are the loss), typically the port's
    ``Transformer``. ``model_parameters``: a flax-layout numpy tree for a
    ``Transformer`` (``models.convert.module_from_jax``); default the
    module's own parameters. ``device``: default CUDA; ``"cpu"`` runs the
    kernels' plain versions. ``sharding_rules``: None, or the model's
    ``cfg.tp_rules()`` (tensor parallelism, module docstring; any other
    table raises)."""

    #: set by the PipelineEngine, the engine of pipelined models
    _pipelined = False

    def __init__(self,
                 model: nn.Module,
                 config=None,
                 model_parameters=None,
                 loss_fn: Optional[Callable] = None,
                 optimizer: Optional[Optimizer] = None,
                 lr_scheduler=None,
                 mpu=None,
                 device=None,
                 sharding_rules=None):
        self.config: DeepSpeedConfig = load_config(config)
        bad = unported_sections(self.config)
        if bad:
            raise NotImplementedError(
                f"ds_config sections {bad}: enabled, but the section " + _LATER)
        if self.config.pipeline.stages > 1 and not self._pipelined:
            raise NotImplementedError(
                f"pipeline.stages {self.config.pipeline.stages} with a model "
                "other than models.pipeline.PipelinedTransformer (the JAX "
                "engine replicates such a model over the 'pipe' axis) "
                + _LATER)
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
        self.batch_rank, self.batch_world = 0, 1
        self.seq_rank, self.seq_world = 0, 1
        sp_size = self.config.sequence_parallel.sp_size
        moe = self.config.moe
        ep_size = moe.ep_size if moe.enabled else 1
        tp_size = self.config.tensor_parallel.tp_size
        mcfg = getattr(model, "cfg", None)
        if sharding_rules is not None:
            from ..models.transformer import TransformerConfig
            from ..utils.partitioning import check_tp_rules
            if not isinstance(mcfg, TransformerConfig):
                raise ValueError(
                    "sharding_rules need the in-tree Transformer (models."
                    "build_model): this model has no TransformerConfig")
            sharding_rules = check_tp_rules(
                sharding_rules, mcfg,
                model.tp_rules() if self._pipelined else None)
        for key, size in (("sequence_parallel.sp_size", sp_size),
                          ("moe.ep_size", ep_size),
                          ("tensor_parallel.tp_size", tp_size)):
            if size > 1 and not comm.is_initialized():
                raise ValueError(
                    f"{key} {size} needs a process group of a multiple of "
                    f"{size} ranks (launch the script with "
                    "launcher/launch.py, or call comm.init_distributed())")
        if comm.is_initialized():
            from ..parallel.mesh import (BATCH_AXES, ZERO_AXES,
                                         build_mesh_from_config,
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
                    self.mesh.world_size != comm.get_world_size() or \
                    self.mesh.shape["seq"] != sp_size or \
                    self.mesh.shape["expert"] != ep_size or \
                    self.mesh.shape["model"] != tp_size or \
                    self.mesh.shape["pipe"] != self.config.pipeline.stages:
                self.mesh = build_mesh_from_config(self.config)
            dp_world = self.mesh.axes_size(ZERO_AXES)
            dp_rank = self.mesh.axis_rank(ZERO_AXES)
            # the ranks that take distinct samples; a seq group shares them
            self.batch_world = self.mesh.axes_size(BATCH_AXES)
            self.batch_rank = self.mesh.axis_rank(BATCH_AXES)
            self.seq_world = self.mesh.axes_size("seq")
            self.seq_rank = self.mesh.axis_rank("seq")
        self.config.resolve_batch_sizes(dp_world_size=self.batch_world)
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
        # compression training (QAT, pruning) and MoQ: one spec of
        # transforms that the forward applies to the stacked leaves
        # (_compress); activation_quantization rewires the model below
        self.compression_spec, self._moq_enabled = self._compression(
            tp_size, ep_size)
        # the sparse_attention section rewires the model's attention_impl,
        # compression_training.activation_quantization its activation_quant
        model = wire_attention_config(model, self.config)
        model = wire_low_precision(model, self.config)
        self.module = model
        self.loss_fn = loss_fn or _default_loss_fn
        try:
            sig = inspect.signature(model.forward).parameters
        except (TypeError, ValueError):
            sig = {}
        self._takes_train = "train" in sig
        self._takes_seed = "dropout_seed" in sig
        self._takes_gating = "gating_seed" in sig
        self._moe_loss = bool(getattr(self.loss_fn, "_moe_loss", False))
        self._seq_labels = (self._sequence_parallel_labels(model)
                            if self.seq_world > 1 else None)
        self.tp = None
        self._vocab_parallel = False
        tp_of = None
        if self.mesh is not None and sharding_rules is not None:
            tp_of = self._tensor_parallel(model, sharding_rules)
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
                self.grad_accum_dtype, self.device, values,
                grad_world=self.batch_world, mesh=self.mesh, tp_of=tp_of,
                pipe_shared=(
                    [n for n, _ in model.named_parameters()
                     if not n.startswith("blocks.")]
                    if self.mesh.shape["pipe"] > 1 else None))
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

        # eigenvalue and the comm plan ---------------------------------------
        self.eigenvalue = None
        if self.config.eigenvalue.enabled:
            from .eigenvalue import Eigenvalue
            ev = self.config.eigenvalue
            self.eigenvalue = Eigenvalue(
                verbose=ev.verbose, max_iter=ev.max_iter, tol=ev.tol,
                stability=ev.stability,
                gas_boundary_resolution=ev.gas_boundary_resolution,
                layer_name=ev.layer_name, layer_num=ev.layer_num)
        self._moq_scheduler = None
        self._compressed: List[tuple] = []      # see _compress
        self._comp_leaves = None
        self.comm_plan_ctx = None
        self._cp_guard = None
        self._grad_sync_algo = "exact"
        if self.config.zero_optimization.zero_quantized_weights:
            if self.config.zero_optimization.stage != 3:
                raise ValueError("zero_quantized_weights needs ZeRO stage 3 "
                                 "(it quantizes the stage-3 param gathers)")
            if self.dp is not None:
                self.dp.quantize_gathers(self.config.comm_plan.quant_bits)
        if self.config.comm_plan.enabled:
            self._comm_plan()

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
        self._auxes: List[torch.Tensor] = []    # MoE aux, see _loss
        self._micro_count = 0
        self._pending = None
        self._train_mode = True
        # preemption: set inside a step; a SIGTERM there defers its save
        # to the step's end (see install_preemption_handler)
        self._in_step = False
        self._preempt_pending = None
        self._last_metrics: Dict[str, Any] = {}
        self._step_t0 = None
        # global batches consumed since data start (one a step), kept in
        # the checkpoint's client_state
        self.data_position = 0
        self._ckpt_cache = None             # see _ckpt_leaves
        self._groups = None                 # see _leaf_groups
        self._init_resilience()
        where = ("one process" if self.dp is None else
                 f"data parallel over {dp_world} rank(s)")
        if self.seq_world > 1:
            where += (f", {self.seq_world} sequence chunks "
                      f"({self.module.cfg.attention_impl})")
        if ep_size > 1:
            where += f", experts split over {ep_size} ranks"
        if self.tp is not None:
            where += f", tensor parallel over {self.tp.size} rank(s)"
        log_dist(f"DeepSpeedEngine initialized: ZeRO stage "
                 f"{self.config.zero_optimization.stage} ({where}), "
                 f"dtype {self.config.precision_dtype}, device {self.device}, "
                 f"batch {self.config.train_batch_size} (micro "
                 f"{self.config.train_micro_batch_size_per_gpu} x gas "
                 f"{self.config.gradient_accumulation_steps})", ranks=[0])

    # ------------------------------------------------------------ resilience

    def _init_resilience(self) -> None:
        """The training-integrity sentinel, the phase-aware watchdog with
        the rank's heartbeat record, and the straggler detector (the JAX
        engine's set-up, :635-724)."""
        from .. import comm
        # host detector over the step's statistics and the remediation
        # ladder (skip -> rollback -> abort); the non-finite streak abort
        # lives inside observe()
        self.sentinel = TrainingSentinel(self.config.integrity)
        # the rollback source: the last dir saved to or loaded from; an
        # explicit integrity.load_dir always wins at rollback time
        self._ckpt_dir: Optional[str] = self.config.integrity.load_dir
        integ = self.config.integrity
        if self.sentinel.enabled or integ.audit_interval > 0:
            log_dist(f"integrity sentinel: metrics={integ.metrics} "
                     f"zmax={integ.zmax} skip={integ.skip} "
                     f"rollback_after={integ.rollback_after} "
                     f"audit_interval={integ.audit_interval}", ranks=[0])
        # lifecycle phases (RESTORE -> COMPILE -> STEP -> SAVE), each
        # with its own deadline; the heartbeat writer (opt-in through
        # DSTPU_HEARTBEAT_DIR, which the runner's --heartbeat_dir
        # exports) mirrors every transition to the rank's record
        self.heartbeat = hb.HeartbeatWriter.from_env(
            rank=comm.get_rank() if comm.is_initialized() else 0)
        self._step_phase_reached = False
        self.watchdog = None
        wd = self.config.watchdog
        pre_step = {hb.PHASE_COMPILE: wd.compile_timeout,
                    hb.PHASE_RESTORE: wd.restore_timeout,
                    hb.PHASE_SAVE: wd.save_timeout}
        if wd.stall_timeout > 0 or any(t > 0 for t in pre_step.values()):
            from .watchdog import StallWatchdog
            self.watchdog = StallWatchdog(
                wd.stall_timeout or 0.0,
                poll_interval=wd.poll_interval or None,
                phase_timeouts=pre_step, heartbeat=self.heartbeat,
                phase=hb.PHASE_INIT)
            if any(t > 0 for t in pre_step.values()):
                # a compile or restore hang is bounded before the first
                # completed step; INIT itself stays unbounded here
                self.watchdog.start()
            log_dist(f"watchdog configured: stall={wd.stall_timeout}s "
                     f"compile={wd.compile_timeout}s "
                     f"restore={wd.restore_timeout}s "
                     f"save={wd.save_timeout}s", ranks=[0])
        if self.heartbeat is not None:
            self.heartbeat.write(hb.PHASE_INIT, 0, force=True)
        # the rolling step_ms gauge rides every STEP record; the
        # cross-rank detector is opt-in and acts on verdicts against
        # this rank only (flag, then rc 117 with straggler.abort_after)
        self._step_clock = straggler_lib.StepClock(
            window=self.config.straggler.window)
        self.straggler: Optional[straggler_lib.StragglerDetector] = None
        self._straggler_next_check = 0.0
        self._straggler_flagged = False
        if self.config.straggler.enabled and self.heartbeat is not None:
            st = self.config.straggler
            self.straggler = straggler_lib.StragglerDetector(st)
            log_dist(f"straggler detector: zmax={st.zmax} "
                     f"rel_threshold={st.rel_threshold} "
                     f"strike_window={st.strike_window} "
                     f"abort_after={st.abort_after}"
                     + (" (evidence-only)" if st.abort_after <= 0 else ""),
                     ranks=[0])

    def _report_phase(self, phase: str) -> None:
        """Move the watchdog clock into ``phase`` and mirror the
        transition to the rank's heartbeat record."""
        if self.watchdog is not None:
            self.watchdog.start().enter_phase(phase, step=self.global_steps)
        if self.heartbeat is not None:
            self.heartbeat.write(phase, self.global_steps, force=True)
        if phase != hb.PHASE_STEP:
            # a non-step phase's gap is not a step of the step_ms gauge
            self._step_clock.reset()

    def _phase_scope(self, phase: str):
        """Bracket a bounded lifecycle section (RESTORE / SAVE): the
        phase's own deadline applies inside, and the previous phase
        resumes with a fresh clock on exit."""
        if self.heartbeat is not None:
            self.heartbeat.write(phase, self.global_steps, force=True)
        self._step_clock.reset()
        if self.watchdog is not None:
            self.watchdog.start()
            return self.watchdog.phase_scope(phase)
        return contextlib.nullcontext()

    def _step_entry(self, batch):
        """The train-batch entry of every engine (JAX :1487-1510): the
        run failpoints, the ``sentinel.spike`` poisoned batch (its float
        features scaled by the armed factor) and, before the first
        completed step, the COMPILE phase. Returns the batch to train
        on."""
        chaos.failpoint("run.kill")
        chaos.failpoint("run.preempt")
        chaos.failpoint("run.hang")
        # degraded, not dead: sleep mode makes this rank slow
        chaos.failpoint("run.slow")
        spike = chaos.flag("sentinel.spike")
        if spike is not None:
            batch = _scale_floats(batch, spike)
        if not self._step_phase_reached:
            # first entry to the first completed step: the kernels'
            # first builds and the first step, bounded by compile_timeout
            self._report_phase(hb.PHASE_COMPILE)
            chaos.failpoint("run.compile_hang")
        return batch

    def _maybe_check_straggler(self) -> None:
        """Worker-side straggler ladder at ``straggler.check_interval``
        cadence: read the shared heartbeat channel, run the cross-rank
        detector, act on verdicts against THIS rank (the STRAGGLER flag,
        then rc 117 past ``straggler.abort_after``)."""
        det = self.straggler
        if det is None:
            return
        now = time.monotonic()
        if now < self._straggler_next_check:
            return
        self._straggler_next_check = now + \
            self.config.straggler.check_interval
        records = hb.read_heartbeats(self.heartbeat.directory)
        mine = det.observe(records).get(self.heartbeat.rank)
        if mine is None:
            return
        if not self._straggler_flagged:
            self._straggler_flagged = True
            logger.error(
                "straggler: this rank's step time is %s MADs above the "
                "world median for %d consecutive windows — stamping the "
                "STRAGGLER heartbeat flag (host %s)",
                self.config.straggler.zmax,
                self.config.straggler.strike_window, self.heartbeat.host)
            self.heartbeat.add_flag(straggler_lib.STRAGGLER_FLAG,
                                    lock_timeout=5.0)
        if mine == straggler_lib.ABORT:
            self.heartbeat.stamp_terminal(hb.PHASE_STALLED,
                                          lock_timeout=5.0)
            raise straggler_lib.StragglerAbort(
                f"rank {self.heartbeat.rank} ({self.heartbeat.host}) "
                f"persistently slow past straggler.abort_after="
                f"{self.config.straggler.abort_after} windows — exiting "
                f"rc {straggler_lib.STALL_EXIT_CODE} so the elastic agent "
                "relaunches the world without this host")

    def _sentinel_rollback(self) -> None:
        """Remediation rung 2: restore the newest intact checkpoint via
        the verified loader; the data position is NOT rewound, so the
        poisoned span is skipped, not replayed."""
        load_dir = self.config.integrity.load_dir or self._ckpt_dir
        if not load_dir:
            raise TrainingIntegrityError(
                "sentinel rollback requested (strikes: "
                f"{self.sentinel.last_anomaly}) but no checkpoint directory "
                "is known — set integrity.load_dir or save a checkpoint "
                "before enabling the rollback rung")
        from_step = self.global_steps
        position = self.data_position
        logger.error(
            "integrity sentinel: rolling back from step %d (%s) to the "
            "newest intact checkpoint under %s", from_step,
            self.sentinel.last_anomaly, load_dir)
        try:
            # newest intact, not the audited-clean preference: an in-run
            # anomaly rollback targets the latest intact tag
            tag = ckpt_lib.resolve_load_tag(
                load_dir, check_digests=self.config.checkpoint.verify_load)
            self.load_checkpoint(load_dir, tag=tag)
        except (FileNotFoundError, OSError,
                ckpt_lib.CheckpointIntegrityError) as e:
            raise TrainingIntegrityError(
                f"sentinel rollback from step {from_step} failed: no intact "
                f"checkpoint under {load_dir} ({e}); aborting with rc "
                f"{sentinel_lib.INTEGRITY_EXIT_CODE}") from e
        self.data_position = position
        self.sentinel.note_rollback(self.global_steps)
        log_dist(
            f"integrity sentinel: rolled back to step {self.global_steps} "
            f"(tag {tag}); data pipeline continues at batch {position} — "
            "the poisoned span is skipped, not replayed", ranks=[0])

    def fast_forward_dataloader(self, loader, batches_per_step: int = 1):
        """Position ``loader`` past the data this engine's (restored)
        state already consumed: ``data_position`` global batches, kept
        in the checkpoint's client state. ``batches_per_step`` scales for
        loaders yielding micro-batches. Returns the batches skipped."""
        ff = getattr(loader, "fast_forward", None)
        if ff is None:
            raise TypeError(
                f"{type(loader).__name__} has no fast_forward(n); wrap it "
                "in deepspeed_tpu_torch.runtime.dataloader.RepeatingLoader "
                "or use DeepSpeedDataLoader")
        n = self.data_position * int(batches_per_step)
        ff(n)
        return n

    # -- cross-replica SDC audit ---------------------------------------------

    def _maybe_sdc_audit(self) -> None:
        iv = self.config.integrity.audit_interval
        if iv <= 0 or self.global_steps % iv != 0:
            return
        self._run_sdc_audit()

    def _audit_state_leaves(self) -> List[tuple]:
        """(name, tensor) of every state tensor that each data-parallel
        replica holds whole and identically: the compute parameters,
        master and moments of a leaf no ZeRO, expert or TP split cuts.
        A split leaf's bytes differ between ranks legitimately. Scalars
        are left out."""
        if self.dp is not None:
            whole = [e.pdim is None and e.eslab is None and e.tp is None
                     for e in self.dp.entries]
            mwhole = [e.mdim is None and e.eslab is None and e.tp is None
                      for e in self.dp.entries]
        else:
            whole = mwhole = [True] * len(self._params)
        out = [(f"params/{i}", p.data) for i, p in enumerate(self._params)
               if whole[i]]
        master = self._master()
        if master is not None and (self.keep_master or self.dp is not None):
            out += [(f"master/{i}", m) for i, m in enumerate(master)
                    if mwhole[i]]
        for slot in sorted(self.opt_state):
            out += [(f"{slot}/{i}", t)
                    for i, t in enumerate(self.opt_state[slot])
                    if i < len(mwhole) and mwhole[i]]
        return [(k, t) for k, t in out
                if t.dim() > 0 and t.element_size() in (1, 2, 4)]

    def _run_sdc_audit(self) -> None:
        """One cross-replica audit: this rank's checksum of its auditable
        state, all-gathered over the data-parallel replicas through the
        counted comm facade, a majority vote, and on a minority replica
        the SDC flag and the rc-118 abort. Runs every
        ``audit_interval`` steps, never on the step path otherwise."""
        from .. import comm
        rank = comm.get_rank() if comm.is_initialized() else 0
        # chaos: silent corruption of this rank's bytes, keyed by rank
        if chaos.flag("sentinel.sdc", key=str(rank)) is not None:
            self._inject_sdc_bitflip()
        named = self._audit_state_leaves()
        if not named:
            logger.warning(
                "integrity.audit_interval is set but no state leaf is held "
                "whole by every replica (ZeRO-3 shards everything): the "
                "cross-replica SDC audit has nothing to compare")
            return
        local = torch.tensor([rank, state_checksum([t for _, t in named])],
                             dtype=torch.int64, device=self.device)
        if self.dp is not None:
            rows = comm.all_gather(local.view(1, 2), axis="data")
        else:
            rows = local.view(1, 2)
        pairs = [(f"proc{int(r)}/dev0", int(v)) for r, v in rows.tolist()]
        bad = sentinel_lib.compare_replica_checksums(pairs)
        if not bad:
            self.sentinel.note_clean_audit(self.global_steps)
            if self._ckpt_dir:
                tag = ckpt_lib.get_latest_tag(self._ckpt_dir)
                if tag:
                    # the newest tag existed under a clean audit: the
                    # resume point of a post-SDC relaunch
                    sentinel_lib.write_last_audited_clean(self._ckpt_dir,
                                                          tag)
            return
        mine = f"proc{rank}/"
        logger.error(
            "integrity audit: cross-replica checksum MISMATCH at step %d — "
            "implicated replicas: %s (checksums: %s)", self.global_steps,
            bad, pairs)
        if self.heartbeat is not None and any(k.startswith(mine)
                                              for k in bad):
            self.heartbeat.add_flag(sentinel_lib.SDC_FLAG,
                                    step=self.global_steps,
                                    lock_timeout=2.0)
        raise TrainingIntegrityError(
            f"cross-replica SDC detected at step {self.global_steps}: "
            f"replica checksums diverged (implicated: {bad}). The live "
            "state is not trustworthy; relaunch resumes from the last "
            "audited-clean checkpoint")

    def _inject_sdc_bitflip(self) -> None:
        """Chaos only: flip one bit of this rank's copy of the first
        auditable parameter (a device silently corrupting memory; the
        other replicas keep the true bytes)."""
        named = self._audit_state_leaves()
        if not named:
            return
        name, t = next(((k, v) for k, v in named if k.startswith("params/")),
                       named[0])
        with torch.no_grad():
            t.view(-1).view(torch.uint8)[0] ^= 1
        logger.warning("chaos sentinel.sdc: flipped one bit of %s", name)

    # -- preemption ----------------------------------------------------------

    def _emergency_save(self, save_dir: str,
                        client_state: Optional[dict] = None) -> str:
        """Preemption-time save: drain pending async writes, then write
        synchronously. A drained save that already published an intact
        tag of this step is not rewritten."""
        from ..checkpoint.engine import NpzCheckpointEngine
        drained_ok = True
        if hasattr(self, "checkpoint_engine"):
            try:
                drained_ok = bool(self.checkpoint_engine.commit(
                    "preempt-drain"))
            except Exception as e:       # a failed past save must not
                drained_ok = False       # block THIS save
                logger.error("preempt: drain of pending checkpoint "
                             "writes failed: %s", e)
        tag = f"global_step{self.global_steps}"
        if drained_ok and ckpt_lib.get_latest_tag(save_dir) == tag:
            path = os.path.join(save_dir, tag)
            if ckpt_lib.verify_tag(path) is None:
                log_dist(f"preempt: drained in-flight save already "
                         f"published intact {tag}; skipping the duplicate "
                         "emergency write", ranks=[0])
                return path
        client_state = dict(client_state or {})
        client_state["preempted"] = True
        return self._save_checkpoint_with(NpzCheckpointEngine(), save_dir,
                                          None, client_state)

    def install_preemption_handler(self, save_dir: str,
                                   grace_secs: float = 30.0,
                                   client_state: Optional[dict] = None,
                                   exit_fn=None):
        """SIGTERM / SIGINT -> emergency synchronous checkpoint -> exit
        with ``PREEMPTION_EXIT_CODE`` (114: the elastic agent resumes
        without counting a restart). ``grace_secs`` is a hard deadline:
        past it a timer still exits 114 (the previous intact tag carries
        the restart); a second signal exits at once. Returns the handler
        (tests call it directly).

        The save needs the step's state whole. A signal that lands inside
        a step (between its micro-batches, or between the optimizer's
        updates of the moments and of the params) only arms the deadline
        and stamps the heartbeat; the save and the exit follow at the
        step's end (``_step_boundary``), with the state of the step the
        signal interrupted. Between steps they run at once."""
        import signal
        import threading
        from ..exit_codes import PREEMPTION_EXIT_CODE
        exit_fn = exit_fn or os._exit
        state = {"fired": False}

        def _handler(signum=None, frame=None):
            if state["fired"]:
                exit_fn(PREEMPTION_EXIT_CODE)
                return
            state["fired"] = True
            if self.watchdog is not None:
                # the grace window is save time, not step time
                self.watchdog.suspend()
            # the timer arms first: the heartbeat stamp and the save can
            # block on dead storage, and only it guarantees the rc-114 exit
            timer = threading.Timer(max(grace_secs, 0.1),
                                    lambda: exit_fn(PREEMPTION_EXIT_CODE))
            timer.daemon = True
            timer.start()
            if self.heartbeat is not None:
                # bounded lock: the signal may have landed inside a
                # heartbeat write on this same thread
                self.heartbeat.write(hb.PHASE_PREEMPTED, self.global_steps,
                                     force=True, lock_timeout=2.0)
            log_dist(f"preemption (signal {signum}): emergency checkpoint "
                     f"to {save_dir} within {grace_secs}s", ranks=[0])

            def save_and_exit():
                try:
                    self._emergency_save(save_dir, client_state)
                except Exception as e:
                    logger.error("emergency save failed: %s — exiting with "
                                 "the resume rc anyway (previous checkpoint "
                                 "stands)", e)
                finally:
                    timer.cancel()
                    exit_fn(PREEMPTION_EXIT_CODE)

            if (self._in_step or self._accum is not None
                    or self._pending is not None):
                self._preempt_pending = save_and_exit
                return
            save_and_exit()

        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
        return _handler

    def _prefer_audited_clean(self, load_dir: str,
                              tag: Optional[str]) -> Optional[str]:
        """With the SDC audit on, a ``tag=None`` resume prefers the
        ``last_audited_clean`` marker over ``latest``: tags written after
        the last clean audit may carry the corruption it later caught. An
        explicit tag is never overridden; a marker naming a missing or
        corrupt tag falls back to the newest intact one."""
        if tag is not None or self.config.integrity.audit_interval <= 0:
            return tag
        clean = sentinel_lib.read_last_audited_clean(load_dir)
        if not clean:
            return None
        reason = ckpt_lib.verify_tag(
            os.path.join(load_dir, clean),
            check_digests=self.config.checkpoint.verify_load)
        if reason is not None:
            logger.warning(
                "integrity: last_audited_clean names %r but it fails "
                "verification (%s); resuming from newest intact instead",
                clean, reason)
            return None
        log_dist(f"integrity: resuming from last audited-clean checkpoint "
                 f"'{clean}'", ranks=[0])
        return clean

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

    def _sequence_parallel_labels(self, model: nn.Module) -> str:
        """How a sequence-parallel chunk's labels are cut: "causal"
        (next-token labels shifted on the whole sample) or "masked" (the
        labels as given). Each rank's loss must be its share of the
        whole samples' mean, which the in-tree losses compute from the
        engine's ``shifted_labels`` / ``label_count``; any other loss
        would see one chunk as if it were the sample, so it raises."""
        from ..models import transformer as tr
        cfg = getattr(model, "cfg", None)
        loss_fn = getattr(self.loss_fn, "_moe_base_loss", self.loss_fn)
        if not isinstance(cfg, tr.TransformerConfig):
            raise ValueError(
                "sequence_parallel.sp_size > 1 runs the in-tree Transformer "
                "(models.build_model); this model has no TransformerConfig")
        if cfg.rope_scaling_type == "dynamic":
            raise NotImplementedError(
                "sequence_parallel.sp_size > 1 with dynamic rope scaling: its "
                "table follows the whole sequence's length, which a rank's "
                "chunk does not see (ROADMAP.md Queue 3)")
        if loss_fn is tr.masked_lm_loss:
            return "masked"
        if loss_fn is tr.causal_lm_loss:
            return "causal"
        if cfg.fused_loss and loss_fn in (tr.fused_loss_passthrough,
                                          _default_loss_fn):
            return "causal" if cfg.causal else "masked"
        raise ValueError(
            "sequence_parallel.sp_size > 1 needs loss_fn causal_lm_loss, "
            "masked_lm_loss or a fused_loss model (fused_loss_passthrough): "
            "a rank holds one chunk of each sequence, and these take the "
            "engine's labels cut on the whole sample")

    def _tensor_parallel(self, model: nn.Module, rules):
        """Run ``model`` (a ``Transformer``) as this rank's shards on the
        mesh's ``model`` axis, its TP context set. An in-tree loss
        (``causal_lm_loss``, ``masked_lm_loss``) is given this context and
        the model's vocab-parallel logits (``_vocab_parallel``); every
        other caller of the model gets the gathered logits. Returns the
        partition's ``tp_of(parameter name, whole shape)``: the TP spec
        and every model rank's ``TPShard`` of a leaf the rules shard,
        else None."""
        from ..models import transformer as tr
        from ..utils.partitioning import TPContext, spec_for, tp_shard
        cfg = model.cfg
        size = self.mesh.shape["model"]
        self.tp = TPContext(self.mesh.axis_rank("model"), size,
                            cfg.vocab_size)
        model.set_tp(self.tp)
        self._vocab_parallel = self.loss_fn in (tr.causal_lm_loss,
                                                tr.masked_lm_loss)

        def tp_of(name, shape):
            path = _leaf_path(name, True)
            spec = spec_for(path, rules)
            if tp_shard(path, shape, spec, cfg, 0, size) is None:
                return None
            spec = tuple(spec)[-len(shape):]
            return spec, [tp_shard(path, shape, spec, cfg, r, size)
                          for r in range(size)]
        return tp_of

    def _seq_chunk(self, batch):
        """This rank's chunk of a micro-batch under sequence parallelism:
        every [B, S, ...] tensor cut along S (S % sp == 0), plus the
        loss's ``shifted_labels`` / ``label_count`` (see
        ``models.transformer.Transformer``, which takes the chunk's
        global positions). The batch as given at seq-world 1."""
        if self.seq_world == 1:
            return batch
        if not isinstance(batch, dict):
            batch = {"input_ids": batch}
        ids = torch.as_tensor(batch["input_ids"])
        B, S = ids.shape
        sp, r = self.seq_world, self.seq_rank
        if S % sp:
            raise ValueError(f"sequence length {S} does not split into "
                             f"{sp} sequence-parallel chunks")
        Sl = S // sp
        full = dict(batch)
        labels = torch.as_tensor(full.get("labels", ids))
        if self._seq_labels == "causal":
            labels = torch.cat([labels[:, 1:], torch.full(
                (B, 1), -100, dtype=labels.dtype, device=labels.device)],
                dim=1)
            full["shifted_labels"] = labels
        full["label_count"] = (labels != -100).sum().to(torch.float32)
        out = {}
        for k, v in full.items():
            if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 2 \
                    and v.shape[1] == S:
                v = torch.as_tensor(v)[:, r * Sl:(r + 1) * Sl]
            out[k] = v
        return out

    def _leaf_groups(self) -> List[int]:
        """The checkpoint leaf of each trainable tensor, as an index: a
        ``Transformer``'s per-block tensors of one name share the stacked
        ``blocks/<leaf>/<name>`` leaf of the JAX package (LAMB's norms are
        that leaf's)."""
        if self._groups is None:
            flax = _flax_module(self.module)
            index = {id(p): i for i, p in enumerate(self._params)}
            groups, ids = list(range(len(self._params))), {}
            for name, p in self.module.named_parameters():
                if id(p) in index:
                    groups[index[id(p)]] = ids.setdefault(
                        _leaf_path(name, flax), len(ids))
            self._groups = groups
        return self._groups

    def _dropout_seed(self, micro: int) -> int:
        """The seed of one micro-batch's dropout masks: the config seed,
        the step, the micro-batch and this rank's data and seq
        coordinates, as the JAX engine folds its key."""
        from ..models.transformer import mix_seed
        gas = self.config.gradient_accumulation_steps
        return mix_seed(self.config.seed, self.global_steps * gas + micro,
                        self.batch_rank, self.seq_rank)

    def _gating_seed(self, micro: int) -> int:
        """The seed of one micro-batch's MoE gating noise (the JAX
        engine's "gating" stream, which it passes in every training
        step): like the dropout seed, a stream of its own."""
        from ..models.transformer import mix_seed
        gas = self.config.gradient_accumulation_steps
        return mix_seed(self.config.seed, 0x67617465,
                        self.global_steps * gas + micro, self.batch_rank,
                        self.seq_rank)

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

    def _apply(self, batch, train: bool, micro: int = 0,
               for_loss: bool = False):
        """The model's outputs on ``batch``; ``for_loss``: for
        :meth:`_loss`, which under TP takes vocab-parallel logits."""
        kw = {"train": train} if self._takes_train else {}
        if for_loss and self._vocab_parallel:
            kw["vocab_parallel"] = True
        if train and self._takes_seed:
            kw["dropout_seed"] = self._dropout_seed(micro)
        if train and self._takes_gating:
            kw["gating_seed"] = self._gating_seed(micro)
        if self.compression_spec is not None and self.compression_spec.groups:
            self._compress()
        from ..comm_plan.runtime import use_context
        with use_context(self.comm_plan_ctx):
            if self._remat_apply is not None and train:
                return self._remat_apply(batch, kw)
            return self.module(batch, **kw)

    def _loss(self, outputs, batch) -> torch.Tensor:
        """``loss_fn(outputs, batch)``. A MoE loss's outputs carry the
        routers' aux loss, kept for the step's metrics; each rank's aux is
        its own gating group's, so under sequence parallelism, where the
        ranks of a seq group sum their losses, it enters as its share
        (aux / sp): the step then weighs the mean over every group, as
        the JAX model's mean over its groups does."""
        if self._moe_loss:
            logits, aux = outputs
            self._auxes.append(aux.detach().to(torch.float32))
            if self.seq_world > 1:
                outputs = (logits, aux / self.seq_world)
        return self._loss_of(outputs, batch)

    def _loss_of(self, outputs, batch) -> torch.Tensor:
        if self._vocab_parallel:
            return self.loss_fn(outputs, batch, tp=self.tp)
        return self.loss_fn(outputs, batch)

    def _micro_backward(self, loss: torch.Tensor) -> None:
        """Backward of the scaled loss; the compute-dtype grads, cast to
        grad_accum_dtype, are added into the accumulator."""
        (loss.to(torch.float32) * self.scale_state.scale).backward()
        self._drop_compressed()
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
        auxes, self._auxes = self._auxes, []
        aux_h = None
        if self.dp is not None:
            # this rank's slabs; flag, norm and loss from one all-reduce
            grads = self.dp.step_grads(denom)
            finite_h, sq_h, loss_h, aux_h = self.dp.step_stats(
                grads, losses, auxes)
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
            # one host read a step: the overflow flag, the norm, the loss
            # (and a MoE model's aux)
            read = [finite.to(torch.float32), sq, loss]
            if auxes:
                read.append(torch.stack(auxes).mean())
            finite_h, sq_h, loss_h, *rest = torch.stack(read).tolist()
            aux_h = rest[0] if rest else None
        overflow = finite_h != 1.0
        norm = float(np.sqrt(sq_h)) if sq_h >= 0 else float("nan")
        # sentinel rung 1: a raw global norm past the ceiling skips the
        # step through the overflow skip's keep-old-state path
        limit = self.sentinel.spike_limit()
        spiked = bool(limit is not None and norm > limit)
        skip = overflow or spiked
        integ = self.config.integrity
        wants = ([m for m in ("update_norm", "param_norm")
                  if m in integ.metrics] if integ.enabled else [])
        before = None
        clip = self.config.gradient_clipping
        lr = (float(self.lr_fn(self.step_count)) if self.lr_fn is not None
              else self._current_lr())
        if not skip:
            if clip > 0:
                coef = min(clip / (norm + 1e-6), 1.0)
                torch._foreach_mul_(grads, coef)
            master = self._master()
            if "update_norm" in wants:
                before = [m.detach().clone() for m in master]
            kw = {}
            if self.optimizer.name == "lamb":
                kw["norm_groups"] = self._leaf_groups()
                if self.dp is not None:
                    kw["norm_sq_reduce"] = self.dp.leaf_sq
            self.optimizer.update(grads, self.opt_state, master,
                                  self.step_count, lr_t=lr, **kw)
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
        metrics = {"loss": loss_h, "grad_norm": norm, "lr": lr,
                   "overflow": skip, "loss_scale": old_scale,
                   "nonfinite_streak": self.nonfinite_streak}
        if limit is not None:
            metrics["anomaly_skip"] = spiked
        if wants:
            metrics.update(self._integrity_norms(wants, before))
        if aux_h is not None:
            metrics["aux"] = aux_h
        return metrics

    def _integrity_norms(self, wants: List[str],
                         before: Optional[List[torch.Tensor]]
                         ) -> Dict[str, float]:
        """The sentinel's extra statistics after the update (the JAX
        step's in-jit ones): the update norm (0 on a skipped step) and
        the param norm of the master, whole over the ZeRO group (a
        replicated leaf counted once), in one more host read."""
        master = self._master()
        sqs = []
        for name in wants:
            if name == "update_norm":
                sqs.append(torch.stack(
                    [(a.to(torch.float32) - b.to(torch.float32))
                     .square().sum() for a, b in zip(master, before)])
                    if before is not None else
                    torch.zeros(len(master), device=self.device))
            else:
                sqs.append(self.dp.owned_sq(master) if self.dp is not None
                           else torch.stack([m.to(torch.float32).square()
                                             .sum() for m in master]))
        sq = torch.stack(sqs)
        if self.dp is not None:
            from .. import comm
            sq = torch.where(self.dp._rep[None, :], torch.zeros_like(sq), sq)
            comm.all_reduce(sq, op=comm.ReduceOp.SUM,
                            axis=self.dp.step_axes)
        return dict(zip(wants, sq.sum(dim=1).sqrt().tolist()))

    def _after_step(self, metrics: Dict[str, Any]) -> None:
        self.global_steps += 1
        self.data_position += 1
        self._step_phase_reached = True
        if self.watchdog is not None:
            # step progress is the liveness signal; the first completed
            # step arms the clock and retires the COMPILE deadline
            self.watchdog.start().enter_phase(hb.PHASE_STEP,
                                              step=self.global_steps)
        if self.heartbeat is not None:
            # throttled; the rolling step_ms gauge rides along
            gauge = self._step_clock.mark()
            self.heartbeat.write(
                hb.PHASE_STEP, self.global_steps,
                extra=({straggler_lib.STEP_MS_GAUGE: gauge}
                       if gauge is not None else None))
            self._maybe_check_straggler()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self._last_metrics = metrics
        if self._cp_guard is not None:
            self._cp_guard.observe(float(metrics["grad_norm"]))
        # one code path for every "wrong numbers" verdict: the non-finite
        # streak abort, anomaly strikes and the post-rollback abort (the
        # metrics are host numbers already: no extra device read)
        print_step = self.global_steps % self.config.steps_per_print == 0
        if print_step or self.sentinel.wants_every_step:
            verdict = self.sentinel.observe(self.global_steps, metrics)
            if verdict == sentinel_lib.ROLLBACK:
                self._sentinel_rollback()
        self._maybe_sdc_audit()
        if print_step:
            msg = (f"step={self.global_steps} loss={metrics['loss']:.4f} "
                   f"lr={metrics['lr']:.3e} "
                   f"grad_norm={metrics['grad_norm']:.3f}")
            if self.config.wall_clock_breakdown and self._step_t0:
                msg += (f" train_batch_ms="
                        f"{1e3 * (time.perf_counter() - self._step_t0):.2f}")
            log_dist(msg, ranks=[0])
        self._step_boundary()

    def _step_boundary(self) -> None:
        """The end of a step: params, master, moments and counters agree
        again. A preemption signal that landed inside the step saves and
        exits here."""
        self._in_step = False
        pending, self._preempt_pending = self._preempt_pending, None
        if pending is not None:
            pending()

    # ------------------------------------------- compression and comm plan

    def _compression(self, tp_size: int, ep_size: int):
        """(the compression spec or None, whether MoQ is on): the
        ``compression_training`` and ``quantize_training`` sections (the
        JAX engine :333-350). A spec whose transforms take a statistic of
        a whole stacked leaf refuses the layouts that split leaves over
        ranks: tensor and expert parallelism, ZeRO-3 in a process group,
        and a pipeline (whose ranks each hold their stage's layers)."""
        from ..compression import init_compression
        from .quantize import build_moq_spec
        spec = init_compression({"compression_training":
                                 self.config.compression_training.model_dump()})
        moq = build_moq_spec(self.config.quantize_training)
        if moq is not None:
            spec.groups.extend(moq.groups)
        if not spec.enabled:
            return None, False
        where = []
        if self._pipelined and (spec.groups or spec.activation_bits):
            where.append("a pipeline (its ranks hold their stages' layers)")
        if spec.groups:
            if tp_size > 1:
                where.append(f"tensor parallelism (tp {tp_size})")
            if ep_size > 1:
                where.append(f"expert parallelism (ep {ep_size})")
            if self.mesh is not None and \
                    self.config.zero_optimization.stage == 3:
                where.append("ZeRO-3 (each rank holds slabs of a leaf)")
        if where:
            raise NotImplementedError(
                "compression_training / quantize_training under "
                f"{', '.join(where)}: the transforms take a statistic of a "
                "whole stacked leaf (a quantization scale, a top-k, a row "
                "norm), which would span ranks, " + _LATER)
        log_dist(f"compression training: "
                 f"{[g.kind + ':' + g.name for g in spec.groups]}",
                 ranks=[0])
        return spec, moq is not None

    def _compress(self) -> None:
        """Put the compressed leaves where the forward reads them: every
        leaf a group of the spec matches (a ``Transformer``'s block leaves
        stacked [L, ...] as in the JAX package, through ``torch.stack``,
        so the straight-through gradient reaches each block's parameter)
        is transformed at the optimizer step count and its pieces put in
        the owning modules' instance dicts, where attribute lookup finds
        them before the parameters (the ZeRO-3 gathers' mechanism). They
        stay there through the backward, so a remat recomputation reads
        them too; :meth:`_drop_compressed` takes them out."""
        from ..compression.compress import compressible, transform_leaf
        self._drop_compressed()
        spec, step = self.compression_spec, self.step_count
        if self._comp_leaves is None:
            flax = _flax_module(self.module)
            owners = {}
            for mname, mod in self.module.named_modules():
                for pname, p in mod._parameters.items():
                    if p is not None:
                        owners.setdefault(id(p), (mod, pname))
            leaves: Dict[str, list] = {}
            for name, p in self.module.named_parameters():
                path = _leaf_path(name, flax)
                if p.requires_grad and compressible(path, spec):
                    leaves.setdefault(path, []).append(owners[id(p)] + (p,))
            self._comp_leaves = {
                path: (flax and path.startswith("blocks/"), items)
                for path, items in leaves.items()}
        for path, (stacked, items) in self._comp_leaves.items():
            ps = [getattr(owner, pname) for owner, pname, _ in items]
            w = torch.stack(ps) if stacked else ps[0]
            out = transform_leaf(path, w, spec, step)
            if out is w:
                continue
            for (owner, pname, _), t in zip(
                    items, out.unbind(0) if stacked else [out]):
                owner.__dict__[pname] = t
                self._compressed.append((owner, pname))

    def _drop_compressed(self) -> None:
        for owner, pname in self._compressed:
            owner.__dict__.pop(pname, None)
        self._compressed = []

    def _comm_plan(self) -> None:
        """The ``comm_plan`` section (the JAX engine :515-551): the plan
        context (active around the model's forward, where the MoE layer
        reads it), the grad-sync verdict, the ZeRO-3 overlap gathers and
        the accuracy guard, all resolved here."""
        from ..comm_plan import CommPlan
        from ..comm_plan.runtime import AccuracyGuard, PlanContext
        cp = self.config.comm_plan
        plan = CommPlan.load(cp.plan_path) if cp.plan_path else None
        self.comm_plan_ctx = PlanContext(
            plan=plan, overrides=dict(cp.overrides or {}),
            bits=cp.quant_bits, block=cp.quant_block,
            size_threshold=int(cp.size_threshold_mb * 2 ** 20),
            overlap_chunks=cp.overlap_chunks)
        self._resolve_grad_sync_algo()
        self._resolve_param_gather()
        if cp.guard_min_grad_norm > 0:
            self._cp_guard = AccuracyGuard(cp.guard_min_grad_norm)
        log_dist(
            "comm plan: "
            f"plan={'recorded:' + cp.plan_path if cp.plan_path else 'heuristic'} "
            f"grad_sync={self.comm_plan_ctx.resolved.get('grad_reduce_scatter')} "
            f"param_gather={self.comm_plan_ctx.resolved.get('param_all_gather')} "
            f"overlap_chunks={cp.overlap_chunks} "
            f"overrides={dict(cp.overrides or {})} "
            f"guard={cp.guard_min_grad_norm}", ranks=[0])

    def _mesh_shape(self) -> Dict[str, int]:
        if self.mesh is None:
            return {"pipe": 1, "data": 1, "expert": 1, "seq": 1, "model": 1}
        return dict(self.mesh.shape)

    def _grad_sync_envelope(self):
        return grad_sync_envelope(self.compression_spec is not None,
                                  self.config.zero_optimization.stage,
                                  self._mesh_shape())

    def _resolve_grad_sync_algo(self) -> None:
        """The grad sync's wire format, resolved once (the JAX engine
        :1093-1120): override, then plan, then heuristic. A verdict
        outside the envelope, forced or selected, degrades to exact with
        a warning."""
        from ..comm_plan.runtime import resolve_algo
        ctx = self.comm_plan_ctx
        itemsize = torch.empty((), dtype=self.grad_accum_dtype).element_size()
        numel = (sum(int(np.prod(e.full_shape)) for e in self.dp.entries)
                 if self.dp is not None
                 else sum(p.numel() for p in self._params))
        shape = self._mesh_shape()
        algo = resolve_algo(ctx, "grad_reduce_scatter", "data",
                            numel * itemsize,
                            axis_size=shape["data"] * shape["expert"])
        if algo != "exact":
            ok, why = self._grad_sync_envelope()
            if not ok:
                forced = any((ctx.overrides or {}).get(k)
                             for k in ("grad_reduce_scatter",
                                       "reduce_scatter"))
                logger.warning(
                    "comm_plan: grad sync %s %r but %s — running exact",
                    "forced" if forced else "selected", algo, why)
                algo = "exact"
                ctx.resolved["grad_reduce_scatter"] = "exact"
        self._grad_sync_algo = algo

    def _param_gather_viable(self):
        if self.config.zero_optimization.stage < 3:
            return False, ("ZeRO stage < 3 keeps compute params whole — "
                           "there is no param gather to overlap")
        if self.config.zero_optimization.zero_quantized_weights:
            return False, ("zero_quantized_weights already owns the "
                           "explicit param gather (qwZ)")
        if self.dp is None:
            return False, ("one process holds every parameter whole — "
                           "there is no param gather to overlap")
        return True, ""

    def _resolve_param_gather(self) -> None:
        """Per leaf, the ZeRO-3 gather's schedule (the JAX engine
        :1124-1199): each leaf split over a ZeRO group of more than one
        rank queries the plan in its own size bucket (the stacked leaf's
        bytes, as JAX sizes it), and the ``overlap`` family's leaves
        gather (and reduce-scatter their gradients) in chunks. Leaves of a
        TP shard and leaves under ``overlap_min_leaf_elems`` keep the
        whole-tensor gather."""
        from ..comm.planned import planned_param_gather
        from ..comm_plan.runtime import resolve_algo
        from .comm.overlap import OVERLAP_ALGOS
        ctx = self.comm_plan_ctx
        cp = self.config.comm_plan
        ctx.resolved.setdefault("param_all_gather", "exact")
        ok, why = self._param_gather_viable()
        if not ok:
            forced = any((ctx.overrides or {}).get(k)
                         for k in ("param_all_gather", "all_gather"))
            if forced and self.config.zero_optimization.stage >= 3:
                logger.warning(
                    "comm_plan: param gather forced but %s — running the "
                    "implicit gather", why)
            return
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        layers = {}
        for e in self.dp.entries:
            layers[e.leaf] = layers.get(e.leaf, 0) + 1
        n_overlap = 0
        for e in self.dp.entries:
            numel = int(np.prod(e.shape)) * layers[e.leaf]
            if e.pdim is None or e.world == 1 or e.tp is not None or \
                    numel < cp.overlap_min_leaf_elems:
                continue
            algo = resolve_algo(ctx, "param_all_gather", "data",
                                numel * itemsize, axis_size=e.world)
            if algo in OVERLAP_ALGOS:
                self.dp.overlap_gather(e, planned_param_gather(
                    e.axes, e.pdim, algo=algo, chunks=cp.overlap_chunks,
                    bits=cp.quant_bits, block=cp.quant_block),
                    cp.overlap_chunks)
                n_overlap += 1
        ctx.resolved["param_all_gather"] = ("overlap" if n_overlap
                                            else "exact")

    def _step_sync_algo(self) -> str:
        """This step's grad-sync algorithm: the resolved one, unless the
        accuracy guard has latched exact for a lossy one (``overlap``
        moves exact values and is exempt)."""
        from ..comm_plan.plan import QUANTIZED_ALGOS
        algo = self._grad_sync_algo
        if self.comm_plan_ctx is None or algo == "exact":
            return "exact"
        if self._cp_guard is not None and self._cp_guard.use_exact and \
                algo in QUANTIZED_ALGOS:
            return "exact"
        return algo

    def _eig_loss(self, names: List[str]):
        """The loss of ``batch`` as a function of the parameters ``ps``
        (``names``' values), for the Hessian-vector products: the model's
        training forward without dropout or compression (the JAX engine's
        ``_eig_loss``)."""
        kw = {"train": True} if self._takes_train else {}

        def loss(ps, batch):
            out = torch.func.functional_call(
                self.module, dict(zip(names, ps)), (batch,), kw)
            return self._loss_of(out, batch)

        return loss

    def _eig_inputs(self, batch):
        if self.eigenvalue is None:
            raise RuntimeError("enable the 'eigenvalue' config section")
        if self.dp is not None and (self.dp_world_size > 1 or
                                    self.tp is not None or
                                    self.config.zero_optimization.stage
                                    == 3):
            raise NotImplementedError(
                "compute_eigenvalue across ranks (data parallel, tensor "
                "parallel or ZeRO-3: the product would have to reduce over "
                "the ranks' batches and gather their slabs) " + _LATER)
        self._drop_compressed()
        named = [(n, p) for n, p in self.module.named_parameters()
                 if p.requires_grad]
        names = [n for n, _ in named]
        gen = torch.Generator(device=self.device).manual_seed(
            self.config.seed + self.global_steps)
        return (self._eig_loss(names), [p for _, p in named], gen,
                (self._to_device(batch),))

    def compute_eigenvalue(self, batch) -> float:
        """The largest |eigenvalue| of the loss's Hessian on ``batch``
        (reference: the engine's eigenvalue hook, which feeds MoQ), by
        power iteration on Hessian-vector products. A model whose forward
        runs a kernel differentiable once (the flash and block-sparse
        attention kernels) raises, naming it: build it with
        ``attention_impl="reference"``."""
        loss, params, gen, args = self._eig_inputs(batch)
        return self.eigenvalue.compute_eigenvalue(loss, params, gen,
                                                  loss_args=args)

    def moq_rescale(self, batch):
        """Curvature-paced MoQ (reference: quantize.py's eigenvalue
        gating): measure the Hessian eigenvalue on ``batch`` and stretch
        the MoQ bit schedule's period by its ratio to the first
        measurement. Returns the (possibly new) compression spec."""
        if not self._moq_enabled or self.eigenvalue is None:
            raise RuntimeError("moq_rescale needs both quantize_training and "
                               "eigenvalue enabled")
        if self._moq_scheduler is None:
            from .quantize import MoQScheduler
            self._moq_scheduler = MoQScheduler(self.compression_spec,
                                               self.eigenvalue)
        loss, params, gen, args = self._eig_inputs(batch)
        new_spec = self._moq_scheduler.maybe_rescale(loss, params, gen,
                                                     loss_args=args)
        if new_spec is not self.compression_spec:
            self.compression_spec = new_spec
            self._comp_leaves = None
        return self.compression_spec

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
        batch = self._step_entry(batch)
        self._in_step = True
        self._step_t0 = time.perf_counter()
        gas = self.config.gradient_accumulation_steps
        tb = self.config.train_batch_size
        W, rank = self.batch_world, self.batch_rank

        def split(x, i):
            if isinstance(x, dict):
                return {k: split(v, i) for k, v in x.items()}
            if x.shape[0] != tb:
                raise ValueError(f"batch leading dim {x.shape[0]} != "
                                 f"train_batch_size {tb}")
            m = tb // (gas * W)
            lo = (i * W + rank) * m
            return x[lo:lo + m]

        self.module.train()
        # the comm plan's grad sync: each rank accumulates its own
        # gradients over the micro-batches, then each leaf syncs once in
        # the step tail (the JAX engine's stacked-grads step, :1201-1277)
        algo = self._step_sync_algo()
        if self.dp is not None:
            self.dp.sync = (None if algo == "exact"
                            else self._grad_sync(algo))
        losses = []
        for i in range(gas):
            micro = self._to_device(self._seq_chunk(split(batch, i)))
            loss = self._loss(self._apply(micro, True, i, True), micro)
            self._micro_backward(loss)
            losses.append(loss.detach())
            self.micro_steps += 1
        metrics = self._finalize_step(gas, losses)
        if self.dp is not None:
            self.dp.sync = None
        if self.comm_plan_ctx is not None:
            metrics["grad_sync_algo"] = algo
            metrics["param_gather_algo"] = self.comm_plan_ctx.resolved.get(
                "param_all_gather", "exact")
        self._after_step(metrics)
        return metrics

    def _grad_sync(self, algo: str):
        """``sync(grad, axes)``: the planned grad sync of one leaf's
        accumulated gradient over its ZeRO group, a mean."""
        from ..comm.planned import planned_grad_sync
        cp = self.config.comm_plan
        return lambda g, axes: planned_grad_sync(
            g, axis=axes, algo=algo, bits=cp.quant_bits,
            block=cp.quant_block, mean=True, chunks=cp.overlap_chunks)

    def eval_batch(self, batch):
        """The model's outputs on ``batch`` in eval mode, without grads
        (under sequence parallelism, those of this rank's chunk)."""
        self.module.eval()
        with torch.no_grad():
            out = self._apply(self._to_device(self._seq_chunk(batch)),
                              False)
        self._drop_compressed()
        return out

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
        grads. Under sequence parallelism every rank of a seq group is
        given the same micro-batch and takes its chunk."""
        batch = self._to_device(self._seq_chunk(batch))
        if not self._train_mode:
            self.module.eval()
            with torch.no_grad():
                loss = self._loss_of(self._apply(batch, False,
                                                 for_loss=True), batch)
            self._drop_compressed()
            return loss
        self.module.train()
        loss = self._loss(self._apply(batch, True, self._micro_count, True),
                          batch)
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
        self._in_step = True
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
        if _flax_module(self.module):
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
        flax = _flax_module(self.module)
        index = {id(p): i for i, p in enumerate(self._params)}
        groups: Dict[str, list] = {}
        for name, p in self.module.named_parameters():
            groups.setdefault(_leaf_path(name, flax), []).append(p)
        stacked = {path: flax and path.startswith("blocks/")
                   for path in groups}
        # a pipe rank's blocks: its layers of the stacked leaves, at their
        # offset in the whole (``Leaf.layers``)
        held = getattr(self.module, "layers", None)
        nl = getattr(getattr(self.module, "cfg", None), "num_layers", None)
        layers = ((held[0], nl) if flax and held is not None
                  and len(held) < nl else None)

        def split(path, p, kind):
            """(splits, writes): an expert leaf's expert slab or a TP
            leaf's shard, then the ZeRO slab along the kind's dim; whether
            this rank writes the piece (one rank of the group where it is
            whole, model rank 0 for a leaf whole on the model axis, pipe
            rank 0 for one every pipe rank holds)."""
            if self.dp is None or id(p) not in index:
                return None, None
            e = self.dp.entries[index[id(p)]]
            dim = e.pdim if kind == "param" else e.mdim
            splits = [] if e.eslab is None else [e.eslab]
            if e.tp is not None:
                splits.append(e.tp)
            if dim is not None:
                splits.append((dim, e.rank, e.world))
            writes = ((e.tp is not None or self.dp.model_rank == 0)
                      and (dim is not None or e.rank == 0)
                      and (stacked[path] or self.dp.pipe_rank == 0))
            return splits or None, writes

        def leaf(parts, path, ps, kind):
            return ckpt_lib.Leaf(
                parts if stacked[path] else parts[0], stacked[path],
                *split(path, ps[0], kind),
                layers=layers if stacked[path] else None)

        params = {path: leaf(ps, path, ps, "param")
                  for path, ps in groups.items()}

        def over(tensors):
            return {path: leaf([tensors[index[id(p)]] for p in ps], path,
                               ps, "master")
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
        parameters (``master_aliases_params``). Runs in the SAVE phase
        (``watchdog.save_timeout`` bounds it; 0 leaves it unbounded)."""
        if self._accum is not None or self._pending is not None:
            raise RuntimeError("save_checkpoint() in the middle of a "
                               "forward/backward accumulation window")
        with self._phase_scope(hb.PHASE_SAVE):
            self._ckpt_dir = save_dir      # the sentinel's rollback source
            return self._save_in_phase(ckpt_engine, save_dir, tag,
                                       client_state)

    def _save_in_phase(self, ckpt_engine, save_dir: str,
                       tag: Optional[str],
                       client_state: Optional[dict]) -> str:
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
        """Stop the watchdog, conclude the heartbeat record with EXIT, and
        drain and stop the async checkpoint writer (idempotent)."""
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.heartbeat is not None:
            # bounded lock: a refresher wedged on dead storage must not
            # hang the clean shutdown it annotates
            self.heartbeat.write(hb.PHASE_EXIT, self.global_steps,
                                 force=True, lock_timeout=2.0)
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
        client_state). With the SDC audit on, ``tag=None`` prefers the
        last audited-clean tag. Runs in the RESTORE phase
        (``watchdog.restore_timeout``)."""
        if self._accum is not None or self._pending is not None:
            raise RuntimeError("load_checkpoint() in the middle of a "
                               "forward/backward accumulation window")
        with self._phase_scope(hb.PHASE_RESTORE):
            self._ckpt_dir = load_dir      # the sentinel's rollback source
            tag = self._prefer_audited_clean(load_dir, tag)
            return self._load_in_phase(load_dir, tag, load_module_only)

    def _load_in_phase(self, load_dir: str, tag: Optional[str],
                       load_module_only: bool):
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
