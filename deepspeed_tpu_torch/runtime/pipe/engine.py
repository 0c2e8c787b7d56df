"""PipelineEngine: train and eval over the stage interpreter
(counterpart of ``deepspeed_tpu/runtime/pipe/engine.py``; reference
``runtime/pipe/engine.py``: ``train_batch`` / ``eval_batch`` the only
step APIs, micro-batches == gradient_accumulation_steps, ``forward`` /
``backward`` / ``step`` redirected).

``pipeline.schedule`` is "gpipe" or "1f1b" and ``pipeline.placement``
"spmd" or "mpmd", as in JAX; both placements run the port's one executor
(``mpmd/executor.py``, the placement changes no math). Each rank of the
mesh's ``pipe`` axis holds one stage of a ``PipelinedTransformer`` built
with ``stage=`` its index (one process holds every stage without a
group). ``pipe`` composes with ``data`` (ZeRO stages 0-3 over each pipe
rank's own leaves; at stage 3 the executor gathers a stage's blocks
around its forward and backward ticks and the embedding and head around
their uses, ``PipelinedTransformer.gather``), with ``expert`` (each pipe
rank's MoE layers exchange their queues over its expert group; expert
leaves reduce over ``data`` only, the others over ``data`` x
``expert``, as the plain engine's) and with ``model`` (``sharding_rules=
model.tp_rules()``: each stage's blocks, the embedding and the head run
the Megatron layers of the rank's ``model`` coordinate; a MoE model's
experts split their hidden dim over ``model`` too, as the plain model's
do). A pipeline with ``seq`` above 1 raises ``NotImplementedError``
naming ROADMAP.md, and so do compression and MoQ (their statistics span
the stages' layers). The ``comm_plan`` context is active around the
executor, so a MoE stage's exchange reads the plan; the grad sync stays
exact (the envelope excludes ``pipe`` above 1, as in JAX).

A MoE model's loss: ``make_moe_loss(w, base_loss)`` is split into its
base loss (the last stage's) and its aux weight (the executor's
cotangent of every stage's aux); ``causal_lm_loss`` or no loss_fn take
``cfg.moe_aux_weight``. An unmarked custom loss raises under 1F1B or
``placement: "mpmd"`` (JAX's ``ValueError``: the executor hands the base
loss bare logits). The reported loss is base + w x aux and the metrics
carry ``aux``. Gating noise is drawn only with dropout (the JAX
pipelined model's "gating" rng rides its dropout key).

``train_batch`` takes the global batch: micro-batch i is the rows the
plain engine's split gives it (``runtime/engine.py``), and the step tail
is the plain engine's with one micro-batch of the executor's grads. The
embedding and head leaves every pipe rank holds get partial grads (stage
0 the embedding's, the last stage the head's and the tied ``wte``'s):
they are summed over ``pipe``, so every copy stays equal; the grad norm
sums the stage-owned leaves' squares over ``pipe`` and counts those
leaves once, the fp16 overflow flag is OR-ed over ``pipe`` (every stage
skips together), and the loss is the last stage's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..engine import DeepSpeedEngine, _default_loss_fn

_LATER = "is not ported to deepspeed_tpu_torch yet (see ROADMAP.md)"


class PipelineEngine(DeepSpeedEngine):
    """The engine of a ``models.pipeline.PipelinedTransformer`` (picked by
    ``deepspeed_tpu_torch.initialize``)."""

    _pipelined = True

    def __init__(self, model, config=None, model_parameters=None,
                 loss_fn=None, **kwargs):
        from ...config.config import load_config
        from ...models.pipeline import PipelinedTransformer
        from ...models.transformer import causal_lm_loss
        if not isinstance(model, PipelinedTransformer):
            raise TypeError("PipelineEngine needs a models.pipeline."
                            "PipelinedTransformer")
        cfg = load_config(config)
        pc = cfg.pipeline
        if pc.schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline.schedule '{pc.schedule}' "
                             "(gpipe | 1f1b)")
        placement = getattr(pc, "placement", "spmd")
        if placement not in ("spmd", "mpmd"):
            raise ValueError(f"unknown pipeline.placement '{placement}' "
                             "(spmd | mpmd)")
        if placement == "mpmd" and model.backward == "store":
            raise ValueError(
                "backward='store' is an SPMD-executor mode (vjp residual "
                "rings inside the stacked scan); the MPMD placement's "
                "fused per-stage backward is the recompute regime — "
                "build the model with backward='recompute'")
        if pc.stages not in (1, model.pp):
            raise ValueError(f"pipeline.stages {pc.stages} for a model "
                             f"built at pp {model.pp}")
        if cfg.sequence_parallel.sp_size > 1:
            raise NotImplementedError(
                "a pipeline together with sequence_parallel.sp_size > 1 "
                "(the JAX pipelined model threads no ring or Ulysses "
                "attention through its stages; ROADMAP item 4.1) " + _LATER)
        moe = model.moe
        rules = kwargs.get("sharding_rules")
        if rules is not None:
            from ...utils.partitioning import check_tp_rules
            check_tp_rules(rules, model.cfg, model.tp_rules())
        self.schedule = pc.schedule
        lf = loss_fn or _default_loss_fn
        self._aux_weight = None
        if getattr(lf, "_moe_loss", False):
            # the aux term rides the pipe (the executor's cotangent); the
            # base loss goes to the last stage
            self._aux_weight = float(lf._moe_aux_weight)
            lf = lf._moe_base_loss
        elif moe:
            self._aux_weight = float(model.cfg.moe_aux_weight)
        self._custom_loss = (None if lf in (causal_lm_loss, _default_loss_fn)
                             else lf)
        per_micro = placement == "mpmd" or pc.schedule == "1f1b"
        if moe and self._custom_loss is not None and \
                not getattr(loss_fn, "_moe_loss", False):
            if per_micro:
                raise ValueError(
                    "the hand-scheduled pipeline executors (1f1b / "
                    "placement='mpmd') with an MoE model need the loss "
                    "built by models.make_moe_loss(aux_weight, "
                    "base_loss=...): the executor computes the aux "
                    "term itself and passes the base loss bare logits, "
                    "so a raw loss_fn written against the model's "
                    "(logits, aux) output would misread its input.")
            raise NotImplementedError(
                "a raw loss_fn of a MoE model's (logits, aux) under the "
                "spmd gpipe schedule (the JAX step hands it the whole "
                "batch's tuple; ROADMAP item 4.1) " + _LATER
                + "; build it with models.make_moe_loss")
        # the JAX spmd-gpipe step applies a custom loss_fn to the whole
        # batch's logits; its 1F1B and mpmd executors per micro-batch
        self._batch_loss = (self._custom_loss is not None
                            and not per_micro)
        if self._custom_loss is not None and not self._batch_loss:
            from ...utils.logging import logger
            logger.warning(
                "the hand-scheduled pipeline executors (1f1b / "
                "placement='mpmd') compute a custom loss_fn PER "
                "MICROBATCH and average the results (the reference's "
                "_aggregate_total_loss semantics). For per-token-mean "
                "losses this equals the full-batch value; losses "
                "normalized over data-dependent counts (e.g. valid "
                "-100-masked tokens) will weight micros differently than "
                "the gpipe schedule's full-batch evaluation.")
        if model_parameters is not None:
            from ...models.convert import params_from_jax
            model = PipelinedTransformer(
                model.cfg, model.pp, model.n_micro, model.backward,
                params=params_from_jax(model_parameters), stage=model.stage)
        super().__init__(model, config=config, loss_fn=loss_fn, **kwargs)
        gas = self.config.gradient_accumulation_steps
        if gas != model.n_micro:
            raise ValueError(
                f"gradient_accumulation_steps {gas} != the model's n_micro "
                f"{model.n_micro}: a pipeline's micro-batches are the "
                "accumulation steps")
        pipe = 1 if self.mesh is None else self.mesh.shape["pipe"]
        want = model.pp if model.stage is not None else 1
        if pipe != want:
            raise ValueError(
                f"a model of stage {model.stage} (pp {model.pp}) on a "
                f"'pipe' axis of {pipe}: build it with stage=None in one "
                "process, or stage=<pipe rank> on each rank of a process "
                "group with pipeline.stages = pp")
        if model.stage is not None and model.stage != \
                self.mesh.axis_rank("pipe"):
            raise ValueError(f"the model holds stage {model.stage}; this "
                             f"rank is pipe rank "
                             f"{self.mesh.axis_rank('pipe')}")
        self.pipe_world = pipe
        self._shared = [n for n, _ in model.named_parameters()
                        if not n.startswith("blocks.")]
        if pipe > 1:
            from ... import comm
            # the pipe group's communicator, made by every rank together
            # before its first point-to-point transfer
            comm.all_reduce(torch.zeros(1, device=self.device), axis="pipe")

    # ------------------------------------------------------------- steps

    def _micros(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of every micro-batch, [gas, micro, ...]."""
        gas = self.config.gradient_accumulation_steps
        tb = self.config.train_batch_size
        W, rank = self.batch_world, self.batch_rank
        if not isinstance(batch, dict):
            batch = {"input_ids": batch}
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v)
            if v.shape[0] != tb:
                raise ValueError(f"batch leading dim {v.shape[0]} != "
                                 f"train_batch_size {tb}")
            m = tb // (gas * W)
            rows = v.reshape((gas, W, m) + tuple(v.shape[1:]))[:, rank]
            out[k] = rows.to(self.device)
        return out

    def _total_valid(self, micros) -> torch.Tensor:
        """The default objective's divisor: the global batch's valid
        targets over the data ranks (each rank's loss is then its W-th
        share, averaged back by the step tail)."""
        lab = micros.get("labels", micros["input_ids"])
        n = (lab[:, :, 1:] != -100).sum().to(torch.float32)
        if self.dp is not None and self.batch_world > 1:
            from ... import comm
            from ...parallel.mesh import BATCH_AXES
            comm.all_reduce(n, axis=BATCH_AXES)
        return torch.clamp(n, min=1.0) / self.batch_world

    def train_batch(self, batch) -> Dict[str, Any]:
        """One global batch through the pipeline (gas micro-batches),
        then the step. Returns the metrics dict as host numbers; the
        loss is the global batch's."""
        import time
        if self.optimizer is None:
            raise RuntimeError("PipelineEngine needs an optimizer")
        if hasattr(batch, "__next__"):
            batch = next(batch)
        batch = self._step_entry(batch)
        self._in_step = True
        self._step_t0 = time.perf_counter()
        micros = self._micros(batch)
        gas = self.config.gradient_accumulation_steps
        seeds = gating = None
        if self.module.cfg.dropout > 0.0:
            seeds = [self._dropout_seed(i) for i in range(gas)]
            gating = [self._gating_seed(i) for i in range(gas)]
        self.module.train()
        from ...comm_plan.runtime import use_context
        with use_context(self.comm_plan_ctx):
            loss, grads = self.module.pipeline_value_and_grad(
                micros, schedule=self.schedule, loss_fn=self._custom_loss,
                batch_loss=self._batch_loss,
                total_valid=(self._total_valid(micros)
                             if self._custom_loss is None else None),
                seeds=seeds, gating_seeds=gating,
                aux_weight=self._aux_weight,
                loss_scale=self.scale_state.scale)
        if self.module.moe:
            # this rank's stages' aux: the step tail sums it over 'pipe'
            self._auxes.append(self.module.last_aux.detach())
        if self.pipe_world > 1:
            self._sum_over_pipe(grads)
        names = {id(p): n for n, p in self.module.named_parameters()}
        if self.dp is not None:
            for e in self.dp.entries:
                self.dp.add_grad(e, grads[names[id(e.param)]])
        else:
            self._accum = [grads[names[id(p)]].to(self.grad_accum_dtype)
                           for p in self._params]
        self.micro_steps += gas
        metrics = self._finalize_step(1, [loss])
        self._after_step(metrics)
        return metrics

    def _sum_over_pipe(self, grads: Dict[str, torch.Tensor]) -> None:
        """The embedding and head leaves' partial grads summed over
        ``pipe`` (one all-reduce), in place in ``grads``."""
        from ... import comm
        flat = torch.cat([grads[n].reshape(-1) for n in self._shared])
        comm.all_reduce(flat, axis="pipe")
        at = 0
        for n in self._shared:
            k = grads[n].numel()
            grads[n] = flat[at:at + k].view_as(grads[n])
            at += k

    def eval_batch(self, batch):
        """The model's f32 logits on ``batch`` (every rank: the last
        stage's, broadcast over ``pipe``)."""
        if hasattr(batch, "__next__"):
            batch = next(batch)
        self.module.eval()
        from ...comm_plan.runtime import use_context
        with torch.no_grad(), use_context(self.comm_plan_ctx):
            return self.module(self._to_device(batch))

    # the reference redirects these for pipeline engines (engine.py:1246-1256)
    def forward(self, *a, **k):
        raise RuntimeError("PipelineEngine: use train_batch/eval_batch instead "
                           "of forward()")

    __call__ = forward

    def backward(self, *a, **k):
        raise RuntimeError("PipelineEngine: use train_batch/eval_batch instead "
                           "of backward()")

    def step(self, *a, **k):
        raise RuntimeError("PipelineEngine: use train_batch/eval_batch instead "
                           "of step()")

    # -------------------------------------------------------- checkpoints

    def _module_state_dict(self) -> Dict[str, np.ndarray]:
        """The whole model's flax-path numpy dict: each rank's block
        stacks gathered over ``pipe`` in stage order."""
        from ...models.convert import scan_params
        flat: Dict[str, np.ndarray] = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + k + "/")
                else:
                    if prefix.startswith("blocks/") and self.pipe_world > 1:
                        from ... import comm
                        v = comm.all_gather(v.contiguous(), axis="pipe")
                    flat[prefix + k] = v.detach().to(torch.float32).cpu() \
                        .numpy()
        walk(scan_params(self.module), "")
        return flat

    def save_16bit_model(self, save_dir: str,
                         save_filename: str = "pytorch_model.npz") -> str:
        """The parameters in their compute dtype, name-keyed, in one npz
        (the whole model; rank 0 writes)."""
        import os
        from .. import checkpointing as ckpt_lib
        from ... import comm
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, save_filename)
        sd = self.module_state_dict()
        if not comm.is_initialized() or comm.get_rank() == 0:
            ckpt_lib.save_tree({k: torch.from_numpy(v).to(self.compute_dtype)
                                for k, v in sd.items()}, path)
        comm.barrier()
        return path
