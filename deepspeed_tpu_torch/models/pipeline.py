"""The pipelined transformer: the model side of pipeline parallelism
(counterpart of ``deepspeed_tpu/models/pipeline.py``).

Parameter names are the port ``Transformer``'s: ``wte``, ``wpe``,
``ln_f``, ``lm_head`` and ``blocks.<global layer>.<leaf>.<name>``, so
the same scan-layout tree (``models.convert.params_from_jax``) and the
same checkpoints serve pp 1 and pp N. ``stage`` selects the blocks a
module holds: None, every layer (one process runs every stage), or one
stage's ``L / pp`` layers (a rank of the mesh's ``pipe`` axis; it converts
and holds only those). The embedding and head leaves are on every stage:
stage 0 embeds, the last stage normalizes, projects and takes the loss,
so the engine sums their gradients over ``pipe`` (the JAX executor's
"head grads psum over 'pipe'").

One executor runs both of the JAX package's placements
(``runtime/pipe/mpmd/executor.py``); a stage's body runs its blocks, the
flash kernels inside each. A MoE model's stage body returns its layers'
aux summed (the executor's aux side channel); under TP (``set_tp``) the
blocks, the embedding and the head run the rank's Megatron shards; under
ZeRO-3 the executor gathers a stage's parameters around its ticks
(:meth:`PipelinedTransformer.gather`). The default objective is the JAX 1F1B path's
global token mean: each micro-batch's nll sum times ``n_micro /
total_valid``, averaged over micro-batches. A custom ``loss_fn`` runs per
micro-batch and is averaged, except that ``batch_loss`` evaluates it once
on the whole batch's logits, as the JAX engine's spmd-gpipe step does.
Dropout masks are seeded by (micro-batch, global layer) with the
engine's ``mix_seed`` / ``site_generator``, so gpipe, 1F1B and pp 1 draw
the same masks, and the same as the plain ``Transformer`` given that
micro-batch's seed (JAX folds (micro, stage, layer) so its two schedules
agree; a torch generator cannot match JAX's bits anyway).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .transformer import (Block, TransformerConfig, _check_trainable, _Leaf,
                          init_params, layer_params, mix_seed, site_generator)

_LATER = "is not ported to deepspeed_tpu_torch yet (see ROADMAP.md)"


def check_pipelined(cfg: TransformerConfig, pp: int, backward: str) -> None:
    """The JAX model's refusals (``deepspeed_tpu/models/pipeline.py:
    55-98``), and the port's for what its pipeline does not carry."""
    if pp < 1 or cfg.num_layers % pp != 0:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by "
                         f"pp {pp}")
    if backward not in ("recompute", "store"):
        raise ValueError(f"backward must be recompute|store, got "
                         f"{backward!r}")
    if cfg.layer_windows is not None:
        raise NotImplementedError(
            "pipelined model does not thread per-layer sliding windows "
            "(layer_windows); run windowed models on the non-pipelined "
            "engine")
    for knob in ("embed_ln", "token_type_vocab", "mlm_head", "no_lm_head"):
        if getattr(cfg, knob):
            raise NotImplementedError(
                f"pipelined model does not support {knob}; run this "
                "architecture on the non-pipelined engine")
    if cfg.post_ln:
        raise NotImplementedError(
            "pipelined model does not support post_ln (its stages end "
            "with ln_f); run this architecture on the non-pipelined engine")
    if cfg.fused_loss:
        raise NotImplementedError(
            "fused_loss in the pipelined model (its last stage takes the "
            "head's logits per micro-batch, ROADMAP item 4.1) " + _LATER)


def seeded_params(cfg: TransformerConfig, seed: int,
                  layers: Optional[Sequence[int]] = None, device=None,
                  dtype=torch.float32) -> Dict[str, Any]:
    """A scan-layout tree whose ``blocks`` hold only ``layers`` (default
    all), each layer drawn from its own seed (``mix_seed(seed, layer +
    1)``) and the embedding and head leaves from ``mix_seed(seed, 0)``:
    a rank builds its stage without drawing, or holding, any other
    layer's values, and a plain ``Transformer`` built from the same call
    over every layer holds the same values. Draws on ``device`` (default
    the CPU)."""
    import dataclasses
    layers = list(range(cfg.num_layers)) if layers is None else list(layers)
    one = dataclasses.replace(cfg, num_layers=1)
    dev = torch.device(device) if device is not None else torch.device("cpu")

    def gen(s):
        return torch.Generator(device=dev).manual_seed(s)
    top = init_params(one, gen(mix_seed(seed, 0)), device=dev, dtype=dtype)
    per = [init_params(one, gen(mix_seed(seed, li + 1)), device=dev,
                       dtype=dtype)["blocks"] for li in layers]

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return torch.cat(nodes)
    top["blocks"] = stack(*per)
    return top


class PipelinedTransformer(nn.Module):
    """A decoder ``Transformer`` whose blocks run as ``pp`` pipeline
    stages of ``num_layers / pp`` layers over ``n_micro`` micro-batches
    (the engine's gradient_accumulation_steps). ``backward``: "recompute"
    (default; a stage's backward re-runs it from its saved input) or
    "store" (the forward's graph kept to the backward tick).

    ``params``: a scan-layout tree (``blocks`` leaves ``[L, ...]``, or
    ``[L / pp, ...]`` of this module's stage only); default
    ``init_params`` at ``seed`` (the plain ``Transformer(cfg, seed=seed)``
    values). ``stage``: module docstring. ``forward(batch)`` gives the
    whole batch's f32 logits (every stage, in order; under a ``pipe``
    group, the last stage's broadcast over it)."""

    #: parameter paths are the scan Transformer's (checkpoints, LAMB)
    flax_layout = True
    #: ZeRO-3: the executor gathers each stage's parameters (``gather``)
    zero_gathers_itself = True

    def __init__(self, cfg: TransformerConfig, pp: int, n_micro: int,
                 backward: str = "recompute",
                 params: Optional[Dict[str, Any]] = None, *,
                 seed: int = 0, device=None, stage: Optional[int] = None):
        super().__init__()
        check_pipelined(cfg, pp, backward)
        _check_trainable(cfg)
        if cfg.activation_quant:
            raise NotImplementedError(
                f"activation_quant={cfg.activation_quant!r} in a pipelined "
                "model is not ported to deepspeed_tpu_torch yet (see "
                "ROADMAP.md)")
        if stage is not None and not 0 <= stage < pp:
            raise ValueError(f"stage {stage} of {pp}")
        self.cfg, self.pp, self.n_micro = cfg, pp, n_micro
        self.backward, self.stage = backward, stage
        per = cfg.num_layers // pp
        self.layers = (list(range(cfg.num_layers)) if stage is None
                       else list(range(stage * per, (stage + 1) * per)))
        if params is None:
            gen = torch.Generator(device=device or "cpu").manual_seed(seed)
            params = init_params(cfg, gen, dtype=torch.float32)
        from .generation import ensure_scan_layout
        params = ensure_scan_layout(params, cfg.num_layers)
        blocks = params["blocks"]
        lead = next(iter(_tensors(blocks))).shape[0]
        if lead == cfg.num_layers:
            offset = 0
        elif lead == len(self.layers):
            offset = self.layers[0]
        else:
            raise ValueError(f"params hold {lead} layers: expected "
                             f"{cfg.num_layers} or this stage's "
                             f"{len(self.layers)}")
        for name, sub in params.items():
            if name == "blocks":
                continue
            self.add_module(name, _Leaf(sub))
        self.blocks = nn.ModuleDict(
            (str(li), Block(cfg, layer_params(blocks, li - offset,
                                              clone=True)))
            for li in self.layers)
        self._pipes: Dict[Any, Any] = {}
        self._channel = None
        # this rank's TPContext on the mesh's ``model`` axis (set_tp)
        self.tp = None
        # the step's mean aux of this process's stages (a MoE model)
        self.last_aux: Optional[torch.Tensor] = None

    @property
    def moe(self) -> bool:
        return self.cfg.moe_experts > 0

    def set_tp(self, tp) -> None:
        """Run each stage's blocks, the embedding and the head as rank
        ``tp.rank`` of ``tp.size`` on the mesh's ``model`` axis (the
        plain ``Transformer.set_tp``): the parameters must be (or become,
        as the engine places them) this rank's shards."""
        if tp is not None:
            from ..utils.partitioning import check_tp_model
            check_tp_model(self.cfg, tp.size)
        self.tp = tp
        for blk in self.blocks.values():
            blk.tp = tp
            if hasattr(blk, "moe"):
                blk.moe.tp = tp

    def gather(self, tree):
        """ZeRO-3: a context in which the parameters of ``tree`` (modules,
        or lists and dicts of them) are whole, yielding the tensors to
        differentiate in ``tree_leaves`` order (the executor's
        ``gather``). Each sharded parameter (``ds_zero``, set by the
        engine's partition) is all-gathered over its ZeRO group into a
        fresh leaf that the owning module's attribute lookup finds first;
        the others are yielded as they are."""
        from ..runtime.pipe.mpmd.executor import tree_leaves

        @contextlib.contextmanager
        def held():
            out, put = [], []
            for p in tree_leaves(tree):
                e = getattr(p, "ds_zero", None)
                if e is None or not e.gathered:
                    out.append(p)
                    continue
                full = e.full_data().detach().requires_grad_(True)
                e.owner.__dict__[e.name] = full
                put.append(e)
                out.append(full)
            try:
                yield out
            finally:
                for e in put:
                    e.owner.__dict__.pop(e.name, None)
        return held()

    # ------------------------------------------------------------ pieces

    @property
    def local_stages(self) -> List[int]:
        return list(range(self.pp)) if self.stage is None else [self.stage]

    def stage_blocks(self, s: int) -> List[tuple]:
        """[(global layer, Block)] of stage ``s``."""
        per = self.cfg.num_layers // self.pp
        return [(li, self.blocks[str(li)])
                for li in range(s * per, (s + 1) * per)]

    def head_params(self) -> Dict[str, nn.Module]:
        head = {"ln_f": self.ln_f}
        if self.cfg.tie_embeddings:
            head["wte"] = self.wte
        else:
            head["lm_head"] = self.lm_head
        return head

    def _embed_params(self) -> List[nn.Module]:
        """The leaves stage 0's embedding reads."""
        mods = [self.wte]
        if self.cfg.pos_embed == "learned":
            mods.append(self.wpe)
        return mods

    def _names(self) -> Dict[int, str]:
        return {id(p): n for n, p in self.named_parameters()}

    def embed(self, ids: torch.Tensor,
              seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """[n, mb, S] ids -> [n, mb, S, H] stage-0 inputs in the compute
        dtype, as the plain ``Transformer`` embeds each micro-batch
        (dropout from each micro-batch's seed)."""
        from ..ops.attention import dropout
        cfg = self.cfg
        emb = self.wte.embedding
        dt = cfg.dtype
        ids = torch.as_tensor(ids, device=emb.device).long()
        S = ids.shape[-1]
        if self.tp is None:
            x = F.embedding(ids, emb).to(dt)
        else:
            from .generation import tp_embedding
            x = tp_embedding(ids, emb, self.tp).to(dt)
        if cfg.embed_scale is not None:
            x = x * torch.tensor(cfg.embed_scale, dtype=dt)
        if cfg.pos_embed == "learned":
            pos = torch.arange(S, device=emb.device)[None]
            x = x + F.embedding(pos, self.wpe.embedding).to(dt)[None]
        if seeds is not None and cfg.dropout > 0.0:
            x = torch.stack([dropout(x[m], cfg.dropout, site_generator(
                seeds[m], "embed", x.device)) for m in range(x.shape[0])])
        return x

    def stage_fn(self, blocks, x, extra, stage):
        """One stage's body: its blocks in order (each one remat region
        when ``cfg.remat``); a MoE model's returns (y, its layers' aux
        summed), as the JAX stage body does. ``extra``: the micro-batch's
        ``mask``, dropout ``seed`` and MoE ``gating`` seed (each layer's
        from it as the plain ``Transformer`` makes them)."""
        cfg = self.cfg
        extra = extra if isinstance(extra, dict) else {}
        mask = extra.get("mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=x.device).to(
                torch.bool)[:, None, None, :]
        seed, gseed = extra.get("seed"), extra.get("gating")
        remat = cfg.remat and torch.is_grad_enabled()
        if remat:
            from ..runtime.act_checkpoint import remat_block
        auxes = []
        for li, blk in blocks:
            ls = None if seed is None else mix_seed(int(seed), li + 1)
            gs = None if gseed is None else mix_seed(int(gseed), li + 1)
            args = (x, mask, None, 0, ls, gs)
            x = remat_block(blk, cfg.remat_policy, *args) if remat \
                else blk(*args)
            if self.moe:
                x, a = x
                auxes.append(a)
        if self.moe:
            return x, torch.stack(auxes).sum()
        return x

    def head_logits(self, head, y: torch.Tensor,
                    vocab_parallel: bool = False) -> torch.Tensor:
        """Final norm, then the tied or untied head: f32 logits, as the
        plain ``Transformer`` computes them. Under TP the whole [..., V]
        gathered over the model axis, or with ``vocab_parallel`` this
        rank's vocab shard."""
        from .generation import _col_in, _dense, _layer_norm
        cfg, tp = self.cfg, self.tp
        h = _layer_norm(y, head["ln_f"].p, cfg.layer_norm_eps,
                        cfg.norm == "rmsnorm")
        h = _col_in(h, tp)
        if cfg.tie_embeddings:
            logits = h @ head["wte"].embedding.to(cfg.dtype).transpose(0, 1)
        elif tp is not None and "bias" in head["lm_head"]._parameters:
            from .generation import vocab_slice
            logits = _dense(h, {"kernel": head["lm_head"].kernel})
            logits = logits + vocab_slice(_col_in(head["lm_head"].bias, tp),
                                          tp).to(cfg.dtype)
        else:
            logits = _dense(h, head["lm_head"].p)
        logits = logits.to(torch.float32)
        if cfg.final_logit_softcap:
            from ..ops.attention import apply_softcap
            logits = apply_softcap(logits, cfg.final_logit_softcap)
        if tp is not None and not vocab_parallel:
            from .generation import gather_vocab
            logits = gather_vocab(logits, tp)
        return logits

    def _global_mean_loss(self, head, y, lab, ctx):
        """A micro-batch's share of the global token mean: its nll sum
        times n_micro / ctx (``ctx``: the valid targets' count). Under TP
        from the vocab-parallel logits (no rank forms [mb, S, V])."""
        from .transformer import nll_terms
        logits = self.head_logits(head, y, vocab_parallel=True)[:, :-1]
        tgt = lab[:, 1:]
        valid = tgt != -100
        logz, gold = nll_terms(logits, tgt, valid, self.tp)
        nll_sum = ((logz - gold) * valid).sum()
        return nll_sum * (self.n_micro / ctx)

    # ------------------------------------------------------------- passes

    def _pipeline(self, schedule: str, loss_fn, batch_loss: bool,
                  channel, devices):
        from ..runtime.pipe.mpmd.executor import MPMDPipeline
        key = (schedule, loss_fn, batch_loss, id(channel),
               None if devices is None else tuple(map(str, devices)))
        pipe = self._pipes.get(key)
        if pipe is None:
            if loss_fn is None:
                head_loss = self._global_mean_loss
            elif batch_loss:
                def head_loss(head, ys, lab, ctx):
                    logits = torch.cat([self.head_logits(head, y)
                                        for y in ys])
                    return loss_fn(logits, lab).to(torch.float32)
            else:
                def head_loss(head, y, lab, ctx):
                    return loss_fn(self.head_logits(head, y),
                                   lab).to(torch.float32)
            pipe = MPMDPipeline(
                self.stage_fn, head_loss, pp=self.pp, schedule=schedule,
                devices=devices, channel=channel,
                stages=None if self.stage is None else [self.stage],
                backward=self.backward, batch_loss=batch_loss,
                with_aux=self.moe, gather=self.gather)
            self._pipes[key] = pipe
        return pipe

    def _group_channel(self):
        """This rank's ``pipe`` channel (one per module)."""
        if self._channel is None:
            from ..runtime.pipe.mpmd.channel import PipeGroupChannel
            self._channel = PipeGroupChannel(self.stage)
        return self._channel

    def _stage_trees(self):
        return [self.stage_blocks(s) if s in self.local_stages else None
                for s in range(self.pp)]

    def pipeline_value_and_grad(self, micros: Dict[str, Any], *,
                                schedule: str = "1f1b", loss_fn=None,
                                batch_loss: bool = False,
                                total_valid=None, seeds=None,
                                gating_seeds=None, aux_weight=None,
                                loss_scale=None, devices=None,
                                channel=None):
        """Loss and grads of one step. ``micros``: the step's batch as
        [n_micro, mb, ...] tensors (``input_ids``, optional
        ``attention_mask`` and ``labels``; every [B, ...] leaf a custom
        ``loss_fn`` reads); ``total_valid``: the default objective's count
        of valid targets (default this batch's); ``seeds``: each
        micro-batch's dropout seed (None: no dropout); ``gating_seeds``:
        a MoE model's per-micro-batch seeds of top-2's gating noise (None:
        noise-free gating); ``aux_weight``: a MoE model's weight of the
        routers' aux loss (default ``cfg.moe_aux_weight``); ``devices``:
        one process's per-stage devices; ``channel``: this stage's
        transfer channel (default the ``pipe`` group's; the MPMD stage
        worker passes its socket channel). Returns (loss, {parameter name:
        f32 grad}) for this module's parameters, the grads scaled by
        ``loss_scale`` and divided by n_micro, each rank's own share of
        the embedding and head leaves' (zeros where it has none). A MoE
        model's loss is the task loss plus ``aux_weight`` times the aux
        of this process's stages (JAX's ``train_value_and_grad`` reports
        the task loss plus the weighted aux), the aux itself kept in
        ``last_aux``."""
        cfg = self.cfg
        ids = torch.as_tensor(micros["input_ids"])
        n, mb, S = ids.shape
        if n != self.n_micro:
            raise ValueError(f"{n} micro-batches for a model of n_micro "
                             f"{self.n_micro}")
        dev = self.wte.embedding.device
        labels = micros.get("labels")
        labels = ids if labels is None else torch.as_tensor(labels)
        extras = {}
        if micros.get("attention_mask") is not None:
            extras["mask"] = torch.as_tensor(micros["attention_mask"])
        if seeds is not None and cfg.dropout > 0.0:
            extras["seed"] = list(seeds)
        if gating_seeds is not None and self.moe:
            extras["gating"] = list(gating_seeds)
        aux_w = float(cfg.moe_aux_weight if aux_weight is None
                      else aux_weight)
        if loss_fn is None:
            lab = labels.to(dev)
            ctx = total_valid
            if ctx is None:
                ctx = torch.clamp((lab[:, :, 1:] != -100).sum().to(
                    torch.float32), min=1.0)
            head_labels = lab
        else:
            ctx = None
            head_labels = {k: torch.as_tensor(v).to(dev)
                           for k, v in micros.items()}
            if batch_loss:
                head_labels = {k: v.reshape((n * mb,) + tuple(v.shape[2:]))
                               for k, v in head_labels.items()}
            else:
                head_labels = [{k: v[m] for k, v in head_labels.items()}
                               for m in range(n)]
        first = 0 in self.local_stages
        emb = None
        if first:
            with self.gather(self._embed_params()) as ins, \
                    torch.enable_grad():
                emb = self.embed(ids, extras.get("seed"))
        if channel is None and self.stage is not None:
            channel = self._group_channel()
        pipe = self._pipeline(schedule, loss_fn, batch_loss, channel,
                              devices)
        loss, aux, grads, hgrads, dm = pipe.value_and_grad(
            self._stage_trees(), self.head_params(),
            None if emb is None else emb.detach(), head_labels,
            extras=extras, loss_ctx=ctx, loss_scale=loss_scale,
            aux_cotangent=aux_w if self.moe else 0.0,
            n_micro=n, boundary=((mb, S, cfg.hidden_size), cfg.dtype, dev))
        if self.moe:
            self.last_aux = aux
            loss = loss + aux_w * aux
        from ..runtime.pipe.mpmd.executor import tree_leaves
        names = self._names()
        out: Dict[str, torch.Tensor] = {}

        def put(p, g):
            if g is None:
                return
            name = names[id(p)]
            out[name] = g if name not in out else out[name] + g
        for s in self.local_stages:
            for p, g in zip(tree_leaves(self.stage_blocks(s)), grads[s]):
                put(p, g)
        if first:
            # the embedding's leaves as the forward used them (ZeRO-3:
            # gathered), each put under its parameter
            own = tree_leaves(self._embed_params())
            gs = torch.autograd.grad(emb, ins, grad_outputs=dm)
            for p, g in zip(own, gs):
                put(p, g.to(torch.float32))
        if self.pp - 1 in self.local_stages:
            # the head's grads after the embedding's: the tied wte's sum
            # in the JAX executor's order
            for p, g in zip(tree_leaves(self.head_params()), hgrads):
                put(p, g)
        for name, p in self.named_parameters():
            if p.requires_grad and name not in out:
                # a ZeRO-3 slab's grad is its whole tensor's
                e = getattr(p, "ds_zero", None)
                out[name] = torch.zeros(p.shape if e is None else e.shape,
                                        dtype=torch.float32, device=p.device)
        return loss, out

    def forward(self, batch, train: bool = False, devices=None):
        """The whole batch's f32 logits [B, S, V] (eval; under a ``pipe``
        group every rank returns the last stage's, broadcast); a MoE
        model's ``(logits, aux)``, the aux summed over the stages and
        averaged over the micro-batches, as the JAX apply returns it."""
        cfg = self.cfg
        if isinstance(batch, dict):
            ids, attention_mask = batch["input_ids"], batch.get(
                "attention_mask")
        else:
            ids, attention_mask = batch, None
        ids = torch.as_tensor(ids)
        B, S = ids.shape
        if B % self.n_micro:
            raise ValueError(f"batch {B} not divisible by n_micro "
                             f"{self.n_micro}")
        n, mb = self.n_micro, B // self.n_micro
        dev = self.wte.embedding.device
        extras = {}
        if attention_mask is not None:
            extras["mask"] = torch.as_tensor(attention_mask).reshape(n, mb,
                                                                     S)
        channel = None if self.stage is None else self._group_channel()
        pipe = self._pipeline("gpipe", None, False, channel, devices)
        with torch.no_grad():
            first = 0 in self.local_stages
            micros = None
            if first:
                with self.gather(self._embed_params()):
                    micros = self.embed(ids.reshape(n, mb, S))
            outs = pipe.forward(
                self._stage_trees(), micros, extras=extras, n_micro=n,
                boundary=((mb, S, cfg.hidden_size), cfg.dtype, dev))
            if self.moe:
                outs, aux = outs
            logits = torch.empty((B, S, cfg.vocab_size),
                                 dtype=torch.float32, device=dev)
            if outs:
                head = self.head_params()
                with self.gather(head):
                    logits.copy_(torch.cat([self.head_logits(head,
                                                             y.to(dev))
                                            for y in outs]))
        if self.stage is not None and self.pp > 1:
            from .. import comm
            comm.broadcast(logits, src=self.pp - 1, axis="pipe")
            if self.moe:
                comm.all_reduce(aux, axis="pipe")
        return (logits, aux) if self.moe else logits

    def tp_rules(self) -> Dict[str, Any]:
        """The JAX model's table: blocks lead with the ``pipe`` axis on
        the layer dim (the stage's split, which the port makes by
        building each rank's stage), experts on ``expert``, the rest as
        the plain model's rules. ``sharding_rules=`` this table runs each
        stage's Megatron layers at the rank's ``model`` coordinate."""
        from ..utils.partitioning import PartitionSpec as P

        def block(*spec):
            return P(*(("pipe",) + spec))

        return {
            r"blocks/.*attn_qkv/kernel": block(None, "model"),
            r"blocks/.*attn_qkv/bias": block("model"),
            r"blocks/.*attn_proj/kernel": block("model", None),
            r"blocks/.*mlp_fc/kernel": block(None, "model"),
            r"blocks/.*mlp_fc/bias": block("model"),
            r"blocks/.*mlp_gate/kernel": block(None, "model"),
            r"blocks/.*mlp_gate/bias": block("model"),
            r"blocks/.*mlp_proj/kernel": block("model", None),
            r"blocks/.*experts/fc/kernel": block("expert", None, "model"),
            r"blocks/.*experts/fc/bias": block("expert", "model"),
            r"blocks/.*experts/gate/kernel": block("expert", None, "model"),
            r"blocks/.*experts/gate/bias": block("expert", "model"),
            r"blocks/.*experts/proj/kernel": block("expert", "model", None),
            r"blocks/.*experts/proj/bias": block("expert", None),
            r"blocks/.*moe/gate/kernel": block(),
            r"blocks/": P("pipe"),
            r"wte/embedding": P("model", None),
            r"lm_head/kernel": P(None, "model"),
        }


def _tensors(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    else:
        yield node


def build_pipelined_model(name_or_cfg, pp: int, n_micro: int, **overrides):
    """(PipelinedTransformer, cfg) for a preset name (with config
    overrides) or a ``TransformerConfig``; ``backward``, ``seed``,
    ``device``, ``stage`` and ``params`` go to the model."""
    from .transformer import get_config
    kw = {k: overrides.pop(k) for k in ("backward", "seed", "device",
                                        "stage", "params")
          if k in overrides}
    cfg = (name_or_cfg if isinstance(name_or_cfg, TransformerConfig)
           else get_config(name_or_cfg, **overrides))
    return PipelinedTransformer(cfg, pp=pp, n_micro=n_micro, **kw), cfg
