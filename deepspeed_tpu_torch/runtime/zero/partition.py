"""ZeRO stages 0-3 across the ranks of a ``torch.distributed`` process
group: the engine's data-parallel state and its collectives (the port's
counterpart of what the JAX engine gets from XLA's SPMD partitioner under
``runtime/zero/stages.py``'s shardings; reference
``runtime/zero/stage_1_and_2.py`` and ``stage3.py``).

Each trainable parameter is one :class:`ZeroParam`, split over the ZeRO
group along the dims :class:`~.stages.ZeroShardingPolicy` picks:

* the optimizer's tensors (the fp32 master, or the parameters themselves
  in fp32 and pure-bf16 training, and the moments) hold this rank's slab
  along ``mdim`` from stage 1 up, the whole tensor at stage 0;
* gradients are reduce-scattered along ``gdim`` from stage 2 up, after
  each micro-batch's backward (stage 3: inside it), else accumulated whole
  and all-reduced (mean) once a step;
* compute parameters hold this rank's slab along ``pdim`` at stage 3 and
  are gathered around each use (:meth:`ZeroPartition.install_gathers`).

**Expert leaves** (a parameter whose name has an ``experts`` part, the
JAX engine's ``expert_fn``: a MoE layer's stacked [E, ...] expert
kernels and biases) first split their E dim over the mesh's ``expert``
axis: each rank holds and trains only its E / ep experts
(``ZeroParam.eslab``), and the MoE layer's all-to-all brings it their
queues. ZeRO then works on that local piece over
:data:`~...parallel.mesh.EXPERT_ZERO_AXES` (``data``, ``seq``): its
slabs, stage-3 gathers and gradient reductions stay within that group.
The all-to-all's backward has already summed, on each expert's owner,
the gradients of every rank of its expert group, so the reduction over
the expert-data group covers every rank's share, and it is divided by
the same ``grad_world`` (the ranks that take distinct samples) as every
other leaf's. Every other leaf keeps ``ZERO_AXES``.

**Tensor-parallel leaves** (the engine's ``tp`` map: a leaf the model's
TP rules shard over the mesh's ``model`` axis) first take this rank's
shard of the whole tensor (``ZeroParam.tp``, a
``utils.partitioning.TPShard``: per-head qkv columns, padded vocab
rows), and ZeRO works on that shard over the ZeRO axes only: the
policy's dims come from the whole shape and the TP spec (a composed TP
dim is split within the shard), stage 3 gathers the shard, never over
``model``, and the gradients' reductions stay in the ZeRO group. The
model ranks hold equal copies of every other leaf. Their gradients come
out equal on each only because the model makes them so: a replicated
leaf used outside the sharded computation gets the same gradient on
every rank, and one used on a rank's share of it (``q_norm`` /
``k_norm`` on its heads, an output bias sliced to its vocab rows) goes
through ``comm.tp_copy_to``, which sums the ranks' partial gradients
over ``model`` (``models/transformer.py``).

At a world of one every split is 1-way and the same collectives run, so
one GPU runs the sharded path with real NCCL calls.

**Stage 3's gathers.** A unit is one module whose parameters are gathered
together: each block of a ``blocks`` ``ModuleList``, each module whose
class sets ``zero_unit = True`` (``TiledLinear``'s tiles), and the root
for the rest. A unit's forward pre-hook all-gathers each of its sharded
parameters through :class:`_Gather` and puts the full tensor in the
owning module's ``__dict__``, where attribute lookup finds it before the
shard in ``_parameters``; the forward hook takes it out again. The shard
stays the leaf autograd differentiates: :class:`_Gather`'s backward
reduce-scatters the full gradient into the accumulator and gives the
shard none. Nothing is freed by resizing storage: a gathered tensor
lives while something references it. Without remat, autograd would keep
every gathered weight to the backward, so the root's forward runs under
``saved_tensors_hooks`` that store a gathered tensor (or a view of it) as
a token and gather it again when the backward unpacks it. Under remat
(``torch.utils.checkpoint``), the region's own hooks take over inside
each block and its recomputation runs the block's pre-hook again: the
weights are gathered a second time in the backward.

**The step tail.** One all-reduce over :data:`~...parallel.mesh.
STEP_AXES` (the ZeRO axes and ``model``; and ``pipe`` under a pipeline,
whose stages hold their own blocks and each a copy of the embedding and
head leaves, counted on pipe rank 0, and whose loss is the last
stage's) carries every leaf's squared
grad norm (a leaf whole on its ZeRO group counted on that group's rank 0
only, a leaf whole on the model axis on model rank 0 only), the count of
non-finite leaves and the loss (model rank 0's); one host read follows,
as in the single-process engine.
The leaf norms are summed on the device in parameter order, so at a world
of one the grad norm is the single-process engine's, bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch import nn

from ... import comm
from ...parallel.mesh import EXPERT_ZERO_AXES, STEP_AXES, ZERO_AXES
from .stages import ZeroShardingPolicy


def slab(t: torch.Tensor, dim: Optional[int], rank: int, world: int
         ) -> torch.Tensor:
    """This rank's slab of ``t`` along ``dim`` (a view; ``t`` if None)."""
    if dim is None:
        return t
    size = t.shape[dim] // world
    return t.narrow(dim, rank * size, size)


class ZeroParam:
    """One trainable parameter's place in the partition: where it lives
    (``owner._parameters[name]``), its shape (``full_shape`` the whole
    tensor's, ``shape`` this rank's expert piece or TP shard of it), the
    dims it splits on (None: whole), its ZeRO group (``axes``, with this
    rank's ``rank`` in it of ``world``), an expert leaf's ``eslab`` (dim
    0, its expert rank, ep), a TP leaf's ``tp`` (this rank's ``TPShard``;
    ``tp_maps`` every model rank's, ``tp_spec`` the leaf's TP spec) and
    its index in the engine's parameter list."""

    __slots__ = ("param", "owner", "name", "shape", "full_shape", "pdim",
                 "mdim", "gdim", "index", "partition", "aliased", "axes",
                 "rank", "world", "eslab", "tp", "tp_maps", "tp_spec")

    def __init__(self, partition, index, owner, name, param, policy,
                 group, eslab=None, tp=None, path: str = ""):
        self.partition = partition
        self.index = index
        self.owner, self.name, self.param = owner, name, param
        self.axes, self.rank, self.world = group
        self.eslab = eslab
        self.full_shape = tuple(param.shape)
        shape = list(self.full_shape)
        if eslab is not None:
            if shape[0] % eslab[2]:
                raise ValueError(f"expert leaf '{name}' of shape "
                                 f"{self.full_shape}: {shape[0]} experts "
                                 f"do not split over {eslab[2]} ranks")
            shape[0] //= eslab[2]
        # tp: (the leaf's TP spec, every model rank's TPShard, this
        # rank's index), or None
        self.tp_spec, self.tp_maps = (tp[0], tp[1]) if tp else (None, None)
        self.tp = self.tp_maps[tp[2]] if tp else None
        if self.tp is not None:
            shape[self.tp.dim] = self.tp.local
        self.shape = tuple(shape)
        is_expert = self.axes == EXPERT_ZERO_AXES
        # the policy reads the whole shape beside its TP spec; the dims
        # it gives are this rank's shard's too
        dshape = self.full_shape if self.tp is not None else self.shape
        kw = dict(tp_spec=self.tp_spec, path=path)
        self.pdim = policy.param_dim(dshape, is_expert, **kw)
        self.mdim = policy.master_dim(dshape, is_expert, **kw)
        self.gdim = policy.grad_dim(dshape, is_expert, **kw)
        if self.tp is not None and self.tp.local % self.world:
            d = self.tp.dim % len(shape)
            if d in (self.pdim, self.mdim, self.gdim):
                raise NotImplementedError(
                    f"'{name}': its TP shard of {self.tp.local} along dim "
                    f"{d} (uneven heads) does not split into {self.world} "
                    "ZeRO slabs; a ZeRO split of an uneven TP shard is not "
                    "ported to deepspeed_tpu_torch yet (see ROADMAP.md)")
        self.aliased = False

    @property
    def gathered(self) -> bool:
        """Held as a slab between uses (stage 3)."""
        return self.pdim is not None

    def local(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's expert piece or TP shard of the whole tensor
        (itself for a leaf that is neither)."""
        if self.eslab is not None:
            whole = slab(whole, *self.eslab)
        return whole if self.tp is None else self.tp.take(whole)

    def full_data(self) -> torch.Tensor:
        """The compute parameter gathered over its ZeRO group (an expert
        leaf's local experts)."""
        p = self.param.data
        if self.pdim is None:
            return p
        return comm.all_gather(p, axis=self.axes, gather_dim=self.pdim)

    def whole_data(self) -> torch.Tensor:
        """The whole parameter, an expert leaf's every expert and a TP
        leaf's every shard too."""
        p = self.full_data()
        if self.tp is not None:
            from ...utils.partitioning import tp_assemble
            n = len(self.tp_maps)
            # shards of uneven heads differ in extent: gathered padded to
            # the widest, each cut back to its own
            d = self.tp.dim % p.dim()
            most = max(m.local for m in self.tp_maps)
            if p.shape[d] < most:
                pad = list(p.shape)
                pad[d] = most - p.shape[d]
                p = torch.cat([p, p.new_zeros(pad)], d)
            pieces = comm.all_gather(p, axis="model", tiled=False,
                                     gather_dim=0).unbind(0)
            p = tp_assemble([pc.narrow(d, 0, m.local) for pc, m in
                             zip(pieces[:n], self.tp_maps)], self.tp_maps)
        if self.eslab is None:
            return p
        return comm.all_gather(p, axis="expert", gather_dim=0)


class _Gather(torch.autograd.Function):
    """shard -> the whole parameter; the backward reduces the gradient into
    the partition's accumulator and gives the shard none."""

    @staticmethod
    def forward(ctx, shard, entry):
        ctx.entry = entry
        return entry.full_data()

    @staticmethod
    def backward(ctx, grad):
        e = ctx.entry
        e.partition.add_grad(e, grad)
        return None, None


class _Token:
    """A saved gathered tensor, stored as the view to take of a fresh
    gather when the backward unpacks it."""

    __slots__ = ("entry", "size", "stride", "offset")

    def __init__(self, entry, t):
        self.entry = entry
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


class ZeroPartition:
    """The data-parallel state of one engine (see the module docstring).

    ``params``: the engine's trainable parameters, in order; ``values``:
    an iterator of (parameter name, whole value) to fill parameters that
    are still on ``meta`` (``zero.Init``), one leaf at a time.
    ``master_dtype``: fp32 with a master, else the compute dtype."""

    def __init__(self, module: nn.Module, params: List[nn.Parameter],
                 policy: ZeroShardingPolicy, rank: int, world: int,
                 compute_dtype: torch.dtype, master_dtype: torch.dtype,
                 grad_accum_dtype: torch.dtype, device: torch.device,
                 values: Optional[Iterator[Tuple[str, torch.Tensor]]] = None,
                 grad_world: Optional[int] = None, mesh=None, tp_of=None,
                 pipe_shared: Optional[List[str]] = None):
        self.module = module
        # the ranks whose losses are averaged: the ZeRO group less its seq
        # axis, whose ranks hold shares of one loss (summed, not averaged)
        self.grad_world = world if grad_world is None else grad_world
        self.policy, self.stage = policy, policy.stage
        self.rank, self.world = rank, world
        self.world_all = (world if mesh is None
                          else mesh.axes_size(ZERO_AXES))
        self.compute_dtype, self.master_dtype = compute_dtype, master_dtype
        self.grad_accum_dtype = grad_accum_dtype
        self.device = device
        owners = {}
        for mname, mod in module.named_modules():
            for pname, p in mod._parameters.items():
                if p is not None:
                    owners.setdefault(id(p), (mod, pname,
                                              f"{mname}.{pname}".lstrip(".")))
        # the expert leaves' groups (``mesh``: the engine's MeshManager;
        # without one every leaf is over the ZeRO group given)
        dense = (ZERO_AXES, rank, world)
        expert, eslab = dense, None
        # tp_of(parameter name, whole shape): the engine's map of a TP
        # leaf, (TP spec, every model rank's TPShard), or None
        self.model_rank = 0 if mesh is None else mesh.axis_rank("model")
        # a pipeline's ranks: each holds its stage's blocks and a copy of
        # the ``pipe_shared`` leaves (embedding, head); the step tail then
        # reduces over ``pipe`` too
        self.pipe_rank = 0 if mesh is None else mesh.axis_rank("pipe")
        self.step_axes = (STEP_AXES if mesh is None
                          or mesh.shape["pipe"] == 1
                          else ("pipe",) + STEP_AXES)
        shared = set(pipe_shared or ())
        names: List[str] = []
        if mesh is not None:
            expert = (EXPERT_ZERO_AXES, mesh.axis_rank(EXPERT_ZERO_AXES),
                      mesh.axes_size(EXPERT_ZERO_AXES))
            ep = mesh.shape["expert"]
            eslab = (0, mesh.axis_rank("expert"), ep) if ep > 1 else None
        self.entries: List[ZeroParam] = []
        by_name: Dict[str, ZeroParam] = {}
        for i, p in enumerate(params):
            mod, pname, full = owners[id(p)]
            is_expert = mesh is not None and "experts" in full.split(".")
            tp = tp_of(full, tuple(p.shape)) if tp_of is not None else None
            e = ZeroParam(self, i, mod, pname, p, policy,
                          expert if is_expert else dense,
                          eslab if is_expert else None,
                          tp=None if tp is None else (*tp, self.model_rank),
                          path=full)
            self.entries.append(e)
            by_name[full] = e
            names.append(full)
        self.masters: List[Optional[torch.Tensor]] = [None] * len(params)
        if values is not None:
            for name, value in values:
                if name in by_name:
                    self._place(by_name[name], value)
        for e in self.entries:
            if self.masters[e.index] is None:
                if e.param.is_meta:
                    raise ValueError(f"parameter '{e.name}' is on meta and "
                                     "no value was given for it")
                self._place(e, e.param.data)
        self.accum: List[Optional[torch.Tensor]] = [None] * len(params)
        self._live: Dict[int, ZeroParam] = {}
        self._hooks = []
        self._saved_ctx = None
        # a leaf whole on every rank of its ZeRO group counts on its rank
        # 0, one whole on every model rank on model rank 0, one every
        # pipe rank holds on pipe rank 0
        self._rep = torch.tensor([(e.mdim is None and e.rank != 0)
                                  or (e.tp is None and self.model_rank != 0)
                                  or (n in shared and self.pipe_rank != 0)
                                  for e, n in zip(self.entries, names)],
                                 device=device)
        # a TP leaf with kv heads that several model ranks hold: the
        # weight of its slab's positions (along mdim, as the step's grads
        # and the master are cut) in every norm, 0 where a lower model
        # rank counts them; else None (the norms below apply it)
        self._owned = [self._owned_weight(e) for e in self.entries]

    def _owned_weight(self, e: ZeroParam) -> Optional[torch.Tensor]:
        m = None if e.tp is None else e.tp.owned_mask()
        if m is None:
            return None
        nd = len(e.shape)
        d = e.tp.dim % nd
        shape = [1] * nd
        shape[d] = m.numel()
        m = m.view(shape)
        if e.mdim is not None and e.mdim % nd == d:
            m = slab(m, d, e.rank, e.world)
        return m.to(self.device)

    # ------------------------------------------------------------ placement

    def _place(self, e: ZeroParam, full: torch.Tensor) -> None:
        """Fill entry ``e`` from its whole value: the master slab along
        mdim, the compute parameter (its slab along pdim at stage 3)."""
        if tuple(full.shape) != e.full_shape:
            raise ValueError(f"value of '{e.name}' has shape "
                             f"{tuple(full.shape)}, expected {e.full_shape}")
        full = e.local(full.detach()).to(self.device, torch.float32)
        data = slab(full, e.pdim, e.rank, e.world).to(
            self.compute_dtype).contiguous()
        if data.data_ptr() == full.data_ptr():
            data = data.clone()
        if e.param.is_meta:
            p = nn.Parameter(data, requires_grad=e.param.requires_grad)
            e.owner._parameters[e.name] = p
            e.param = p
        else:
            e.param.data = data
        e.param.ds_zero = e
        if (e.mdim is None and e.pdim is None
                and self.master_dtype == self.compute_dtype):
            self.masters[e.index] = e.param.data      # the optimizer's own
            e.aliased = True
        else:
            self.masters[e.index] = slab(full, e.mdim, e.rank,
                                         e.world).to(
                self.master_dtype).clone()

    @property
    def params(self) -> List[nn.Parameter]:
        return [e.param for e in self.entries]

    def shard_sizes(self) -> Dict[str, int]:
        """Bytes this rank holds, by kind (compute params, masters)."""
        return {"params": sum(e.param.numel() * e.param.element_size()
                              for e in self.entries),
                "masters": sum(m.numel() * m.element_size()
                               for m, e in zip(self.masters, self.entries)
                               if not e.aliased)}

    # -------------------------------------------------------- stage-3 gathers

    def install_gathers(self) -> None:
        """Stage 3: the unit hooks that gather sharded parameters around
        each forward (see the module docstring). A module that gathers
        its own (``zero_gathers_itself``: a pipelined model, whose
        executor gathers each stage around its ticks) gets none."""
        if not any(e.gathered for e in self.entries) or \
                getattr(self.module, "zero_gathers_itself", False):
            return
        units: List[nn.Module] = []
        blocks = getattr(self.module, "blocks", None)
        if isinstance(blocks, nn.ModuleList):
            units.extend(blocks)
        units.extend(m for m in self.module.modules()
                     if getattr(type(m), "zero_unit", False)
                     and m not in units)
        claimed = {}
        for u in units:
            for m in u.modules():
                claimed.setdefault(id(m), u)
        per_unit: Dict[int, List[ZeroParam]] = {}
        for e in self.entries:
            if e.gathered:
                u = claimed.get(id(e.owner), self.module)
                per_unit.setdefault(id(u), []).append(e)
        for u in units:
            mine = per_unit.get(id(u))
            if mine:
                self._hooks.append(u.register_forward_pre_hook(
                    lambda mod, args, es=mine: self._gather(es)))
                self._hooks.append(u.register_forward_hook(
                    lambda mod, args, out, es=mine: self._release(es),
                    always_call=True))
        root = per_unit.get(id(self.module), [])
        self._hooks.append(self.module.register_forward_pre_hook(
            lambda mod, args: self._enter_root(root)))
        self._hooks.append(self.module.register_forward_hook(
            lambda mod, args, out: self._exit_root(root), always_call=True))

    def _gather(self, entries: List[ZeroParam]) -> None:
        for e in entries:
            full = _Gather.apply(e.param, e)
            self._live[full.untyped_storage().data_ptr()] = e
            e.owner.__dict__[e.name] = full

    def _release(self, entries: List[ZeroParam]) -> None:
        for e in entries:
            full = e.owner.__dict__.pop(e.name, None)
            if full is not None:
                self._live.pop(full.untyped_storage().data_ptr(), None)

    def _enter_root(self, entries: List[ZeroParam]) -> None:
        if torch.is_grad_enabled() and self._saved_ctx is None:
            self._saved_ctx = torch.autograd.graph.saved_tensors_hooks(
                self._pack, self._unpack)
            self._saved_ctx.__enter__()
        self._gather(entries)

    def _exit_root(self, entries: List[ZeroParam]) -> None:
        self._release(entries)
        if self._saved_ctx is not None:
            ctx, self._saved_ctx = self._saved_ctx, None
            ctx.__exit__(None, None, None)

    def _pack(self, t: torch.Tensor):
        if not self._live or t.layout != torch.strided or t.is_meta:
            return t
        e = self._live.get(t.untyped_storage().data_ptr())
        if e is None or t.dtype != self.compute_dtype:
            return t
        return _Token(e, t)

    def _unpack(self, x):
        if isinstance(x, _Token):
            return x.entry.full_data().as_strided(x.size, x.stride, x.offset)
        return x

    @contextlib.contextmanager
    def gathered(self, params: Iterable[nn.Parameter],
                 modifier_rank: Optional[int] = None):
        """Whole ``params`` in ``.data`` for the block (``zero.
        GatheredParameters``; an expert leaf with all its experts). With
        ``modifier_rank``, that rank's values are broadcast on exit and
        written back into every rank's master and parameter slabs."""
        es = [p.ds_zero for p in params
              if getattr(p, "ds_zero", None) is not None
              and p.ds_zero.partition is self]
        shards = {}
        for e in es:
            if e.gathered or e.eslab is not None or e.tp is not None:
                shards[e.index] = e.param.data
                e.param.data = e.whole_data()
        try:
            yield
        except BaseException:
            for e in es:
                if e.index in shards:
                    e.param.data = shards[e.index]
            raise
        for e in es:
            whole = e.param.data
            if modifier_rank is not None:
                comm.broadcast(whole, src=modifier_rank, axis=ZERO_AXES)
            full = e.local(whole)
            if modifier_rank is not None and not e.aliased:
                self.masters[e.index].copy_(
                    slab(full, e.mdim, e.rank, e.world))
            if e.index in shards:
                shard = shards[e.index]
                if modifier_rank is not None:   # (an aliased master too)
                    shard.copy_(slab(full, e.pdim, e.rank, e.world))
                e.param.data = shard

    # ------------------------------------------------------------- gradients

    def add_grad(self, e: ZeroParam, grad: torch.Tensor) -> None:
        """One micro-batch's whole gradient of ``e``: reduce-scattered
        (summed, over ``grad_world``) along gdim into this rank's slab, or
        kept whole for the step's all-reduce, then added into the
        accumulator."""
        g = grad.to(self.grad_accum_dtype)
        if e.gdim is not None:
            g = comm.reduce_scatter(g, axis=e.axes, scatter_dim=e.gdim)
            g.div_(self.grad_world)
        a = self.accum[e.index]
        if a is None:
            self.accum[e.index] = g
        else:
            a.add_(g)

    def after_backward(self) -> None:
        """Take the grads autograd left in ``.grad`` (every parameter not
        gathered by a unit) into the accumulator."""
        for e in self.entries:
            p = e.param
            if e.gathered:
                if p.grad is not None:
                    raise RuntimeError(f"gathered parameter '{e.name}' got a "
                                       "gradient outside its unit")
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            self.add_grad(e, g)

    def _slot_shape(self, e: ZeroParam) -> Tuple[int, ...]:
        shape = list(e.shape)
        if e.gdim is not None:
            shape[e.gdim] //= e.world
        return tuple(shape)

    def step_grads(self, denom: float) -> List[torch.Tensor]:
        """The accumulated grads as the optimizer's slabs (mdim), the
        whole ones all-reduced (summed, over ``grad_world``) first, in
        fp32 divided by ``denom``; the accumulator is emptied."""
        grads = []
        for e in self.entries:
            a = self.accum[e.index]
            if a is None:
                a = torch.zeros(self._slot_shape(e), device=self.device,
                                dtype=self.grad_accum_dtype)
            if e.gdim is None:
                comm.all_reduce(a, op=comm.ReduceOp.SUM, axis=e.axes)
                a = slab(a.div_(self.grad_world), e.mdim, e.rank, e.world)
            grads.append(a)
        self.accum = [None] * len(self.entries)
        if all(g.dtype == torch.float32 for g in grads):
            torch._foreach_div_(grads, denom)
            return grads
        return [g.to(torch.float32) / denom for g in grads]

    def step_stats(self, grads: List[torch.Tensor],
                   losses: List[torch.Tensor],
                   auxes: Optional[List[torch.Tensor]] = None
                   ) -> Tuple[float, float, float, Optional[float]]:
        """(finite flag, squared global grad norm, mean loss of the global
        batch, mean of ``auxes`` over the batch ranks or None) from one
        all-reduce of this rank's partials, read to the host once."""
        n = len(grads)
        normed = [g if w is None else g * w
                  for g, w in zip(grads, self._owned)]
        sq = torch.stack(torch._foreach_norm(normed)).square()
        # a replicated leaf counts on its group's rank 0
        sq = torch.where(self._rep, torch.zeros_like(sq), sq)
        bad = torch.stack([~torch.isfinite(g).all() for g in grads]).sum()
        loss = torch.stack([x.detach().to(torch.float32)
                            for x in losses]).mean()
        if self.model_rank:         # the model ranks share one loss
            loss = torch.zeros_like(loss)
        parts = [sq, bad.to(sq.dtype).view(1), loss.view(1)]
        if auxes:
            # and one router: the aux counts on model rank 0
            aux = torch.stack(auxes).mean().view(1)
            parts.append(torch.zeros_like(aux) if self.model_rank else aux)
        packed = torch.cat(parts)
        comm.all_reduce(packed, op=comm.ReduceOp.SUM, axis=self.step_axes)
        total = packed[:n].sum()
        finite = (packed[n] == 0).to(torch.float32)
        # the seq ranks of a sample hold shares of one loss; the MoE aux
        # of every rank is a whole group's, so it averages over them all
        host = [finite, total, packed[n + 1] / self.grad_world]
        if auxes:
            host.append(packed[n + 2] / self.world_all)
        finite_h, sq_h, loss_h, *aux = torch.stack(host).tolist()
        return finite_h, sq_h, loss_h, (aux[0] if aux else None)

    def owned_sq(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """[n] f32 squared norms of this rank's slabs ``tensors`` (one an
        entry, cut as the masters are), each over the positions this rank
        counts: a KV head that several model ranks hold counts on the
        lowest (``TPShard.owned_mask``). The sentinel's param norm, and
        LAMB's through :meth:`leaf_sq`."""
        return torch.stack([
            (t.to(torch.float32) if w is None
             else t.to(torch.float32) * w).square().sum()
            for t, w in zip(tensors, self._owned)])

    def leaf_sq(self, ps: List[torch.Tensor],
                us: List[torch.Tensor]) -> torch.Tensor:
        """LAMB's ``norm_sq_reduce``: this rank's slabs of the parameters
        and of their updates -> the whole leaves' [n, 2] squared norms
        (a replicated leaf counted once)."""
        sq = torch.stack([self.owned_sq(ps), self.owned_sq(us)], dim=1)
        sq = torch.where(self._rep[:, None], torch.zeros_like(sq), sq)
        return comm.all_reduce(sq.contiguous(), op=comm.ReduceOp.SUM,
                               axis=self.step_axes)

    def refresh_params(self) -> None:
        """After the update: each compute parameter from the masters, the
        other ranks' slabs all-gathered."""
        for e in self.entries:
            if e.aliased:
                continue
            m = self.masters[e.index]
            v = m if m.dtype == self.compute_dtype else m.to(
                self.compute_dtype)
            if e.pdim is not None and e.pdim == e.mdim:
                e.param.data.copy_(v)
                continue
            full = v if e.mdim is None else comm.all_gather(
                v, axis=e.axes, gather_dim=e.mdim)
            e.param.data.copy_(slab(full, e.pdim, e.rank, e.world))
