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

**The step tail.** One all-reduce carries every leaf's squared grad norm
(a replicated leaf counted on rank 0 only), the count of non-finite leaves
and the loss; one host read follows, as in the single-process engine.
The leaf norms are summed on the device in parameter order, so at a world
of one the grad norm is the single-process engine's, bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch import nn

from ... import comm
from ...parallel.mesh import ZERO_AXES
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
    (``owner._parameters[name]``), its full shape, the dims it splits on
    (None: whole) and its index in the engine's parameter list."""

    __slots__ = ("param", "owner", "name", "shape", "pdim", "mdim", "gdim",
                 "index", "partition", "aliased")

    def __init__(self, partition, index, owner, name, param, policy):
        self.partition = partition
        self.index = index
        self.owner, self.name, self.param = owner, name, param
        self.shape = tuple(param.shape)
        self.pdim = policy.param_dim(self.shape)
        self.mdim = policy.master_dim(self.shape)
        self.gdim = policy.grad_dim(self.shape)
        self.aliased = False

    @property
    def gathered(self) -> bool:
        """Held as a slab between uses (stage 3)."""
        return self.pdim is not None

    def full_data(self) -> torch.Tensor:
        """The whole compute parameter (an all-gather when gathered)."""
        p = self.param.data
        if self.pdim is None:
            return p
        return comm.all_gather(p, axis=ZERO_AXES, gather_dim=self.pdim)


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
                 values: Optional[Iterator[Tuple[str, torch.Tensor]]] = None):
        self.module = module
        self.policy, self.stage = policy, policy.stage
        self.rank, self.world = rank, world
        self.compute_dtype, self.master_dtype = compute_dtype, master_dtype
        self.grad_accum_dtype = grad_accum_dtype
        self.device = device
        owners = {}
        for mname, mod in module.named_modules():
            for pname, p in mod._parameters.items():
                if p is not None:
                    owners.setdefault(id(p), (mod, pname,
                                              f"{mname}.{pname}".lstrip(".")))
        self.entries: List[ZeroParam] = []
        by_name: Dict[str, ZeroParam] = {}
        for i, p in enumerate(params):
            mod, pname, full = owners[id(p)]
            e = ZeroParam(self, i, mod, pname, p, policy)
            self.entries.append(e)
            by_name[full] = e
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
        self._rep = torch.tensor([e.mdim is None for e in self.entries],
                                 device=device)

    # ------------------------------------------------------------ placement

    def _place(self, e: ZeroParam, full: torch.Tensor) -> None:
        """Fill entry ``e`` from its whole value: the master slab along
        mdim, the compute parameter (its slab along pdim at stage 3)."""
        full = full.detach().to(self.device, torch.float32)
        if tuple(full.shape) != e.shape:
            raise ValueError(f"value of '{e.name}' has shape "
                             f"{tuple(full.shape)}, expected {e.shape}")
        data = slab(full, e.pdim, self.rank, self.world).to(
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
            self.masters[e.index] = slab(full, e.mdim, self.rank,
                                         self.world).to(
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
        each forward (see the module docstring)."""
        if not any(e.gathered for e in self.entries):
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
        GatheredParameters``). With ``modifier_rank``, that rank's values
        are broadcast on exit and written back into every rank's master
        and parameter slabs."""
        es = [p.ds_zero for p in params
              if getattr(p, "ds_zero", None) is not None
              and p.ds_zero.partition is self]
        shards = {}
        for e in es:
            if e.gathered:
                shards[e.index] = e.param.data
                e.param.data = e.full_data()
        try:
            yield
        except BaseException:
            for e in es:
                if e.index in shards:
                    e.param.data = shards[e.index]
            raise
        for e in es:
            full = e.param.data
            if modifier_rank is not None:
                comm.broadcast(full, src=modifier_rank, axis=ZERO_AXES)
                if not e.aliased:
                    self.masters[e.index].copy_(
                        slab(full, e.mdim, self.rank, self.world))
            if e.index in shards:
                e.param.data = (slab(full, e.pdim, self.rank, self.world)
                                .contiguous() if modifier_rank is not None
                                else shards[e.index])

    # ------------------------------------------------------------- gradients

    def add_grad(self, e: ZeroParam, grad: torch.Tensor) -> None:
        """One micro-batch's whole gradient of ``e``: reduce-scattered
        (mean) along gdim into this rank's slab, or kept whole for the
        step's all-reduce, then added into the accumulator."""
        g = grad.to(self.grad_accum_dtype)
        if e.gdim is not None:
            g = comm.reduce_scatter(g, axis=ZERO_AXES, scatter_dim=e.gdim,
                                    op=comm.ReduceOp.AVG)
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
            shape[e.gdim] //= self.world
        return tuple(shape)

    def step_grads(self, denom: float) -> List[torch.Tensor]:
        """The accumulated grads as the optimizer's slabs (mdim), the
        whole ones all-reduced (mean) first, in fp32 divided by
        ``denom``; the accumulator is emptied."""
        grads = []
        for e in self.entries:
            a = self.accum[e.index]
            if a is None:
                a = torch.zeros(self._slot_shape(e), device=self.device,
                                dtype=self.grad_accum_dtype)
            if e.gdim is None:
                comm.all_reduce(a, op=comm.ReduceOp.AVG, axis=ZERO_AXES)
                a = slab(a, e.mdim, self.rank, self.world)
            grads.append(a)
        self.accum = [None] * len(self.entries)
        if all(g.dtype == torch.float32 for g in grads):
            torch._foreach_div_(grads, denom)
            return grads
        return [g.to(torch.float32) / denom for g in grads]

    def step_stats(self, grads: List[torch.Tensor],
                   losses: List[torch.Tensor]) -> Tuple[float, float, float]:
        """(finite flag, squared global grad norm, mean loss of the global
        batch) from one all-reduce of this rank's partials, read to the
        host once."""
        n = len(grads)
        sq = torch.stack(torch._foreach_norm(grads)).square()
        if self.rank != 0:                  # replicated leaves: rank 0's
            sq = torch.where(self._rep, torch.zeros_like(sq), sq)
        bad = torch.stack([~torch.isfinite(g).all() for g in grads]).sum()
        loss = torch.stack([x.detach().to(torch.float32)
                            for x in losses]).mean()
        packed = torch.cat([sq, bad.to(sq.dtype).view(1), loss.view(1)])
        comm.all_reduce(packed, op=comm.ReduceOp.SUM, axis=ZERO_AXES)
        total = packed[:n].sum()
        finite = (packed[n] == 0).to(torch.float32)
        mean_loss = packed[n + 1] / self.world
        finite_h, sq_h, loss_h = torch.stack(
            [finite, total, mean_loss]).tolist()
        return finite_h, sq_h, loss_h

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
                v, axis=ZERO_AXES, gather_dim=e.mdim)
            e.param.data.copy_(slab(full, e.pdim, self.rank, self.world))
