"""The ``deepspeed.comm`` facade over ``torch.distributed`` (counterpart
of ``deepspeed_tpu/comm/comm.py``; reference ``deepspeed/comm/comm.py``:
the module-level collective API, ``timed_op`` logging and the
``init_distributed`` bootstrap).

Where the JAX package names a mesh axis inside a compiled program, the
port names the same axis and issues an eager collective over the process
group of that axis: ``axis=`` selects the group from the global mesh
(``parallel.mesh.MeshManager.group``). Without a mesh an axis naming
``data`` is the whole world and the others are size 1 (a collective over
one of them raises, as JAX's unbound axis names do). Every collective returns its result; ``all_reduce`` and
``broadcast`` also write it into the tensor they were given, as
``torch.distributed`` does.

The transport is NCCL for CUDA tensors and gloo only for an explicit CPU
device (:func:`init_distributed`); nothing falls back from one to the
other. Each collective adds one to its count in :func:`op_counts` when it
is issued (always on, as the kernel wrappers count their launches), and
records its bytes and host time in the :class:`CommsLogger` while the
``comms_logger`` section enables it.

The point-to-point ops of the JAX facade (``ppermute``,
``send_recv_next`` / ``send_recv_prev``, ``axis_rank``, ``axis_size``)
run over the axis group with ``torch.distributed.batch_isend_irecv``:
ring attention rotates its K/V chunks with them
(``parallel/ring_attention.py``), and a pipeline's stages exchange
activations and cotangents with one ``ppermute`` a tick and direction
(``runtime/pipe/mpmd/channel.py``). :func:`ppermute_async` posts the transfers and
returns a handle, so a caller computes while they fly.
"""

from __future__ import annotations

import datetime
import functools
import os
import socket
import time
from collections import Counter
from enum import Enum
from typing import Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..utils.logging import logger
from .logging import CommsLogger

AxisName = Union[str, Sequence[str]]

class ReduceOp(Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
              ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.MAX: dist.ReduceOp.MAX}

_comms_logger = CommsLogger()
_counts: Counter = Counter()


def configure(comms_config=None) -> None:
    """Wire the comms logger from a DeepSpeedConfig.comms_logger section."""
    if comms_config is not None:
        _comms_logger.configure(enabled=comms_config.enabled,
                                verbose=comms_config.verbose,
                                prof_all=comms_config.prof_all,
                                debug=comms_config.debug)


def _env_int(*names: str, default: int = -1) -> int:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _free_local_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(dist_backend: Optional[str] = None,
                     auto_mpi_discovery: bool = True,
                     init_method: Optional[str] = None,
                     rank: int = -1,
                     world_size: int = -1,
                     device=None,
                     **kwargs) -> None:
    """Start the process group (reference: comm/comm.py:599-662).

    Already initialized, or no world size given (argument,
    ``DSTPU_NUM_PROCESSES`` or ``WORLD_SIZE``): nothing to do, one
    process. Otherwise the rank comes from ``rank``, ``DSTPU_PROCESS_ID``
    or ``RANK``; the rendezvous from ``init_method``,
    ``DSTPU_COORDINATOR_ADDRESS`` (``host:port``), ``MASTER_ADDR`` /
    ``MASTER_PORT``, or, for a world of one, a free localhost port.

    The backend follows the device: NCCL for CUDA (the default device;
    ``cuda:{LOCAL_RANK}`` is made current before the group starts), gloo
    only when ``device="cpu"`` is asked for. A ``dist_backend`` that
    disagrees with the device raises. ``initialization_timeout`` (or
    ``DSTPU_INIT_TIMEOUT``), seconds, bounds the rendezvous."""
    from ..utils.device import resolve_device
    if dist.is_initialized():
        return
    n = world_size if world_size > 0 else _env_int("DSTPU_NUM_PROCESSES",
                                                    "WORLD_SIZE")
    if n <= 0:
        return
    r = rank if rank >= 0 else _env_int("DSTPU_PROCESS_ID", "RANK")
    if r < 0:
        if n != 1:
            raise ValueError(f"init_distributed: a world of {n} needs this "
                             "process's rank (rank=, DSTPU_PROCESS_ID or "
                             "RANK)")
        r = 0
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist_backend not in (None, backend):
        raise ValueError(
            f"dist_backend {dist_backend!r} on a {dev.type} device: NCCL "
            "serves CUDA tensors and gloo only an explicit CPU device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    coord = init_method or os.environ.get("DSTPU_COORDINATOR_ADDRESS")
    if coord and "://" not in coord:
        coord = f"tcp://{coord}"
    if coord is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            coord = "env://"
        elif n == 1:
            coord = f"tcp://127.0.0.1:{_free_local_port()}"
        else:
            raise ValueError(f"init_distributed: a world of {n} needs a "
                             "rendezvous (init_method=, "
                             "DSTPU_COORDINATOR_ADDRESS or MASTER_ADDR / "
                             "MASTER_PORT)")
    timeout = float(kwargs.pop("initialization_timeout", 0) or
                    os.environ.get("DSTPU_INIT_TIMEOUT", "0") or 0)
    extra = ({"timeout": datetime.timedelta(seconds=timeout)}
             if timeout > 0 else {})
    dist.init_process_group(backend, init_method=coord, world_size=n,
                            rank=r, **extra)
    logger.info(f"torch.distributed initialized: rank {r}/{n} ({backend}) "
                f"@ {coord}")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_local_rank() -> int:
    return max(_env_int("DSTPU_LOCAL_RANK", "LOCAL_RANK", default=0), 0)


def get_device_count() -> int:
    """The devices of the job: one per rank in a world, else this host's
    GPUs."""
    return get_world_size() if is_initialized() else \
        torch.cuda.device_count()


def _mesh():
    """The global mesh, or None when none is set for this world."""
    from ..parallel.mesh import get_global_mesh
    mm = get_global_mesh()
    return None if mm is None or mm.world_size != get_world_size() else mm


def _names_data(axis: AxisName) -> bool:
    return "data" in ((axis,) if isinstance(axis, str) else tuple(axis))


def _group(axis: AxisName):
    """The process group of ``axis`` (a mesh axis name or a tuple of
    them) in the global mesh. Without one, an axis naming ``data`` is the
    whole world and any other axis is bound to nothing: it raises, as
    JAX does for an unbound axis name."""
    if not is_initialized():
        raise RuntimeError("no process group: call "
                           "deepspeed_tpu_torch.comm.init_distributed() "
                           "(or torch.distributed.init_process_group) first")
    mm = _mesh()
    if mm is not None:
        return mm.group(axis)
    if not _names_data(axis):
        raise ValueError(f"axis {axis!r} is bound by no mesh: without "
                         "parallel.mesh.set_global_mesh only 'data' spans "
                         "the world")
    return None


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def timed_op(fn):
    """Count every call; record its bytes and host seconds while the
    comms logger is on (reference: comm.py:112-153)."""

    @functools.wraps(fn)
    def wrapper(tensor, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(tensor, *args, **kwargs)
        _counts[fn.__name__] += 1
        if _comms_logger.enabled:
            _comms_logger.append(fn.__name__, _nbytes(tensor),
                                 time.perf_counter() - t0)
        return out

    return wrapper


def op_counts() -> Dict[str, int]:
    """Collectives issued since the last :func:`reset_op_counts`, by op."""
    return dict(_counts)


def reset_op_counts() -> None:
    _counts.clear()


@timed_op
def all_reduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
               axis: AxisName = "data") -> torch.Tensor:
    """Reduce ``tensor`` over the axis group, in place; returns it. AVG is
    the sum divided by the group size (the same on every backend)."""
    g = _group(axis)
    if op == ReduceOp.AVG:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=g)
        return tensor.div_(dist.get_world_size(g))
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported op {op}")
    dist.all_reduce(tensor, op=_TORCH_OPS[op], group=g)
    return tensor


@timed_op
def all_gather(tensor: torch.Tensor, axis: AxisName = "data",
               tiled: bool = True, gather_dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``gather_dim`` in rank order
    (``tiled``), or stacked along a new dim there."""
    g = _group(axis)
    w = dist.get_world_size(g)
    d = gather_dim % (tensor.dim() + (0 if tiled else 1))
    x = (tensor.movedim(d, 0) if tiled else tensor.unsqueeze(0)).contiguous()
    out = torch.empty((w * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=g)
    return out.movedim(0, d).contiguous()


@timed_op
def reduce_scatter(tensor: torch.Tensor, axis: AxisName = "data",
                   scatter_dim: int = 0,
                   op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """This rank's slab of the group's sum along ``scatter_dim`` (whose
    size the group size divides); AVG divides it by the group size."""
    g = _group(axis)
    w = dist.get_world_size(g)
    d = scatter_dim % tensor.dim()
    if tensor.shape[d] % w:
        raise ValueError(f"reduce_scatter: dim {d} of {tuple(tensor.shape)} "
                         f"does not split {w} ways")
    x = tensor.movedim(d, 0).contiguous()
    out = torch.empty((x.shape[0] // w,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"reduce_scatter: unsupported op {op}")
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=g)
    if op == ReduceOp.AVG:
        out.div_(w)
    return out.movedim(0, d).contiguous()


def _all_to_all(tensor: torch.Tensor, axis: AxisName, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    g = _group(axis)
    w = dist.get_world_size(g)
    s = split_dim % tensor.dim()
    if tensor.shape[s] % w:
        raise ValueError(f"all_to_all: dim {s} of {tuple(tensor.shape)} "
                         f"does not split {w} ways")
    if w == 1:                       # nothing crosses a group of one
        return tensor.clone()
    x = tensor.movedim(s, 0).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=g)
    blocks = [b.movedim(0, s) for b in out.chunk(w, 0)]
    return torch.cat(blocks, dim=concat_dim % tensor.dim())


class _AllToAll(torch.autograd.Function):
    """The exchange inside an autograd graph: the backward is the inverse
    exchange (split and concatenate dims swapped), itself one counted
    :func:`all_to_all`."""

    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return all_to_all(g.contiguous(), axis=axis, split_dim=concat_dim,
                          concat_dim=split_dim), None, None, None


@timed_op
def all_to_all(tensor: torch.Tensor, axis: AxisName = "expert",
               split_dim: int = 0, concat_dim: int = 0) -> torch.Tensor:
    """Split ``split_dim`` into one chunk per rank, send chunk j to rank
    j, and concatenate what arrives along ``concat_dim`` in rank order
    (JAX's tiled ``all_to_all``). Differentiable: under autograd the
    backward is the inverse exchange (ring attention's Ulysses heads and
    the MoE queues both cross their groups this way). Over a group of
    one rank the call is counted but issues no transfer."""
    if torch.is_grad_enabled() and tensor.requires_grad:
        return _AllToAll.apply(tensor, axis, split_dim, concat_dim)
    return _all_to_all(tensor, axis, split_dim, concat_dim)


class _CopyTo(torch.autograd.Function):
    """Megatron's copy to the model-parallel region: identity forward,
    the gradient all-reduced (summed) over the axis in the backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _counts["tp_copy_to"] += 1
        return all_reduce(g.contiguous(), axis=ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's reduce from the model-parallel region: all-reduce
    (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        _counts["tp_reduce_from"] += 1
        return all_reduce(x.contiguous(), axis=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """Megatron's gather from the model-parallel region: all-gather along
    ``dim`` forward, this rank's split of the gradient backward."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        _counts["tp_gather_from"] += 1
        ctx.args = (axis, dim, x.shape[dim])
        return all_gather(x.contiguous(), axis=axis, gather_dim=dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim, n = ctx.args
        r = axis_rank(axis)
        return g.narrow(dim, r * n, n).contiguous(), None, None


def tp_copy_to(x: torch.Tensor, axis: AxisName = "model") -> torch.Tensor:
    """``x`` into a column-parallel layer: the same values, with the
    ranks' partial gradients summed over ``axis`` in the backward (one
    counted ``all_reduce``, and ``tp_copy_to``)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyTo.apply(x, axis)
    return x


def tp_reduce_from(x: torch.Tensor, axis: AxisName = "model"
                   ) -> torch.Tensor:
    """A row-parallel layer's partial sums, summed over ``axis`` (one
    counted ``all_reduce``, and ``tp_reduce_from``); the backward passes
    the gradient through. Returns a new tensor."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFrom.apply(x, axis)
    _counts["tp_reduce_from"] += 1
    return all_reduce(x.contiguous().clone(), axis=axis)


def tp_gather_from(x: torch.Tensor, axis: AxisName = "model",
                   dim: int = -1) -> torch.Tensor:
    """The ranks' shards of ``x`` concatenated along ``dim`` in rank order
    (one counted ``all_gather``, and ``tp_gather_from``); the backward
    keeps this rank's split of the gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFrom.apply(x, axis, dim % x.dim())
    _counts["tp_gather_from"] += 1
    return all_gather(x.contiguous(), axis=axis, gather_dim=dim % x.dim())


@timed_op
def broadcast(tensor: torch.Tensor, src: int = 0,
              axis: AxisName = "data") -> torch.Tensor:
    """Rank ``src`` of the axis group's tensor, on every member, in
    place; returns it."""
    g = _group(axis)
    root = src if g is None else dist.get_global_rank(g, src)
    dist.broadcast(tensor, root, group=g)
    return tensor


def barrier(name: str = "dstpu_barrier") -> None:
    """Every rank of the world waits here (reference: comm.py barrier)."""
    if is_initialized():
        dist.barrier()
        _counts["barrier"] += 1


class P2PHandle:
    """The transfers of one :func:`ppermute_async`; :meth:`wait` blocks
    until they land and returns the received tensor."""

    __slots__ = ("out", "reqs", "sent")

    def __init__(self, out: torch.Tensor, reqs, sent=None):
        self.out, self.reqs = out, reqs
        self.sent = sent                    # alive until the sends land

    def wait(self) -> torch.Tensor:
        for r in self.reqs:
            r.wait()
        self.reqs, self.sent = [], None
        return self.out


def _p2p(tensor: torch.Tensor, perm, axis: AxisName) -> P2PHandle:
    """Post ``perm``'s transfers of ``tensor`` along ``axis``: (source,
    destination) pairs of axis indices. A rank no pair sends to receives
    zeros, as JAX's ``ppermute`` gives them."""
    n, me = axis_size(axis), axis_rank(axis)
    pairs = [(int(a) % n, int(b) % n) for a, b in perm]
    if len({a for a, _ in pairs}) != len(pairs) or \
            len({b for _, b in pairs}) != len(pairs):
        raise ValueError(f"ppermute: {perm} sends from or to a rank twice")
    dst = next((b for a, b in pairs if a == me), None)
    src = next((a for a, b in pairs if b == me), None)
    if src is None:
        out = torch.zeros_like(tensor)
    elif src == me:
        out = tensor
    else:
        out = torch.empty_like(tensor)
    if n == 1:                          # nothing leaves the rank
        return P2PHandle(out, [])
    g = _group(axis)
    glob = (lambda i: i) if g is None else \
        (lambda i: dist.get_global_rank(g, i))
    x = tensor.contiguous()
    ops = []
    if dst is not None and dst != me:
        ops.append(dist.P2POp(dist.isend, x, glob(dst), group=g))
    if src is not None and src != me:
        ops.append(dist.P2POp(dist.irecv, out, glob(src), group=g))
    reqs = dist.batch_isend_irecv(ops) if ops else []
    return P2PHandle(out, reqs, x)


@timed_op
def ppermute_async(tensor: torch.Tensor, perm,
                   axis: AxisName = "pipe") -> P2PHandle:
    """:func:`ppermute`, posted: returns a :class:`P2PHandle` whose
    ``wait()`` gives the result. ``tensor`` must not change until then."""
    return _p2p(tensor, perm, axis)


@timed_op
def ppermute(tensor: torch.Tensor, perm,
             axis: AxisName = "pipe") -> torch.Tensor:
    """Send this rank's ``tensor`` along ``axis`` as ``perm`` says
    ((source, destination) pairs of axis indices); returns what arrives,
    zeros on a rank no pair sends to. At axis size 1 nothing is sent."""
    return _p2p(tensor, perm, axis).wait()


def send_recv_next(tensor: torch.Tensor,
                   axis: AxisName = "pipe") -> torch.Tensor:
    """Shift +1 along the axis ring: index i's tensor arrives at i + 1."""
    n = axis_size(axis)
    return ppermute(tensor, [(i, (i + 1) % n) for i in range(n)], axis)


def send_recv_prev(tensor: torch.Tensor,
                   axis: AxisName = "pipe") -> torch.Tensor:
    """Shift -1 along the axis ring: index i's tensor arrives at i - 1."""
    n = axis_size(axis)
    return ppermute(tensor, [(i, (i - 1) % n) for i in range(n)], axis)


def axis_rank(axis: AxisName) -> int:
    """This rank's index along ``axis`` of the global mesh. Without a
    mesh: its rank in the world along an axis naming ``data``, 0 along
    any other (``seq``, ``pipe``, ``model`` and ``expert`` are size 1)."""
    mm = _mesh()
    if mm is not None:
        return mm.axis_rank(axis)
    return get_rank() if _names_data(axis) else 0


def axis_size(axis: AxisName) -> int:
    """The size of ``axis`` in the global mesh. Without a mesh: the world
    along an axis naming ``data``, 1 along any other."""
    mm = _mesh()
    if mm is not None:
        return mm.axes_size(axis)
    return get_world_size() if _names_data(axis) else 1


def log_summary() -> str:
    """reference: comm/comm.py:483 log_summary()."""
    return _comms_logger.log_summary()


def get_comms_logger() -> CommsLogger:
    return _comms_logger
