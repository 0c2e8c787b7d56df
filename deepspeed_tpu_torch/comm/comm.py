"""The ``deepspeed.comm`` facade over ``torch.distributed`` (counterpart
of ``deepspeed_tpu/comm/comm.py``; reference ``deepspeed/comm/comm.py``:
the module-level collective API, ``timed_op`` logging and the
``init_distributed`` bootstrap).

Where the JAX package names a mesh axis inside a compiled program, the
port names the same axis and issues an eager collective over the process
group of that axis: ``axis=`` selects the group from the global mesh
(``parallel.mesh.MeshManager.group``), the whole world when no mesh is
set. Every collective returns its result; ``all_reduce`` and
``broadcast`` also write it into the tensor they were given, as
``torch.distributed`` does.

The transport is NCCL for CUDA tensors and gloo only for an explicit CPU
device (:func:`init_distributed`); nothing falls back from one to the
other. Each collective adds one to its count in :func:`op_counts` when it
is issued (always on, as the kernel wrappers count their launches), and
records its bytes and host time in the :class:`CommsLogger` while the
``comms_logger`` section enables it.

The in-program point-to-point ops of the JAX facade (``ppermute``,
``send_recv_next`` / ``send_recv_prev``, ``axis_rank``, ``axis_size``)
serve pipelines and raise ``NotImplementedError`` until those are ported
(ROADMAP.md item 4.1).
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

_PIPELINES = ("in-program point-to-point collectives (pipelines, ROADMAP "
              "item 4.1) are not ported to deepspeed_tpu_torch yet (see "
              "ROADMAP.md)")


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


def _group(axis: AxisName):
    """The process group of ``axis`` (a mesh axis name or a tuple of
    them) in the global mesh; the whole world without one."""
    if not is_initialized():
        raise RuntimeError("no process group: call "
                           "deepspeed_tpu_torch.comm.init_distributed() "
                           "(or torch.distributed.init_process_group) first")
    from ..parallel.mesh import get_global_mesh
    mm = get_global_mesh()
    return None if mm is None else mm.group(axis)


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


@timed_op
def all_to_all(tensor: torch.Tensor, axis: AxisName = "expert",
               split_dim: int = 0, concat_dim: int = 0) -> torch.Tensor:
    """Split ``split_dim`` into one chunk per rank, send chunk j to rank
    j, and concatenate what arrives along ``concat_dim`` in rank order
    (JAX's tiled ``all_to_all``)."""
    g = _group(axis)
    w = dist.get_world_size(g)
    s = split_dim % tensor.dim()
    if tensor.shape[s] % w:
        raise ValueError(f"all_to_all: dim {s} of {tuple(tensor.shape)} "
                         f"does not split {w} ways")
    x = tensor.movedim(s, 0).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=g)
    blocks = [b.movedim(0, s) for b in out.chunk(w, 0)]
    return torch.cat(blocks, dim=concat_dim % tensor.dim())


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


def ppermute(tensor, perm, axis: AxisName = "pipe"):
    raise NotImplementedError(_PIPELINES)


def send_recv_next(tensor, axis: AxisName = "pipe"):
    raise NotImplementedError(_PIPELINES)


def send_recv_prev(tensor, axis: AxisName = "pipe"):
    raise NotImplementedError(_PIPELINES)


def axis_rank(axis: AxisName):
    raise NotImplementedError(_PIPELINES)


def axis_size(axis: AxisName):
    raise NotImplementedError(_PIPELINES)


def log_summary() -> str:
    """reference: comm/comm.py:483 log_summary()."""
    return _comms_logger.log_summary()


def get_comms_logger() -> CommsLogger:
    return _comms_logger
