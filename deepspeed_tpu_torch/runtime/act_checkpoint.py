"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/act_checkpoint.py``; reference
``runtime/activation_checkpointing/checkpointing.py``: ``checkpoint`` at
:748, ``configure`` at :830), on ``torch.utils.checkpoint`` without
reentrance.

Two levels, as in the JAX package:

* **the model's blocks** (``TransformerConfig.remat`` /
  ``remat_policy``, :func:`remat_block`): each ``Block`` is one
  checkpointed region. The policies follow the JAX ``Transformer``'s:
  ``"full"`` keeps only the block's input; ``"attn"`` also keeps the
  attention output (o and the row logsumexp that the backward kernels
  read), so the backward recomputes the projections but never the
  attention forward; ``"dots"`` keeps the attention output and every
  matmul output (``x @ W``) of the block. A kept value is named where it
  is computed (``ops/checkpoint_name.py``: ``reuse`` inside the attention
  wrappers' autograd functions, ``dot`` for the block's matmuls), so a
  kept attention forward launches its kernel once. Torch's selective
  checkpointing cannot do this: it sees dispatcher ops only, and even
  with the attention forward registered as a ``torch.library.custom_op``
  it holds what it keeps in its own cache, which
  ``torch.autograd.graph.saved_tensors_hooks`` never sees (so "attn"
  would count the same saved bytes as "full"), and the block-sparse
  forward's host-built schedule is no argument a custom op's schema
  takes.
* **any user module** (the engine's ``activation_checkpointing`` section,
  :func:`remat`, :func:`checkpoint`): the whole call is one region under
  the configured policy; ``"dots"`` is a selective policy over the
  dispatcher's matmuls without batch dims (``aten.mm`` / ``aten.addmm``,
  JAX's ``dots_with_no_batch_dims_saveable``).

Host-memory offload of saved activations (``cpu_checkpointing``, the
``"offload"`` policy) raises ``NotImplementedError``: it waits for the
offload work of ROADMAP item 5.2. Attention through the plain reference
(``impl="reference"``, a generic additive bias) is an ordinary autograd
graph with no name to keep: it is recomputed under every policy.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from ..ops.checkpoint_name import keep_region
from ..utils.logging import logger

_OFFLOAD = ("host-memory offload of saved activations (cpu_checkpointing, "
            "the 'offload' remat policy; ROADMAP item 5.2) is not ported to "
            "deepspeed_tpu_torch yet (see ROADMAP.md)")

#: the block policies: the names of the values each one keeps
BLOCK_POLICIES = {"full": (), "attn": ("attn",), "dots": ("attn", "dot")}

# module-level state, mirroring the reference's globals
_CONFIGURED = False
_PARTITION_ACTIVATIONS = False
_CPU_CHECKPOINTING = False
_CONTIGUOUS_CHECKPOINTING = False
_NUM_CHECKPOINTS: Optional[int] = None
_PROFILE = False
_POLICY_NAME = "full"


def check_block_policy(name: str) -> None:
    """Raise for a block policy the port does not run."""
    if name == "offload":
        raise NotImplementedError(_OFFLOAD)
    if name not in BLOCK_POLICIES:
        raise ValueError(f"unknown remat_policy '{name}'; have "
                         f"{sorted(BLOCK_POLICIES) + ['offload']}")


def _run_region(fn: Callable, keep: Sequence[str], args, kwargs,
                context_fn=None):
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    if keep:
        return keep_region(fn, keep, args, kwargs)
    extra = {} if context_fn is None else {"context_fn": context_fn}
    return _torch_checkpoint(fn, *args, use_reentrant=False, **extra,
                             **kwargs)


def remat_block(fn: Callable, policy: str, *args, **kwargs):
    """One checkpointed region around ``fn(*args)`` (a transformer block)
    under a block policy (:data:`BLOCK_POLICIES`)."""
    check_block_policy(policy)
    return _run_region(fn, BLOCK_POLICIES[policy], args, kwargs)


# ------------------------------------------------------- user-module policy

_NO_BATCH_DOTS = None


def _dots_context():
    """Selective checkpointing that saves the matmuls without batch dims
    (``aten.mm``, ``aten.addmm``) and recomputes everything else."""
    global _NO_BATCH_DOTS
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    if _NO_BATCH_DOTS is None:
        _NO_BATCH_DOTS = {torch.ops.aten.mm.default,
                          torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def make_remat_policy(name: str) -> Optional[Callable]:
    """A policy name -> the ``context_fn`` of ``torch.utils.checkpoint``
    (None: save everything, no checkpointing).

    ``none``    — save everything (checkpointing disabled)
    ``full``    — save nothing, recompute everything (the reference's
                  ``checkpoint()``)
    ``dots``    — save the matmul outputs without batch dims, recompute
                  the rest (Megatron-style selective recompute)
    ``offload`` — raises ``NotImplementedError`` (ROADMAP item 5.2)
    """
    if name == "none":
        return None
    if name == "full":
        return torch.utils.checkpoint.noop_context_fn
    if name == "dots":
        return _dots_context
    if name == "offload":
        raise NotImplementedError(_OFFLOAD)
    raise ValueError(f"unknown remat policy {name!r} "
                     "(expected none|full|dots|offload)")


def configure(mpu_=None,
              deepspeed_config=None,
              partition_activations: Optional[bool] = None,
              contiguous_checkpointing: Optional[bool] = None,
              num_checkpoints: Optional[int] = None,
              checkpoint_in_cpu: Optional[bool] = None,
              synchronize: Optional[bool] = None,
              profile: Optional[bool] = None) -> None:
    """Configure the module-level checkpointing behavior (reference
    signature, checkpointing.py:830). ``deepspeed_config`` may be a path,
    a dict or a ``DeepSpeedConfig``; explicit kwargs override it. ``mpu_``
    and ``synchronize`` are accepted for API parity and unused (one
    process, one stream). ``cpu_checkpointing`` raises (ROADMAP item
    5.2)."""
    global _CONFIGURED, _PARTITION_ACTIVATIONS, _CPU_CHECKPOINTING
    global _CONTIGUOUS_CHECKPOINTING, _NUM_CHECKPOINTS, _PROFILE, _POLICY_NAME

    cpu = _CPU_CHECKPOINTING
    if deepspeed_config is not None:
        from ..config import load_config
        sect = load_config(deepspeed_config).activation_checkpointing
        cpu = sect.cpu_checkpointing
    if checkpoint_in_cpu is not None:
        cpu = checkpoint_in_cpu
    if cpu:
        raise NotImplementedError(_OFFLOAD)
    if deepspeed_config is not None:
        _PARTITION_ACTIVATIONS = sect.partition_activations
        _CONTIGUOUS_CHECKPOINTING = sect.contiguous_memory_optimization
        _NUM_CHECKPOINTS = sect.number_checkpoints
        _PROFILE = sect.profile
    if partition_activations is not None:
        _PARTITION_ACTIVATIONS = partition_activations
    if contiguous_checkpointing is not None:
        _CONTIGUOUS_CHECKPOINTING = contiguous_checkpointing
    if num_checkpoints is not None:
        _NUM_CHECKPOINTS = num_checkpoints
    if profile is not None:
        _PROFILE = profile
    _POLICY_NAME = "full"
    _CONFIGURED = True
    if _PROFILE:
        logger.info("activation checkpointing configured: policy=%s "
                    "partition_activations=%s num_checkpoints=%s",
                    _POLICY_NAME, _PARTITION_ACTIVATIONS, _NUM_CHECKPOINTS)


def is_configured() -> bool:
    return _CONFIGURED


def reset() -> None:
    """Reference parity (checkpointing.py:773): resets the module state."""
    global _CONFIGURED, _PARTITION_ACTIVATIONS, _CPU_CHECKPOINTING
    global _CONTIGUOUS_CHECKPOINTING, _NUM_CHECKPOINTS, _POLICY_NAME, _PROFILE
    _CONFIGURED = False
    _PARTITION_ACTIVATIONS = False
    _CPU_CHECKPOINTING = False
    _CONTIGUOUS_CHECKPOINTING = False
    _NUM_CHECKPOINTS = None
    _POLICY_NAME = "full"
    _PROFILE = False


def partition_activations_in_checkpoint(partition_activation: bool) -> None:
    """Reference parity (checkpointing.py:760)."""
    global _PARTITION_ACTIVATIONS
    _PARTITION_ACTIVATIONS = partition_activation


def set_num_layers(nlayers: int) -> None:
    """Reference parity (checkpointing.py:768)."""
    global _NUM_CHECKPOINTS
    _NUM_CHECKPOINTS = nlayers


def remat(function: Callable, policy_name: Optional[str] = None
          ) -> Callable:
    """``function`` as one checkpointed region under the configured (or
    given) policy; the recomputation runs in the backward."""
    name = policy_name or _POLICY_NAME
    context_fn = make_remat_policy(name)
    if context_fn is None:
        return function

    @functools.wraps(function)
    def wrapped(*args, **kwargs):
        return _run_region(function, (), args, kwargs, context_fn=context_fn)
    return wrapped


def checkpoint(function: Callable, *args: Any) -> Any:
    """Checkpoint a model segment: ``deepspeed.checkpointing.checkpoint``
    (reference :748) under the configured policy."""
    return remat(function)(*args)


def checkpointable(function: Callable) -> Callable:
    """Decorator form of :func:`checkpoint`; the policy is resolved at
    call time, so a later :func:`configure` applies."""
    @functools.wraps(function)
    def wrapped(*args):
        return remat(function)(*args)
    return wrapped
