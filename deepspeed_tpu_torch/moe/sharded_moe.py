"""MoE gating math: top-1 / top-2 with capacity, jitter and the
load-balance loss (counterpart of ``deepspeed_tpu/moe/sharded_moe.py``;
reference ``deepspeed/moe/sharded_moe.py`` top1gating:177 /
top2gating:278, the GShard formulation).

:func:`route` makes the routing decisions once, in index form: for each
token and each of its k choices the expert, the position in that
expert's queue, whether the token was kept (position < capacity) and its
combine weight. :func:`top1_gating` and :func:`top2_gating` expand those
decisions into the JAX package's dense tensors (combine [T, E, C],
dispatch [T, E, C] bool, exp_counts [E]); the MoE layer
(``moe/layer.py``) scatters tokens into queues by index instead, so both
forms route identically. The combine weights carry the gradient through
the gates; positions, keep flags and the dispatch mask carry none.

Drop rule: positions count up in token order, first choices before
second choices (the second choices queue behind every first choice of
their expert), and a token whose position reaches the capacity C is
dropped from that expert.

Noise: top-2's second pick is Gumbel-max over the logits with the first
pick masked out, drawn from a ``torch.Generator``; ``generator=None``
draws nothing, as the JAX package's ``rng=None``. top-1's
multiplicative jitter needs ``jitter_eps > 0`` and a generator.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


def compute_capacity(tokens: int, experts: int, capacity_factor: float,
                     k: int = 1, min_capacity: int = 4) -> int:
    """Queue slots per expert: ceil(k * tokens / experts * factor), at
    least ``min_capacity``."""
    cap = int(math.ceil(k * tokens / experts * capacity_factor))
    return max(cap, min_capacity)


def _positions_in_expert(mask: torch.Tensor) -> torch.Tensor:
    """mask [T, E] 0/1 -> each token's position in its expert's queue."""
    return (torch.cumsum(mask, dim=0) - 1.0) * mask


def load_balance_loss(gates: torch.Tensor, mask1: torch.Tensor
                      ) -> torch.Tensor:
    """E * sum_e mean_t(gates[:, e]) * mean_t(mask1[:, e]) (the GShard
    objective; reference top1gating's aux loss)."""
    E = gates.shape[1]
    me = gates.mean(dim=0)
    ce = mask1.to(gates.dtype).mean(dim=0)
    return (me * ce).sum() * E


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(Exp(1)), from ``generator``."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -torch.log(e.exponential_(generator=generator))


class Route(NamedTuple):
    """The routing decisions of T tokens with k choices each."""
    aux: torch.Tensor          # scalar f32 load-balance loss
    expert: torch.Tensor       # [T, k] int64 chosen expert
    position: torch.Tensor     # [T, k] int64 slot in that expert's queue
    keep: torch.Tensor         # [T, k] bool: position < capacity
    weight: torch.Tensor       # [T, k] f32 combine weight (0 if dropped)
    capacity: int


def route(logits: torch.Tensor, k: int, capacity: int,
          generator: Optional[torch.Generator] = None,
          jitter_eps: float = 0.0) -> Route:
    """Top-k (k in 1, 2) routing of logits [T, E] into queues of
    ``capacity`` slots (see the module docstring)."""
    if k not in (1, 2):
        raise ValueError(f"k must be 1 or 2, got {k}")
    T, E = logits.shape
    C = int(capacity)
    logits = logits.to(torch.float32)
    if k == 1 and jitter_eps > 0.0 and generator is not None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        logits = logits * (1.0 - jitter_eps + 2.0 * jitter_eps * u)
    gates = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(idx1, E).to(torch.float32)
    aux = load_balance_loss(gates, mask1)
    pos1 = _positions_in_expert(mask1)
    keep1 = (pos1 < C).to(torch.float32) * mask1
    g1 = (gates * keep1).sum(dim=-1)
    p1 = pos1.sum(dim=-1)
    if k == 1:
        return Route(aux, idx1[:, None], p1.long()[:, None],
                     keep1.sum(dim=-1)[:, None] > 0, g1[:, None], C)
    noisy = logits
    if generator is not None:
        noisy = logits + gumbel(logits.shape, generator, logits.device)
    masked = torch.where(mask1 > 0, torch.full_like(noisy, -math.inf), noisy)
    idx2 = torch.argmax(masked, dim=-1)
    mask2 = F.one_hot(idx2, E).to(torch.float32)
    # expert queues are shared: second choices queue after first choices
    pos2 = (_positions_in_expert(mask2)
            + mask1.sum(dim=0, keepdim=True)) * mask2
    keep2 = (pos2 < C).to(torch.float32) * mask2
    g2 = (gates * keep2).sum(dim=-1)
    denom = torch.clamp(g1 + g2, min=torch.finfo(torch.float32).eps)
    g1, g2 = g1 / denom, g2 / denom
    p2 = pos2.sum(dim=-1)
    return Route(aux, torch.stack([idx1, idx2], dim=1),
                 torch.stack([p1, p2], dim=1).long(),
                 torch.stack([keep1.sum(-1), keep2.sum(-1)], dim=1) > 0,
                 torch.stack([g1, g2], dim=1), C)


def dense_from_route(r: Route, num_experts: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """(aux, combine [T, E, C] f32, dispatch [T, E, C] bool, exp_counts
    [E] f32) of a route: the JAX package's one-hot form."""
    T, k = r.expert.shape
    E, C = num_experts, r.capacity
    combine = torch.zeros((T, E, C), dtype=torch.float32,
                          device=r.weight.device)
    dispatch = torch.zeros((T, E, C), dtype=torch.bool,
                           device=r.weight.device)
    counts = torch.zeros((E,), dtype=torch.float32, device=r.weight.device)
    for j in range(k):
        onehot = (F.one_hot(r.expert[:, j], E)[:, :, None]
                  * F.one_hot(r.position[:, j].clamp(max=C - 1), C)[:, None]
                  * r.keep[:, j, None, None]).to(torch.float32)
        combine = combine + r.weight[:, j, None, None] * onehot
        dispatch = dispatch | (onehot > 0)
        counts = counts + onehot.sum(dim=(0, 2))
    return r.aux, combine, dispatch, counts


def top1_gating(logits: torch.Tensor,
                capacity_factor: float = 1.0,
                min_capacity: int = 4,
                jitter_eps: float = 0.0,
                generator: Optional[torch.Generator] = None,
                capacity: Optional[int] = None):
    """(aux, combine [T, E, C], dispatch [T, E, C] bool, exp_counts [E])
    of top-1 routing (JAX ``top1_gating``; ``generator`` for ``rng``)."""
    T, E = logits.shape
    C = capacity if capacity is not None else compute_capacity(
        T, E, capacity_factor, 1, min_capacity)
    return dense_from_route(route(logits, 1, C, generator, jitter_eps), E)


def top2_gating(logits: torch.Tensor,
                capacity_factor: float = 1.0,
                min_capacity: int = 4,
                generator: Optional[torch.Generator] = None,
                capacity: Optional[int] = None):
    """(aux, combine [T, E, C], dispatch [T, E, C] bool, exp_counts [E])
    of GShard top-2 routing: the first expert from the clean gates, the
    second by Gumbel-max over the other experts' logits (no noise with
    ``generator=None``), both gate values renormalized by max(g1 + g2,
    eps) (JAX ``top2_gating``)."""
    T, E = logits.shape
    C = capacity if capacity is not None else compute_capacity(
        T, E, capacity_factor, 2, min_capacity)
    return dense_from_route(route(logits, 2, C, generator), E)
