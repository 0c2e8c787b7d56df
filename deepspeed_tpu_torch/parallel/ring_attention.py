"""Sequence parallelism: ring attention and Ulysses attention over the
mesh's ``seq`` axis (counterpart of
``deepspeed_tpu/parallel/ring_attention.py``).

q, k and v are ``[B, H, S_local, D]``: this rank's chunk of a sequence
split over the ``seq`` group, rank r holding positions r * S_local and on.

* :func:`ring_attention` — the K/V chunks rotate around the ``seq`` ring
  (``comm.ppermute_async``, posted before the current chunk is computed)
  while each rank keeps its Q chunk. At step t rank r attends to the
  chunk of rank src = (r - t) % sp: causally when src == r, fully when
  src < r (or always without causality), and not at all when src > r
  under causality. Partial results merge by their log-sum-exp in f32;
  the output is the compute dtype. sp - 1 rotations (the JAX scan makes
  sp and discards the last). Each chunk step is
  ``ops.flash_attention.flash_attention_fwd``, which gives o and its row
  logsumexp: the flash forward kernel for CUDA tensors, its plain version
  for CPU tensors, so both devices run the same chunk steps and merges.
  The JAX package computes this step with einsums outside any Pallas
  kernel (``_chunk_attn_update``, an online softmax, the tests' oracle);
  the flash kernels compute the same function without the [S_local,
  S_local] f32 scores that sequence parallelism exists to avoid. The backward (a ``torch.autograd.
  Function``) runs the ring again, each chunk through
  ``flash_attention_bwd`` with the merged o and lse; dK and dV (f32)
  travel with their chunk and arrive home after sp hops.
* :func:`ulysses_attention` — ``all_to_all`` turns the sequence split
  into a head split (H / sp heads over the whole sequence), attention
  runs locally through ``ops.attention.attention(impl="auto")`` (the
  flash kernels for CUDA tensors, their plain versions for CPU tensors;
  the JAX router passes ``attn_impl="reference"``, the same function),
  and ``all_to_all`` turns it back. Heads not divisible by sp raise the
  JAX ``ValueError``.

At seq-world 1 the JAX functions return ``mha_reference``; the port runs
its one-chunk ring (one causal flash step, no send) or its identity
all-to-alls around flash: the same function, on the card's kernels.

Counters (host ints, reset by assignment): ``ring_attention.chunk_steps``
(chunk forwards computed), ``ring_attention.rotations`` (K/V rotations,
forward and backward) and ``ring_attention.returns`` (the backward's
final dK/dV hop home).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import comm

SEQ_AXIS = "seq"


def chunk_positions(B: int, S: int, device) -> Optional[torch.Tensor]:
    """[B, S] global positions of this rank's chunk of S tokens (rank r
    of the seq group holds r * S on), or None at seq-world 1 (the
    model's default positions are the chunk's own)."""
    sp = comm.axis_size(SEQ_AXIS) if comm.is_initialized() else 1
    if sp == 1:
        return None
    r = comm.axis_rank(SEQ_AXIS)
    return (r * S + torch.arange(S, device=device)).expand(B, S)


def chunk_kind(r: int, src: int, causal: bool) -> str:
    """What rank ``r`` computes against rank ``src``'s K/V chunk:
    "causal" (its own chunk), "full" or "skip" (every key after every
    query)."""
    if not causal:
        return "full"
    return "causal" if src == r else ("full" if src < r else "skip")


def merge(o: Optional[torch.Tensor], lse: Optional[torch.Tensor],
          o_c: torch.Tensor, lse_c: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two partial attentions over disjoint keys -> their union's (o f32,
    lse [B, H, S] f32), weighted by their log-sum-exps."""
    o_c = o_c.to(torch.float32)
    if o is None:
        return o_c, lse_c
    new = torch.logaddexp(lse, lse_c)
    o = o * torch.exp(lse - new)[..., None] + \
        o_c * torch.exp(lse_c - new)[..., None]
    return o, new


def chunk_step(q, k, v, kind: str, sm_scale: float):
    """One chunk of the ring's forward on the kernels: (o, lse) of
    ``q`` against (k, v), causal or full."""
    from ..ops.flash_attention import flash_attention_fwd
    ring_attention.chunk_steps += 1
    return flash_attention_fwd(q, k, v, causal=kind == "causal",
                               sm_scale=sm_scale)


class _Later:
    """A transfer's result: ``wait()`` gives it."""

    __slots__ = ("wait",)

    def __init__(self, wait):
        self.wait = wait


def _pack(ts: List[torch.Tensor]) -> torch.Tensor:
    """One byte buffer of ``ts`` (each kept in its dtype), for one
    transfer."""
    return torch.cat([t.contiguous().view(-1).view(torch.uint8)
                      for t in ts])


def _unpack(buf: torch.Tensor, like: List[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[i:i + n].view(t.dtype).view(t.shape))
        i += n
    return out


class SeqRing:
    """Moves chunks to the next rank of this rank's ``seq`` group."""

    def __init__(self, axis: str = SEQ_AXIS):
        self.axis = axis
        self.sp = comm.axis_size(axis) if comm.is_initialized() else 1
        self.r = comm.axis_rank(axis) if comm.is_initialized() else 0

    def post(self, ts: List[torch.Tensor], src: int, grads: bool = False):
        """Send ``ts`` (the chunk of rank ``src``) on; the handle's
        ``wait()`` gives the previous rank's."""
        if self.sp == 1:
            return _Later(lambda: ts)
        if grads and len(ts) == 2:
            ring_attention.returns += 1
        else:
            ring_attention.rotations += 1
        perm = [(i, (i + 1) % self.sp) for i in range(self.sp)]
        h = comm.ppermute_async(_pack(ts), perm, self.axis)
        return _Later(lambda: _unpack(h.wait(), ts))


class EmulatedRing:
    """``sp`` virtual ranks on one device, for checking the chunk logic
    (the causal / full / skip choice, the merge, the backward's
    accumulation) without a group: the K/V a rank receives at step t + 1
    is chunk src - 1 by indexing, and the dK/dV it sends on are summed
    into that chunk's slot of ``dk`` / ``dv`` (the ring's hops only move
    these sums)."""

    def __init__(self, ks: List[torch.Tensor], vs: List[torch.Tensor]):
        self.ks, self.vs, self.sp = ks, vs, len(ks)
        self.dk = [torch.zeros_like(t, dtype=torch.float32) for t in ks]
        self.dv = [torch.zeros_like(t, dtype=torch.float32) for t in vs]

    def post(self, ts, src: int, grads: bool = False):
        nxt = (src - 1) % self.sp
        kv = [self.ks[nxt], self.vs[nxt]]
        if not grads:
            return _Later(lambda: kv)
        dk, dv = ts[-2:]
        self.dk[src] += dk
        self.dv[src] += dv
        zeros = [torch.zeros_like(dk), torch.zeros_like(dv)]
        return _Later(lambda: zeros if len(ts) == 2 else kv + zeros)


def ring_forward(q, k, v, r: int, sp: int, causal: bool, sm_scale: float,
                 ring) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``r``'s ring forward -> (o f32, lse [B, H, S_local] f32):
    :func:`chunk_step` on each chunk it sees, :func:`merge` of the
    partial results."""
    o = lse = None
    k_c, v_c = k, v
    for t in range(sp):
        src = (r - t) % sp
        h = ring.post([k_c, v_c], src) if t < sp - 1 else None
        kind = chunk_kind(r, src, causal)
        if kind != "skip":
            o, lse = merge(o, lse, *chunk_step(q, k_c, v_c, kind, sm_scale))
        if h is not None:
            k_c, v_c = h.wait()
    return o, lse


def ring_backward(q, k, v, o, lse, do, r: int, sp: int, causal: bool,
                  sm_scale: float, ring):
    """Rank ``r``'s ring backward -> (dq, dk, dv) in f32: each chunk
    through ``flash_attention_bwd`` with the merged ``o`` and ``lse``;
    dK and dV ride with their chunk and come home on the last hop."""
    from ..ops.flash_attention import flash_attention_bwd
    f32 = torch.float32
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dk_c = torch.zeros(k.shape, dtype=f32, device=k.device)
    dv_c = torch.zeros(v.shape, dtype=f32, device=v.device)
    k_c, v_c = k, v
    for t in range(sp):
        src = (r - t) % sp
        kind = chunk_kind(r, src, causal)
        if kind != "skip":
            a, b, c = flash_attention_bwd(q, k_c, v_c, o, lse, do,
                                          causal=kind == "causal",
                                          sm_scale=sm_scale)
            dq += a.to(f32)
            dk_c += b.to(f32)
            dv_c += c.to(f32)
        if t < sp - 1:
            k_c, v_c, dk_c, dv_c = ring.post([k_c, v_c, dk_c, dv_c], src,
                                             grads=True).wait()
        else:
            dk_c, dv_c = ring.post([dk_c, dv_c], src, grads=True).wait()
    return dq, dk_c, dv_c


def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else \
        1.0 / float(np.sqrt(q.shape[-1]))


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        from ..ops.checkpoint_name import reuse
        ring = SeqRing()

        def run():
            o, lse = ring_forward(q, k, v, ring.r, ring.sp, causal, scale,
                                  ring)
            return o.to(q.dtype), lse
        # a remat region that keeps "attn" keeps (o, lse): no second ring
        o, lse = reuse("attn", run, q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ring = SeqRing()
        dq, dk, dv = ring_backward(q, k, v, o, lse, do.contiguous(), ring.r,
                                   ring.sp, ctx.causal, ctx.scale, ring)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over the ``seq`` group: q, k, v [B, H, S_local, D]
    -> o of q's shape and dtype, differentiable (see the module
    docstring)."""
    scale = _scale(q, sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingAttention.apply(q, k, v, causal, scale)
    ring = SeqRing()
    o, _ = ring_forward(q, k, v, ring.r, ring.sp, causal, scale, ring)
    return o.to(q.dtype)


ring_attention.chunk_steps = 0
ring_attention.rotations = 0
ring_attention.returns = 0


def emulate_ring(q, k, v, sp: int, *, causal: bool = True,
                 sm_scale: Optional[float] = None, do=None):
    """The ring's chunk steps, merge and backward for ``sp`` virtual
    ranks of one sample on one device (:class:`EmulatedRing`): q, k, v
    [B, H, S, D] whole -> o (and with ``do`` also dq, dk, dv), in the
    inputs' dtype. Test-only: it checks the chunk logic where no group
    exists."""
    scale = _scale(q, sm_scale)
    qs, ks, vs = (list(t.chunk(sp, dim=2)) for t in (q, k, v))
    ring = EmulatedRing(ks, vs)
    outs = [ring_forward(qs[r], ks[r], vs[r], r, sp, causal, scale, ring)
            for r in range(sp)]
    o = torch.cat([x.to(q.dtype) for x, _ in outs], dim=2)
    if do is None:
        return o
    dos = list(do.chunk(sp, dim=2))
    dqs = [ring_backward(qs[r], ks[r], vs[r], outs[r][0].to(q.dtype),
                         outs[r][1], dos[r].contiguous(), r, sp, causal,
                         scale, ring)[0] for r in range(sp)]
    return (o, torch.cat(dqs, 2).to(q.dtype),
            torch.cat(ring.dk, 2).to(k.dtype),
            torch.cat(ring.dv, 2).to(v.dtype))


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses attention over the ``seq`` group: q, k, v [B, H, S_local,
    D] -> o of q's shape and dtype, differentiable. Raises ``ValueError``
    unless sp divides H."""
    from ..ops.attention import attention
    sp = comm.axis_size(SEQ_AXIS) if comm.is_initialized() else 1
    H = q.shape[1]
    if H % sp != 0:
        raise ValueError(f"ulysses needs heads {H} divisible by sp {sp}")
    scale = _scale(q, sm_scale)
    if sp == 1:                             # the all-to-alls are identities
        return attention(q, k, v, causal=causal, sm_scale=scale,
                         impl="auto")
    # comm.all_to_all is differentiable: its backward is the inverse
    to_heads = lambda t: comm.all_to_all(t, axis=SEQ_AXIS, split_dim=1,
                                         concat_dim=2)   # [B, H/sp, S, D]
    oh = attention(to_heads(q), to_heads(k), to_heads(v), causal=causal,
                   sm_scale=scale, impl="auto")
    return comm.all_to_all(oh, axis=SEQ_AXIS, split_dim=2,
                           concat_dim=1).to(q.dtype)
