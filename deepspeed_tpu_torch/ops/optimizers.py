"""Optimizers as functional (init, update) pairs over lists of tensors
(counterpart of ``deepspeed_tpu/ops/optimizers.py``).

``adam`` / ``adamw`` are the JAX package's: math in f32, moments in the
master's dtype (f32 for an f32 master, bf16 for the pure-bf16 mode),
AdamW's decay decoupled and added to the update, bias correction at
``step + 1``. They are whole-tensor elementwise updates, not kernels of
the JAX package: f32 tensors go through ``torch._foreach_*`` (one fused
launch per op over the whole list), other dtypes through f32 copies one
tensor at a time.

Where the JAX package returns new trees, ``update`` writes the new
parameters and moments into the given tensors (the 1.1B-parameter
trainer would otherwise hold two copies of its 18 bytes a parameter of
state) and returns them. The engine decides a skip before it calls
``update``, so a skipped step leaves every tensor as it was.

``lamb``, ``sgd`` (momentum, Nesterov) and ``adagrad`` are the JAX
package's formulas with its state names (``m`` / ``v``, ``momentum``,
``sum``), so their checkpoints cross between the packages; their math
runs in f32, one tensor at a time. LAMB's trust ratio takes each
leaf's whole norms. A leaf of the JAX package's scan layout stacks every
layer (``blocks/attn_qkv/kernel`` [L, ...]) where the port holds one
tensor a layer, so the engine passes ``norm_groups`` (the leaf of each
tensor) and the norms are summed over a leaf's tensors; where it hands
LAMB ZeRO slabs, it also passes ``norm_sq_reduce``, which takes the slabs
and sums their squared norms over the ZeRO group (the JAX package gets
both sums from XLA). The 1-bit family is
not ported yet: ``build_optimizer`` raises for it, naming ROADMAP.md.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch


class Optimizer(NamedTuple):
    """state = init(params); params, state = update(grads, state, params,
    step, lr_t=None)."""
    init: Callable[[List[torch.Tensor]], Dict[str, List[torch.Tensor]]]
    update: Callable[..., Tuple[List[torch.Tensor],
                                Dict[str, List[torch.Tensor]]]]
    name: str


def _zeros_like(params: List[torch.Tensor]) -> List[torch.Tensor]:
    """Moment buffers: bf16 params get bf16 moments (the pure-bf16 mode),
    everything else f32, as in the JAX package."""
    return [torch.zeros_like(p, dtype=torch.bfloat16
                             if p.dtype == torch.bfloat16 else torch.float32)
            for p in params]


def adam(lr: float = 1e-3,
         betas: Tuple[float, float] = (0.9, 0.999),
         eps: float = 1e-8,
         weight_decay: float = 0.0,
         bias_correction: bool = True,
         adamw_mode: bool = False) -> Optimizer:
    """Adam, or AdamW with ``adamw_mode`` (decoupled weight decay)."""
    b1, b2 = betas

    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    def update(grads, state, params, step, lr_t=None):
        lr_eff = float(lr if lr_t is None else lr_t)
        t = float(step) + 1.0
        bc1 = 1.0 - b1 ** t if bias_correction else 1.0
        bc2 = 1.0 - b2 ** t if bias_correction else 1.0
        m_all, v_all = state["m"], state["v"]
        fast = [i for i, (p, g, m, v) in enumerate(zip(params, grads, m_all,
                                                       v_all))
                if p.dtype == g.dtype == m.dtype == v.dtype == torch.float32]
        fast_set = set(fast)
        if fast:
            ps = [params[i] for i in fast]
            gs = [grads[i] for i in fast]
            ms = [m_all[i] for i in fast]
            vs = [v_all[i] for i in fast]
            if weight_decay != 0.0 and not adamw_mode:
                gs = torch._foreach_add(gs, ps, alpha=weight_decay)
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, gs, alpha=1.0 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, gs, gs, value=1.0 - b2)
            den = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(ms, bc1)
            torch._foreach_div_(upd, den)
            del den
            if weight_decay != 0.0 and adamw_mode:
                torch._foreach_add_(upd, ps, alpha=weight_decay)
            torch._foreach_add_(ps, upd, alpha=-lr_eff)
        for i, (p, g, m, v) in enumerate(zip(params, grads, m_all, v_all)):
            if i in fast_set:
                continue
            g = g.to(torch.float32)
            p32 = p.to(torch.float32)
            if weight_decay != 0.0 and not adamw_mode:
                g = g + weight_decay * p32
            m_new = b1 * m.to(torch.float32) + (1.0 - b1) * g
            v_new = b2 * v.to(torch.float32) + (1.0 - b2) * g * g
            upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            if weight_decay != 0.0 and adamw_mode:
                upd = upd + weight_decay * p32
            p.copy_(p32 - lr_eff * upd)
            m.copy_(m_new)
            v.copy_(v_new)
        return params, state

    return Optimizer(init, update, "adamw" if adamw_mode else "adam")


def adamw(lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01, bias_correction: bool = True
          ) -> Optimizer:
    return adam(lr, betas, eps, weight_decay, bias_correction,
                adamw_mode=True)


def lamb(lr: float = 1e-3,
         betas: Tuple[float, float] = (0.9, 0.999),
         eps: float = 1e-6,
         weight_decay: float = 0.0,
         min_coeff: float = 0.01,
         max_coeff: float = 10.0) -> Optimizer:
    """LAMB with a per-tensor trust ratio clip(|p| / |u|, min_coeff,
    max_coeff) (1 where either norm is 0), u = m / (sqrt(v) + eps) + wd p,
    no bias correction, f32 moments. ``update(..., norm_sq_reduce=f,
    norm_groups=g)``: ``f(ps, us)`` gives the [n, 2] squared norms of the
    whole tensors of which this rank's ``ps`` and ``us`` are ZeRO slabs
    (default: this rank's own); ``g[i]`` is the leaf of tensor i, whose
    norms are taken over all its tensors (default one leaf a tensor)."""
    b1, b2 = betas

    def init(params):
        return {"m": [torch.zeros_like(p, dtype=torch.float32)
                      for p in params],
                "v": [torch.zeros_like(p, dtype=torch.float32)
                      for p in params]}

    def update(grads, state, params, step, lr_t=None, norm_sq_reduce=None,
               norm_groups=None):
        lr_eff = float(lr if lr_t is None else lr_t)
        upds, sq = [], []
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            g = g.to(torch.float32)
            p32 = p.to(torch.float32)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            u = m / (torch.sqrt(v) + eps)
            if weight_decay != 0.0:
                u = u + weight_decay * p32
            upds.append(u)
            if norm_sq_reduce is None:
                sq.append(torch.stack([p32.square().sum(),
                                       u.square().sum()]))
        if not upds:
            return params, state
        sq = (torch.stack(sq) if norm_sq_reduce is None
              else norm_sq_reduce(params, upds))
        if norm_groups is not None:
            idx = torch.as_tensor(norm_groups, device=sq.device)
            sq = torch.zeros((int(max(norm_groups)) + 1, 2), dtype=sq.dtype,
                             device=sq.device).index_add_(0, idx, sq)[idx]
        norms = sq.sqrt()
        w, u_n = norms[:, 0], norms[:, 1]
        trust = torch.where((w > 0) & (u_n > 0),
                            (w / u_n).clamp(min_coeff, max_coeff),
                            torch.ones_like(w))
        for i, (p, u) in enumerate(zip(params, upds)):
            p.copy_(p.to(torch.float32) - lr_eff * trust[i] * u)
        return params, state

    return Optimizer(init, update, "lamb")


def sgd(lr: float = 1e-3, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """SGD; with ``momentum`` the buffer b = momentum b + g steps by b, or
    by g + momentum b with ``nesterov``. No state without momentum."""

    def init(params):
        if momentum == 0.0:
            return {}
        return {"momentum": [torch.zeros_like(p, dtype=torch.float32)
                             for p in params]}

    def update(grads, state, params, step, lr_t=None):
        lr_eff = float(lr if lr_t is None else lr_t)
        bufs = state.get("momentum", [None] * len(params))
        for p, g, buf in zip(params, grads, bufs):
            g = g.to(torch.float32)
            p32 = p.to(torch.float32)
            if weight_decay != 0.0:
                g = g + weight_decay * p32
            if buf is not None:
                buf.mul_(momentum).add_(g)
                g = g + momentum * buf if nesterov else buf
            p.copy_(p32 - lr_eff * g)
        return params, state

    return Optimizer(init, update, "sgd")


def adagrad(lr: float = 1e-2, eps: float = 1e-10,
            weight_decay: float = 0.0) -> Optimizer:
    """Adagrad: s += g^2, p -= lr g / (sqrt(s) + eps); f32 sums."""

    def init(params):
        return {"sum": [torch.zeros_like(p, dtype=torch.float32)
                        for p in params]}

    def update(grads, state, params, step, lr_t=None):
        lr_eff = float(lr if lr_t is None else lr_t)
        for p, g, s in zip(params, grads, state["sum"]):
            g = g.to(torch.float32)
            p32 = p.to(torch.float32)
            if weight_decay != 0.0:
                g = g + weight_decay * p32
            s.addcmul_(g, g)
            p.copy_(p32 - lr_eff * g / (torch.sqrt(s) + eps))
        return params, state

    return Optimizer(init, update, "adagrad")


def _not_ported(name: str) -> Callable[..., Optimizer]:
    def build(**_):
        raise NotImplementedError(
            f"optimizer '{name}' is not ported to deepspeed_tpu_torch yet "
            "(see ROADMAP.md item 5.1); use Adam, AdamW, LAMB, SGD or "
            "Adagrad")
    return build


# the optimizer ``type`` names the JAX package's engine accepts
_REGISTRY: Dict[str, Callable[..., Optimizer]] = {
    "adam": adam,
    "adamw": adamw,
    "fusedadam": adam,
    "lamb": lamb,
    "fusedlamb": lamb,
    "sgd": sgd,
    "adagrad": adagrad,
    "onebitadam": _not_ported("onebitadam"),
    "zerooneadam": _not_ported("zerooneadam"),
    "onebitlamb": _not_ported("onebitlamb"),
}


def build_optimizer(opt_type: str, params: Optional[dict] = None
                    ) -> Optimizer:
    key = opt_type.lower().replace("_", "")
    if key not in _REGISTRY:
        raise ValueError(f"Unknown optimizer type '{opt_type}'. "
                         f"Known: {sorted(_REGISTRY)}")
    kwargs = dict(params or {})
    # the reference accepts torch-style names; normalize
    if "betas" in kwargs:
        kwargs["betas"] = tuple(kwargs["betas"])
    kwargs.pop("torch_adam", None)
    kwargs.pop("adam_w_mode", None)
    return _REGISTRY[key](**kwargs)
