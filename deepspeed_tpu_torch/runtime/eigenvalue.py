"""Hessian max-eigenvalue estimation by power iteration (counterpart of
``deepspeed_tpu/runtime/eigenvalue.py``; reference
``runtime/eigenvalue.py:7``: power iteration on the loss curvature, which
MoQ uses to pace quantization).

The Hessian-vector product is double backward: the gradient of the loss
taken with ``create_graph=True``, then the gradient of its dot product
with ``v`` (the JAX package takes ``jax.jvp`` of ``jax.grad``; both give
H v). The hand-written attention kernels' ``autograd.Function`` s are
differentiable once (their backward launches a kernel whose output has no
graph), as the JAX package's flash ``custom_vjp`` is: a loss whose graph
holds one raises, naming it, rather than running a product that would
silently leave attention's curvature out.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..utils.logging import log_dist

#: the graph nodes of the kernels' once-differentiable Functions, by the
#: name autograd gives their backward, with the kernels they launch
_ONCE_DIFFERENTIABLE = {
    "_FlashAttentionBackward":
        "flash_attention (ops/flash_attention.py: flash_attention_fwd and "
        "the flash backward kernels)",
    "_BlockSparseAttentionBackward":
        "block_sparse_attention (ops/block_sparse_attention.py: the "
        "block-sparse forward, dq and dk/dv kernels)",
}


def check_twice_differentiable(loss: torch.Tensor) -> None:
    """Raise if the graph of ``loss`` runs a kernel whose backward is not
    differentiable (``_ONCE_DIFFERENTIABLE``)."""
    seen, stack = set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        kernel = _ONCE_DIFFERENTIABLE.get(type(node).__name__)
        if kernel is not None:
            raise NotImplementedError(
                f"the Hessian-vector product of this loss would "
                f"differentiate {kernel} twice; its backward is "
                "differentiable once (as the JAX package's flash custom_vjp "
                "is). Build the model with attention_impl='reference' to "
                "measure the eigenvalue")
        stack.extend(n for n, _ in node.next_functions)


class Eigenvalue:
    def __init__(self, verbose: bool = False, max_iter: int = 100,
                 tol: float = 1e-2, stability: float = 1e-6,
                 gas_boundary_resolution: int = 1,
                 layer_name: str = "", layer_num: int = 0):
        self.verbose = verbose
        self.max_iter = max_iter
        self.tol = tol
        self.stability = stability
        self.gas_boundary_resolution = gas_boundary_resolution
        self.layer_name = layer_name
        self.layer_num = layer_num

    @staticmethod
    def _normalize(vs: List[torch.Tensor]) -> List[torch.Tensor]:
        sq = sum(v.square().sum() for v in vs)
        inv = torch.rsqrt(torch.clamp(sq, min=1e-30))
        return [v * inv for v in vs]

    def _step(self, loss_fn, params, v, loss_args):
        ps = [p.detach().requires_grad_(True) for p in params]
        loss = loss_fn(ps, *loss_args)
        check_twice_differentiable(loss)
        grads = torch.autograd.grad(loss, ps, create_graph=True,
                                    allow_unused=True)
        dot = sum((g.to(torch.float32) * vv).sum()
                  for g, vv in zip(grads, v) if g is not None)
        hv = torch.autograd.grad(dot, ps, allow_unused=True)
        hv = [(torch.zeros_like(vv) if h is None
               else torch.nan_to_num(h.detach().to(torch.float32)))
              + self.stability * vv for h, vv in zip(hv, v)]
        eig = sum((a * b).sum() for a, b in zip(v, hv))
        return self._normalize(hv), eig

    def compute_eigenvalue(self, loss_fn: Callable[..., torch.Tensor],
                           params: Sequence[torch.Tensor],
                           generator: Optional[torch.Generator] = None,
                           loss_args: tuple = ()) -> float:
        """Largest |eigenvalue| of d2 loss / d params2 (power iteration
        with the reference's stability damping and relative-tolerance
        early stop). ``loss_fn(params, *loss_args)`` takes the list of
        tensors ``params`` (a dict's values are taken in order); the start
        vector is drawn from ``generator`` (default: seed 0)."""
        if isinstance(params, dict):
            params = list(params.values())
        params = list(params)
        dev = params[0].device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        v = self._normalize([
            torch.randn(p.shape, generator=generator, device=dev,
                        dtype=torch.float32) for p in params])
        prev = 0.0
        eig = 0.0
        for i in range(self.max_iter):
            v, eig_dev = self._step(loss_fn, params, v, loss_args)
            eig = float(eig_dev)
            if self.verbose:
                log_dist(f"eigenvalue iter {i}: {eig:.6f}", ranks=[0])
            if abs(eig) > 0 and \
                    abs(eig - prev) / max(abs(eig), 1e-12) < self.tol:
                break
            prev = eig
        return abs(eig)
