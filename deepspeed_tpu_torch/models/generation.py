"""Layer helpers of the decode path (counterpart of the helpers in
``deepspeed_tpu/models/generation.py``): norms, the dense matmul with its
int8 weight forms, and the restack to the scan layout."""

from __future__ import annotations

from typing import Any, Dict

import torch

PyTree = Any


def _layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float,
                rms: bool = False) -> torch.Tensor:
    """LayerNorm / RMSNorm computed in f32, returned in x's dtype."""
    xf = x.to(torch.float32)
    if rms:
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (y * p["scale"]).to(x.dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _kernel_of(p: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """Matmul weight in ``dtype``, dequantizing the int8 weight-only forms:
    blockwise ``kernel_qscale`` (q [..., Kp, N] int8, scales
    [..., Kp/block, N] f32: w[i, n] = q[i, n] * s[i // block, n]) or
    per-output-channel ``kernel_scale``. The served path sends blockwise
    kernels to the ``quant_matmul`` kernel instead (see :func:`_dense`)."""
    k = p["kernel"]
    if "kernel_qscale" in p:
        s = p["kernel_qscale"]
        nkb = s.shape[-2]
        qb = k.shape[-2] // nkb
        w = (k.to(torch.float32).reshape(
                k.shape[:-2] + (nkb, qb, k.shape[-1]))
             * s[..., :, None, :])
        return w.reshape(k.shape).to(dtype)
    if "kernel_scale" in p:
        return (k.to(torch.float32) * p["kernel_scale"]).to(dtype)
    return k.to(dtype)


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor],
           impl: str = "auto") -> torch.Tensor:
    """x @ W (+ bias). Blockwise-int8 kernels go through ``quant_matmul``
    (the hand-written kernel for CUDA tensors; ``impl="reference"`` forces
    its plain version); every other weight is a plain ``torch.matmul``,
    as the JAX package left it to XLA."""
    if "kernel_qscale" in p:
        from ..ops.quant_matmul import quant_matmul
        y = quant_matmul(x, p["kernel"], p["kernel_qscale"], impl=impl)
    else:
        y = x @ _kernel_of(p, x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def ensure_scan_layout(params: PyTree, num_layers: int) -> PyTree:
    """Restack a per-layer tree (blocks_0..blocks_{L-1}) into the scan
    layout (``blocks`` leaves [L, ...]) that the decode path consumes."""
    if "blocks" in params:
        return params
    names = [f"blocks_{i}" for i in range(num_layers)]
    missing = [n for n in names if n not in params]
    if missing:
        raise ValueError(
            f"params have neither 'blocks' (scan layout) nor all of "
            f"blocks_0..blocks_{num_layers - 1} (missing {missing[:3]}...); "
            "cannot build the decode layout")

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return torch.stack(nodes)

    rest = {k: v for k, v in params.items() if k not in names}
    return {**rest, "blocks": stack(*(params[n] for n in names))}
