"""Parameters between the JAX package and the port.

:func:`params_from_jax` takes the JAX package's parameter tree as nested
dicts of numpy arrays (``jax.device_get`` of a flax ``params`` dict) in
either layout, scan (``blocks`` leaves ``[L, ...]``) or per-layer
(``blocks_0..blocks_{L-1}``, restacked the way ``ensure_scan_layout``
does), and returns the same tree of torch tensors. The names and the
``[in, out]`` kernel layout are the same in both packages, so nothing is
renamed or transposed. int8 kernels and their ``kernel_scale`` /
``kernel_qscale`` leaves are carried over in their own dtypes.

For training, :func:`module_from_jax` loads such a tree into the port's
``Transformer`` module, :func:`module_to_jax` gives the module's
parameters back as the numpy tree in the scan layout, and
:func:`scan_params` gives the stacked tensor dict that ``generate()``,
``forward_with_cache`` and ``paged_forward`` take, so trained weights go
straight into the port's inference paths.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from .generation import ensure_scan_layout
from .transformer import Transformer, TransformerConfig

def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy kind torch reads
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))          # owned, writable copy
    return t.to(device)


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    in the scan layout, each leaf in its own dtype (``InferenceEngine``
    casts the floating-point ones to the served dtype)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, device)

    out = walk(dict(tree))
    n_layers = sum(1 for k in out if re.fullmatch(r"blocks_\d+", k))
    return ensure_scan_layout(out, n_layers) if n_layers else out


def module_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device="cpu") -> Transformer:
    """A flax parameter tree (nested dict of numpy arrays, either layout)
    -> a ``Transformer`` module on ``device`` holding those values in
    their own dtypes."""
    return Transformer(cfg, params_from_jax(tree, device=device))


def scan_params(module: Transformer) -> Dict[str, Any]:
    """The module's parameters as the scan-layout dict of tensors
    (``blocks`` leaves stacked [L, ...], a MoE layer's under ``moe``),
    detached from autograd."""
    out: Dict[str, Any] = {}
    blocks: Dict[tuple, list] = {}
    for name, t in module.named_parameters():
        parts = name.split(".")
        t = t.detach()
        if parts[0] == "blocks":             # blocks.<i>.<leaf>...<param>
            blocks.setdefault(tuple(parts[2:]), []).append(t)
        elif len(parts) == 1:                # a bare array (mlm_bias)
            out[name] = t
        else:
            out.setdefault(parts[0], {})[parts[1]] = t
    tree: Dict[str, Any] = {}
    for path, ts in blocks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.stack(ts)
    out["blocks"] = tree
    return out


def module_to_jax(module: Transformer) -> Dict[str, Any]:
    """The module's parameters as the flax tree of numpy arrays in the
    scan layout (bf16 leaves as float32)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        t = node.cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    return walk(scan_params(module))
