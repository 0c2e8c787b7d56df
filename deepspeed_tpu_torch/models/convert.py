"""Parameters from the JAX package to the port.

:func:`params_from_jax` takes the JAX package's parameter tree as nested
dicts of numpy arrays (``jax.device_get`` of a flax ``params`` dict) in
either layout, scan (``blocks`` leaves ``[L, ...]``) or per-layer
(``blocks_0..blocks_{L-1}``, restacked the way ``ensure_scan_layout``
does), and returns the same tree of torch tensors. The names and the
``[in, out]`` kernel layout are the same in both packages, so nothing is
renamed or transposed. int8 kernels and their ``kernel_scale`` /
``kernel_qscale`` leaves are carried over in their own dtypes.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from .generation import ensure_scan_layout

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
