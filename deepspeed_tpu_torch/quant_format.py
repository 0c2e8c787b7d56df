"""The int8 quantization formats, single-sourced for the port.

Counterpart of ``deepspeed_tpu/quant_format.py`` (the two formats the
serving path uses; the training-side fake-quant waits for a later slice):

* **blockwise** (:func:`block_quant`): the last dim is cut into
  ``QUANT_BLOCK``-element blocks, one f32 scale each. The weight-only
  decode matmuls (``ops/quant_matmul.py``) store kernels int8 with these
  scales along the contraction dim.
* **per-row** (:func:`kv_quantize`): one f32 scale per trailing row
  (absmax over the last dim). The paged KV pool stores one int8 row per
  (layer, head, slot) K or V vector with this scale.

Both are symmetric absmax / 127 with round-half-to-even, as in the JAX
package, so the bytes match exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

#: elements per quantization block (one f32 scale each)
QUANT_BLOCK = 256


def block_quant(x: torch.Tensor, bits: int = 8, block: int = QUANT_BLOCK
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Blockwise symmetric quantization of the LAST dim.

    x [..., L] -> (q int8 [..., Lp], scales f32 [..., Lp/block], pad)
    with Lp = L padded up to a block multiple. Zero blocks get scale 1
    (quantize to 0 exactly); q is clipped to the symmetric range."""
    qmax = float(2 ** (bits - 1) - 1)
    L = x.shape[-1]
    nb = -(-L // block)
    pad = nb * block - L
    xf = x.to(torch.float32)
    if pad:
        xf = F.pad(xf, (0, pad))
    xb = xf.reshape(x.shape[:-1] + (nb, block))
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / qmax)
    q = torch.clamp(torch.round(xb / scale), -qmax, qmax).to(torch.int8)
    return (q.reshape(x.shape[:-1] + (nb * block,)),
            scale.reshape(x.shape[:-1] + (nb,)), pad)


def kv_quantize(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 values, f32 per-row scales [..., 1])."""
    tf = t.to(torch.float32)
    scale = tf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale
