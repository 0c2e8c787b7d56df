"""The int8 quantization formats, single-sourced for the port.

Counterpart of ``deepspeed_tpu/quant_format.py``:

* **blockwise** (:func:`block_quant` / :func:`block_dequant`): the last
  dim is cut into ``QUANT_BLOCK``-element blocks, one f32 scale each. The
  weight-only decode matmuls (``ops/quant_matmul.py``) store kernels int8
  with these scales along the contraction dim, and the int8 wire formats
  of ``runtime/comm/`` move int8 payloads with them (error <=
  block_absmax / 127 per element, docs/COMM.md).
* **per-row** (:func:`kv_quantize`): one f32 scale per trailing row
  (absmax over the last dim). The paged KV pool stores one int8 row per
  (layer, head, slot) K or V vector with this scale.

Both are symmetric absmax / 127 with round-half-to-even, as in the JAX
package, so the bytes match exactly. A block holding an inf or a NaN gets
a non-finite scale and int8 zeros (casting NaN to int8 is undefined in
torch): its dequantized values come out non-finite, so an overflow check
downstream still sees them.

:func:`fake_quant_act` is the straight-through activation fake-quant of
the low-precision training experiment (the model's ``activation_quant``):
int8 blockwise, or fp8-e4m3 with one f32 scale a block.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

#: elements per quantization block (one f32 scale each)
QUANT_BLOCK = 256

#: float8_e4m3 dynamic range (finite max): the fp8 fake-quant scale target
_E4M3_MAX = 448.0


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device. PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, one ulp off
    the CPU's quotient at times, which moves a value across a rounding
    boundary of the quantizers; a divisor tensor on x's device divides."""
    return x / torch.full_like(x, d)


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
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        div_exact(absmax, qmax))
    q = torch.clamp(torch.round(xb / scale), -qmax, qmax)
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    return (q.reshape(x.shape[:-1] + (nb * block,)),
            scale.reshape(x.shape[:-1] + (nb,)), pad)


def block_dequant(q: torch.Tensor, scales: torch.Tensor, pad: int
                  ) -> torch.Tensor:
    """Inverse of :func:`block_quant` (f32 out, padding stripped)."""
    nb = scales.shape[-1]
    block = q.shape[-1] // nb
    xb = q.to(torch.float32).reshape(q.shape[:-1] + (nb, block))
    out = (xb * scales[..., None]).reshape(q.shape)
    if pad:
        out = out[..., :q.shape[-1] - pad]
    return out


def kv_quantize(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 values, f32 per-row scales [..., 1])."""
    tf = t.to(torch.float32)
    scale = tf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale


def _fake_quant(x: torch.Tensor, fmt: str, block: int) -> torch.Tensor:
    """The ``fmt`` roundtrip of ``x`` over its last dim, in x's dtype."""
    if fmt == "int8":
        q, s, pad = block_quant(x, 8, block)
        return block_dequant(q, s, pad).to(x.dtype)
    L = x.shape[-1]
    nb = -(-L // block)
    pad = nb * block - L
    xf = x.to(torch.float32)
    if pad:
        xf = F.pad(xf, (0, pad))
    xb = xf.reshape(x.shape[:-1] + (nb, block))
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        div_exact(absmax, _E4M3_MAX))
    y = (xb / scale).to(torch.float8_e4m3fn).to(torch.float32)
    out = (y * scale).reshape(x.shape[:-1] + (nb * block,))
    if pad:
        out = out[..., :L]
    return out.to(x.dtype)


class _FakeQuantAct(torch.autograd.Function):
    """The forward is the roundtrip, the gradient passes through."""

    @staticmethod
    def forward(ctx, x, fmt, block):
        return _fake_quant(x, fmt, block)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quant_act(x: torch.Tensor, fmt: str = "int8",
                   block: int = QUANT_BLOCK) -> torch.Tensor:
    """Straight-through activation fake-quant over the last dim.

    * ``"int8"``: the blockwise format above (error <= block_absmax / 127
      per element).
    * ``"fp8"``: e4m3-style: one f32 scale per block maps the block's
      absmax onto 448, the values round through ``torch.float8_e4m3fn``
      (round to nearest even) and the scale divides back out; the
      numerics of delayed-scaling fp8 at 16-bit speed, not an fp8 matmul.
    """
    if fmt not in ("int8", "fp8"):
        raise ValueError(f"fake_quant_act fmt {fmt!r}: expected int8|fp8")
    return _FakeQuantAct.apply(x, fmt, block)
