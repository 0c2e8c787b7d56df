"""Quantization ops: per-group int8 / int4 quant and dequant, stochastic
rounding, the straight-through fake-quant and 1-bit sign compression
(counterpart of ``deepspeed_tpu/ops/quantizer.py``; reference
``csrc/quantization/*``).

Tensors are quantized per GROUP (a row of ``x.reshape(groups, -1)``), as
the reference's group-wise API does. These are PyTorch ops: the JAX
package leaves them to XLA fusion, so the port hand-writes no kernel for
them. The same math backs the compressed collectives
(``runtime/comm/compressed.py``) and QAT (``compression/``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..quant_format import div_exact


def _grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    n = x.numel()
    if n % groups != 0:
        raise ValueError(f"size {n} not divisible by groups {groups}")
    return x.reshape(groups, n // groups)


def quantize_symmetric(x: torch.Tensor, bits: int = 8, groups: int = 1,
                       stochastic: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (q int8, scale f32 [groups]); q in [-qmax, qmax], x ~= q *
    scale. ``stochastic``: round ``y + u - 0.5`` with ``u`` uniform in
    [0, 1) drawn from ``generator`` (unbiased: E[q] = y inside the range);
    without a generator the rounding is to nearest, as JAX's without an
    rng."""
    shape = x.shape
    g = _grouped(x.to(torch.float32), groups)
    qmax = float(2 ** (bits - 1) - 1)
    absmax = g.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        div_exact(absmax, qmax))
    y = g / scale
    if stochastic and generator is not None:
        noise = torch.rand(y.shape, generator=generator,
                           device=y.device) - 0.5
        q = torch.round(y + noise)
    else:
        q = torch.round(y)
    q = torch.nan_to_num(torch.clamp(q, -qmax, qmax), nan=0.0)
    return q.to(torch.int8).reshape(shape), scale[:, 0]


def dequantize_symmetric(q: torch.Tensor, scale: torch.Tensor,
                         groups: int = 1) -> torch.Tensor:
    shape = q.shape
    g = _grouped(q.to(torch.float32), groups)
    return (g * scale[:, None]).reshape(shape)


def quantize_asymmetric(x: torch.Tensor, bits: int = 8, groups: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x -> (q in [0, 2^bits - 1] as int32, scale, zero_point) per
    group."""
    shape = x.shape
    g = _grouped(x.to(torch.float32), groups)
    qmax = float(2 ** bits - 1)
    lo = g.amin(dim=1, keepdim=True)
    hi = g.amax(dim=1, keepdim=True)
    scale = torch.where(hi == lo, torch.ones_like(hi),
                        div_exact(hi - lo, qmax))
    q = torch.clamp(torch.round((g - lo) / scale), 0, qmax)
    q = torch.nan_to_num(q, nan=0.0).to(torch.int32)
    return q.reshape(shape), scale[:, 0], lo[:, 0]


def dequantize_asymmetric(q: torch.Tensor, scale: torch.Tensor,
                          zero_point: torch.Tensor, groups: int = 1
                          ) -> torch.Tensor:
    shape = q.shape
    g = _grouped(q.to(torch.float32), groups)
    return (g * scale[:, None] + zero_point[:, None]).reshape(shape)


def _roundtrip(x: torch.Tensor, bits: int, groups: int,
               symmetric: bool) -> torch.Tensor:
    if symmetric:
        q, s = quantize_symmetric(x, bits, groups)
        return dequantize_symmetric(q, s, groups).to(x.dtype)
    q, s, zp = quantize_asymmetric(x, bits, groups)
    return dequantize_asymmetric(q, s, zp, groups).to(x.dtype)


class _FakeQuantize(torch.autograd.Function):
    """Quant-dequant forward, straight-through backward."""

    @staticmethod
    def forward(ctx, x, bits, groups, symmetric):
        return _roundtrip(x, bits, groups, symmetric)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quantize(x: torch.Tensor, bits: int = 8, groups: int = 1,
                  symmetric: bool = True) -> torch.Tensor:
    """Quant-dequant round trip (the QAT forward; straight-through
    gradient)."""
    return _FakeQuantize.apply(x, bits, groups, symmetric)


def onebit_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-bit sign compression: x -> (signs int8 {-1, +1}, scale =
    mean |x|) (reference: the compressed allreduce's sign + scale
    packing, ``runtime/comm/nccl.py:52``)."""
    xf = x.to(torch.float32)
    scale = xf.abs().mean()
    signs = torch.where(xf >= 0, 1, -1).to(torch.int8)
    return signs, scale


def onebit_decompress(signs: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
    return signs.to(torch.float32) * scale


#: the weight of each of a byte's 8 signs, least significant bit first
_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def _weights(device) -> torch.Tensor:
    return torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=device)


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """Signs (or real values; sign taken, 0 counts as +) f32 [m] -> uint8
    bitmap [m / 8], element 8i + j in bit j of byte i (the JAX package's
    order). m must be a multiple of 8. This is what makes a 1-bit
    collective carry 1 bit an element on the wire."""
    bits = (x >= 0).reshape(-1, 8).to(torch.uint8)
    return (bits * _weights(x.device)[None, :]).sum(dim=1,
                                                    dtype=torch.uint8)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """uint8 bitmap [m / 8] -> f32 signs {-1, +1} [m]."""
    bits = (packed[:, None] & _weights(packed.device)[None, :]) > 0
    return torch.where(bits, 1.0, -1.0).reshape(-1).to(torch.float32)
