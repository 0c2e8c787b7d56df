"""TiledLinear — a large linear split into independently sharded tiles
(counterpart of ``deepspeed_tpu/runtime/zero/tiling.py``; reference
``deepspeed/runtime/zero/tiling.py``).

Each tile is its own module holding one parameter and a ZeRO-3 unit of
its own (``zero_unit``), so ZeRO-3 gathers one tile around its matmul and
drops it before the next: the transient full-weight footprint of a huge
projection is one tile's, never the whole [in, out] matrix.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class _Tile(nn.Module):
    """One [in / in_splits, out / out_splits] tile: ``x_i @ kernel``."""

    zero_unit = True

    def __init__(self, kernel: torch.Tensor):
        super().__init__()
        self.kernel = nn.Parameter(kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel.to(x.dtype)


class TiledLinear(nn.Module):
    """``y = concat_j(sum_i x_i @ K_ij) + b``: equal to ``nn.Linear`` with
    the assembled weight (:meth:`assembled_weight`, [in, out]) up to the
    order of the partial sums. Tile ``K_ij`` is the submodule
    ``kernel_{i}_{j}`` (the JAX package's parameter name), drawn normal
    with std 1 / sqrt(tile fan-in) (flax's lecun_normal scale); ``bias``
    [out] starts at 0."""

    def __init__(self, in_features: int, out_features: int,
                 in_splits: int = 1, out_splits: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_features % in_splits or out_features % out_splits:
            raise ValueError(
                f"TiledLinear: {in_features}x{out_features} not divisible "
                f"into {in_splits}x{out_splits} tiles")
        self.in_features, self.out_features = in_features, out_features
        self.in_splits, self.out_splits = in_splits, out_splits
        self.compute_dtype = dtype
        din, dout = in_features // in_splits, out_features // out_splits
        for i in range(in_splits):
            for j in range(out_splits):
                w = torch.randn(din, dout, generator=generator,
                                dtype=torch.float32) * din ** -0.5
                self.add_module(f"kernel_{i}_{j}", _Tile(w.to(device)))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_features:
            raise ValueError(f"TiledLinear: input width {x.shape[-1]} != "
                             f"{self.in_features}")
        din = self.in_features // self.in_splits
        x = x.to(self.compute_dtype)
        outs = []
        for j in range(self.out_splits):
            acc = None
            for i in range(self.in_splits):
                part = getattr(self, f"kernel_{i}_{j}")(
                    x[..., i * din:(i + 1) * din])
                acc = part if acc is None else acc + part
            outs.append(acc)
        y = torch.cat(outs, dim=-1)
        if self.bias is not None:
            y = y + self.bias.to(self.compute_dtype)
        return y

    def assembled_weight(self) -> torch.Tensor:
        """The [in, out] kernel the tiles make up."""
        return torch.cat([torch.cat([getattr(self, f"kernel_{i}_{j}").kernel
                                     for j in range(self.out_splits)], dim=1)
                          for i in range(self.in_splits)], dim=0)
