"""Block-sparse attention: the sparsity layouts and sparse self-attention
(counterpart of ``deepspeed_tpu/ops/sparse_attention.py``).

A sparsity config produces a block layout [heads, q_blocks, k_blocks]
(bool: attend / skip) at the config's ``block`` granularity, exactly as
the JAX package's ``make_layout`` does (the same numpy code, BigBird's and
Variable's ``default_rng(seed)`` included). Execution:

* :func:`sparse_attention` sends a call whose shapes the kernels take to
  ``ops.block_sparse_attention.block_sparse_flash_attention``: for CUDA
  tensors the hand-written kernels (cost scales with the layout's density),
  for CPU tensors their plain versions. A call they cannot take (a head dim
  or dtype the kernels lack) runs the dense-mask ``mha_reference``, as the
  JAX package's auto path does; ``use_kernel=True`` raises for it instead.
* The layout of a (config, sequence length) pair is built once and cached,
  with the kernels' tile schedule (``block_sparse_attention.schedule``).

The layout classes are a copy of the JAX package's (which is almost pure
numpy): the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
           "BSLongformerSparsityConfig", "BigBirdSparsityConfig",
           "LocalSlidingWindowSparsityConfig", "VariableSparsityConfig",
           "SPARSITY_CONFIGS", "build_sparsity_config", "layout_to_dense_mask",
           "config_layout", "sparse_attention", "SparseSelfAttention"]


@dataclasses.dataclass
class SparsityConfig:
    """Base: dense layout (reference: sparsity_config.py SparsityConfig)."""
    num_heads: int
    block: int = 16
    different_layout_per_head: bool = False

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._num_blocks(seq_len)
        return np.ones((self.num_heads, n, n), dtype=bool)

    def _num_blocks(self, seq_len: int) -> int:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} not divisible by block "
                             f"{self.block}")
        return seq_len // self.block


@dataclasses.dataclass
class DenseSparsityConfig(SparsityConfig):
    pass


@dataclasses.dataclass
class FixedSparsityConfig(SparsityConfig):
    """Fixed pattern (Sparse Transformers): local windows of
    `num_local_blocks` + global attention to the last `num_global_blocks`
    of each preceding window (reference: sparsity_config.py Fixed)."""
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"   # or "unidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._num_blocks(seq_len)
        L, G = self.num_local_blocks, self.num_global_blocks
        layout = np.zeros((self.num_heads, n, n), dtype=bool)
        for qi in range(n):
            win = qi // L
            # local window
            lo = win * L
            hi = min(lo + L, n)
            layout[:, qi, lo:hi] = True
            # global: last G blocks of every previous window
            for w in range(win):
                gs = (w + 1) * L - G
                layout[:, qi, max(gs, 0):(w + 1) * L] = True
        if self.attention == "unidirectional":
            tril = np.tril(np.ones((n, n), dtype=bool))
            layout &= tril[None]
        return layout


@dataclasses.dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Longformer: symmetric sliding window + designated global blocks."""
    num_sliding_window_blocks: int = 3
    global_block_indices: tuple = (0,)

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._num_blocks(seq_len)
        w = self.num_sliding_window_blocks // 2
        layout = np.zeros((self.num_heads, n, n), dtype=bool)
        for qi in range(n):
            layout[:, qi, max(0, qi - w):min(n, qi + w + 1)] = True
        for g in self.global_block_indices:
            if g < n:
                layout[:, g, :] = True     # global block attends everything
                layout[:, :, g] = True     # everything attends global block
        return layout


@dataclasses.dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding window + global blocks."""
    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._num_blocks(seq_len)
        rng = np.random.default_rng(self.seed)
        w = self.num_sliding_window_blocks // 2
        layout = np.zeros((self.num_heads, n, n), dtype=bool)
        for qi in range(n):
            layout[:, qi, max(0, qi - w):min(n, qi + w + 1)] = True
        g = self.num_global_blocks
        layout[:, :g, :] = True
        layout[:, :, :g] = True
        heads = self.num_heads if self.different_layout_per_head else 1
        for h in range(heads):
            for qi in range(n):
                picks = rng.choice(n, size=min(self.num_random_blocks, n),
                                   replace=False)
                layout[h if heads > 1 else slice(None), qi, picks] = True
        return layout


@dataclasses.dataclass
class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Plain sliding window (optionally causal)."""
    num_sliding_window_blocks: int = 3
    attention: str = "unidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._num_blocks(seq_len)
        w = self.num_sliding_window_blocks
        layout = np.zeros((self.num_heads, n, n), dtype=bool)
        for qi in range(n):
            if self.attention == "unidirectional":
                layout[:, qi, max(0, qi - w + 1):qi + 1] = True
            else:
                half = w // 2
                layout[:, qi, max(0, qi - half):min(n, qi + half + 1)] = True
        return layout


@dataclasses.dataclass
class VariableSparsityConfig(SparsityConfig):
    """Variable: per-window local sizes + custom global indices."""
    num_random_blocks: int = 0
    local_window_blocks: tuple = (4,)
    global_block_indices: tuple = (0,)
    attention: str = "bidirectional"
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._num_blocks(seq_len)
        layout = np.zeros((self.num_heads, n, n), dtype=bool)
        # consecutive local windows of the given sizes (last repeats)
        sizes = list(self.local_window_blocks)
        start = 0
        while start < n:
            size = sizes.pop(0) if len(sizes) > 1 else sizes[0]
            end = min(start + size, n)
            layout[:, start:end, start:end] = True
            start = end
        for g in self.global_block_indices:
            if g < n:
                layout[:, g, :] = True
                layout[:, :, g] = True
        if self.num_random_blocks:
            rng = np.random.default_rng(self.seed)
            for qi in range(n):
                picks = rng.choice(n, size=min(self.num_random_blocks, n),
                                   replace=False)
                layout[:, qi, picks] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


SPARSITY_CONFIGS = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "variable": VariableSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
    "local_sliding_window": LocalSlidingWindowSparsityConfig,
}


def build_sparsity_config(mode: str, num_heads: int, **kwargs) -> SparsityConfig:
    """reference: runtime/config.py:270-453 sparse_attention section parsing."""
    if mode not in SPARSITY_CONFIGS:
        raise ValueError(f"unknown sparse attention mode '{mode}'; "
                         f"have {sorted(SPARSITY_CONFIGS)}")
    return SPARSITY_CONFIGS[mode](num_heads=num_heads, **kwargs)


def layout_to_dense_mask(layout: np.ndarray, block: int,
                         device=None) -> torch.Tensor:
    """[H, nq, nk] block layout -> [H, S, S] bool element mask."""
    lay = torch.as_tensor(np.array(layout, dtype=bool), device=device)
    return lay.repeat_interleave(block, 1).repeat_interleave(block, 2)


def _config_key(config: SparsityConfig) -> tuple:
    return (type(config),) + tuple(
        tuple(v) if isinstance(v, list) else v
        for v in dataclasses.astuple(config))


_LAYOUTS: Dict[tuple, np.ndarray] = {}


def config_layout(config: SparsityConfig, seq_len: int) -> np.ndarray:
    """``config.make_layout(seq_len)``, built once per (config, seq_len)
    (the model calls this for every layer of every micro-batch) and
    returned read-only, since every caller shares the one array."""
    key = (_config_key(config), int(seq_len))
    layout = _LAYOUTS.get(key)
    if layout is None:
        layout = config.make_layout(seq_len)
        layout.flags.writeable = False
        if len(_LAYOUTS) >= 64:
            _LAYOUTS.clear()
        _LAYOUTS[key] = layout
    return layout


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     config: SparsityConfig,
                     *,
                     causal: bool = False,
                     sm_scale: Optional[float] = None,
                     use_kernel: Optional[bool] = None,
                     heads: Optional[slice] = None) -> torch.Tensor:
    """Block-sparse attention. q, k, v: [B, H, S, D]; differentiable.
    ``heads``: q's heads are these of the config's ``num_heads`` (a
    tensor-parallel rank's), whose layouts they take.

    ``use_kernel`` None (auto): the layout-skipping kernels when they take
    the shapes (``block_sparse_attention.tileable``), else the dense-mask
    ``mha_reference``; True: the kernels or ``ValueError``; False: the
    dense-mask path. The kernels' wrappers launch the CUDA kernels for
    CUDA tensors and run their plain versions for CPU tensors."""
    from . import block_sparse_attention as bsa
    S = q.shape[-2]
    layout = config_layout(config, S)
    if heads is not None:
        layout = layout[heads]
    if use_kernel is None:
        use_kernel = bsa.tileable(q, k, v, config.block, layout) is None
    if use_kernel:
        return bsa.block_sparse_flash_attention(
            q, k, v, layout, config.block, causal=causal, sm_scale=sm_scale)
    from .attention import mha_reference
    mask = layout_to_dense_mask(layout, config.block, device=q.device)[None]
    return mha_reference(q, k, v, causal=causal, mask=mask, sm_scale=sm_scale)


class SparseSelfAttention(torch.nn.Module):
    """Module-style wrapper (reference: sparse_self_attention.py:11)."""

    def __init__(self, sparsity_config: SparsityConfig, causal: bool = False):
        super().__init__()
        self.config = sparsity_config
        self.causal = causal

    def forward(self, q, k, v):
        return sparse_attention(q, k, v, self.config, causal=self.causal)
