"""Compression training: QAT, magnitude pruning, layer reduction
(counterpart of ``deepspeed_tpu/compression/compress.py``; reference
``deepspeed/compression/``: ``compress.py`` init_compression /
student_initialization, ``basic_layer.py`` LinearLayer_Compress's
quantize and prune forwards).

Module surgery is a transform over the parameter tree, as in the JAX
package: ``apply_compression(params, spec, step)`` fake-quantizes or
masks each matched leaf in the forward. The straight-through gradient
comes from an ``autograd.Function`` whose backward is the identity; a
pruning mask is computed without grad, so ``d(w * mask) / dw = mask``.

The tree is the JAX package's: a ``Transformer``'s block leaves STACKED
``blocks/<leaf>/<name>`` [L, ...]. Every statistic is taken over the
stacked leaf, as JAX takes it: one quantization scale per group of
``w.reshape(groups, -1)`` (at ``quantize_groups=1`` one scale spans all L
layers), one top-k over the whole stacked leaf, and row and head scores
along dim 0, which is L. The engine stacks the blocks' tensors
(``torch.stack`` keeps the graph), transforms and unstacks them; a
per-block transform would be a different one.

Techniques (reference constants.py):
  weight_quantization      start_bits -> target_bits halving every
                           quantization_period steps, symmetric or
                           asymmetric
  activation_quantization  consumed by the model (``activation_quant``)
  sparse_pruning           elementwise magnitude, keep dense_ratio
  row_pruning              L1 norms along dim 0, keep dense_ratio rows
  channel_pruning          L1 column norms
  head_pruning             L1 per head block of dim 0
  layer_reduction          the student keeps teacher_layer of the stack
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..quant_format import div_exact

PyTree = Any


@dataclasses.dataclass(frozen=True)
class CompressionGroup:
    kind: str                       # weight_quantization | sparse_pruning | ...
    name: str
    modules: Tuple[str, ...]        # regexes on param paths
    schedule_offset: int = 0
    # quantization
    start_bits: int = 8
    target_bits: int = 8
    quantization_period: int = 0
    quantization_type: str = "symmetric"
    quantize_groups: int = 1
    # pruning
    dense_ratio: float = 1.0
    num_heads: int = 0              # head_pruning

    def matches(self, path: str) -> bool:
        return any(re.search(m, path) for m in self.modules)


@dataclasses.dataclass
class CompressionSpec:
    groups: List[CompressionGroup]
    activation_bits: int = 0        # 0 = off; consumed by the model family
    activation_offset: int = 0
    layer_reduction: Optional[Dict] = None

    @property
    def enabled(self) -> bool:
        return bool(self.groups) or self.activation_bits > 0 or \
            bool(self.layer_reduction)


def parse_compression_config(cfg: Dict) -> CompressionSpec:
    """ds_config['compression_training'] -> CompressionSpec (reference:
    compression/config.py get_compression_config)."""
    groups: List[CompressionGroup] = []

    def collect(kind: str):
        section = cfg.get(kind) or {}
        shared = section.get("shared_parameters") or {}
        if not shared.get("enabled", False):
            return
        for name, g in (section.get("different_groups") or {}).items():
            params = g.get("params") or {}
            groups.append(CompressionGroup(
                kind=kind, name=name,
                modules=tuple(g.get("modules", [".*"])),
                schedule_offset=int(shared.get("schedule_offset", 0)),
                start_bits=int(params.get("start_bits", 8)),
                target_bits=int(params.get("target_bits",
                                           params.get("start_bits", 8))),
                quantization_period=int(params.get("quantization_period", 0)),
                quantization_type=str(
                    shared.get("quantization_type",
                               shared.get("quantizer_kernel", "symmetric"))
                    if isinstance(shared.get("quantization_type", "symmetric"),
                                  str) else "symmetric"),
                quantize_groups=int(params.get("quantize_groups", 1)),
                dense_ratio=float(params.get("dense_ratio", 1.0)),
                num_heads=int(params.get("num_heads", 0)),
            ))

    for kind in ("weight_quantization", "sparse_pruning", "row_pruning",
                 "channel_pruning", "head_pruning"):
        collect(kind)

    act = cfg.get("activation_quantization") or {}
    act_shared = act.get("shared_parameters") or {}
    act_bits = 0
    act_offset = 0
    if act_shared.get("enabled", False):
        act_offset = int(act_shared.get("schedule_offset", 0))
        bits_list = [int((g.get("params") or {}).get("bits", 8))
                     for g in (act.get("different_groups") or {}).values()]
        act_bits = min(bits_list) if bits_list else 8

    lr_cfg = cfg.get("layer_reduction") or {}
    layer_reduction = lr_cfg if lr_cfg.get("enabled", False) else None
    return CompressionSpec(groups=groups, activation_bits=act_bits,
                           activation_offset=act_offset,
                           layer_reduction=layer_reduction)


# ---------------------------------------------------------------------------
# the per-leaf transforms (``step``: the optimizer steps applied, a host int)
# ---------------------------------------------------------------------------

def _quantize(w: torch.Tensor, bits: float, symmetric: bool,
              groups: int) -> torch.Tensor:
    """The fake-quant roundtrip of ``w`` at a (possibly scheduled) bit
    width, in w's dtype."""
    wf = w.to(torch.float32)
    shape = wf.shape
    g = (wf.reshape(groups, -1) if wf.numel() % groups == 0
         else wf.reshape(1, -1))
    qmax = 2.0 ** (bits - 1) - 1.0
    if symmetric:
        absmax = g.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax == 0, torch.ones_like(absmax),
                            div_exact(absmax, qmax))
        q = torch.clamp(torch.round(g / scale), -qmax, qmax)
        out = q * scale
    else:
        lo = g.amin(dim=1, keepdim=True)
        hi = g.amax(dim=1, keepdim=True)
        scale = torch.where(hi == lo, torch.ones_like(hi),
                            div_exact(hi - lo, 2 * qmax))
        q = torch.clamp(torch.round((g - lo) / scale), 0, 2 * qmax)
        out = q * scale + lo
    return out.reshape(shape).to(w.dtype)


class _QuantizeSTE(torch.autograd.Function):
    """Fake-quant forward, straight-through backward."""

    @staticmethod
    def forward(ctx, w, bits, symmetric, groups):
        return _quantize(w, bits, symmetric, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def _bits_at(group: CompressionGroup, step: int) -> float:
    """start_bits -> target_bits, halving every quantization_period steps
    past the offset (reference: basic_layer's bit schedule)."""
    if group.quantization_period <= 0 or group.start_bits == group.target_bits:
        return float(group.target_bits)
    halvings = float(np.floor((step - group.schedule_offset)
                              / group.quantization_period))
    bits = group.start_bits / (2.0 ** max(halvings, 0.0))
    return max(bits, float(group.target_bits))


def _topk_mask(scores: torch.Tensor, keep_ratio: float) -> torch.Tensor:
    """Boolean mask keeping the top keep_ratio fraction by score."""
    n = scores.numel()
    k = max(int(round(n * keep_ratio)), 1)
    thresh = torch.sort(scores.reshape(-1)).values[n - k]
    return scores >= thresh


def _transform_leaf(w: torch.Tensor, group: CompressionGroup,
                    step: int) -> torch.Tensor:
    if step < group.schedule_offset:
        return w
    if group.kind == "weight_quantization":
        return _QuantizeSTE.apply(
            w, _bits_at(group, step),
            group.quantization_type != "asymmetric", group.quantize_groups)
    with torch.no_grad():
        a = w.detach().to(torch.float32).abs()
        if group.kind == "sparse_pruning":
            mask = _topk_mask(a, group.dense_ratio)
        elif group.kind == "row_pruning":
            mask = _topk_mask(a.sum(dim=tuple(range(1, w.dim()))),
                              group.dense_ratio)
            mask = mask.reshape((-1,) + (1,) * (w.dim() - 1))
        elif group.kind == "channel_pruning":
            mask = _topk_mask(a.sum(dim=tuple(range(w.dim() - 1))),
                              group.dense_ratio)
        elif group.kind == "head_pruning":
            # rows of the attention out-proj grouped per head (reference:
            # basic_layer head_pruning on output_matrix rows)
            nh = group.num_heads
            rows = w.shape[0]
            if nh <= 0 or rows % nh:
                raise ValueError(f"head_pruning needs num_heads dividing "
                                 f"rows {rows}, got {nh}")
            per = rows // nh
            mask = _topk_mask(a.reshape(nh, per, -1).sum(dim=(1, 2)),
                              group.dense_ratio)
            mask = mask.repeat_interleave(per).reshape(
                (rows,) + (1,) * (w.dim() - 1))
        else:
            raise ValueError(f"unknown compression kind {group.kind}")
    return w * mask.to(w.dtype)


def _leaves(tree: PyTree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def compressible(path: str, spec: CompressionSpec) -> bool:
    """Whether some group of ``spec`` transforms the leaf at ``path`` (a
    kernel or an embedding that a group's regexes match)."""
    return ("kernel" in path or "embedding" in path) and any(
        g.matches(path) for g in spec.groups)


def transform_leaf(path: str, leaf: torch.Tensor, spec: CompressionSpec,
                   step: int) -> torch.Tensor:
    """One leaf through every group of ``spec`` that matches it, in the
    spec's order."""
    if leaf.dim() < 1 or not ("kernel" in path or "embedding" in path):
        return leaf
    for g in spec.groups:
        if g.matches(path):
            leaf = _transform_leaf(leaf, g, step)
    return leaf


def apply_compression(params: PyTree, spec: CompressionSpec,
                      step: int) -> PyTree:
    """Transform every matched leaf of a nested dict of tensors (the JAX
    layout's paths). Gradients pass straight through to the raw weights
    (QAT semantics). ``step``: the optimizer steps applied so far (the
    schedule gate is ``step >= schedule_offset``)."""
    if not spec.groups:
        return params

    def walk(node, prefix):
        return {k: (walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                    else transform_leaf(f"{prefix}{k}", v, spec, step))
                for k, v in node.items()}

    return walk(params, "")


def init_compression(config: Dict) -> CompressionSpec:
    """The reference's ``compress.init_compression``: the spec the engine
    applies in its forward."""
    section = config.get("compression_training", config)
    if hasattr(section, "model_dump"):
        section = section.model_dump()
    return parse_compression_config(section)


# ---------------------------------------------------------------------------
# layer reduction + export
# ---------------------------------------------------------------------------

def apply_layer_reduction(params: PyTree, keep_layers: List[int]) -> PyTree:
    """Student initialization from a teacher's stacked layers (reference:
    compress.student_initialization: teacher_layer selects which teacher
    blocks seed the student)."""
    out = dict(params)
    if "blocks" not in out:
        raise ValueError("layer_reduction expects scan-layers params "
                         "(a 'blocks' subtree stacked [L, ...])")

    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        t = torch.as_tensor(node)
        idx = torch.as_tensor(keep_layers, dtype=torch.long, device=t.device)
        return t.index_select(0, idx)

    out["blocks"] = take(out["blocks"])
    return out


def export_int8(params: PyTree, spec: CompressionSpec) -> Dict[str, Any]:
    """Post-training export: the weights a ``weight_quantization`` group
    matches as (int8, scale) pairs, the rest as they are, as a flat dict
    of numpy arrays by path (reference: redundancy_clean / the inference
    handoff)."""
    from ..ops.quantizer import quantize_symmetric
    out = {}
    for p, leaf in _leaves(params):
        t = torch.as_tensor(leaf).detach()
        matched = any(g.matches(p) and g.kind == "weight_quantization"
                      for g in spec.groups)
        if matched and t.dim() >= 1:
            q, scale = quantize_symmetric(t, bits=8, groups=1)
            out[p + ".int8"] = q.cpu().numpy()
            out[p + ".scale"] = scale.cpu().numpy()
        else:
            out[p] = (t.to(torch.float32) if t.dtype == torch.bfloat16
                      else t).cpu().numpy()
    return out
