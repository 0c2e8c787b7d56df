"""PipelineModule: a model as a layer list, partitioned into stages
(counterpart of ``deepspeed_tpu/runtime/pipe/module.py``; reference
``runtime/pipe/module.py``): ``LayerSpec`` / ``TiedLayerSpec`` lazy layer
construction, layer -> stage partitioning by ``uniform | parameters |
type:regex`` (reference ``_partition_layers``, module.py:365) and the
partition-boundary math (a prefix-sum search, as
``ds_utils.partition_balanced``).

The pipelined span is a homogeneous run of identical specs: transformer
stacks are, and the embedding and head run outside it
(``models/pipeline.py`` builds that shape from a ``TransformerConfig``).
"""

from __future__ import annotations

import re
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


class LayerSpec:
    """Lazy layer description: class + ctor args, built at partition time
    (reference: module.py:24-71)."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs

    def build(self):
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self):
        return f"LayerSpec({getattr(self.typename, '__name__', self.typename)})"


class TiedLayerSpec(LayerSpec):
    """Layer whose parameters are shared across stages under a tie key
    (reference: module.py:72-85; e.g. embedding tied with the LM head)."""

    def __init__(self, key, typename, *module_args, forward_fn=None,
                 tied_weight_attr="embedding", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """Boundaries [p0..pP] splitting items as evenly as possible."""
    parts = [0] * (num_parts + 1)
    chunk = num_items // num_parts
    residual = num_items % num_parts
    for p in range(1, num_parts + 1):
        parts[p] = parts[p - 1] + chunk + (1 if p <= residual else 0)
    return parts


def partition_balanced(weights: Sequence[float], num_parts: int) -> List[int]:
    """Boundaries minimizing the max per-part weight sum (binary search over
    the bottleneck + greedy check — the reference uses the same idea)."""
    weights = list(weights)
    n = len(weights)
    if num_parts >= n:
        return list(range(n + 1)) + [n] * (num_parts - n)
    prefix = np.concatenate([[0.0], np.cumsum(weights)])

    def feasible(cap: float) -> Optional[List[int]]:
        bounds = [0]
        for _ in range(num_parts):
            lo = bounds[-1]
            # furthest j with sum(weights[lo:j]) <= cap
            j = int(np.searchsorted(prefix, prefix[lo] + cap, side="right")) - 1
            if j <= lo:
                return None
            bounds.append(min(j, n))
            if bounds[-1] == n:
                break
        if bounds[-1] != n:
            return None
        while len(bounds) < num_parts + 1:
            bounds.append(n)
        return bounds

    lo, hi = max(weights), sum(weights)
    best = feasible(hi)
    for _ in range(60):
        mid = (lo + hi) / 2
        b = feasible(mid)
        if b is not None:
            best, hi = b, mid
        else:
            lo = mid
    return best


class PipelineModule:
    """Holds the layer list + stage assignment.

    ``partition_method``: "uniform" | "parameters" | "type:<regex>"
    (reference: module.py:365-420). ``param_counts`` supplies per-layer
    parameter counts for the "parameters" method (the reference builds each
    layer and counts; here models pass counts so partitioning stays lazy).
    """

    def __init__(self,
                 layers: Sequence[LayerSpec],
                 num_stages: int,
                 partition_method: str = "parameters",
                 param_counts: Optional[Sequence[float]] = None,
                 loss_fn: Optional[Callable] = None,
                 activation_checkpoint_interval: int = 0):
        self.layer_specs = list(layers)
        self.num_stages = num_stages
        self.partition_method = partition_method
        self.loss_fn = loss_fn
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.parts = self._partition(param_counts)

    def _partition(self, param_counts) -> List[int]:
        n = len(self.layer_specs)
        method = self.partition_method.lower()
        if method == "uniform":
            return partition_uniform(n, self.num_stages)
        if method == "parameters":
            if param_counts is None:
                param_counts = [1.0] * n
            if len(param_counts) != n:
                raise ValueError("param_counts length != number of layers")
            return partition_balanced(param_counts, self.num_stages)
        if method.startswith("type:"):
            pat = re.compile(method[5:], re.IGNORECASE)
            weights = [1.0 if pat.search(getattr(s.typename, "__name__", str(s)))
                       else 0.0 for s in self.layer_specs]
            if sum(weights) == 0:
                raise ValueError(f"no layer matches {method}")
            return partition_balanced(weights, self.num_stages)
        raise NotImplementedError(f"partition_method {self.partition_method}")

    def stage_layers(self, stage_id: int) -> List[LayerSpec]:
        return self.layer_specs[self.parts[stage_id]:self.parts[stage_id + 1]]

    def stage_of_layer(self, layer_idx: int) -> int:
        for s in range(self.num_stages):
            if self.parts[s] <= layer_idx < self.parts[s + 1]:
                return s
        raise IndexError(layer_idx)

    def tied_keys(self) -> List[str]:
        keys = []
        for s in self.layer_specs:
            if isinstance(s, TiedLayerSpec) and s.key not in keys:
                keys.append(s.key)
        return keys

    def homogeneous_span(self) -> tuple:
        """(start, end) of the maximal run of identical specs — the pipelined
        region the stages pipeline. Identical = same type + same ctor
        args."""
        n = len(self.layer_specs)
        best = (0, 0)
        i = 0
        while i < n:
            j = i + 1
            si = self.layer_specs[i]
            while j < n:
                sj = self.layer_specs[j]
                same = (type(si) is type(sj) and si.typename is sj.typename
                        and si.module_args == sj.module_args
                        and si.module_kwargs == sj.module_kwargs)
                if not same:
                    break
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = j
        return best
