"""MoQ, mixture-of-quantization training (counterpart of
``deepspeed_tpu/runtime/quantize.py``; reference ``runtime/quantize.py``:
bit reduction on a schedule during training, optionally paced by the
Hessian eigenvalue so that sensitive weights quantize later). The
``quantize_training`` section becomes one ``compression`` weight-
quantization group, the same straight-through fake-quant, and
``MoQScheduler`` lengthens its bit schedule by the measured curvature
ratio.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..compression.compress import CompressionGroup, CompressionSpec


def build_moq_spec(qt: Dict[str, Any]) -> Optional[CompressionSpec]:
    """ds_config['quantize_training'] -> CompressionSpec (None if
    disabled). Keys follow the reference (runtime/config.py
    get_quantize_enabled): quantize_bits {start_bits, target_bits},
    quantize_schedule {quantize_period, schedule_offset},
    quantize_groups, quantize_algo {q_type: symmetric|asymmetric},
    modules (default every kernel and embedding)."""
    if not qt or not qt.get("enabled", False):
        return None
    bits = qt.get("quantize_bits", {})
    sched = qt.get("quantize_schedule", {})
    algo = qt.get("quantize_algo", {})
    group = CompressionGroup(
        kind="weight_quantization",
        name="moq",
        modules=tuple(qt.get("modules", ["kernel", "embedding"])),
        schedule_offset=int(sched.get("schedule_offset", 0)),
        start_bits=int(bits.get("start_bits", 16)),
        target_bits=int(bits.get("target_bits", 8)),
        quantization_period=int(sched.get("quantize_period", 100)),
        quantization_type=str(algo.get("q_type", "symmetric")),
        quantize_groups=int(qt.get("quantize_groups", 1)),
    )
    return CompressionSpec(groups=[group])


class MoQScheduler:
    """Eigenvalue-paced period stretching (reference: quantize.py's
    eigenvalue gating: weights of larger curvature quantize more
    slowly)."""

    def __init__(self, spec: CompressionSpec, eigenvalue=None,
                 period_scale_max: float = 4.0):
        self.spec = spec
        self.eigenvalue = eigenvalue
        self.period_scale_max = period_scale_max
        self._baseline: Optional[float] = None

    def maybe_rescale(self, loss_fn, params, generator=None,
                      loss_args: tuple = ()) -> CompressionSpec:
        """Measure the curvature and stretch quantization_period by its
        ratio to the first measurement (capped at ``period_scale_max``,
        never below 1). Returns the (possibly new) spec."""
        if self.eigenvalue is None:
            return self.spec
        eig = self.eigenvalue.compute_eigenvalue(loss_fn, params, generator,
                                                 loss_args=loss_args)
        if self._baseline is None:
            self._baseline = max(eig, 1e-12)
            return self.spec
        scale = min(max(eig / self._baseline, 1.0), self.period_scale_max)
        self.spec = CompressionSpec(
            groups=[dataclasses.replace(
                g, quantization_period=int(g.quantization_period * scale))
                for g in self.spec.groups],
            activation_bits=self.spec.activation_bits,
            activation_offset=self.spec.activation_offset,
            layer_reduction=self.spec.layer_reduction)
        return self.spec
