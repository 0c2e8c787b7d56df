"""InferenceEngine — config-driven inference wrapper (counterpart of
``deepspeed_tpu/inference/engine.py``).

This slice serves: it casts the weights to the config's dtype (bf16 or
f32) on one device and builds the continuous-batching ``ServingEngine``
(``serve()``'s single-engine branch). int8 ``dtype`` (per-channel
weights), ``tp_size > 1``, ``generate()`` and the serving fleet,
disaggregated and process placements raise ``NotImplementedError`` until
later slices of the port (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.generation import ensure_scan_layout
from ..models.transformer import TransformerConfig
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig, load_inference_config

_DTYPES = {"float16": torch.float16, "fp16": torch.float16,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}
_LATER = "is not ported to deepspeed_tpu_torch yet (see ROADMAP.md)"


class InferenceEngine:
    """``model``: the ``TransformerConfig`` of the served model (or an
    object with a ``cfg`` attribute). ``model_parameters``: its scan-layout
    (or per-layer) parameter tree of tensors, e.g. from
    ``models.transformer.init_params`` or ``models.convert.params_from_jax``.
    ``config``: a dict, a ``DeepSpeedInferenceConfig`` or a path to a JSON
    file. ``device``: default CUDA; ``"cpu"`` runs the plain versions of
    the kernels."""

    def __init__(self, model=None, config=None, model_parameters=None,
                 device=None, **kwargs):
        if kwargs:
            raise TypeError(f"InferenceEngine: unsupported arguments "
                            f"{sorted(kwargs)}")
        cfg = getattr(model, "cfg", model)
        if not isinstance(cfg, TransformerConfig):
            raise NotImplementedError(
                "deepspeed_tpu_torch serves a models.transformer."
                "TransformerConfig; arbitrary modules " + _LATER)
        self.cfg = cfg
        self.config: DeepSpeedInferenceConfig = load_inference_config(config)
        self.device = resolve_device(device)
        dtype = str(self.config.dtype)
        if dtype == "int8":
            raise NotImplementedError(
                "dtype='int8' (per-channel weight-only) " + _LATER
                + "; serving.weight_dtype='int8' is ported")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r}: expected one of "
                             f"{sorted(_DTYPES)}")
        tp = self.config.tensor_parallel.tp_size
        if tp != 1:
            raise NotImplementedError(f"tensor_parallel.tp_size={tp} "
                                      + _LATER)
        if model_parameters is None:
            raise ValueError("need model_parameters (models.transformer."
                             "init_params builds them from a seed)")
        self.dtype = _DTYPES[dtype]
        self.params = _cast(ensure_scan_layout(model_parameters,
                                               cfg.num_layers),
                            self.dtype, self.device)
        log_dist(f"InferenceEngine: dtype={dtype} device={self.device}",
                 ranks=[0])

    def generate(self, *args, **kwargs):
        raise NotImplementedError("InferenceEngine.generate " + _LATER
                                  + "; use serve()")

    def serve(self, serving=None, heartbeat=None):
        """The continuous-batching serving loop over this engine's weights:
        a ``serving.ServingEngine`` with a paged KV pool, FIFO admission,
        prefix-cache reuse and one fixed-shape decode step. ``serving``
        overrides the config's ``serving`` section (dict or
        ServingConfig)."""
        from ..config.config import ServingConfig
        from ..serving.engine import ServingEngine
        scfg = serving if serving is not None else self.config.serving
        if isinstance(scfg, dict):
            scfg = ServingConfig(**scfg)
        fleet = scfg.fleet
        if (fleet.replicas > 1 or fleet.prefill_replicas > 0
                or fleet.decode_replicas > 0 or fleet.autoscale.enabled
                or str(fleet.placement) == "process"):
            raise NotImplementedError(
                "serving.fleet (replicas, disaggregated roles, autoscale, "
                "process placement) " + _LATER)
        if self.config.watchdog.serve_timeout > 0:
            raise NotImplementedError("watchdog.serve_timeout (the serving "
                                      "stall watchdog) " + _LATER)
        return ServingEngine(self.cfg, self.params, serving=scfg,
                             heartbeat=heartbeat, device=self.device)


def _cast(tree: Dict[str, Any], dtype, device) -> Dict[str, Any]:
    """Floating-point leaves to ``dtype`` on ``device``; int8 kernels and
    their f32 scales keep their dtype."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _cast(v, dtype, device)
        elif k in ("kernel_scale", "kernel_qscale") or \
                not v.is_floating_point():
            out[k] = v.to(device)
        else:
            out[k] = v.to(device=device, dtype=dtype)
    return out
