"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``):
the same JSON keys and defaults."""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from pydantic import Field

from ..config.config import DeepSpeedConfigModel, ServingConfig, \
    WatchdogConfig


class InferenceTPConfig(DeepSpeedConfigModel):
    tp_size: int = 1
    enabled: bool = True


class QuantConfig(DeepSpeedConfigModel):
    enabled: bool = False
    bits: int = 8


class MoEInferenceConfig(DeepSpeedConfigModel):
    enabled: bool = False
    ep_size: int = 1
    moe_experts: list = Field(default_factory=lambda: [1])


class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    dtype: str = "bfloat16"
    tensor_parallel: InferenceTPConfig = Field(default_factory=InferenceTPConfig,
                                               alias="tp")
    moe: MoEInferenceConfig = Field(default_factory=MoEInferenceConfig)
    quant: QuantConfig = Field(default_factory=QuantConfig)
    replace_with_kernel_inject: bool = False
    injection_policy: Optional[Dict[Any, Any]] = None
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_tokens: int = 1024
    checkpoint: Optional[str] = None
    enable_cuda_graph: bool = False
    replace_method: str = "auto"
    serving: ServingConfig = Field(default_factory=ServingConfig)
    watchdog: WatchdogConfig = Field(default_factory=WatchdogConfig)


def load_inference_config(config) -> DeepSpeedInferenceConfig:
    """None, a dict, a config object, or a path to a JSON file."""
    if config is None:
        return DeepSpeedInferenceConfig()
    if isinstance(config, DeepSpeedInferenceConfig):
        return config
    if isinstance(config, dict):
        return DeepSpeedInferenceConfig(**config)
    with open(config) as f:
        return DeepSpeedInferenceConfig(**json.load(f))
