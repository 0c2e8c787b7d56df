"""InferenceEngine — config-driven inference wrapper (counterpart of
``deepspeed_tpu/inference/engine.py``).

It casts the weights to the config's dtype (bf16 or f32) on one device,
or, with ``dtype: "int8"``, quantizes every matmul kernel per output
channel (:func:`quantize_weights_int8`) and computes in bf16. It serves
the continuous-batching ``ServingEngine`` (``serve()``'s single-engine
branch) and runs ``generate()`` (``models.generation.generate``). The int8
engine's ``forward()`` is ``forward_with_cache`` on a fresh cache; the
bf16/f32 ``forward()`` applies the ``models.transformer.Transformer``
module to the engine's weights, as the JAX engine applies its flax
model. ``load_checkpoint`` reads a name-keyed npz written by either
package (re-quantizing for int8). ``tp_size > 1`` and the serving fleet,
disaggregated and process placements raise ``NotImplementedError`` until
later slices of the port (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.generation import (ensure_scan_layout, forward_with_cache,
                                 generate, init_cache, padded_cache_len)
from ..models.transformer import TransformerConfig
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig, load_inference_config

_DTYPES = {"float16": torch.float16, "fp16": torch.float16,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}
_LATER = "is not ported to deepspeed_tpu_torch yet (see ROADMAP.md)"


def quantize_weights_int8(params: Dict[str, Any]) -> Dict[str, Any]:
    """Weight-only int8: per-output-channel symmetric quantization of the
    matmul kernels (attention, MLP, lm_head). Embeddings, norms, biases
    and a MoE router (a ``gate`` node) stay high precision. Each quantized
    ``kernel`` [..., in, out] becomes int8 with a sibling f32
    ``kernel_scale`` [..., 1, out] (absmax / 127 over ``in``; 1 for an all
    zero channel), so ``kernel.float() * kernel_scale`` rebuilds the
    weight within scale / 2 elementwise. The bytes equal the JAX
    package's (round half to even in both)."""

    def walk(node, path=()):
        out = {}
        for key, val in node.items():
            if (key == "kernel" and isinstance(val, torch.Tensor)
                    and val.dim() >= 2 and "gate" not in path):
                w = val.to(torch.float32)
                scale = w.abs().amax(dim=-2, keepdim=True) / 127.0
                scale = torch.where(scale == 0.0, torch.ones_like(scale),
                                    scale)
                out["kernel"] = torch.clamp(torch.round(w / scale), -127,
                                            127).to(torch.int8)
                out["kernel_scale"] = scale
            elif isinstance(val, dict):
                out[key] = walk(val, path + (key,))
            else:
                out[key] = val
        return out

    return walk(params)


class InferenceEngine:
    """``model``: the ``TransformerConfig`` of the served model (or an
    object with a ``cfg`` attribute, such as the module that
    ``replace_transformer_layer`` returns). ``model_parameters``: its
    scan-layout (or per-layer) parameter tree of tensors, e.g. from
    ``models.transformer.init_params``, ``models.hf.load_hf`` or
    ``models.convert.params_from_jax``.
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
        self.quantized = dtype == "int8"
        if dtype not in _DTYPES and not self.quantized:
            raise ValueError(f"dtype {dtype!r}: expected one of "
                             f"{sorted(_DTYPES)}")
        tp = self.config.tensor_parallel.tp_size
        if tp != 1:
            raise NotImplementedError(f"tensor_parallel.tp_size={tp} "
                                      + _LATER)
        if model_parameters is None:
            raise ValueError("need model_parameters (models.transformer."
                             "init_params builds them from a seed)")
        # int8 is weight-only: activations compute in bf16
        self.dtype = torch.bfloat16 if self.quantized else _DTYPES[dtype]
        params = ensure_scan_layout(model_parameters, cfg.num_layers)
        if self.quantized:
            params = quantize_weights_int8(params)
        self.params = _cast(params, self.dtype, self.device)
        self._module = None
        log_dist(f"InferenceEngine: dtype={dtype} device={self.device}"
                 + (" (int8 weight-only)" if self.quantized else ""),
                 ranks=[0])

    def forward(self, batch):
        """Logits [B, T, V] f32 of ``batch`` (ids [B, T], or a dict with
        ``input_ids`` and optional ``attention_mask``, ``position_ids`` and
        ``token_type_ids``). The bf16/f32 engine applies the
        ``Transformer`` module to its weights (built on first use), so an
        encoder returns its MLM logits or, without an LM head, its hidden
        states; the int8 engine runs ``forward_with_cache`` on a fresh
        cache."""
        if not self.quantized:
            if self._module is None:
                from ..models.transformer import Transformer
                self._module = Transformer(self.cfg, params=self.params)
                self._module.requires_grad_(False)
            if isinstance(batch, dict):
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in batch.items()}
            with torch.no_grad():
                return self._module(batch)
        ids = batch["input_ids"] if isinstance(batch, dict) else batch
        ids = torch.as_tensor(ids, device=self.device)
        B, T = ids.shape
        cache = init_cache(self.cfg, B, padded_cache_len(T),
                           device=self.device)
        with torch.no_grad():
            logits, _ = forward_with_cache(self.cfg, self.params, ids, cache)
        return logits

    __call__ = forward

    def load_checkpoint(self, path: str):
        """Load a name-keyed npz (``save_16bit_model`` output or a tag's
        ``model_states.npz``, written by either package) onto this
        engine's device: every parameter path of the served model must be
        present with its shape. Leaves are cast to the engine's dtype; an
        int8 engine loads the full-precision kernels and quantizes them
        again (:func:`quantize_weights_int8`)."""
        from ..runtime.checkpointing import load_tree

        def full_precision(node):      # the tree before quantization
            return {k: full_precision(v) if isinstance(v, dict) else v
                    for k, v in node.items() if k != "kernel_scale"}

        raw = load_tree(path, full_precision(self.params))
        if self.quantized:
            raw = quantize_weights_int8(
                _cast(raw, torch.float32, self.device))
        self.params = _cast(raw, self.dtype, self.device)
        self._module = None
        log_dist(f"InferenceEngine: loaded {path}", ranks=[0])
        return self

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k=None,
                 generator: Optional[torch.Generator] = None, top_p=None,
                 repetition_penalty=None, attention_mask=None,
                 kv_cache_dtype=None) -> torch.Tensor:
        """Autoregressive generation with a KV cache
        (``models.generation.generate``): ids [B, T] -> [B, T +
        max_new_tokens]. ``generator`` (a ``torch.Generator`` on this
        engine's device) takes the place of the JAX package's ``rng``;
        top_p, repetition_penalty and left-padded ragged batches
        (``attention_mask``) follow HF generate."""
        ids = torch.as_tensor(input_ids, device=self.device)
        return generate(self.cfg, self.params, ids, max_new_tokens,
                        temperature, generator, top_k, top_p,
                        repetition_penalty, attention_mask, kv_cache_dtype)

    def serve(self, serving=None, heartbeat=None):
        """The continuous-batching serving loop over this engine's weights:
        a ``serving.ServingEngine`` with a paged KV pool, FIFO admission,
        prefix-cache reuse and one fixed-shape decode step. ``serving``
        overrides the config's ``serving`` section (dict or
        ServingConfig)."""
        from ..config.config import ServingConfig
        from ..models.generation import check_decodable
        from ..serving.engine import ServingEngine
        check_decodable(self.cfg)
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
