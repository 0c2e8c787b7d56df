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
package (re-quantizing for int8) and reshards it onto this engine's
``tp_size``.

Tensor parallelism (``tensor_parallel.tp_size`` with
``sharding_rules=cfg.tp_rules()``, in a process group whose mesh has a
``model`` axis of ``tp_size``): each rank keeps only its shards of the
weights (``utils.partitioning.shard_tree``: its heads' qkv columns, its
MLP columns and projection rows, its ceil(V / t) vocab rows) and runs
the Megatron layers over them (``models/generation.py``); ``generate()``
and ``serve()`` give every rank the whole logits, so each picks the same
tokens. The layers run whenever a process group is up and the rules are
given, a model axis of one included. ``sharding_rules=None`` keeps the
weights whole on every rank, as the JAX engine replicates them.
``serve()`` with a ``fleet`` section starts the serving fleet: thread or
process replicas, the disaggregated prefill / decode pair and autoscaling
(``serving/fleet.py``, ``procfleet.py``, ``disagg.py``).
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


def quantize_weights_int8(params: Dict[str, Any], tp=None, rules=None
                          ) -> Dict[str, Any]:
    """Weight-only int8: per-output-channel symmetric quantization of the
    matmul kernels (attention, MLP, lm_head). Embeddings, norms, biases
    and a MoE router (a ``gate`` node) stay high precision. Each quantized
    ``kernel`` [..., in, out] becomes int8 with a sibling f32
    ``kernel_scale`` [..., 1, out] (absmax / 127 over ``in``; 1 for an all
    zero channel), so ``kernel.float() * kernel_scale`` rebuilds the
    weight within scale / 2 elementwise. The bytes equal the JAX
    package's (round half to even in both).

    Under TP (``tp``, with the ``rules`` that cut ``params`` into this
    rank's shards) a row-parallel kernel's absmax is the max over the
    model axis of the ranks' row shards: each rank holds the whole
    leaf's quantization, sliced, and keeps the whole [1, out] scale, so
    the all-reduced sum of the partial products is the whole one."""
    from ..utils.partitioning import spec_for

    def row_parallel(path) -> bool:
        spec = spec_for("/".join(path + ("kernel",)), rules)
        return (tp is not None and spec is not None
                and len(spec) >= 2 and spec[-2] == "model")

    def walk(node, path=()):
        out = {}
        for key, val in node.items():
            if (key == "kernel" and isinstance(val, torch.Tensor)
                    and val.dim() >= 2 and "gate" not in path):
                w = val.to(torch.float32)
                amax = w.abs().amax(dim=-2, keepdim=True)
                if row_parallel(path):
                    from .. import comm
                    comm.all_reduce(amax, op=comm.ReduceOp.MAX,
                                    axis=tp.axis)
                scale = amax / 127.0
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
    the kernels. ``sharding_rules``: None, or ``cfg.tp_rules()`` (module
    docstring; any other table raises). ``shards``: in place of
    ``model_parameters``, this rank's shards of the scan-layout tree as
    ``utils.partitioning.shard_tree`` cuts them (a caller that builds
    them layer by layer never holds the whole model); their shapes are
    checked."""

    def __init__(self, model=None, config=None, model_parameters=None,
                 device=None, sharding_rules=None, shards=None, **kwargs):
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
        self.tp, self._rules = _tp_context(
            cfg, self.config.tensor_parallel.tp_size, sharding_rules,
            self.device)
        if (model_parameters is None) == (shards is None):
            raise ValueError("need model_parameters (models.transformer."
                             "init_params builds them from a seed), or "
                             "this rank's shards")
        # int8 is weight-only: activations compute in bf16
        self.dtype = torch.bfloat16 if self.quantized else _DTYPES[dtype]
        # the whole tree's shapes: what a checkpoint holds
        if shards is not None:
            from ..models.transformer import init_params
            self._whole = init_params(cfg, None, device="meta",
                                      dtype=torch.float32)
            _check_shapes(shards, self._shard(self._whole))
            self._place(shards, sharded=True)
        else:
            params = ensure_scan_layout(model_parameters, cfg.num_layers)
            self._whole = _meta(params)
            self._place(params)
        self._module = None
        log_dist(f"InferenceEngine: dtype={dtype} device={self.device}"
                 + (" (int8 weight-only)" if self.quantized else "")
                 + (f" tp={self.tp.size}" if self.tp else ""), ranks=[0])

    def _shard(self, tree):
        from ..utils.partitioning import shard_tree
        return shard_tree(tree, self.cfg, self.tp, self._rules)

    def _place(self, params, sharded: bool = False) -> None:
        """This rank's shards of a whole tree (or, ``sharded``, the shards
        themselves), quantized for the int8 engine, in the engine's dtype
        on its device."""
        if not sharded:
            params = self._shard(params)
        if self.quantized:
            params = quantize_weights_int8(
                _cast(params, torch.float32, self.device), self.tp,
                self._rules)
        self.params = _cast(params, self.dtype, self.device)

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
                self._module.set_tp(self.tp)
            if isinstance(batch, dict):
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in batch.items()}
            with torch.no_grad():
                return self._module(batch)
        ids = batch["input_ids"] if isinstance(batch, dict) else batch
        ids = torch.as_tensor(ids, device=self.device)
        B, T = ids.shape
        cache = init_cache(self.cfg, B, padded_cache_len(T),
                           device=self.device, tp=self.tp)
        with torch.no_grad():
            logits, _ = forward_with_cache(self.cfg, self.params, ids, cache,
                                           tp=self.tp)
        return logits

    __call__ = forward

    def load_checkpoint(self, path: str):
        """Load a name-keyed npz (``save_16bit_model`` output or a tag's
        ``model_states.npz``, written by either package) onto this
        engine's device: every parameter path of the served model must be
        present with its shape. Leaves are cast to the engine's dtype; an
        int8 engine loads the full-precision kernels and quantizes them
        again (:func:`quantize_weights_int8`). The checkpoint's leaves are
        whole, whatever topology wrote them; each rank keeps its shards of
        them (``tp_size`` resharding)."""
        from ..runtime.checkpointing import load_tree
        self.params = None
        self._place(load_tree(path, self._whole))
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
                        repetition_penalty, attention_mask, kv_cache_dtype,
                        tp=self.tp)

    def serve(self, serving=None, heartbeat=None):
        """The continuous-batching serving loop over this engine's weights:
        a ``serving.ServingEngine`` with a paged KV pool, tiered FIFO
        admission, prefix-cache reuse and one fixed-shape decode step.
        ``serving`` overrides the config's ``serving`` section (dict or
        ServingConfig); ``heartbeat`` (a ``runtime.heartbeat.
        HeartbeatWriter``) receives a SERVE record every loop iteration.
        When the config arms ``watchdog.serve_timeout``, the stall
        watchdog supervises the loop (rc 117 on a wedged iteration).

        With ``serving.fleet.replicas > 1``, both ``prefill_replicas`` and
        ``decode_replicas``, ``autoscale.enabled`` or ``placement:
        "process"`` this returns a STARTED fleet instead
        (``serving.make_fleet``: a thread ``ServingFleet`` or a
        ``ProcessFleet``), supervised through per-replica heartbeats; the
        in-process stall watchdog stays off (its rc-117 exit would take
        every replica). Close it (or use it as a context manager) so the
        replicas stamp EXIT."""
        from ..config.config import ServingConfig
        from ..models.generation import check_decodable
        from ..utils.logging import logger
        check_decodable(self.cfg)
        scfg = serving if serving is not None else self.config.serving
        if isinstance(scfg, dict):
            scfg = ServingConfig(**scfg)
        fleet = scfg.fleet
        if (fleet.prefill_replicas > 0) != (fleet.decode_replicas > 0):
            # one-sided disaggregation fails here, not by falling through
            # to a single engine
            raise ValueError(
                "serving.fleet: prefill_replicas and decode_replicas "
                "must both be > 0 for disaggregated serving (got "
                f"{fleet.prefill_replicas}/{fleet.decode_replicas})")
        disagg = fleet.prefill_replicas > 0
        # autoscale.enabled forces the fleet even at replicas=1: the
        # single engine has no supervisor to grow it
        if (fleet.replicas > 1 or disagg or fleet.autoscale.enabled
                or str(fleet.placement) == "process"):
            if self.tp is not None:
                raise ValueError(
                    "serving.fleet serves replicas of a whole model on "
                    "one device; it does not combine with "
                    "tensor_parallel (serve one engine per model group)")
            from ..serving.procfleet import make_fleet
            hb_dir = fleet.heartbeat_dir
            if heartbeat is not None and hb_dir is None:
                # the fleet writes per-replica records and run-scopes its
                # channel, so it takes a `fleet/` subdirectory of the
                # caller's channel rather than its rank file
                import os
                hb_dir = os.path.join(heartbeat.directory, "fleet")
                logger.warning(
                    "serve(): fleet mode replaces the provided heartbeat "
                    "writer with per-replica writers under %s — point "
                    "`dstpu health` there", hb_dir)
            if self.config.watchdog.serve_timeout > 0:
                logger.warning(
                    "serve(): watchdog.serve_timeout is not armed under "
                    "a fleet — its rc-117 exit would take every replica; "
                    "the fleet supervisor (fleet.heartbeat_timeout) "
                    "supervises replicas instead")
            return make_fleet(self.cfg, self.params, serving=scfg,
                              heartbeat_dir=hb_dir,
                              device=self.device).start()
        from ..serving.engine import ServingEngine
        eng = ServingEngine(self.cfg, self.params, serving=scfg,
                            heartbeat=heartbeat, device=self.device,
                            tp=self.tp)
        if self.config.watchdog.serve_timeout > 0:
            eng.arm_watchdog(self.config.watchdog.serve_timeout)
        return eng


def _tp_context(cfg, tp_size: int, rules, device):
    """(TPContext or None, the rules as run) of an engine: the mesh's
    ``model`` axis in a process group, when rules are given."""
    from .. import comm
    from ..utils.partitioning import TPContext, check_tp_model, check_tp_rules
    rules = check_tp_rules(rules, cfg)
    if not comm.is_initialized():
        if tp_size > 1:
            raise ValueError(
                f"tensor_parallel.tp_size {tp_size} needs a process group "
                f"of a multiple of {tp_size} ranks (launch the script with "
                "launcher/launch.py, or call comm.init_distributed())")
        return None, rules
    import torch.distributed as dist
    from ..parallel.mesh import MeshManager, get_global_mesh, set_global_mesh
    if (dist.get_backend() == "nccl") != (device.type == "cuda"):
        raise ValueError(
            f"process group backend {dist.get_backend()!r} with device "
            f"{device}: NCCL serves CUDA and gloo the CPU")
    mesh = get_global_mesh()
    if mesh is None or mesh.world_size != comm.get_world_size() or \
            mesh.shape["model"] != tp_size:
        mesh = MeshManager(tp_size=tp_size)
        set_global_mesh(mesh)
    if rules is None:
        return None, rules
    check_tp_model(cfg, tp_size)
    return TPContext(mesh.axis_rank("model"), tp_size, cfg.vocab_size), rules


def _meta(tree):
    return {k: _meta(v) if isinstance(v, dict) else
            torch.empty(tuple(v.shape), device="meta")
            for k, v in tree.items()}


def _check_shapes(tree, like, prefix: str = "") -> None:
    for k, ref in like.items():
        if k not in tree:
            raise ValueError(f"shards lack '{prefix}{k}'")
        if isinstance(ref, dict):
            _check_shapes(tree[k], ref, f"{prefix}{k}/")
        elif tuple(tree[k].shape) != tuple(ref.shape):
            raise ValueError(f"shard '{prefix}{k}' has shape "
                             f"{tuple(tree[k].shape)}, expected "
                             f"{tuple(ref.shape)}")


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
