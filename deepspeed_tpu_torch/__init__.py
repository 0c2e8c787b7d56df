"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference; this package runs the
same system with PyTorch on an NVIDIA GPU (Hopper), its TPU kernels
rewritten by hand in CUDA. It imports neither JAX nor ``deepspeed_tpu``.
Module names follow the JAX package's layout. Ported so far: the
serving path, ``init_inference(...).serve()``; generation,
``init_inference(...).generate()``; training, ``initialize(...)`` ->
``engine.train_batch()`` (or ``forward`` / ``backward`` / ``step``), in
one process or data parallel with ZeRO stages 0-3 across the ranks of a
``torch.distributed`` process group (``comm``, ``init_distributed``, the
mesh and topology classes, ``zero``; one process per GPU through
``python -m deepspeed_tpu_torch.launcher.launch``), with sequence
parallelism and mixture-of-experts models (``MoE``, ``make_moe_loss``)
whose experts split over the mesh's ``expert`` axis; and the HF import,
``replace_transformer_layer(hf_model)`` (``models.hf``, 21 architecture
policies), with the reference's fused-layer API
``DeepSpeedTransformerLayer`` / ``DeepSpeedTransformerConfig``.

Entry points run on CUDA unless the caller passes ``device="cpu"``, which
runs every kernel's plain PyTorch version.
"""

import importlib
from typing import Tuple

__version__ = "0.1.0"

#: the package's exports, each imported at its first use: the launcher's
#: processes (the runner, its supervisors) import the package without
#: paying for torch and the model code they never run
_EXPORTS = {
    "comm": (".comm", None),
    "zero": (".zero", None),
    "init_distributed": (".comm", "init_distributed"),
    "replace_transformer_layer": (".models.hf", "replace_transformer_layer"),
    "revert_transformer_layer": (".models.hf", "revert_transformer_layer"),
    "DeepSpeedTransformerConfig": (".models.transformer",
                                   "DeepSpeedTransformerConfig"),
    "DeepSpeedTransformerLayer": (".models.transformer",
                                  "DeepSpeedTransformerLayer"),
    "make_moe_loss": (".models.transformer", "make_moe_loss"),
    "MoE": (".moe", "MoE"),
    "MeshManager": (".parallel.mesh", "MeshManager"),
    "build_mesh_from_config": (".parallel.mesh", "build_mesh_from_config"),
    "get_global_mesh": (".parallel.mesh", "get_global_mesh"),
    "ProcessTopology": (".parallel.topology", "ProcessTopology"),
    "PipeDataParallelTopology": (".parallel.topology",
                                 "PipeDataParallelTopology"),
    "PipeModelDataParallelTopology": (".parallel.topology",
                                      "PipeModelDataParallelTopology"),
    "PipelineParallelGrid": (".parallel.topology", "PipelineParallelGrid"),
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod, attr = _EXPORTS[name]
    value = importlib.import_module(mod, __name__)
    if attr is not None:
        value = getattr(value, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


def initialize(args=None,
               model=None,
               optimizer=None,
               model_parameters=None,
               training_data=None,
               lr_scheduler=None,
               mpu=None,
               dist_init_required=None,
               collate_fn=None,
               config=None,
               config_params=None,
               **kwargs) -> Tuple:
    """Wrap ``model`` (an ``nn.Module``, typically
    ``models.transformer.build_model(...)[0]``) in a
    :class:`~deepspeed_tpu_torch.runtime.engine.DeepSpeedEngine`, or a
    ``models.pipeline.PipelinedTransformer`` in a
    :class:`~deepspeed_tpu_torch.runtime.pipe.engine.PipelineEngine`; returns
    (engine, optimizer, dataloader, lr_scheduler) as the JAX package's
    ``initialize`` does. ``model_parameters``: a flax-layout numpy tree
    for a ``Transformer``, or None for the module's own parameters.
    Keyword-only extras: ``loss_fn`` (default: the model returns the
    loss) and ``device`` (default CUDA; ``"cpu"`` runs the plain
    versions). Unless ``dist_init_required`` is False,
    :func:`init_distributed` starts the process group a launcher
    described (``WORLD_SIZE`` / ``RANK`` in the environment), as the JAX
    package's ``initialize`` does; without one the engine runs in one
    process, with one (of any size) data parallel."""
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if dist_init_required is None or dist_init_required:
        from .comm import init_distributed
        init_distributed(device=kwargs.get("device"))
    from .models.pipeline import PipelinedTransformer
    from .runtime.engine import DeepSpeedEngine
    from .runtime.pipe.engine import PipelineEngine
    engine_cls = (PipelineEngine if isinstance(model, PipelinedTransformer)
                  else DeepSpeedEngine)
    engine = engine_cls(model=model, config=config,
                             model_parameters=model_parameters,
                             optimizer=optimizer, lr_scheduler=lr_scheduler,
                             mpu=mpu, **kwargs)
    dataloader = None
    if training_data is not None:
        from .runtime.dataloader import DeepSpeedDataLoader
        dataloader = DeepSpeedDataLoader(
            training_data,
            batch_size=engine.config.train_batch_size,
            collate_fn=collate_fn,
            drop_last=engine.config.dataloader_drop_last)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler


def init_inference(model=None, config=None, **kwargs):
    """Build an :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
    (``model``: a ``TransformerConfig``, or a module with a ``cfg`` such as
    ``replace_transformer_layer``'s; see the engine for the rest)."""
    from .inference.engine import InferenceEngine
    return InferenceEngine(model=model, config=config, **kwargs)


def default_inference_config():
    """The default inference config as a plain dict (feed it back to
    ``init_inference`` after edits)."""
    from .inference.config import DeepSpeedInferenceConfig
    return DeepSpeedInferenceConfig().model_dump()


def add_config_arguments(parser):
    """The reference's argparse flags: ``--deepspeed``,
    ``--deepspeed_config`` and the hidden ``--deepscale``."""
    import argparse
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to the DeepSpeed json configuration")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help=argparse.SUPPRESS)
    return parser
