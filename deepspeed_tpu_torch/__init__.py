"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference; this package runs the
same system with PyTorch on an NVIDIA GPU (Hopper), its TPU kernels
rewritten by hand in CUDA. It imports neither JAX nor ``deepspeed_tpu``.
Module names follow the JAX package's layout. Ported so far: the
serving path, ``init_inference(...).serve()``, and generation,
``init_inference(...).generate()``.

Entry points run on CUDA unless the caller passes ``device="cpu"``, which
runs every kernel's plain PyTorch version.
"""

__version__ = "0.1.0"


def init_inference(model=None, config=None, **kwargs):
    """Build an :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
    (``model``: a ``TransformerConfig``; see the engine for the rest)."""
    from .inference.engine import InferenceEngine
    return InferenceEngine(model=model, config=config, **kwargs)
