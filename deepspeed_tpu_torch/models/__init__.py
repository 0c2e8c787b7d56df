"""The in-tree model family (the GPT decoder / BERT encoder and the
presets), as the JAX package's ``models`` exports it."""

from .transformer import (
    Transformer,
    TransformerConfig,
    Block,
    build_model,
    get_config,
    causal_lm_loss,
    masked_lm_loss,
    make_moe_loss,
    cross_entropy,
    fused_loss_passthrough,
)
from .pipeline import PipelinedTransformer, build_pipelined_model

__all__ = [
    "Transformer", "TransformerConfig", "Block", "build_model", "get_config",
    "causal_lm_loss", "masked_lm_loss", "make_moe_loss", "cross_entropy",
    "fused_loss_passthrough", "PipelinedTransformer", "build_pipelined_model",
]
