"""Mixture of experts: gating, the expert-parallel layer and the
explicit all-to-all executor (counterpart of ``deepspeed_tpu/moe``)."""

from .layer import MoE, ExpertMLP, expert_parallel_apply
from .sharded_moe import (top1_gating, top2_gating, compute_capacity,
                          load_balance_loss)

__all__ = ["MoE", "ExpertMLP", "expert_parallel_apply", "top1_gating",
           "top2_gating", "compute_capacity", "load_balance_loss"]
