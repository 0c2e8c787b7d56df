"""Elastic training: world-size-compatible batch configuration math."""

from .elastic_agent import PREEMPTION_EXIT_CODE, DSElasticAgent
from .elasticity import (HCN_LIST, ElasticityError, compute_elastic_config,
                         get_best_candidates, get_valid_gpus)

__all__ = ["HCN_LIST", "ElasticityError", "compute_elastic_config",
           "get_best_candidates", "get_valid_gpus", "DSElasticAgent",
           "PREEMPTION_EXIT_CODE"]
