"""Typed config sections the serving slice reads.

Counterpart of the serving part of ``deepspeed_tpu/config/config.py``:
``ServingConfig`` and the sections nested in it, plus ``WatchdogConfig``.
The JSON keys and defaults are the JAX package's, so one ds_config file
parses to the same ``model_dump()`` in both packages. Fields that drive
machinery this slice has not ported (fleet supervision, autoscaling,
straggler drain, watchdog deadlines) are parsed and kept; the engines
raise ``NotImplementedError`` where a set value would need them.
"""

from __future__ import annotations

from typing import Optional

from pydantic import BaseModel, ConfigDict, Field


class DeepSpeedConfigModel(BaseModel):
    """Base for all config sections: keep unknown keys, populate by alias."""
    model_config = ConfigDict(extra="allow", populate_by_name=True,
                              validate_assignment=True, protected_namespaces=())

    def get(self, key, default=None):
        return getattr(self, key, default)


class StragglerConfig(DeepSpeedConfigModel):
    """Straggler detection knobs (``serving.fleet.straggler``)."""
    enabled: bool = False
    window: int = 8
    check_interval: float = 5.0
    zmax: float = 6.0
    rel_threshold: float = 1.5
    warmup: int = 3
    strike_window: int = 3
    cooldown: int = 10
    abort_after: int = 0


class WatchdogConfig(DeepSpeedConfigModel):
    """Phase deadlines in seconds; 0 leaves a phase unbounded. The serving
    slice reads ``serve_timeout`` only."""
    stall_timeout: float = 0.0
    poll_interval: float = 0.0
    compile_timeout: float = 0.0
    restore_timeout: float = 0.0
    save_timeout: float = 0.0
    serve_timeout: float = 0.0


class AutoscaleConfig(DeepSpeedConfigModel):
    """Replica autoscaling (``serving.fleet.autoscale``)."""
    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    up_queue_per_replica: int = 4
    pressure_s: float = 0.0
    up_after: int = 2
    down_idle_s: float = 10.0
    cooldown_s: float = 15.0


class FleetConfig(DeepSpeedConfigModel):
    """The multi-replica serving fleet. The single engine reads
    ``priority_aging_s`` and ``batch_highwater`` (the scheduler's tier
    aging and batch-tier admission rung); ``replicas``,
    ``prefill_replicas``, ``decode_replicas``, ``placement`` and
    ``autoscale.enabled`` select fleet modes this slice does not serve."""
    replicas: int = 1
    placement: str = "thread"          # "thread" | "process"
    prefill_replicas: int = 0
    decode_replicas: int = 0
    retry_budget: int = 2
    heartbeat_timeout: float = 10.0
    heartbeat_interval: float = 0.25
    poll_interval: float = 0.5
    blacklist_after: int = 3
    min_replicas: int = 1
    max_queue: int = 4096
    default_deadline_s: float = 0.0
    heartbeat_dir: Optional[str] = None
    priority_aging_s: float = 30.0     # tier starvation floor (seconds)
    preempt_pressure_s: float = 0.0
    batch_highwater: float = 0.9       # queue fraction that sheds batch tier
    autoscale: AutoscaleConfig = Field(default_factory=AutoscaleConfig)
    straggler: StragglerConfig = Field(default_factory=StragglerConfig)


class ServingConfig(DeepSpeedConfigModel):
    """The continuous-batching serving loop (``serving/``). The KV cache is
    a paged POOL of ``pool_blocks`` blocks x ``block_size`` tokens shared by
    every in-flight sequence (block 0 reserved as the null block);
    requests are admitted FIFO when their lifetime block budget fits,
    prefilled into their blocks (reusing prefix-cached blocks when
    ``prefix_cache``), and decoded by one fixed-shape step over
    ``max_batch`` lanes."""
    block_size: int = 32               # tokens per KV block
    pool_blocks: int = 256             # pool capacity incl. the null block
    max_batch: int = 8                 # decode lanes
    max_blocks_per_seq: int = 64       # table width; caps prompt+generation
    prefix_cache: bool = True          # reuse shared full-block prefixes
    max_queue: int = 4096              # admission queue bound (backpressure)
    kv_cache_dtype: Optional[str] = None   # None = model dtype; "int8" pool
    # "int8" packs the dense decode kernels once at engine construction
    # into blockwise int8 (ops/quant_matmul.py); None = the model dtype
    weight_dtype: Optional[str] = None
    seed: int = 0                      # sampling generator seed
    # > 0 advances a prompt's prefill at most this many tokens per loop
    # iteration, interleaved with decode steps; 0 = whole prefill
    prefill_chunk_tokens: int = 0
    # per-lane top-k / top-p in the decode step (a [B, V] sort per step)
    sampling_filters: bool = False
    handoff_queue: int = 16            # disaggregated serving (not ported)
    fleet: FleetConfig = Field(default_factory=FleetConfig)
