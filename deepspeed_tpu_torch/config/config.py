"""DeepSpeedConfig — typed parse of a ds_config.json / dict.

The port's own copy of ``deepspeed_tpu/config/config.py`` (that module is
JAX-free; the port imports nothing of the JAX package, so it keeps its
copy): every section, key, alias and default is the same, so any
ds_config the JAX package accepts parses here to the same ``model_dump()``,
and ``resolve_batch_sizes`` triangulates the batch triple the same way.
The section docstrings describe the JAX package's machinery; which
sections the port's engines consume, and which raise
``NotImplementedError`` when enabled, is listed in
``runtime/engine.py`` and ``inference/engine.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Union

from pydantic import BaseModel, ConfigDict, Field, model_validator

from . import constants as C


class DeepSpeedConfigModel(BaseModel):
    """Base for all config sections: ignore-and-warn unknown keys, populate by alias."""
    model_config = ConfigDict(extra="allow", populate_by_name=True,
                              validate_assignment=True, protected_namespaces=())

    def get(self, key, default=None):
        return getattr(self, key, default)


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------

class FP16Config(DeepSpeedConfigModel):
    """reference: runtime/constants.py:132-176"""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False


class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    # TPU extension: master_weights=false is PURE-bf16 training — params ARE
    # the master and Adam moments store bf16 (math still f32 in-register).
    # 6 bytes/param of state instead of 18: the device-resident path to
    # beyond-HBM scale when host offload is bandwidth-starved.
    master_weights: bool = True


class AMPConfig(DeepSpeedConfigModel):
    enabled: bool = False
    opt_level: str = "O1"


# ---------------------------------------------------------------------------
# ZeRO
# ---------------------------------------------------------------------------

class OffloadDeviceEnum:
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    """reference: runtime/zero/offload_config.py"""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False


class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0


class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    """reference: runtime/zero/config.py:78-260"""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None
    sub_group_size: int = 1_000_000_000
    cpu_offload: Optional[bool] = None          # deprecated alias -> offload_optimizer
    cpu_offload_params: Optional[bool] = None   # deprecated alias -> offload_param
    prefetch_bucket_size: int = Field(50_000_000, alias="stage3_prefetch_bucket_size")
    param_persistence_threshold: int = Field(100_000, alias="stage3_param_persistence_threshold")
    model_persistence_threshold: int = Field(int(1e30), alias="stage3_model_persistence_threshold")
    max_live_parameters: int = Field(1_000_000_000, alias="stage3_max_live_parameters")
    max_reuse_distance: int = Field(1_000_000_000, alias="stage3_max_reuse_distance")
    gather_16bit_weights_on_model_save: bool = Field(
        False, alias="stage3_gather_16bit_weights_on_model_save")
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    # ZeRO++ qwZ: stage-3 param gathers carry int8 shards + scales (1/4 the
    # bf16 gather bytes). Trades the per-layer streaming gathers for one
    # whole-tree quantized gather per microbatch — right when gather
    # bandwidth (DCN) is the bottleneck, wrong when HBM capacity is (the
    # gathered bf16 weights are all resident at once)
    zero_quantized_weights: bool = False

    @model_validator(mode="after")
    def _migrate_deprecated(self):
        if self.cpu_offload and self.offload_optimizer is None:
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(device="cpu")
        if self.cpu_offload_params and self.offload_param is None:
            self.offload_param = DeepSpeedZeroOffloadParamConfig(device="cpu")
        if self.overlap_comm is None:
            self.overlap_comm = self.stage == 3
        return self


# ---------------------------------------------------------------------------
# Activation checkpointing / sparse attention
# ---------------------------------------------------------------------------

class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    """reference: runtime/activation_checkpointing/config.py"""
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


class SparseAttentionConfig(DeepSpeedConfigModel):
    """reference: runtime/config.py:270-453; modes map onto our block-sparse
    mask layouts. CONSUMED by engine.wire_attention_config: the section is
    wired into the in-tree model's attention_impl="sparse" (unknown modes
    raise at initialize)."""
    mode: str = "fixed"
    block: int = 16
    different_layout_per_head: bool = False
    # fixed
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    horizontal_global_attention: bool = False
    num_different_global_patterns: int = 1
    # variable
    num_random_blocks: int = 0
    local_window_blocks: List[int] = Field(default_factory=lambda: [4])
    global_block_indices: List[int] = Field(default_factory=lambda: [0])
    global_block_end_indices: Optional[List[int]] = None
    # bigbird / bslongformer
    num_sliding_window_blocks: int = 3


# ---------------------------------------------------------------------------
# Aux sections
# ---------------------------------------------------------------------------

class FlopsProfilerConfig(DeepSpeedConfigModel):
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


class TensorBoardConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


class WandbConfig(DeepSpeedConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed"


class CSVConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


class CommsLoggerConfig(DeepSpeedConfigModel):
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = Field(default_factory=list)


class AIOConfig(DeepSpeedConfigModel):
    """reference: runtime/swap_tensor/constants.py:17-26"""
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


class ElasticityConfig(DeepSpeedConfigModel):
    """reference: elasticity/constants.py"""
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = Field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    version: float = 0.1
    ignore_non_elastic_batch_info: bool = False
    prefer_larger_batch: bool = True


class AutotuningConfig(DeepSpeedConfigModel):
    enabled: bool = False
    fast: bool = True
    results_dir: str = "autotuning_results"
    exps_dir: str = "autotuning_exps"
    overwrite: bool = False
    metric: str = "throughput"
    start_profile_step: int = 3
    end_profile_step: int = 5
    num_tuning_micro_batch_sizes: int = 3
    tuner_type: str = "gridsearch"
    tuner_early_stopping: int = 5
    tuner_num_trials: int = 50
    arg_mappings: Optional[Dict[str, str]] = None
    max_train_batch_size: Optional[int] = None
    min_train_batch_size: int = 1
    max_train_micro_batch_size_per_gpu: Optional[int] = None
    min_train_micro_batch_size_per_gpu: int = 1
    num_nodes: Optional[int] = None
    num_gpus: Optional[int] = None


class PipelineConfig(DeepSpeedConfigModel):
    """reference: runtime/config.py:454-467 + pipe/module.py kwargs"""
    stages: int = 1
    partition: str = "parameters"   # uniform | parameters | type:regex
    seed_layers: bool = False
    activation_checkpoint_interval: int = 0
    micro_batches: Optional[int] = None
    # "gpipe": AD through the scan (memory ∝ n_micro, f32 boundary);
    # "1f1b": hand-scheduled interleave (memory ∝ stages, bf16 boundary) —
    # the reference TrainSchedule's execution regime
    schedule: str = "gpipe"
    # schedule/placement split (round 13, docs/PIPELINE.md): "spmd" runs
    # the stacked-stage single-program executors; "mpmd" runs each stage
    # as its own jit program on its own submesh, connected by the explicit
    # transfer channel (runtime/pipe/mpmd) — per-stage compiles, per-stage
    # failure domains. Both placements execute the same clock tables.
    placement: str = "spmd"


class TensorParallelConfig(DeepSpeedConfigModel):
    """TPU-native addition: first-class training TP (reference delegates to external mpu)."""
    tp_size: int = 1
    autotp: bool = True


class SequenceParallelConfig(DeepSpeedConfigModel):
    """TPU-native addition: ring-attention / Ulysses-style context parallelism
    over ICI. ``mode`` is CONSUMED by engine.wire_attention_config: with
    sp_size > 1 it selects the in-tree model's ring vs ulysses
    attention_impl (hand-set conflicting impls raise)."""
    sp_size: int = 1
    mode: str = "ring"   # ring | ulysses


class MoEConfig(DeepSpeedConfigModel):
    """Engine-level MoE knobs (the reference configures MoE per-layer in code)."""
    enabled: bool = False
    ep_size: int = 1
    num_experts: int = 1
    top_k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None
    drop_tokens: bool = True
    use_rts: bool = True


class CheckpointConfig(DeepSpeedConfigModel):
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = Field(default_factory=dict)
    async_save: bool = False   # TPU-native: orbax-style async checkpointing
    # -- crash-safety knobs (TPU-native; see docs/RESILIENCE.md) ------------
    keep_last: Optional[int] = None   # retention: keep newest K tags (None = all)
    keep_every: int = 0               # + every tag whose step % keep_every == 0
    write_retries: int = 3            # async writer: transient-IO retries
    write_retry_backoff: float = 0.05  # exponential-backoff base, seconds
    verify_load: bool = True          # digest-verify tags at load/rollback


class DataTypesConfig(DeepSpeedConfigModel):
    grad_accum_dtype: Optional[str] = None


class NonFiniteGuardConfig(DeepSpeedConfigModel):
    """DEPRECATED alias (round 7): the streak/abort semantics are folded
    into the training-integrity sentinel as one code path —
    ``abort_after`` here maps onto ``integrity.nonfinite_abort_after``
    (which wins when both are set). Behavior is unchanged: the train step
    skips-and-counts non-finite updates in-jit
    (TrainState.nonfinite_streak), the host check rides the batched
    ``_after_step`` metrics pull (detection latency ``steps_per_print``
    steps unless the sentinel's every-step pull is on), and the abort is
    raised after N CONSECUTIVE skipped steps (0 = never)."""
    abort_after: int = 0


class IntegrityConfig(DeepSpeedConfigModel):
    """TPU-native (round 7): the training-integrity sentinel
    (runtime/sentinel.py, docs/RESILIENCE.md). ``enabled`` turns on the
    host-side anomaly detector over per-step statistics the compiled step
    already computes (loss, global grad norm, update norm, param norm —
    all riding the ONE batched device_get in ``_after_step``) and the
    remediation ladder: in-jit skip of spiked batches (``skip``), then
    auto-rollback to the newest intact checkpoint after
    ``rollback_after`` strikes inside ``strike_window`` steps, then abort
    with rc 118 when the anomaly reproduces after
    ``abort_after_rollbacks`` rollbacks. ``audit_interval`` > 0 adds the
    cross-replica SDC audit: a bit-exact in-jit checksum of every
    fully-replicated state leaf, compared across replicas every N steps;
    a minority replica stamps an ``SDC`` heartbeat flag and the run
    aborts with rc 118 so the relaunch resumes from the last
    audited-clean checkpoint. ``nonfinite_abort_after`` is the folded-in
    PR-3 non-finite guard (``nonfinite_guard.abort_after`` remains as a
    deprecated alias)."""
    enabled: bool = False
    # -- detector ------------------------------------------------------------
    metrics: List[str] = Field(
        default_factory=lambda: ["loss", "grad_norm", "update_norm"])
    window: int = 64           # rolling median/MAD sample window
    zmax: float = 8.0          # robust z-score anomaly threshold
    warmup_steps: int = 20     # accepted samples before any verdict
    cooldown_steps: int = 5    # steps one anomaly event covers (one strike)
    # -- remediation ladder --------------------------------------------------
    skip: bool = True               # rung 1: in-jit skip past the ceiling
    rollback_after: int = 3         # strikes in window -> rung 2
    strike_window: int = 50         # steps
    abort_after_rollbacks: int = 1  # reproduced post-rollback -> rung 3
    load_dir: Optional[str] = None  # rollback source (default: last dir the
    #                                 engine saved to / loaded from)
    # -- SDC audit -----------------------------------------------------------
    audit_interval: int = 0    # steps between cross-replica audits; 0 = off
    # -- folded-in non-finite guard -----------------------------------------
    nonfinite_abort_after: int = 0


class StragglerConfig(DeepSpeedConfigModel):
    """TPU-native (round 15): straggler defense (runtime/straggler.py,
    docs/RESILIENCE.md). The *slow* leg of the threat model — a
    slow-but-alive host (thermal throttling, degraded NIC, noisy
    neighbor) passes every dead/wrong check while the synchronous step
    drags the whole world to its pace. Every worker stamps a rolling
    per-step wall-time gauge (``step_ms``) into its heartbeat records
    regardless of this section (``dstpu health`` RATE column); with
    ``enabled`` a cross-rank detector (the sentinel's median/MAD
    machinery applied across ranks, leave-one-out: the judged rank
    never sits in its own baseline) issues warmup-gated,
    cooldown-debounced verdicts when a rank's step time sits ``zmax``
    robust sigmas above the OTHER ranks' median AND above
    ``rel_threshold`` x that median for ``strike_window`` consecutive
    windows — the relative floor means a UNIFORMLY slow world (everyone
    throttled alike) produces zero verdicts. A verdicted rank stamps a sticky
    ``STRAGGLER`` heartbeat flag (blacklist evidence, the SDC-flag
    pattern); with ``abort_after > 0`` a rank still slow that many
    windows past its verdict exits rc 117 so the elastic agent
    relaunches the world without the slow host. ``abort_after = 0``
    (default) is evidence-only: nothing is ever torn down. The same
    section under ``serving.fleet.straggler`` drives the fleet-side
    slow-replica DRAIN (serving/fleet.py)."""
    enabled: bool = False
    window: int = 8            # worker-side rolling step_ms gauge window
    check_interval: float = 5.0  # engine-side seconds between detection windows
    zmax: float = 6.0          # robust sigmas above the world median
    rel_threshold: float = 1.5  # AND this multiple of the world median
    warmup: int = 3            # complete windows before any verdict
    strike_window: int = 3     # consecutive slow windows -> verdict
    cooldown: int = 10         # windows one verdict debounces
    abort_after: int = 0       # post-verdict windows -> rc 117; 0 = never


class WatchdogConfig(DeepSpeedConfigModel):
    """TPU-native (rounds 4+6): in-worker PHASE-AWARE watchdog. A wedged
    rank in a multi-controller job silently deadlocks every collective in
    the pod; the engine reports lifecycle phases (RESTORE → COMPILE →
    STEP → SAVE, runtime/heartbeat.py) and each phase gets its own
    deadline — a gap beyond it dumps all thread stacks and exits the
    distinct stall rc (runtime/watchdog.py: STALL_EXIT_CODE) so the
    launcher-side supervisor tears the world down and the elastic agent
    restarts — counted against its budget, unlike a preemption. 0 leaves
    a phase unbounded. ``stall_timeout`` bounds steady-state STEP gaps;
    ``compile_timeout`` the first-train_batch-entry → first-completed-step
    window (the compile hang the round-4 watchdog could not see);
    ``restore_timeout`` a checkpoint load; ``save_timeout`` a checkpoint
    write (0 keeps the round-4 suspend-through-saves behavior). The
    watchdog still suspends through the preemption grace window. The
    related bound on ``jax.distributed.initialize`` (the INIT phase) is
    NOT a ds_config knob — it must act before any config is parsed: set
    ``DSTPU_INIT_TIMEOUT`` (forwarded to remote hosts by dstpu),
    ``launch.py --init_timeout``, or the ``initialization_timeout=``
    kwarg of ``init_distributed``. See docs/RESILIENCE.md."""
    stall_timeout: float = 0.0    # STEP: secs without a step heartbeat; 0 = off
    poll_interval: float = 0.0    # check cadence; 0 = min active deadline / 4
    compile_timeout: float = 0.0  # COMPILE: first entry -> first step; 0 = off
    restore_timeout: float = 0.0  # RESTORE: load_checkpoint bound; 0 = off
    save_timeout: float = 0.0     # SAVE: save bound; 0 = unbounded (suspend)
    serve_timeout: float = 0.0    # SERVE: serving-loop iteration gap; 0 = off


class AutoscaleConfig(DeepSpeedConfigModel):
    """TPU-native (round 19): traffic-shaped replica autoscaling
    (``serving/autoscale.py``, docs/SERVING.md §Autoscaling). With
    ``enabled`` the FleetSupervisor/ProcessFleet feed their own SERVE
    heartbeat gauges (queue depth, active lanes, deadline pressure)
    through an AutoscalePolicy each poll: ``up_after`` consecutive
    overloaded observations (queue deeper than ``up_queue_per_replica``
    per live replica, or any queued request within ``pressure_s`` of its
    deadline) spawn ONE warmed replica; a trough of ``down_idle_s``
    seconds with an empty queue drains the newest replica through the
    straggler-drain path (admission stops, lanes finish, then teardown
    — never a mid-lane kill). ``cooldown_s`` debounces both directions
    so a single burst cannot flap, and no verdict at all is issued
    while a replica is still warming (its silence is compile, not
    idleness). Bounds: ``min_replicas`` <= live <= ``max_replicas``.
    Every scale event lands in the heartbeat channel (`dstpu health`
    rank 999) and in ``fleet.scale_events``."""
    enabled: bool = False
    min_replicas: int = 1              # scale-down floor
    max_replicas: int = 4              # scale-up ceiling
    up_queue_per_replica: int = 4      # queue depth per live replica = overload
    pressure_s: float = 0.0            # queued-TTL window that reads as
    #                                    deadline pressure; 0 = off
    up_after: int = 2                  # consecutive overloaded polls -> up
    down_idle_s: float = 10.0          # idle-trough duration -> down
    cooldown_s: float = 15.0           # min seconds between scale events


class FleetConfig(DeepSpeedConfigModel):
    """TPU-native (round 11): the supervised multi-replica serving fleet
    (``serving/fleet.py``, docs/SERVING.md §Fleet). With ``replicas > 1``
    the serving tier runs N continuous-batching replica engines (weights
    shared, KV pools per-replica) behind ONE bounded admission queue. A
    FleetSupervisor consumes each replica's SERVE heartbeat records
    (runtime/heartbeat.py): a dead worker or ``heartbeat_timeout``
    seconds of record silence — the rc-117 contract applied fleet-side —
    tears down only that replica, requeues its in-flight requests with
    exactly-once token emission, and restarts it; ``blacklist_after``
    strikes quarantine a repeatedly-dying replica, and when live replicas
    would drop below ``min_replicas`` the least-struck blacklisted one is
    paroled back (the elastic agent's machinery, applied to serving).
    ``retry_budget`` bounds requeues per request — past it the request
    concludes FAILED instead of looping. ``default_deadline_s`` is the
    queue-wait TTL applied to requests submitted without one (0 = none);
    expired queued requests are shed with TIMEOUT (graceful admission
    backpressure). ``heartbeat_dir`` points the per-replica channel at a
    directory ``dstpu health`` can read (default: a private tempdir,
    exposed as ``ServingFleet.heartbeat_dir``)."""
    replicas: int = 1                  # 1 = plain single-engine serving
    # replica placement (round 18, serving/procfleet.py): "thread" runs
    # replica engines as threads in this process (the round-11 fleet);
    # "process" runs each replica as a supervised OS PROCESS — weights
    # via checkpoint load, request/token streams over the transfer
    # fabric's TCP star (runtime/fabric/), SERVE heartbeats with gauges
    # in the shared channel, warmed restart on death — the
    # fleet-across-a-pod shape. Process placement requires plain
    # replicas (disagg roles share one in-process pool by construction).
    placement: str = "thread"          # "thread" | "process"
    # disaggregated serving (round 12, serving/disagg.py): with BOTH > 0
    # the fleet runs prefill-role and decode-role replicas over ONE
    # shared paged-KV state, connected by the bounded block-handoff
    # queue — `replicas` is ignored in favor of the role counts. A dead
    # prefill replica's half-prefilled request requeues exactly-once
    # (partial blocks released, chunk progress carried in the death
    # ledger); a dead decode replica requeues through the token-exact
    # prompt+emitted path.
    prefill_replicas: int = 0          # disagg prefill-role replicas
    decode_replicas: int = 0           # disagg decode-role replicas
    retry_budget: int = 2              # requeues per request before FAILED
    heartbeat_timeout: float = 10.0    # replica record silence -> dead
    heartbeat_interval: float = 0.25   # replica writer min_interval
    poll_interval: float = 0.5         # supervisor check cadence
    blacklist_after: int = 3           # strikes before quarantine; 0 = never
    min_replicas: int = 1              # parole floor for live replicas
    max_queue: int = 4096              # shared admission queue bound
    default_deadline_s: float = 0.0    # queue-wait TTL; 0 = none
    heartbeat_dir: Optional[str] = None  # None = private tempdir
    # priority lanes (round 19, serving/scheduler.py TieredQueue):
    # submit(priority=) picks latency/standard/batch; dispatch serves
    # the highest tier first, FIFO within a tier, and a head that has
    # waited longer than ``priority_aging_s`` is served regardless of
    # tier (the starvation floor). A latency-tier request within
    # ``preempt_pressure_s`` of its deadline (or waiting past it with
    # no deadline set) may PREEMPT a running batch-tier lane: the
    # victim requeues through the exactly-once token-exact path
    # (emitted prefix carried, no retry_budget charge). 0 disables
    # preemption. ``batch_highwater`` is the admission ladder's soft
    # rung: once the queue is past this fraction of max_queue, new
    # batch-tier submissions get a machine-readable AdmissionRejected
    # instead of deepening the backlog — saturation degrades batch
    # before latency.
    priority_aging_s: float = 30.0     # tier starvation floor (seconds)
    preempt_pressure_s: float = 0.0    # latency deadline slack -> preempt;
    #                                    0 = preemption off
    batch_highwater: float = 0.9       # queue fraction that sheds batch tier
    autoscale: AutoscaleConfig = Field(default_factory=AutoscaleConfig)
    # straggler drain (round 15, runtime/straggler.py): with
    # straggler.enabled the FleetSupervisor runs the cross-rank
    # relative-slowness detector over the replicas' step_ms SERVE gauges
    # and DRAINS a verdicted replica through the existing death path —
    # admission stops, its lanes requeue exactly-once token-exact, the
    # replica restarts warmed, the strike counts toward blacklist_after
    # — instead of letting one throttled replica hold the shared
    # queue's p99 hostage. (abort_after is ignored fleet-side: the
    # drain IS the remediation.)
    straggler: StragglerConfig = Field(default_factory=StragglerConfig)


class ServingConfig(DeepSpeedConfigModel):
    """TPU-native (round 8): the continuous-batching serving loop
    (deepspeed_tpu/serving/, docs/SERVING.md). The KV cache is a paged
    POOL of ``pool_blocks`` blocks x ``block_size`` tokens shared by
    every in-flight sequence (block 0 reserved as the null block);
    requests are admitted FIFO when their lifetime block budget fits,
    prefilled into their blocks (reusing prefix-cached blocks for shared
    system prompts when ``prefix_cache``), and decoded by ONE fixed-shape
    jitted step over ``max_batch`` lanes. Pool HBM ≈ 2 (k+v) x layers x
    heads x head_dim x pool_blocks x block_size x dtype_bytes; size
    ``pool_blocks`` to the HBM left after weights. ``block_size`` trades
    fragmentation (last-block waste per sequence) against table length
    and prefix-cache granularity — shared prefixes are reused at
    full-block granularity only."""
    block_size: int = 32               # tokens per KV block
    pool_blocks: int = 256             # pool capacity incl. the null block
    max_batch: int = 8                 # decode lanes (fixed compiled shape)
    max_blocks_per_seq: int = 64       # table width; caps prompt+generation
    prefix_cache: bool = True          # reuse shared full-block prefixes
    max_queue: int = 4096              # admission queue bound (backpressure)
    kv_cache_dtype: Optional[str] = None   # None = model dtype; "int8" =
    #                                    quantized pool (round 12; round 17
    #                                    dequantizes IN the Pallas kernel)
    # weight-only blockwise int8 (round 17): "int8" packs the dense decode
    # kernels ONCE at engine construction into int8 + one f32 scale per
    # 256 contraction elements (quant_format's wire format) and routes
    # the decode matmuls through ops/pallas/quant_matmul — half the
    # weight HBM per token. None = serve the model dtype.
    weight_dtype: Optional[str] = None
    seed: int = 0                      # sampling PRNG seed
    # chunked prefill (round 12): > 0 advances a prompt's prefill at most
    # this many tokens per loop iteration, interleaved with decode steps
    # — a long prompt no longer adds head-of-line latency to running
    # lanes. 0 = whole prefill per admission (the round-8 behavior).
    # Token-exact vs whole prefill; compiles one extra prefill bucket at
    # most per chunk size (the chunk's block-rounded width).
    prefill_chunk_tokens: int = 0
    # per-lane top-k / top-p in the COMPILED decode step (round 12):
    # off by default because the nucleus filter puts a [B, V] sort in
    # every decode step; when off, submit(top_k=/top_p=) raises as
    # before. Parity with models.generation._sample is pinned by test.
    sampling_filters: bool = False
    # disaggregated serving (round 12): bound on finished-prefill items
    # waiting in the prefill->decode block-handoff queue (backpressure:
    # a full queue stalls prefill, never drops an item)
    handoff_queue: int = 16
    fleet: FleetConfig = Field(default_factory=FleetConfig)


class CommPlanConfig(DeepSpeedConfigModel):
    """TPU-native (round 10): the communication-planning subsystem
    (``deepspeed_tpu/comm_plan/``, docs/COMM.md). With ``enabled`` the
    engine resolves a wire format per collective site — the ZeRO-2
    gradient reduce-scatter and the MoE expert all-to-all — through the
    ladder override > recorded plan > size heuristic, and routes
    non-exact verdicts through the explicit blockwise-int8 collectives
    in ``runtime/comm/quantized.py``. ``plan_path`` points at a plan
    recorded by ``dstpu comm-plan sweep``; ``overrides`` forces an
    algorithm per site alias (``grad_reduce_scatter``,
    ``moe_all_to_all``) or wire kind (``reduce_scatter`` ...), and an
    unexecutable forced algorithm raises at initialize.
    ``guard_min_grad_norm`` is the accuracy guard: once the observed
    global grad norm drops below it, subsequent steps run the exact
    program (quantization error is no longer small relative to the
    signal; the latch applies to the LOSSY algorithms — ``overlap``
    moves exact values and is exempt); it costs the per-step metrics
    pull. ``quant_block`` is the elements-per-scale granularity of the
    int8 wire format (error is bounded by block absmax / 127 per
    element). Round 14: the ``overlap`` algorithm family (docs/COMM.md)
    — ``overlap_chunks`` is the pieces each overlapped collective is
    split into (chunk k+1's wire time hides under chunk k's compute; a
    static trace constant, so changing it recompiles once, never
    per-step), and ``overlap_min_leaf_elems`` keeps tiny param leaves
    on the implicit gather (chunking a bias buys nothing and costs a
    collective's latency floor per chunk)."""
    enabled: bool = False
    plan_path: Optional[str] = None
    overrides: Dict[str, str] = Field(default_factory=dict)
    quant_bits: int = 8
    quant_block: int = 256
    size_threshold_mb: float = 4.0     # heuristic regime boundary
    guard_min_grad_norm: float = 0.0   # 0 = guard off
    overlap_chunks: int = 4            # pieces per overlapped collective
    overlap_min_leaf_elems: int = 4096  # smaller leaves: implicit gather


class ProgressiveLayerDropConfig(DeepSpeedConfigModel):
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


class EigenvalueConfig(DeepSpeedConfigModel):
    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = "bert.encoder.layer"
    layer_num: int = 0


class CompressionConfig(DeepSpeedConfigModel):
    """reference: compression/config.py — parsed; applied by compression/compress.py port."""
    weight_quantization: Dict[str, Any] = Field(default_factory=dict)
    activation_quantization: Dict[str, Any] = Field(default_factory=dict)
    sparse_pruning: Dict[str, Any] = Field(default_factory=dict)
    row_pruning: Dict[str, Any] = Field(default_factory=dict)
    head_pruning: Dict[str, Any] = Field(default_factory=dict)
    channel_pruning: Dict[str, Any] = Field(default_factory=dict)
    layer_reduction: Dict[str, Any] = Field(default_factory=dict)


class CurriculumLearningLegacyConfig(DeepSpeedConfigModel):
    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = Field(default_factory=dict)


class DataEfficiencyConfig(DeepSpeedConfigModel):
    enabled: bool = False
    seed: int = 1234
    data_sampling: Dict[str, Any] = Field(default_factory=dict)
    data_routing: Dict[str, Any] = Field(default_factory=dict)


class NebulaConfig(DeepSpeedConfigModel):
    enabled: bool = False
    persistent_storage_path: Optional[str] = None
    persistent_time_interval: int = 100
    num_of_version_in_retention: int = 2
    enable_nebula_load: bool = True


class OptimizerConfig(DeepSpeedConfigModel):
    type: str = "AdamW"
    params: Dict[str, Any] = Field(default_factory=dict)
    legacy_fusion: bool = False


class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = Field(default_factory=dict)


# ---------------------------------------------------------------------------
# Top-level config
# ---------------------------------------------------------------------------

class DeepSpeedConfig(DeepSpeedConfigModel):
    """Parsed + validated ds_config with batch-size triangulation.

    reference: runtime/config.py:688+ (DeepSpeedConfig), including the
    train_batch = micro_batch * gradient_accumulation_steps * dp_world_size rule.
    """

    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None

    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None

    fp16: FP16Config = Field(default_factory=FP16Config)
    bf16: BF16Config = Field(default_factory=BF16Config)
    amp: AMPConfig = Field(default_factory=AMPConfig)

    zero_optimization: DeepSpeedZeroConfig = Field(default_factory=DeepSpeedZeroConfig)
    gradient_clipping: float = 0.0
    communication_data_type: Optional[str] = None
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    sparse_gradients: bool = False
    disable_allgather: bool = False

    steps_per_print: int = 10
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    dump_state: bool = False

    activation_checkpointing: ActivationCheckpointingConfig = Field(
        default_factory=ActivationCheckpointingConfig)
    sparse_attention: Optional[SparseAttentionConfig] = None
    flops_profiler: FlopsProfilerConfig = Field(default_factory=FlopsProfilerConfig)
    tensorboard: TensorBoardConfig = Field(default_factory=TensorBoardConfig)
    wandb: WandbConfig = Field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = Field(default_factory=CSVConfig)
    comms_logger: CommsLoggerConfig = Field(default_factory=CommsLoggerConfig)
    aio: AIOConfig = Field(default_factory=AIOConfig)
    elasticity: ElasticityConfig = Field(default_factory=ElasticityConfig)
    autotuning: AutotuningConfig = Field(default_factory=AutotuningConfig)
    compression_training: CompressionConfig = Field(default_factory=CompressionConfig)
    data_efficiency: DataEfficiencyConfig = Field(default_factory=DataEfficiencyConfig)
    curriculum_learning: CurriculumLearningLegacyConfig = Field(
        default_factory=CurriculumLearningLegacyConfig)
    progressive_layer_drop: ProgressiveLayerDropConfig = Field(
        default_factory=ProgressiveLayerDropConfig)
    eigenvalue: EigenvalueConfig = Field(default_factory=EigenvalueConfig)
    quantize_training: Dict[str, Any] = Field(default_factory=dict)
    checkpoint: CheckpointConfig = Field(default_factory=CheckpointConfig)
    data_types: DataTypesConfig = Field(default_factory=DataTypesConfig)
    nonfinite_guard: NonFiniteGuardConfig = Field(
        default_factory=NonFiniteGuardConfig)
    integrity: IntegrityConfig = Field(default_factory=IntegrityConfig)
    watchdog: WatchdogConfig = Field(default_factory=WatchdogConfig)
    straggler: StragglerConfig = Field(default_factory=StragglerConfig)
    dataloader_drop_last: bool = False
    nebula: NebulaConfig = Field(default_factory=NebulaConfig)
    pipeline: PipelineConfig = Field(default_factory=PipelineConfig)
    serving: ServingConfig = Field(default_factory=ServingConfig)
    comm_plan: CommPlanConfig = Field(default_factory=CommPlanConfig)
    tensor_parallel: TensorParallelConfig = Field(default_factory=TensorParallelConfig)
    sequence_parallel: SequenceParallelConfig = Field(default_factory=SequenceParallelConfig)
    moe: MoEConfig = Field(default_factory=MoEConfig)

    zero_allow_untested_optimizer: bool = False
    gradient_accumulation_dtype: Optional[str] = None
    seed: int = 42

    # -- accessors matching reference engine property names ------------------

    @property
    def zero_enabled(self) -> bool:
        return self.zero_optimization.stage > 0

    @property
    def fp16_enabled(self) -> bool:
        return self.fp16.enabled

    @property
    def bfloat16_enabled(self) -> bool:
        return self.bf16.enabled

    @property
    def precision_dtype(self) -> str:
        if self.fp16.enabled:
            return "float16"
        if self.bf16.enabled:
            return "bfloat16"
        return "float32"

    @model_validator(mode="before")
    @classmethod
    def _aliases(cls, data):
        if isinstance(data, dict):
            if C.BF16_ALIAS in data and C.BF16 not in data:
                data[C.BF16] = data.pop(C.BF16_ALIAS)
        return data

    @model_validator(mode="after")
    def _fold_nonfinite_guard(self):
        """Deprecation shim (round 7): ``nonfinite_guard.abort_after``
        feeds the sentinel's single code path. An explicit
        ``integrity.nonfinite_abort_after`` wins over the alias."""
        if self.nonfinite_guard.abort_after > 0 and \
                self.integrity.nonfinite_abort_after == 0:
            self.integrity.nonfinite_abort_after = \
                self.nonfinite_guard.abort_after
        return self

    def resolve_batch_sizes(self, dp_world_size: int) -> None:
        """Batch-size triangulation: any 2 of 3 determine the third.

        reference: runtime/config.py _batch_assertion / _set_batch_related_parameters.
        """
        tb, mb, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if tb is not None and mb is not None and gas is not None:
            pass
        elif tb is not None and mb is not None:
            gas = tb // (mb * dp_world_size)
            self.gradient_accumulation_steps = max(gas, 1)
        elif tb is not None and gas is not None:
            mb = tb // (gas * dp_world_size)
            self.train_micro_batch_size_per_gpu = max(mb, 1)
        elif mb is not None and gas is not None:
            self.train_batch_size = mb * gas * dp_world_size
        elif tb is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = max(tb // dp_world_size, 1)
        elif mb is not None:
            self.gradient_accumulation_steps = 1
            self.train_batch_size = mb * dp_world_size
        else:
            raise ValueError(
                "At least one of train_batch_size / train_micro_batch_size_per_gpu "
                "must be set in the config")
        tb, mb, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if tb != mb * gas * dp_world_size:
            raise ValueError(
                f"Batch size inconsistency: train_batch_size={tb} != "
                f"micro_batch({mb}) * gas({gas}) * dp_world_size({dp_world_size})")


def unconsumed_sections(cfg: "DeepSpeedConfig") -> List[str]:
    """Config sections the user activated but no engine code consumes yet.

    The reference errors on unimplemented features; we at least refuse to be
    silent (round-1 Weak #7: a user's ds_config 'worked' while doing nothing
    they asked). Update this list as subsystems land."""
    out = []
    if cfg.amp.enabled:
        out.append("amp (use bf16/fp16 sections instead)")
    if cfg.sparse_gradients:
        out.append("sparse_gradients")
    if cfg.nebula.enabled:
        out.append("nebula (use checkpoint.async_save)")
    if cfg.compression_training.layer_reduction.get("enabled"):
        out.append("compression_training.layer_reduction (apply explicitly "
                   "via compression.apply_layer_reduction)")
    if (cfg.data_efficiency.data_routing or {}).get(
            "random_ltd", {}).get("enabled"):
        out.append("data_efficiency.data_routing.random_ltd (set the model's "
                   "ltd_tokens/ltd_start/ltd_end config instead)")
    for key, sub in (cfg.data_efficiency.data_sampling or {}).items():
        # the engine consumes only the seqlen curriculum; any other enabled
        # sampling feature must not no-op silently
        if key != "curriculum_learning" and isinstance(sub, dict) \
                and sub.get("enabled"):
            out.append(f"data_efficiency.data_sampling.{key} "
                       "(use runtime.data_pipeline.DeepSpeedDataSampler)")
    return out


def warn_unconsumed(cfg: "DeepSpeedConfig") -> List[str]:
    secs = unconsumed_sections(cfg)
    if secs:
        from ..utils.logging import logger
        for s in secs:
            logger.warning(
                "ds_config section %r is parsed but NOT implemented by "
                "deepspeed_tpu — it will have no effect", s)
    return secs


def load_config(config: Union[str, dict, DeepSpeedConfig, None]) -> DeepSpeedConfig:
    """Accept a path to a JSON file, a dict, or an already-parsed config."""
    if config is None:
        return DeepSpeedConfig()
    if isinstance(config, DeepSpeedConfig):
        return config
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise TypeError(f"config must be a path, dict or DeepSpeedConfig, got {type(config)}")
    return DeepSpeedConfig(**config)
