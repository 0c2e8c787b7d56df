"""Production serving: continuous batching over a paged KV cache
(counterpart of ``deepspeed_tpu/serving``).

- :mod:`.kv_cache` — block pool, refcounted fork/free, prefix cache;
- :mod:`.model_runner` — paged transformer forward (the paged attention
  kernel for every decode step);
- :mod:`.scheduler` — tiered FIFO admission control under the block
  budget;
- :mod:`.engine` — the serving loop (SERVE heartbeat phase, the stall
  watchdog, the fleet hooks);
- :mod:`.fleet` — supervised multi-replica fleet (shared admission
  queue, heartbeat-driven replica death detection, exactly-once request
  requeue, blacklist/parole, deadlines, straggler drain, preemption by
  tier, the autoscaler);
- :mod:`.disagg` — disaggregated serving: PrefillEngine/DecodeEngine
  roles over a bounded paged-KV block handoff, zero-copy via the shared
  refcounted pool;
- :mod:`.procfleet` — process-per-replica placement: each replica engine
  in a supervised OS process (serving/replica_worker.py), request/token
  streams over the transfer fabric (runtime/fabric/), the same fleet
  surface — pick by ``serving.fleet.placement`` via :func:`make_fleet`.

Entry points: ``ServingEngine(cfg, params, serving_config)`` directly,
``DisaggEngine`` for the single-process disaggregated pair, or
``deepspeed_tpu_torch.init_inference(...).serve()`` (which returns a
started fleet when ``serving.fleet.replicas > 1``, both
``fleet.prefill_replicas``/``decode_replicas`` are set,
``fleet.autoscale.enabled`` or ``fleet.placement: "process"``).
"""

from .disagg import (BlockHandoff, DecodeEngine, DisaggEngine, HandoffItem,
                     PrefillEngine)
from .engine import ServingEngine, lane_topk_topp
from .fleet import FleetRequest, FleetSupervisor, ServingFleet
from .kv_cache import (BlockPool, BlockPoolExhausted, PrefixCache,
                       SharedPagedState, init_pool)
from .procfleet import ProcessFleet, make_fleet
from .scheduler import Request, Scheduler

__all__ = ["ServingEngine", "ServingFleet", "FleetSupervisor",
           "FleetRequest", "BlockPool", "BlockPoolExhausted", "PrefixCache",
           "SharedPagedState", "init_pool", "Request", "Scheduler",
           "DisaggEngine", "PrefillEngine", "DecodeEngine", "BlockHandoff",
           "HandoffItem", "lane_topk_topp", "ProcessFleet", "make_fleet"]
