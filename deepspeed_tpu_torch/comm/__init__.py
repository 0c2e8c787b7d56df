"""The ``deepspeed.comm`` facade over ``torch.distributed`` (see
``comm.comm``) and the plan-routed entry points of ``comm.planned``
(the int8 and overlapped grad sync, the ZeRO-3 param gather and the MoE
queue exchange that ``comm_plan`` steers)."""

from .comm import (
    ReduceOp,
    all_reduce,
    all_gather,
    all_gather_async,
    reduce_scatter,
    all_to_all,
    all_to_all_async,
    broadcast,
    tp_copy_to,
    tp_reduce_from,
    tp_gather_from,
    CommHandle,
    P2PHandle,
    ppermute,
    ppermute_async,
    send_recv_next,
    send_recv_prev,
    axis_rank,
    axis_size,
    barrier,
    init_distributed,
    is_initialized,
    get_rank,
    get_world_size,
    get_local_rank,
    get_device_count,
    log_summary,
    get_comms_logger,
    configure,
    op_counts,
    reset_op_counts,
)
from .logging import CommsLogger
from .planned import (
    moe_exchange_spec,
    planned_grad_sync,
    planned_param_gather,
    planned_queue_exchange,
)
