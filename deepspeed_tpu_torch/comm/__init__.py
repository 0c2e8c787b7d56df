"""The ``deepspeed.comm`` facade over ``torch.distributed`` (see
``comm.comm``). The JAX package's planned (quantized) grad sync
(``comm/planned.py``) waits for ROADMAP.md item 5.1."""

from .comm import (
    ReduceOp,
    all_reduce,
    all_gather,
    reduce_scatter,
    all_to_all,
    broadcast,
    tp_copy_to,
    tp_reduce_from,
    tp_gather_from,
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
