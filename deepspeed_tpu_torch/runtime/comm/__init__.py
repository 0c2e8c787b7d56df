"""The runtime's specialized communication (counterpart of
``deepspeed_tpu/runtime/comm``): compressed (1-bit and int8)
collectives, the blockwise-int8 reduce-scatter / all-to-all family and the
chunked ``overlap`` schedules, each over the counted ``comm`` facade."""

from .compressed import compressed_allreduce, quantized_allreduce
from .overlap import (
    make_overlap_gather,
    overlap_grad_sync,
)
from .quantized import (
    grad_sync,
    make_queue_exchange,
    quantized_all_to_all,
    quantized_reduce_scatter,
)

__all__ = ["compressed_allreduce", "quantized_allreduce", "grad_sync",
           "make_queue_exchange", "make_overlap_gather",
           "overlap_grad_sync", "quantized_all_to_all",
           "quantized_reduce_scatter"]
