"""deepspeed_tpu_torch.compression: QAT, pruning, layer reduction
(counterpart of ``deepspeed_tpu/compression``; reference
``deepspeed/compression/``)."""

from .compress import (CompressionGroup, CompressionSpec, apply_compression,
                       apply_layer_reduction, export_int8, init_compression,
                       parse_compression_config)

__all__ = ["CompressionSpec", "CompressionGroup", "init_compression",
           "parse_compression_config", "apply_compression",
           "apply_layer_reduction", "export_int8"]
