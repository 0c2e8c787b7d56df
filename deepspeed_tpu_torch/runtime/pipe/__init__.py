"""Pipeline parallelism: layer specs, schedules, the stage interpreter,
the engine (counterpart of ``deepspeed_tpu/runtime/pipe``)."""

from .module import (LayerSpec, TiedLayerSpec, PipelineModule,
                     partition_uniform, partition_balanced)
from .schedule import (PipeSchedule, TrainSchedule, InferenceSchedule,
                       DataParallelSchedule, bubble_fraction,
                       build_1f1b_tables, build_gpipe_tables, build_tables,
                       stage_instruction_stream)
from .spmd import pipeline_apply, stack_stage_params, unstack_stage_params
from .engine import PipelineEngine

__all__ = [
    "LayerSpec", "TiedLayerSpec", "PipelineModule", "partition_uniform",
    "partition_balanced", "PipeSchedule", "TrainSchedule", "InferenceSchedule",
    "DataParallelSchedule", "bubble_fraction", "build_1f1b_tables",
    "build_gpipe_tables", "build_tables", "stage_instruction_stream",
    "pipeline_apply", "stack_stage_params", "unstack_stage_params",
    "PipelineEngine",
]
