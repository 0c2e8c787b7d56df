"""ds_config.json key constants and defaults: the port's own copy of
``deepspeed_tpu/config/constants.py`` (the same key surface)."""

#########################################
# Batch size
#########################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

#########################################
# Optimizer / scheduler
#########################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE = "type"
OPTIMIZER_PARAMS = "params"
LEGACY_FUSION = "legacy_fusion"
SCHEDULER = "scheduler"
SCHEDULER_TYPE = "type"
SCHEDULER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"

# Optimizer type names accepted by the engine (reference engine.py:1042-1054)
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
    ZERO_ONE_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER, SGD_OPTIMIZER, ADAGRAD_OPTIMIZER,
]

#########################################
# Precision
#########################################
FP16 = "fp16"
BF16 = "bf16"
BF16_ALIAS = "bfloat16"
AMP = "amp"

#########################################
# Gradients / comm
#########################################
GRADIENT_CLIPPING = "gradient_clipping"
COMMUNICATION_DATA_TYPE = "communication_data_type"
PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
SPARSE_GRADIENTS = "sparse_gradients"
DISABLE_ALLGATHER = "disable_allgather"

#########################################
# Sections
#########################################
ZERO_OPTIMIZATION = "zero_optimization"
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
SPARSE_ATTENTION = "sparse_attention"
FLOPS_PROFILER = "flops_profiler"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_WANDB = "wandb"
MONITOR_CSV = "csv_monitor"
COMMS_LOGGER = "comms_logger"
AIO = "aio"
ELASTICITY = "elasticity"
AUTOTUNING = "autotuning"
COMPRESSION_TRAINING = "compression_training"
DATA_EFFICIENCY = "data_efficiency"
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
EIGENVALUE = "eigenvalue"
QUANTIZE_TRAINING = "quantize_training"
CHECKPOINT = "checkpoint"
DATA_TYPES = "data_types"
DATALOADER_DROP_LAST = "dataloader_drop_last"
NEBULA = "nebula"
PIPELINE = "pipeline"
TENSOR_PARALLEL = "tensor_parallel"
SEQUENCE_PARALLEL = "sequence_parallel"
MOE = "moe"

#########################################
# Logging / misc
#########################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
MEMORY_BREAKDOWN = "memory_breakdown"
DUMP_STATE = "dump_state"

#########################################
# Defaults
#########################################
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None
GRADIENT_CLIPPING_DEFAULT = 0.0
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0
