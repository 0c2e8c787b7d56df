#!/usr/bin/env python3
"""End-to-end check of deepspeed_tpu_torch on one CUDA GPU (Hopper).

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
GPU, ``nvcc`` and nothing from the network, and it imports neither JAX
nor ``deepspeed_tpu``. Phases, each reported on its own line:

1. **build** — compile the six sources of hand-written kernels in
   ``deepspeed_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in parallel).
2. **check** — each kernel against its plain PyTorch version at the
   serving, generation and training paths' shapes, with the tolerance
   printed on the line; every attention kernel also at head dims 264,
   320, 512 and 1024 (the wide forms) and ``quant_matmul`` at scale
   blocks 8, 40 and 100.
3. **serve** — ``init_inference`` from a JSON config file, llama-1.1b at
   full width (22 layers, seeded random bf16 weights), ``.serve()``, 16
   greedy requests of 64..1024 prompt tokens (6 start with one 2-block
   system prompt) and 64 new tokens each; then one decode step's logits through
   the kernels vs ``impl="reference"``.
4. **int8** — ``kv_cache_dtype`` and ``weight_dtype`` int8: 4 requests
   of 96..512 prompt tokens, 16 new each; every prefill and decode step
   runs ``quant_matmul`` 111 times (22 layers x 5 + the LM head), counted
   by path; its rates, one decode step's logits vs ``impl="reference"``
   and the decode step's busy share.
5. **generate** — ``init_inference(...).generate()`` on the same model
   and weights: 8 prompts of 1024 tokens, 64 greedy new tokens (the
   prefill through ``flash_attention_fwd``, every decode step through
   ``decode_attention``), prefill and decode logits through the kernels
   vs ``impl="reference"``; then a 4-layer leg with a left-padded ragged
   batch, the int8 KV cache, a ``dtype: "int8"`` engine and seeded
   top-k / top-p / repetition-penalty sampling.
6. **train** — ``initialize(model=..., config="ds_train.json")`` on
   llama-1.1b at full width and depth (seeded f32 weights, bf16 compute
   with an fp32 master, AdamW, WarmupLR, clipping, ZeRO stage 1), seq
   1024, micro 2 x gas 2: six ``train_batch`` steps on one batch, each
   launching ``flash_attention_fwd``, ``flash_attention_bwd_dq`` and
   ``flash_attention_bwd_dkv`` 22 x 2 times; the loss falls; one
   micro-batch's loss and grad norm vs ``attention_impl="reference"``;
   one ``forward``/``backward``/``step`` cycle; the trained weights into
   ``generate()``.
7. **long** — ``initialize(model=..., config="ds_long.json")`` on
   llama-1.1b at full width and depth, seq 4096, micro 1 x gas 2, with a
   ``sparse_attention`` section (DeepSpeed's "fixed" defaults,
   unidirectional, blocks of 64): four ``train_batch`` steps, each
   launching ``block_sparse_attention_fwd``, ``_bwd_dq`` and ``_bwd_dkv``
   22 x 2 times (bf16 at head dim 64: the persistent ``wgmma`` routes)
   and no flash kernel; the loss falls; one micro-batch on 2
   layers of the trained weights vs the dense-mask route. Then the window
   leg: 4 layers with a uniform 1024-token window, three steps through
   the same kernels, vs ``attention_impl="reference"`` on 2 layers.
   Before it, the head-dim-256 leg: llama-1.1b's preset cut to 2 layers
   with google/gemma-2b's attention (8 query heads, 1 KV head of 256):
   ``serve()``, ``generate()`` and two ``train_batch`` steps, each held to
   its kernels by the launch counters. Then the HF import (``hf``), each
   model a seeded f32 state dict under HF's names with its published
   config as a plain object: Phi-2 (microsoft/phi-2, 32 layers, 32 heads
   of 80, partial rotary, parallel residual) through
   ``replace_transformer_layer`` -> ``init_inference`` (bf16) ->
   ``generate()`` (4 x 1024 prompt tokens, 32 new) and ``serve()`` (8
   requests, 32 new each), and BERT-large (bert-large-uncased, post-LN,
   token types, the MLM head) through ``load_hf`` -> ``forward`` on 8 x
   512 ids with a ragged key mask and three ``train_batch`` steps with MLM
   labels; each held to its kernels by the launch counters and to the
   plain path by its logits.
8. **time** — prefill and decode tokens/s from the serve and generate
   legs, train and long step time, tokens/s and 6N model TFLOP/s, the
   device busy share of a serve decode step, of a generate prefill and
   decode step and of a train and a long step (torch.profiler), and each
   kernel's device time on its path's work beside its bound, its plain
   version's and a library call's (timed here only; the port never calls
   it), plus the block-sparse kernels over four layouts beside the flash
   kernels on the same shape; ``quant_matmul`` on one decode step (M 8)
   and one 512-token prefill (and at M 96, 224, 352), and at scale blocks
   8, 40 and 100 beside 256; the flash, paged and decode kernels at head
   dims 64, 80, 96, 128 and 256 beside SDPA, every attention kernel at 264
   and 512 beside 256, the decode kernel's context split swept over 1 to
   4 CTAs, and BERT-large's masked flash calls ([8, 16, 512, 64],
   non-causal, the ragged key mask) beside SDPA with the same mask
   (``bert-masked``).
9. **ckpt** — after the train leg, on its model and config: two steps, a
   sync ``save_checkpoint`` of the state at 2 of the 22 layers (the
   depth cut keeps the script inside its time limit and the chip
   machine's disk-write cap; tag bytes, save and
   sha256 seconds), a fresh engine from another seed that
   ``load_checkpoint(tag=None)`` restores bitwise (parameters, master,
   moments, counters, the schedule), and three more steps on both whose
   losses must agree within 1e-6 relative; ``save_16bit_model`` served
   back by an int8 ``serve()`` (``paged_attention``, ``quant_matmul``) and
   a bf16 ``generate()`` (``flash_attention_fwd``, ``decode_attention``)
   with the in-memory engines' tokens; at a 1-layer cut, three async saves
   with ``keep_last=2``, a truncated newest tag rolled back over,
   ``inspect_checkpoint`` and the ``zero_to_fp32`` CLI against the fp32
   master.
10. **remat** — one engine per block policy (off, "dots", "attn",
    "full") at full width and 6 of 22 layers: the memory a micro-batch's
    forward
    holds for its backward and the peaks of its forward + backward and of
    the step, the first step's loss and grad norm against remat off, the
    second step's ms and the flash launches (the forward twice a layer
    under "full").
11. **zero** — bench.py's north-star leg in a 1-rank NCCL world:
    gpt2-1.3b at full width and 6 of 24 layers, ZeRO stage 3, pure bf16
    state, bf16 grad accumulation, "dots" remat, the fused CE, seq 1024,
    micro 2 (cut: gas 4, three steps). Each step's flash launches (6 of
    each a micro-batch) and NCCL all-gathers and reduce-scatters are counted;
    the loss falls; the first step's loss and grad norm match an engine
    without a process group within 1e-6 relative; one sharded save loads
    bitwise into a fresh engine and the next step's loss matches; step
    ms, tokens/s, 6N TFLOP/s, peak memory, device ms by kind, and the
    flash kernels at D 128 beside SDPA and their bounds.
12. **sp** — sequence parallelism on one card. First the ring's chunk
    logic for four virtual ranks of one [1, 8, 4096, 64] bf16 sample
    (``parallel.ring_attention.emulate_ring``: the same chunk steps with
    their causal / full / skip choice, the lse merge and the backward's
    dK/dV accumulation, the rotation by indexing), causal and full,
    against the plain version. Then llama-1.1b at full width and 6 of 22
    layers with max_seq_len raised to 16384, one sample of 16384 tokens a
    step,
    bf16 + fp32 master, AdamW, ZeRO 1, remat "full", in a 1-rank NCCL
    world, three steps with ``attention_impl`` "ring" and three with
    "ulysses": each step's flash launches (12 / 6 / 6) and ring
    counters (one chunk step a layer and forward, no point-to-point op),
    the first step's loss and grad norm within 1e-3 / 1e-2 of the same
    engine with ``attention_impl="flash"``, the loss falling, the step's
    ms, tokens/s, 6N TFLOP/s, peak memory and device ms by kind; and the
    flash kernels at the leg's calls (16384 tokens causal, and an sp = 4
    ring's 4096-token chunks, causal and full) beside SDPA, the plain
    version and the bounds.
13. **dropout** — BERT-large (the hf leg's model) with dropout 0.1, three
    ``train_batch`` steps: every attention call through the plain path
    (24 a step, no kernel launch), the loss falling, bitwise-equal losses
    from a second engine with the same seed, and remat "full"'s first
    step bitwise remat off's.
14. **moe** — Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1's published
    config: hidden 4096, 32 heads of 128 over 8 KV heads, 8 SwiGLU experts
    of 14336, two a token) at full width from a seeded bf16 state dict
    under HF's names, built on the card one tensor at a time. Serving, 4
    of 32 layers: ``replace_transformer_layer`` -> ``init_inference``
    (bf16) -> ``generate()`` on 4 x 1024 prompt tokens + 32 new (4
    ``flash_attention_fwd`` launches a prefill, 4 ``decode_attention`` a
    step), ``serve()`` with 8 requests of 64..1024 tokens (4
    ``paged_attention`` a decode step) and an int8 ``serve()`` (9
    ``quant_matmul`` a forward; the experts stay bf16); prefill and
    decode logits against ``impl="reference"`` on the tokens whose routes
    agree in every layer, the flipped (token, layer) routes counted and
    bounded. Training, 2 layers: the ``moe`` section in a 1-rank NCCL
    world, ``make_moe_loss(0.02)``, pure bf16 state, AdamW, ZeRO 1, seq
    1024, micro 2 x gas 2, three steps (4 launches of each flash kernel
    and 16 all-to-alls a step), the loss falling, the first step bitwise
    the engine without a process group's, one micro-batch against
    ``attention_impl="reference"`` under the same route rule; rates, 6 x
    N_active TFLOP/s beside the expert products' FLOPs, peak memory and
    device ms by kind (the expert ``bmm`` s their own kind).
15. **tp** — Llama-2-70B (meta-llama/Llama-2-70b-hf's published config:
    hidden 8192, 64 heads of 128 over 8 KV heads, SwiGLU 28672, vocab
    32000, untied) at full width from a seeded bf16 state dict under HF's
    names, 4 of 80 layers mapped by
    ``replace_transformer_layer`` (and built again layer by layer, as
    ``--tp-ranks`` builds it, held equal): ``generate()`` [4, 1024] + 32,
    ``serve()`` and an int8 ``serve()`` without a process group, then the
    same under ``sharding_rules=cfg.tp_rules()`` in a 1-rank NCCL world
    (the TP layers at a model axis of one): tokens bitwise equal, the
    kernel launches and the model-axis collectives (2 all-reduces a layer
    forward, the embedding's and the logits gather) counted; 2 layers
    trained there (pure bf16, ZeRO 3, seq 1024, micro 2 x gas 2), the
    first step bitwise the engine's without a group, the loss falling;
    then rows 1-6 timed at a tp-4 rank's shapes (16 query heads of 128
    over 2 KV heads, the int8 matrices' K / 4 and N / 4).
16. **pp** — pipelines: gpt2-1.3b at full width and 12 of 24 layers
    (seeded weights) as 4 stages of 3 layers in one process (``MPMDPipeline``
    over a ``LocalChannel``, every stage on the card), 8 micro-batches of
    1 x 1024: the f32 1F1B step against autograd through the plain model
    (loss rel 1e-5, each leaf's grad 1e-4 of its norm); in bf16 under
    deterministic algorithms gpipe and 1F1B, recompute and store, bitwise
    equal, each step's flash launches counted (12 x 8 of each backward
    kernel; the forward 12 x 8 with store, 21 x 8 with recompute, whose
    last stage skips its forward tick); the plain engine at gas 8 and the
    ``PipelineEngine`` (recompute, store) timed on the same weights; the
    ``PipelineEngine`` at pp 1 in a 1-rank NCCL world against the plain
    engine's first step (loss 1e-6, grad norm 1e-5) and its save at a
    1-layer cut loaded back bitwise.
17. **fleet** (run after generate) — the serving fleet on llama-1.1b at
    full width and depth (the serve leg's weights and 16 prompts, 32 new
    tokens each, prefix cache off), against one ``ServingEngine`` on the
    same prompts: a 2-replica thread fleet token-exact, then with
    ``serve.replica_kill`` (raise) on replica 1 mid-stream (requeues, each
    token emitted once, tokens equal to the unkilled run's, a requeued
    request's continuation held to the engine serving its replay); the
    1 + 1 disaggregated pair over one shared pool (token-exact, handoffs
    counted, the pool back to empty), also with its decode replica killed;
    a 2-process fleet on the card whose replica 1 dies by
    ``serve.replica_kill`` in kill mode mid-stream, restarted by the hub,
    then the pair, the restarted child in it, serving the batch again
    token-exact; a 2-replica int8
    thread fleet launching ``quant_matmul``. Each replica's own launch
    tally (threads) or reported counts (child processes) show
    ``paged_attention`` ran on every decoding replica; the lines carry the
    fleet's and the engine's tokens/s, time to first token p50, kill to
    serving again and each process's peak memory.
18. **run** (after pp) — run-side resilience on llama-1.1b at full width
    (:func:`phase_run`), every sub-leg in child processes started by the
    port's runner (``python -m deepspeed_tpu_torch.launcher.runner``) or
    its MPMD driver: a clean 6-step launch at full depth with the
    heartbeat channel, watchdog and straggler sections (rc 0, ``health``
    reads it); the same preempted by ``run.preempt:sigterm`` after step 3
    (rc 114, an intact emergency tag) and relaunched (resumed with the
    loader fast-forwarded, steps 4-6 the clean run's); ``run.hang`` at 4
    layers (rc 117 within the stall timeout and the grace); the
    sentinel's ladder at 4 layers (a ``sentinel.spike`` skip, then the
    rollback to the audited-clean tag); 2 MPMD stage workers of 11 layers
    each for 4 1F1B steps, then again with stage 1 killed at its step 2
    (restarted alone, the survivor parked and resynced, the twin's
    losses). Each child reports its flash launches, step ms and peak
    memory; the lines carry launch to first step, kill to resumed, the
    MPMD restart and the socket channel's bytes and wait a step.

Each phase's seconds are printed on a ``time: phases_s`` line.

``--old-quant-matmul SRC`` also builds a parent commit's
``csrc/quant_matmul.cu`` from SRC and times it against this one in the
same process (parent, new, new, parent): one forward at each M and the
int8 leg. ``--old-flash-bwd SRC`` does the same for a parent commit's
``csrc/flash_attention_bwd.cu`` (with the headers it includes beside it):
the train leg's dq and dk/dv calls beside SDPA's backward and the bounds,
and the train step's wall and busy ms under each. ``--old-flash-fwd SRC``
(a parent's ``csrc/flash_attention_fwd.cu``, its headers beside it):
the generate prefill's and the train leg's calls, the generate prefill
and decode step and the train step under each. ``--old-paged SRC`` (a
parent's ``csrc/paged_attention.cu``): the serve step's call in a bf16
and an int8 pool, D 96 x 16 heads, and the serve decode step under each.
``--old-decode SRC`` (a parent's ``csrc/decode_attention.cu``, its headers
beside it): the generate step's call in bf16 and fp16, D 96 x 16, D 80 x
32 and D 256 x 16 heads, and T = 64. ``--old-block-sparse SRC`` (a
parent's ``csrc/block_sparse_attention.cu``, its headers beside it): each
of the three kernels over the four timed layouts with the parent's outputs
against these, and the long step. ``--sweep-item-cost``: the block-sparse
forward's and dq's per-item cost of the host balance, swept at the long
leg's call.

``--only PHASE ...`` (``ckpt``, ``remat``, ``hf``, ``bert-masked``,
``zero``, ``sp``, ``dropout``, ``moe``, ``tp``, ``pp``, ``fleet``, ``run``)
builds the kernels and runs only those phases, then a result line that
names them (``"only": [...]``; no kernels line). ``--zero-ranks N`` (a
host with N GPUs) builds the kernels and runs only the zero leg across N
ranks, one process a GPU through ``deepspeed_tpu_torch.launcher.launch``
(NCCL on each ``cuda:{LOCAL_RANK}``), held to one engine without a
process group on the same global batch, and ends in a result line that
names it (``"zero_ranks": N``). ``--sp-ranks N`` does the same for the
sp leg: ring and Ulysses at sp = N (16384 / N tokens a rank), each held
to one engine without a process group on the same sample (loss 1e-4,
grad norm 5e-3) and to its counters (N - 1 rotations a layer and
direction), ending in ``"sp_ranks": N``. ``--ep-ranks N`` runs the moe
train leg across N GPUs at ``ep_size`` N (8 / N experts a rank, one
1024-token sample a rank a micro-batch, gas 2, no gating noise and aux
weight 0, so at capacity E/k it computes the function of one engine
without a process group on the same global batch: loss 1e-4, grad norm
5e-3), its all-to-alls counted, ending in ``"ep_ranks": N``.
``--tp-ranks N`` runs the tp legs across N GPUs: the 8-layer model at tp
N against one GPU without a process group (f32 greedy tokens equal;
each bf16 path's logits deviation from its f32 engine's within 1.25x of
the other's), full-depth Llama-2-70B at tp N (80 x N / 4 layers, each
rank building its shards layer by layer) through ``generate()`` and an
int8 ``serve()`` with prefill, decode, NCCL and peak-memory readings,
and 2 layers trained at tp 2 x data N / 2, ZeRO 3, seq 4096 (loss 1e-4,
grad norm 5e-3 of one engine), ending in ``"tp_ranks": N``.
``--pp-ranks N`` runs gpt2-6.7b at full depth as N pipeline stages, one
GPU each (1F1B, recompute, 8 micro-batches of 1 x 1024, each rank
building its stage from per-layer seeds): the first loss within rel 1e-3
of the unpipelined model's bf16 forward on one GPU, the loss falling over
4 steps, the embedding and head copies bitwise equal on every rank; step
ms, tokens/s, model TFLOP/s a GPU, peak memory, NCCL and idle share
beside the bubble (N - 1) / (8 + N - 1), ending in ``"pp_ranks": N``.

Launch counters are zeroed just before each leg and read just after it.
Any failed check raises, so the script exits non-zero and prints no
result. The last lines are the ``kernels`` JSON, the card's
``nvidia-smi`` name and power limit, and the result JSON.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM dense peaks (NVIDIA data sheet): HBM bytes/s, bf16 tensor flop/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12

LLAMA_LAYERS = 22
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 1024, 64
KERNEL_MODULES = {"paged_attention": "paged_attention",
                  "quant_matmul": "quant_matmul",
                  "decode_attention": "decode_attention",
                  "flash_attention_fwd": "flash_attention",
                  "flash_attention_bwd_dq": "flash_attention",
                  "flash_attention_bwd_dkv": "flash_attention",
                  "block_sparse_attention_fwd": "block_sparse_attention",
                  "block_sparse_attention_bwd_dq": "block_sparse_attention",
                  "block_sparse_attention_bwd_dkv": "block_sparse_attention"}
# the train leg: llama-1.1b, micro 2 x gas 2 of 1024 tokens
TRAIN_MICRO, TRAIN_GAS, TRAIN_SEQ, TRAIN_STEPS = 2, 2, 1024, 6
TRAIN_CONFIG = {
    "train_batch_size": TRAIN_MICRO * TRAIN_GAS,
    "train_micro_batch_size_per_gpu": TRAIN_MICRO,
    "gradient_accumulation_steps": TRAIN_GAS,
    "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_max_lr": 1e-4, "warmup_num_steps": 5}},
    "gradient_clipping": 1.0,
    "zero_optimization": {"stage": 1},
    "steps_per_print": 1000,
}
# the long-context leg: llama-1.1b at seq 4096, micro 1 x gas 2, through
# DeepSpeed's documented "fixed" sparse_attention defaults, made
# unidirectional and with blocks of 64 tokens
LONG_SEQ, LONG_STEPS, LONG_CHECK_LAYERS = 4096, 4, 2
SPARSE_SECTION = {"mode": "fixed", "block": 64, "num_local_blocks": 4,
                  "num_global_blocks": 1, "attention": "unidirectional"}
LONG_CONFIG = dict(TRAIN_CONFIG, train_batch_size=2,
                   train_micro_batch_size_per_gpu=1,
                   gradient_accumulation_steps=2,
                   sparse_attention=SPARSE_SECTION)
# the window leg: a uniform causal window of 1024 on 4 layers (depth cut)
WINDOW, WINDOW_LAYERS, WINDOW_STEPS = 1024, 4, 3
BS_KERNELS = ("block_sparse_attention_fwd", "block_sparse_attention_bwd_dq",
              "block_sparse_attention_bwd_dkv")
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
# the persistent wgmma + TMA kernels of each source (the build lines)
WG_KERNELS = {"flash_attention_fwd": ("flash_fwd_wg",),
              "flash_attention_bwd": ("flash_bwd_dq_wg", "flash_bwd_dkv_wg"),
              "block_sparse_attention": ("bs_fwd_wg", "bs_dq_wg",
                                         "bs_dkv_wg")}
# the zero leg: bench.py's north-star leg (gpt2-1.3b, ZeRO-3, pure bf16
# state, bf16 grad accumulation, "dots" remat, the fused CE, seq 1024,
# micro 2), gas cut 128 -> 4, in a 1-rank NCCL world
# depth cut 24 -> 6 layers (the script's time limit and the 45 GiB cap on
# what one run may write to the card host's disk)
ZERO_MICRO, ZERO_GAS, ZERO_SEQ, ZERO_STEPS, ZERO_LAYERS = 2, 4, 1024, 3, 6
ZERO_CONFIG = {
    "train_batch_size": ZERO_MICRO * ZERO_GAS,
    "train_micro_batch_size_per_gpu": ZERO_MICRO,
    "gradient_accumulation_steps": ZERO_GAS,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "bf16": {"enabled": True, "master_weights": False},
    "data_types": {"grad_accum_dtype": "bf16"},
    "zero_optimization": {"stage": 3},
    "steps_per_print": 10_000,
}
# the sp leg: llama-1.1b at full width and depth with max_seq_len raised
# to SP_SEQ, one sample of SP_SEQ tokens a step, bf16 + fp32 master,
# AdamW, ZeRO 1, remat "full" (attention_impl "ring" and "ulysses"); the
# chunk-logic check emulates SP_EMU ranks on one device
SP_SEQ, SP_STEPS, SP_EMU = 16384, 3, 4
SP_LAYERS = 6               # depth cut 22 -> 6 (the script's time limit)
SP_CONFIG = {
    "train_batch_size": 1, "train_micro_batch_size_per_gpu": 1,
    "gradient_accumulation_steps": 1, "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
    "steps_per_print": 10_000,
}
# BERT's published hidden and attention dropout (bert-large-uncased)
BERT_DROPOUT = 0.1
SERVING = {"block_size": 32, "pool_blocks": 256, "max_batch": 8,
           "max_blocks_per_seq": 64}


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


_PHASE_S = {}
_PHASE_T = [None]


def _mark(name):
    """Charge the seconds since the previous mark to phase ``name``."""
    now = time.perf_counter()
    if _PHASE_T[0] is not None:
        _PHASE_S[name] = round(_PHASE_S.get(name, 0.0) + now - _PHASE_T[0],
                               1)
    _PHASE_T[0] = now


def wall_ms(fn, reps=10, warmup=2):
    """Time per call between CUDA events: includes any gap the host leaves
    between launches (launch-bound calls read slower here)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class _Avg:
    """One (name, device) row of :func:`_key_averages`."""
    __slots__ = ("key", "device_type", "count", "self_cpu_time_total",
                 "self_device_time_total")

    def __init__(self, key, device_type):
        self.key, self.device_type, self.count = key, device_type, 0
        self.self_cpu_time_total = self.self_device_time_total = 0.0


def _key_averages(prof):
    """The sums of ``prof.key_averages()`` that this script reads (count,
    self host and self device time per name and device type), in one pass
    over the trace's events: ``key_averages`` reads every field of every
    event and takes seconds for a train step's trace."""
    rows = {}
    for e in prof.events():
        row = rows.get((e.key, e.device_type))
        if row is None:
            row = rows[(e.key, e.device_type)] = _Avg(e.key, e.device_type)
        row.count += 1
        row.self_cpu_time_total += e.self_cpu_time_total
        row.self_device_time_total += e.self_device_time_total
    return list(rows.values())


def device_ms(fn, reps=10, warmup=2):
    """Device time per call: the CUDA kernel time torch.profiler records
    over ``reps`` calls, summed, so host gaps between launches do not
    count. Where three traces in a row record no kernel (late in a long
    process the profiler can stop recording), the calls are timed between
    CUDA events behind a sleep kernel instead (:func:`queued_ms`), and the
    line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a trace that caught no kernel is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in _key_averages(prof)
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    log("time: torch.profiler recorded no device time in three traces; "
        "this call is timed between CUDA events (queued_ms)")
    return queued_ms(lambda: [fn() for _ in range(reps)]) / reps


def queued_ms(fn, reps=3, sleep_s=0.05):
    """Device ms of one call of fn between CUDA events, the median of
    ``reps``, each call queued behind a sleep kernel so that the host's
    time between launches does not count (the card runs them back to
    back). A reading whose call the host had not wholly queued before the
    sleep ended is taken again behind a longer sleep. Used where short
    profiler traces late in this process did not record every launch."""
    import numpy as np
    import torch
    fn()
    ms = []
    while len(ms) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(sleep_s * 2e9))     # >= sleep_s at <= 2 GHz
        start.record()
        fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            ms.append(start.elapsed_time(end))
        elif sleep_s < 1:
            sleep_s *= 4
        else:
            fail("queued_ms: the host did not stay ahead of the card")
    return float(np.median(ms))


def timings(kernel, plain, library):
    """Device ms of the kernel, plain and library calls, and the kernel's
    host-inclusive ms."""
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain, reps=3),
            "library_ms": device_ms(library),
            "wall_ms": wall_ms(kernel)}


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------- 1. build

def ptxas_report(text):
    """[(kernel, registers, spill store bytes, spill load bytes)] from
    nvcc's ``-Xptxas=-v`` output, one entry per compiled kernel
    (instantiation), names demangled where the toolkit's cu++filt or
    c++filt is found."""
    import re
    import shutil
    rows, name, spill = [], None, (0, 0)
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append([name, int(m.group(1)), *spill])
            name = None
    from deepspeed_tpu_torch.ops import build
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    cand = os.path.join(os.path.dirname(build._nvcc()), "cu++filt")
    filt = cand if os.path.exists(cand) else filt
    if rows and filt:
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, nm in zip(rows, names):
                nm = re.sub(r"\((int|bool|unsigned int)\)", "", nm)
                r[0] = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::",
                              "", nm).split("(")[0]
    return [tuple(r) for r in rows]


def phase_build():
    from deepspeed_tpu_torch.ops import build
    secs = build.build()
    for name in build.KERNELS:
        text = build.build_log(name)
        rows = ptxas_report(text)
        spills = [r for r in rows if r[2] or r[3]]
        # ptxas's advisories, e.g. wgmma serialized (C7520)
        advice = sorted({ln.split("Potential Performance Loss:")[1].split(
            " in the function")[0].strip() for ln in text.splitlines()
            if "Potential Performance Loss" in ln})
        log(f"build: {name} kernels={len(rows)} max_registers="
            f"{max((r[1] for r in rows), default=0)} spilling={len(spills)}"
            f" ptxas_advisories={json.dumps(advice)}")
        for kname, regs, st, ld in rows:
            log(f"build: {name} {kname} registers={regs} spill_stores={st} "
                f"spill_loads={ld}")
        # each wgmma kernel's instantiations and the advisories ptxas
        # gives for it (the advisory names the mangled function)
        for ident in WG_KERNELS.get(name, ()):
            mine = [r for r in rows if r[0].startswith(ident + "<")]
            lines = [ln for ln in text.splitlines()
                     if "Potential Performance Loss" in ln and ident in ln]
            notes = sorted({ln.split("Potential Performance Loss:")[1].split(
                " in the function")[0].strip() for ln in lines})
            log(f"build: {name} wgmma kernel {ident} instantiations="
                f"{len(mine)} registers={[r[1] for r in mine]} spill_bytes="
                f"{sum(r[2] + r[3] for r in mine)} "
                f"C7520={sum('C7520' in ln for ln in lines)} "
                f"ptxas_advisories={json.dumps(notes)}")
    log(f"build: seconds={secs:.2f} kernels={list(build.KERNELS)}")


# --------------------------------------------------------------- 2. check

def _max_err(out, ref):
    return (out.float() - ref.float()).abs().max().item()


# f32 attention kernels agree with their plain versions to rounding.
F32_TOL = 1e-4
# A bf16 attention kernel is held against its plain version run on the
# same values cast to f32: both then take f32 scores of the same numbers,
# and what is left is the kernel's rounding of p to bf16 before P V (at
# most 2^-8 of each p, averaging out over the keys) and of its output to
# bf16 (at most 2^-8 of |o|). Simulated at these shapes (N(0, 1) inputs,
# up to 2M outputs), the worst element lies at 0.8 x 2^-7 of its row's
# largest |o|; the limit is 2^-6 of it, about 2e-3 where the median |o| is
# 0.035-0.05.
BF16_ROW_TOL = 2.0 ** -6


def _hold(label, out, ref, f32, floor=0.0, scale=0.0):
    """Hold a kernel's output against its plain version's, log the line
    and fail beyond the limit: f32 to F32_TOL absolute; bf16 (ref on the
    inputs cast to f32) to BF16_ROW_TOL of each row's largest |ref|, rows
    along the last dim. ``floor`` > 0 (gradients): a row whose values are
    zero in exact arithmetic (the first causal query row's dq: one key,
    softmax gradient 0) is rounding noise on both sides, so each row's
    limit is taken against max(its largest |ref|, floor x the tensor's
    largest). ``scale``: a larger yardstick for that floor when the whole
    tensor is zero in exact arithmetic (a window of one key: dq and dk),
    the largest |ref| of the case's gradients. Returns the largest
    absolute error."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    worst = err.max().item()
    if f32:
        log(f"check: {label} max_abs_err={worst:.3e} tol={F32_TOL}")
        if not worst <= F32_TOL:
            fail(f"{label}: err {worst} > {F32_TOL}")
        return worst
    row = ref.abs().amax(-1, keepdim=True)
    lo = max(floor * max(row.max().item(), scale), 1e-30)
    ratio = (err / row.clamp_min(lo)).max().item()
    log(f"check: {label} max_abs_err={worst:.3e} "
        f"max_err/row_max={ratio:.3e} tol={BF16_ROW_TOL:.3e}*row_max "
        + (f"rows_at_floor={int((row < lo).sum())} " if floor else "")
        + f"median_abs_ref={ref.abs().median().item():.3e}")
    if not ratio <= BF16_ROW_TOL:
        fail(f"{label}: err {ratio:.3e} x its row's max > {BF16_ROW_TOL}")
    return worst


def phase_check():
    import torch
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.quant_format import kv_quantize
    errs = {"paged_attention": 0.0}
    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    # the serving shapes: 8 lanes, 32 heads x 64, blocks of 32, a 64-block
    # table, a stacked 2-layer pool; ragged ctx with a 0-length lane
    B, nh, hd, bs, nbk, nblk, L = 8, 32, 64, 32, 64, 520, 2
    lens = torch.tensor([0, 1, 31, 32, 33, 500, 1024, 2048],
                        dtype=torch.int32, device=dev)
    bt = (torch.randperm(nblk - 1, device=dev, generator=g)[:B * nbk] + 1
          ).reshape(B, nbk).to(torch.int32)
    k32 = torch.randn(L, nh, nblk, bs, hd, device=dev, generator=g)
    v32 = torch.randn(L, nh, nblk, bs, hd, device=dev, generator=g)
    q32 = torch.randn(B, nh, 1, hd, device=dev, generator=g)
    slopes = torch.linspace(0.5, 0.002, nh).tolist()
    kq, ks = kv_quantize(k32)
    vq, vs = kv_quantize(v32)
    bf = torch.bfloat16

    def dequant(x, s, dt=bf):   # the kernel's int8 row: x * scale in q's dtype
        return (x.float() * s.reshape(x.shape[:-1])[..., None]).to(dt)

    # (name, kernel inputs, the plain version's bf16 inputs)
    cases = [
        ("bf16", (q32.to(bf), k32.to(bf), v32.to(bf), {}), None),
        ("f32", (q32, k32, v32, {}), None),
        ("int8", (q32.to(bf), kq, vq, {"k_scale": ks, "v_scale": vs}),
         (q32.to(bf), dequant(kq, ks), dequant(vq, vs), {})),
        ("bf16+alibi+softcap+window",
         (q32.to(bf), k32.to(bf), v32.to(bf),
          {"alibi_slopes": slopes, "softcap": 30.0, "window": 100}), None),
    ]
    # every other head dim the kernel takes, fp16, and int8 rows of 8-byte
    # slices (hd % 16 != 0): 8 heads of a 1-layer pool at the same lanes
    for hd, dt in ((80, bf), (96, bf), (64, torch.float16), (96, torch.float16),
                   (80, torch.float32), (8, bf), (72, bf)):
        kx, vx = (torch.randn(1, 8, nblk, bs, hd, device=dev, generator=g)
                  for _ in range(2))
        qx = torch.randn(B, 8, 1, hd, device=dev, generator=g).to(dt)
        cases.append((f"{str(dt)[6:]} hd={hd}",
                      (qx, kx.to(dt), vx.to(dt), {}), None))
        if hd in (72, 80) or dt == torch.float16:
            (kq1, ks1), (vq1, vs1) = kv_quantize(kx), kv_quantize(vx)
            cases.append((f"int8 {str(dt)[6:]} hd={hd}",
                          (qx, kq1, vq1, {"k_scale": ks1, "v_scale": vs1}),
                          (qx, dequant(kq1, ks1, dt),
                           dequant(vq1, vs1, dt), {})))
    # Gemma's head dim and 192, every dtype and an int8 pool: 4 heads of
    # a 1-layer pool at the same lanes (8 x 4 = 32 (b, h): the context
    # splits over 7 CTAs)
    for hd, dt in ((256, bf), (256, torch.float16), (256, torch.float32),
                   (192, bf), (192, torch.float16), (136, bf)):
        kx, vx = (torch.randn(1, 4, nblk, bs, hd, device=dev, generator=g)
                  for _ in range(2))
        qx = torch.randn(B, 4, 1, hd, device=dev, generator=g).to(dt)
        cases.append((f"{str(dt)[6:]} hd={hd}",
                      (qx, kx.to(dt), vx.to(dt), {}), None))
        if hd == 256 and dt != torch.float32:
            (kq1, ks1), (vq1, vs1) = kv_quantize(kx), kv_quantize(vx)
            cases.append((f"int8 {str(dt)[6:]} hd={hd}",
                          (qx, kq1, vq1, {"k_scale": ks1, "v_scale": vs1}),
                          (qx, dequant(kq1, ks1, dt),
                           dequant(vq1, vs1, dt), {})))
    live = lens > 0
    for name, (q, k, v, kw), plain in cases:
        li = min(1, k.shape[0] - 1)
        splits = tpa.split_plan(B, q.shape[1], bt.shape[1] * bs,
                                build.sm_count(q.device))
        name = f"{name} splits={splits}"
        out = tpa.paged_attention(q, k, v, bt, lens, layer_idx=li, **kw)
        f32 = q.dtype == torch.float32
        rq, rk, rv, rkw = plain or (q, k, v, kw)
        if not f32:
            rq, rk, rv = rq.float(), rk.float(), rv.float()
        ref = tpa.paged_attention_reference(rq, rk, rv, bt, lens,
                                            layer_idx=li, **rkw)
        torch.cuda.synchronize()
        zero = out[~live].abs().max().item()
        err = _hold(f"paged_attention {name} zero_lane_max={zero}",
                    out[live], ref[live], f32)
        errs["paged_attention"] = max(errs["paged_attention"], err)
        if zero != 0.0:
            fail(f"paged_attention {name}: ctx-0 lane {zero}")
    errs["paged_attention"] = max(errs["paged_attention"],
                                  check_paged_splits())
    errs["quant_matmul"] = check_quant_matmul()
    errs["decode_attention"] = check_decode_attention()
    errs["flash_attention_fwd"] = check_flash_attention()
    bwd = check_flash_attention_bwd()
    errs["flash_attention_bwd_dq"] = bwd["dq"]
    errs["flash_attention_bwd_dkv"] = bwd["dkv"]
    errs.update(check_block_sparse_attention())
    for kname, err in check_wide_heads().items():
        errs[kname] = max(errs[kname], err)
    return errs


def check_paged_splits():
    """The paged kernel's context split against its plain version: the
    serve step's call (8 lanes x 32 heads of 64, contexts to 1024;
    unsplit), with an int8 pool, D 96 x 16 heads (2 splits), 2 lanes x 8
    heads (8 splits, the most), D 256 x 8 heads in an int8 pool, short
    contexts, a large batch and contexts of one split's minimum (unsplit),
    ragged lengths with one lane at 1 and one at the table's end; every
    call twice, bit-identical. Returns the largest absolute error."""
    import torch
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.quant_format import kv_quantize
    g = torch.Generator(device="cuda").manual_seed(12)
    sms = build.sm_count(torch.device("cuda"))
    bf = torch.bfloat16
    worst = 0.0
    # (name, B, nh, hd, block size, table blocks, int8 pool)
    cases = [("serve step", 8, 32, 64, 32, 32, False),
             ("serve step int8", 8, 32, 64, 32, 32, True),
             ("D96 x 16 heads", 8, 16, 96, 32, 32, False),
             ("2 lanes x 8 heads", 2, 8, 64, 32, 64, False),
             ("2 lanes x 8 heads int8", 2, 8, 128, 32, 64, True),
             ("D256 x 8 heads int8", 8, 8, 256, 32, 64, True),
             ("short contexts", 8, 16, 64, 16, 16, False),
             ("large batch", 64, 32, 64, 32, 8, False),
             ("one split's contexts", 4, 8, 128, 16, 7, True)]
    for name, B, nh, hd, bs, nbk, quant in cases:
        nblk = B * nbk + 1
        kx, vx = (torch.randn(1, nh, nblk, bs, hd, device="cuda",
                              generator=g) for _ in range(2))
        q = torch.randn(B, nh, 1, hd, device="cuda", generator=g).to(bf)
        bt = (torch.randperm(nblk - 1, device="cuda", generator=g) + 1
              ).reshape(B, nbk).to(torch.int32)
        lens = torch.randint(1, nbk * bs + 1, (B,), device="cuda",
                             generator=g).to(torch.int32)
        lens[0], lens[-1] = 1, nbk * bs
        kw, (rk, rv) = {}, (kx.to(bf), vx.to(bf))
        k, v = rk, rv
        if quant:
            (k, ks), (v, vs) = kv_quantize(kx), kv_quantize(vx)
            kw = {"k_scale": ks, "v_scale": vs}
            rk = (k.float() * ks.reshape(k.shape[:-1])[..., None]).to(bf)
            rv = (v.float() * vs.reshape(v.shape[:-1])[..., None]).to(bf)
        splits = tpa.split_plan(B, nh, nbk * bs, sms)
        out = tpa.paged_attention(q, k, v, bt, lens, layer_idx=0, **kw)
        again = tpa.paged_attention(q, k, v, bt, lens, layer_idx=0, **kw)
        ref = tpa.paged_attention_reference(q.float(), rk.float(),
                                            rv.float(), bt, lens,
                                            layer_idx=0)
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        worst = max(worst, _hold(
            f"paged_attention split {name} B={B} nh={nh} hd={hd} "
            f"max_ctx={nbk * bs} splits={splits} bit_identical={same}",
            out, ref, False))
        if not same:
            fail(f"paged_attention split {name}: two calls differ")
    return worst


# quant_matmul: the decode step's and the prefill's matrices, the regime
# edges (the GEMV takes M <= 16, the GEMM M > 16), the LM head, a ragged K
# and N, and both x dtypes. (M, K, N, x dtype)
QM_H, QM_F, QM_V = 2048, 5632, 32000
QM_CASES = (
    [(8, QM_H, 2560, "bf16"), (8, QM_H, QM_H, "bf16"), (8, QM_H, QM_F, "bf16"),
     (8, QM_F, QM_H, "bf16"), (8, QM_H, QM_V, "bf16"), (512, QM_H, QM_V, "bf16"),
     (512, QM_H, QM_F, "bf16"), (512, QM_F, QM_H, "bf16")]
    + [(M, QM_H, 2560, "bf16") for M in (1, 3, 16, 17, 32, 96, 352, 512)]
    + [(M, 300, N, "bf16") for M in (8, 96) for N in (200, 1000)]
    + [(M, QM_H, 2560, "f32") for M in (1, 8, 17, 96)]
    + [(8, 300, 1000, "f32"), (96, 300, 200, "f32")])
# x and q rows off their 16-byte alignment (plain loads, not cp.async)
QM_UNALIGNED = ((8, QM_H, 2560), (96, QM_H, 2560))
# two calls bit-identical: a split decode shape and split prefill shapes
QM_REPEAT = ((8, QM_H, QM_H), (96, QM_H, QM_H), (512, QM_F, QM_H))
# scale blocks other than 256 (any multiple of 16): (block, M, K, N, x
# dtype); split decode and prefill shapes, a ragged K and N, f32
QM_BLOCKS = [(blk, M, K, N, dt) for blk in (64, 128)
             for M, K, N, dt in ((8, QM_H, QM_H, "bf16"),
                                 (8, QM_F, QM_H, "bf16"),
                                 (16, QM_H, 2560, "bf16"),
                                 (96, QM_H, 2560, "bf16"),
                                 (512, QM_F, QM_H, "bf16"),
                                 (17, 300, 1000, "bf16"),
                                 (8, QM_H, 2560, "f32"),
                                 (96, 300, 200, "f32"))] + [
    (48, 8, QM_H, QM_H, "bf16"), (48, 96, 300, 1000, "bf16"),
    (48, 8, 300, 1000, "f32"), (512, 8, QM_F, QM_H, "bf16"),
    (512, 512, QM_F, QM_H, "bf16"), (16, 96, QM_H, 2560, "bf16")] + [
    # blocks that are not a multiple of 16 rows: the GEMM's k steps cross
    # their ends; the GEMV's pieces end inside a 16-row step
    (blk, M, K, N, dt) for blk in (8, 40, 100)
    for M, K, N, dt in ((8, QM_H, QM_H, "bf16"), (16, QM_F, QM_H, "bf16"),
                        (512, QM_F, QM_H, "bf16"), (96, 300, 1000, "bf16"),
                        (8, QM_H, 2560, "f32"), (96, 300, 200, "f32"))]


def check_quant_matmul():
    """Each case against the plain version on the same inputs. bf16: both
    sum exact products in f32 and round once to bf16, so they lie within
    2^-7 of the largest output (about one bf16 ulp of it). f32: the same
    sums in another order, within 2^-14 of the largest output."""
    import torch
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    g = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0

    def inputs(M, K, N, dt, block=256):
        w = torch.randn(K, N, device="cuda", generator=g) * K ** -0.5
        x = torch.randn(M, K, device="cuda", generator=g)
        return (x.to(torch.bfloat16) if dt == "bf16" else x,
                *tqm.pack_kernel(w, block))

    def offset(t):              # the same values one element further on
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:]
        return o.view_as(t).copy_(t)

    cases = [(256,) + c + (False,) for c in QM_CASES] + [
        (256, M, K, N, "bf16", True) for M, K, N in QM_UNALIGNED] + [
        c + (False,) for c in QM_BLOCKS]
    for block, M, K, N, dt, unaligned in cases:
        x, qw, sw = inputs(M, K, N, dt, block)
        if unaligned:
            x, qw = offset(x), offset(qw)
        out = tqm.quant_matmul(x, qw, sw)
        ref = tqm.quant_matmul_reference(x, qw, sw)
        torch.cuda.synchronize()
        tol = (2 ** -7 if dt == "bf16" else 2 ** -14) * ref.float().abs().max().item()
        err = _max_err(out, ref)
        worst = max(worst, err)
        plan = tqm._plan(M, N, sw.shape[0], build.sm_count(x.device), x.dtype,
                         block)
        log(f"check: quant_matmul M={M} K={K} N={N} x={dt} block={block}"
            f"{' unaligned' if unaligned else ''} regime={plan.regime} "
            f"splits={plan.splits} max_abs_err={err:.3e} tol={tol:.3e}")
        if out.dtype != x.dtype or out.shape != (M, N) or not err <= tol:
            fail(f"quant_matmul {M}x{K}x{N} {dt}: err {err} > {tol}")
    for block, (M, K, N) in [(256, c) for c in QM_REPEAT] + [
            (64, (8, QM_H, QM_H)), (128, (96, QM_H, QM_H)),
            (40, (8, QM_H, QM_H)), (40, (96, QM_H, QM_H))]:
        x, qw, sw = inputs(M, K, N, "bf16", block)
        a, b = tqm.quant_matmul(x, qw, sw), tqm.quant_matmul(x, qw, sw)
        torch.cuda.synchronize()
        same = torch.equal(a, b)
        log(f"check: quant_matmul M={M} K={K} N={N} block={block} two calls "
            f"bit_identical={same}")
        if not same:
            fail(f"quant_matmul {M}x{K}x{N}: two calls differ")
    return worst


def check_decode_attention():
    """decode_attention vs its plain version: the generate decode shapes
    (B 8, 32 heads of 64) in a stacked 2-layer cache of max_len 1000 (not a
    multiple of 128), T in {1, 5, 64}, cur_len in {T, 300, max_len}, f32
    and bf16, plus head dims 8, 32, 40, 80, 96 and 128, fp16, an unstacked
    cache, ALiBi + softcap + window together, and the generate leg's own
    call: T 1 at cur_len 1056 in its stacked 22-layer bf16 cache of
    1280."""
    import torch
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops import decode_attention as tda
    g = torch.Generator(device="cuda").manual_seed(4)
    L, B, nh, max_len = 2, 8, 32, 1000
    slopes = torch.linspace(0.5, 0.002, nh).tolist()
    caches = {}

    def cache(hd, dtype):
        if (hd, dtype) not in caches:
            kv = [torch.randn(L, B, nh, max_len, hd, device="cuda",
                              generator=g).to(dtype) for _ in range(2)]
            caches[(hd, dtype)] = kv
        return caches[(hd, dtype)]

    def hold(q, k, v, cur, li, kw):
        out = tda.decode_attention(q, k, v, cur, layer_idx=li, **kw)
        f32 = q.dtype == torch.float32
        label = (f"decode_attention {str(q.dtype)[6:]} "
                 f"hd={q.shape[-1]} T={q.shape[2]} cur_len={cur} "
                 f"cache={list(k.shape)} layer_idx={li} {sorted(kw)}")
        if not f32:             # the plain version on the values in f32
            q = q.float()
            k, v = (x.float() if li is None else x[li].float()
                    for x in (k, v))
            li = None
        ref = tda.decode_attention_reference(q, k, v, cur, layer_idx=li,
                                             **kw)
        torch.cuda.synchronize()
        return _hold(label, out, ref, f32)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for T in (1, 5, 64):
            for cur in sorted({T, 300, max_len}):
                cases.append((dtype, 64, T, cur, 1, {}))
    bf = torch.bfloat16
    cases += [(bf, 32, 5, 300, 0, {}), (bf, 128, 1, 1000, 1, {}),
              (bf, 128, 64, 1000, 1, {}), (torch.float32, 32, 64, 700, 0, {}),
              (torch.float32, 128, 5, 777, None, {}),
              (bf, 64, 5, 300, 1, {"alibi_slopes": slopes, "softcap": 30.0,
                                   "window": 100}),
              (torch.float32, 64, 64, 1000, 0,
               {"alibi_slopes": slopes, "softcap": 30.0, "window": 100})]
    # every other head dim the kernels take (T 1 pads the thread slices, T
    # > 1 the shared rows) and fp16
    h16 = torch.float16
    cases += [(bf, 80, 1, 1000, 1, {}), (bf, 80, 64, 1000, 1, {}),
              (bf, 96, 1, 777, 0, {}), (bf, 96, 5, 300, None, {}),
              (bf, 8, 1, 300, 0, {}), (bf, 40, 64, 700, 1, {}),
              (torch.float32, 80, 5, 300, 1, {}),
              (torch.float32, 96, 1, 1000, 0, {}),
              (h16, 64, 1, 1000, 1, {}), (h16, 64, 64, 1000, 0, {}),
              (h16, 96, 1, 300, 1, {}), (h16, 80, 5, 777, 0,
                                          {"alibi_slopes": slopes,
                                           "softcap": 30.0, "window": 100})]
    # Gemma's head dim (T 1: 32 threads of 16 bytes a 16-bit row, of 32
    # bytes an f32 row; T 64: 256 threads, shared memory past 48 KB) and
    # 192 and 136 (padded slices and rows)
    f32 = torch.float32
    cases += [(bf, 256, 1, 1000, 1, {}), (bf, 256, 64, 1000, 1, {}),
              (h16, 256, 1, 777, 0, {}), (h16, 256, 64, 300, None, {}),
              (f32, 256, 1, 1000, 1, {}), (f32, 256, 5, 300, 0, {}),
              (f32, 256, 64, 700, 0, {"alibi_slopes": slopes,
                                       "softcap": 30.0, "window": 100}),
              (bf, 256, 5, 777, 1, {"alibi_slopes": slopes, "window": 100}),
              (bf, 192, 1, 1000, 1, {}), (h16, 192, 64, 777, 0, {}),
              (bf, 136, 5, 300, 1, {}), (f32, 192, 1, 300, 0, {}),
              (bf, 96, 64, 1000, 1, {}), (h16, 80, 64, 1000, 0, {}),
              (h16, 80, 1, 1000, 1, {}), (h16, 96, 64, 333, 1, {}),
              (bf, 256, 17, 1000, 0, {}), (f32, 96, 64, 1000, 1, {})]
    worst = 0.0
    for dtype, hd, T, cur, li, kw in cases:
        k, v = cache(hd, dtype)
        if li is None:                      # the unstacked [B, nh, len, hd]
            k, v = k[0], v[0]
        q = torch.randn(B, nh, T, hd, device="cuda", generator=g).to(dtype)
        worst = max(worst, hold(q, k, v, cur, li, kw))
    del caches
    # few (b, h): the context splits over a cluster (T = 1)
    for dtype, hd, cur, kw in ((bf, 64, 1000, {}), (bf, 96, 1000, {}),
                               (h16, 80, 777, {}), (bf, 256, 1000, {}),
                               (f32, 64, 1000, {}), (f32, 256, 300, {}),
                               (bf, 64, 1000, {"alibi_slopes": slopes[:4],
                                               "softcap": 30.0,
                                               "window": 300})):
        k, v = (torch.randn(2, 2, 4, 1000, hd, device="cuda",
                            generator=g).to(dtype) for _ in range(2))
        q = torch.randn(2, 4, 1, hd, device="cuda", generator=g).to(dtype)
        live = min(cur, kw.get("window", cur))
        log(f"check: decode_attention splits="
            f"{tda.split_plan(2, 4, 1, hd, live, build.sm_count(q.device))}")
        worst = max(worst, hold(q, k, v, cur, 1, kw))
    kv = [torch.randn(LLAMA_LAYERS, GEN_BATCH, nh, 1280, 64, device="cuda",
                      generator=g).to(bf) for _ in range(2)]
    q = torch.randn(GEN_BATCH, nh, 1, 64, device="cuda", generator=g).to(bf)
    worst = max(worst, hold(q, kv[0], kv[1], 1056, LLAMA_LAYERS - 1, {}))
    del kv
    return worst


def _width_cases():
    """The flash checks' cases at the head dims the kernels pad (80, 96,
    and 40 and 8 below 64) and in fp16: (name, dtype, B, H, S, Sk, D,
    kwargs), ragged edges, Sk > S, non-causal and the extras included."""
    import torch
    f32, bf, h16 = torch.float32, torch.bfloat16, torch.float16
    slopes = [0.5, 0.25, 0.125, 0.0625]
    return [
        ("train shape D80", bf, 2, 8, 1024, 1024, 80, {}),
        ("D96 S1000", bf, 2, 4, 1000, 1000, 96, {}),
        ("D96 non-causal Sk>S", bf, 2, 4, 300, 1000, 96, {"causal": False}),
        ("D40 S1000", bf, 2, 4, 1000, 1000, 40, {}),
        ("D8 Sk>S causal", bf, 2, 4, 100, 1000, 8, {}),
        ("f32 D80 S1000", f32, 2, 4, 1000, 1000, 80, {}),
        ("f32 D96 non-causal", f32, 2, 4, 1000, 1000, 96, {"causal": False}),
        ("fp16 train shape", h16, 2, 8, 1024, 1024, 64, {}),
        ("fp16 D96 S1000", h16, 2, 4, 1000, 1000, 96, {}),
        ("fp16 D80 alibi+window+softcap", h16, 2, 4, 1024, 1024, 80,
         {"alibi_slopes": slopes, "window": 256, "softcap": 30.0}),
        ("D96 alibi+window+softcap", bf, 2, 4, 1000, 1000, 96,
         {"alibi_slopes": slopes, "window": 100, "softcap": 30.0}),
        # the backward's wgmma kernels (D 64, 16-bit, no extras) at ragged
        # edges
        ("causal S1000", bf, 2, 4, 1000, 1000, 64, {}),
        ("fp16 non-causal Sk>S", h16, 2, 4, 300, 1000, 64, {"causal": False}),
        # Gemma's head dim and 192: the wgmma forward (no extras), the
        # mma.sync kernels with Q (dO, K, V) in shared memory, f32
        ("D256 S1000", bf, 2, 4, 1000, 1000, 256, {}),
        ("fp16 D256 non-causal Sk>S", h16, 2, 4, 300, 1000, 256,
         {"causal": False}),
        ("D256 alibi+window+softcap", bf, 2, 4, 1000, 1000, 256,
         {"alibi_slopes": slopes, "window": 100, "softcap": 30.0}),
        ("fp16 D256 alibi+window+softcap", h16, 1, 4, 1024, 1024, 256,
         {"alibi_slopes": slopes, "window": 256, "softcap": 30.0}),
        ("f32 D256 S1000", f32, 2, 4, 1000, 1000, 256, {}),
        ("f32 D256 non-causal", f32, 1, 4, 777, 777, 256, {"causal": False}),
        ("D192 S1000", bf, 2, 4, 1000, 1000, 192, {}),
        ("fp16 D192 alibi+window+softcap", h16, 2, 4, 1000, 1000, 192,
         {"alibi_slopes": slopes, "window": 100, "softcap": 30.0}),
        ("D200 causal", bf, 2, 4, 1000, 1000, 200, {}),
        ("fp16 D136 Sk>S", h16, 2, 4, 300, 1000, 136, {}),
    ]


def _wg_cases():
    """Every call form of the forward's wgmma kernel (16-bit, no extras, D
    in 64, 80, 96, 128, 192, 256): each width in bf16 and fp16, causal
    and not, S = Sk ragged or Sk > S (the causal offset), a batch of
    several heads."""
    import torch
    out = []
    for i, D in enumerate((64, 80, 96, 128, 192, 256)):
        for j, dt in enumerate((torch.bfloat16, torch.float16)):
            causal = (i + j) % 2 == 0
            S, Sk = ((777, 777), (300, 1000))[(i + 2 * j) % 2]
            out.append((f"wgmma D{D} {'causal' if causal else 'non-causal'}",
                        dt, 2, 3, S, Sk, D, {"causal": causal}))
    return out


# the BERT-large leg's live lengths: one full sample, one of 128, the rest
# ragged between them (every sample keeps a live key)
BERT_KEY_LENS = (512, 128, 200, 333, 384, 450, 479, 256)


def _key_mask(lens, Sk):
    """[B, 1, 1, Sk] key-padding mask, True on each sample's first
    lens[b] keys."""
    import torch
    lens = torch.as_tensor(lens, device="cuda")
    return (torch.arange(Sk, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]


def check_flash_attention():
    """flash_attention_fwd vs its plain version, o and lse on live rows
    (rows with at least one key to attend), exact zeros on the others:
    the generate prefill shape (8 x 32 heads, S = 1024, D = 64, causal,
    bf16), f32, D = 128, S = Sk = 1000, Sk > S, non-causal, a key-padding
    mask with one fully masked batch row, the BERT-large leg's ragged key
    mask (8 x 16 heads, S = 512, D = 64, non-causal, bf16 and fp16),
    per-head (q, k) tiles, ALiBi + window + softcap, and the padded head
    dims and fp16 (:func:`_width_cases`)."""
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    g = torch.Generator(device="cuda").manual_seed(5)
    f32, bf = torch.float32, torch.bfloat16

    def kv_mask(B, Sk):
        lens = torch.tensor([0] + [Sk - 37 * i for i in range(B - 1)],
                            device="cuda")          # batch row 0 all masked
        return (torch.arange(Sk, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]

    def head_mask(B, H, S, Sk):
        m = torch.rand(B, H, S, Sk, device="cuda", generator=g) > 0.3
        m[:, :, 5] = False                          # query row 5 all masked
        return m

    cases = [   # (name, dtype, B, H, S, Sk, D, kwargs)
        ("generate prefill", bf, 8, 32, 1024, 1024, 64, {}),
        ("gpt2-1.3b zero train", bf, 2, 16, 1024, 1024, 128, {}),
        ("f32 causal", f32, 2, 4, 1024, 1024, 64, {}),
        ("D128 S1000", bf, 2, 4, 1000, 1000, 128, {}),
        ("f32 D128 non-causal", f32, 2, 4, 1000, 1000, 128,
         {"causal": False}),
        ("non-causal S1000", bf, 2, 4, 1000, 1000, 64, {"causal": False}),
        ("D32 Sk>S", bf, 2, 4, 100, 1000, 32, {}),
        ("Sk>S causal", bf, 2, 4, 300, 1000, 64, {}),
        ("f32 Sk>S causal D128", f32, 2, 4, 300, 1000, 128, {}),
        ("key mask, dead batch row", bf, 3, 4, 1000, 1000, 64,
         {"causal": False, "mask": kv_mask(3, 1000)}),
        ("f32 key mask causal", f32, 3, 4, 1024, 1024, 64,
         {"mask": kv_mask(3, 1024)}),
        *((f"bert-large train {str(dt)[6:]}", dt, 8, 16, 512, 512, 64,
           {"causal": False, "mask": _key_mask(BERT_KEY_LENS, 512)})
          for dt in (bf, torch.float16)),
        ("per-head tiles", bf, 2, 4, 1024, 1024, 64,
         {"mask": head_mask(2, 4, 1024, 1024)}),
        ("f32 per-batch tiles", f32, 2, 4, 1000, 1000, 64,
         {"causal": False, "mask": head_mask(2, 1, 1000, 1000)}),
        ("alibi+window+softcap", bf, 2, 4, 1024, 1024, 64,
         {"alibi_slopes": [0.5, 0.25, 0.125, 0.0625], "window": 256,
          "softcap": 30.0}),
        ("f32 alibi+window+softcap", f32, 2, 4, 1000, 1000, 128,
         {"alibi_slopes": [0.5, 0.25, 0.125, 0.0625], "window": 100,
          "softcap": 30.0}),
    ] + _width_cases() + _wg_cases()
    worst = 0.0
    for name, dtype, B, H, S, Sk, D, kw in cases:
        q = torch.randn(B, H, S, D, device="cuda", generator=g).to(dtype)
        k = torch.randn(B, H, Sk, D, device="cuda", generator=g).to(dtype)
        v = torch.randn(B, H, Sk, D, device="cuda", generator=g).to(dtype)
        o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
        # bf16: the plain version on the same values in f32 (see _hold)
        ro, rlse = tfa.flash_attention_reference(q.float(), k.float(),
                                                 v.float(), **kw)
        torch.cuda.synchronize()
        live = rlse > -1e29
        # lse: f32 statistics of the same f32 scores on both sides
        err_l = _max_err(lse[live], rlse[live])
        zero = o[~live].abs().max().item() if (~live).any() else 0.0
        label = (f"flash_attention_fwd {name} {str(dtype)[6:]} B={B} H={H} "
                 f"S={S} Sk={Sk} D={D} lse_max_abs_err={err_l:.3e} "
                 f"lse_tol={F32_TOL} dead_rows={int((~live).sum())} "
                 f"dead_row_max={zero} o:")
        worst = max(worst, _hold(label, o[live], ro[live], dtype == f32))
        if not (err_l <= F32_TOL and zero == 0.0):
            fail(f"flash_attention_fwd {name}: lse err {err_l}, dead rows "
                 f"{zero}")
        del q, k, v, o, lse, ro, rlse
    return worst


def check_flash_attention_bwd():
    """flash_attention_bwd_dq and flash_attention_bwd_dkv vs the plain
    backward on the same q, k, v, dO and the kernel forward's o and lse
    (16-bit: the plain version on those values cast to f32), each gradient
    row (along D) to 2^-6 of its largest |grad|, f32 to F32_TOL, and
    exact zeros for query rows with no live key and for keys nobody sees:
    the training leg's shape (2 x 32 heads, S = 1024, D = 64, causal,
    bf16), f32, D = 32 and 128, S = Sk = 1000, Sk > S, non-causal, a key
    mask with one fully masked batch row, the BERT-large leg's ragged key
    mask (8 x 16 heads, S = 512, D = 64, non-causal, bf16 and fp16),
    per-head and per-batch (q, k)
    tiles, ALiBi + window + softcap, and the padded head dims and fp16
    (:func:`_width_cases`). Returns the largest absolute error of dq and
    of dk/dv."""
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    g = torch.Generator(device="cuda").manual_seed(10)
    f32, bf = torch.float32, torch.bfloat16

    def kv_mask(B, Sk):
        lens = torch.tensor([0] + [Sk - 37 * i for i in range(B - 1)],
                            device="cuda")          # batch row 0 all masked
        return (torch.arange(Sk, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]

    def tile_mask(B, H, S, Sk):
        m = torch.rand(B, H, S, Sk, device="cuda", generator=g) > 0.3
        m[:, :, 5] = False                          # query row 5 all masked
        return m

    slopes = [0.5, 0.25, 0.125, 0.0625]
    cases = [   # (name, dtype, B, H, S, Sk, D, kwargs)
        ("training", bf, 2, 32, 1024, 1024, 64, {}),
        ("gpt2-1.3b zero train", bf, 2, 16, 1024, 1024, 128, {}),
        ("f32 causal", f32, 2, 4, 1024, 1024, 64, {}),
        ("D128 S1000", bf, 2, 4, 1000, 1000, 128, {}),
        ("D32 S1000", bf, 2, 4, 1000, 1000, 32, {}),
        ("f32 D128 non-causal", f32, 2, 4, 1000, 1000, 128,
         {"causal": False}),
        ("f32 D32 S1000", f32, 2, 4, 1000, 1000, 32, {}),
        ("non-causal S1000", bf, 2, 4, 1000, 1000, 64, {"causal": False}),
        ("Sk>S causal", bf, 2, 4, 300, 1000, 64, {}),
        ("D32 Sk>S", bf, 2, 4, 100, 1000, 32, {}),
        ("f32 Sk>S causal D128", f32, 2, 4, 300, 1000, 128, {}),
        ("key mask, dead batch row", bf, 3, 4, 1000, 1000, 64,
         {"causal": False, "mask": kv_mask(3, 1000)}),
        ("f32 key mask causal", f32, 3, 4, 1024, 1024, 64,
         {"mask": kv_mask(3, 1024)}),
        *((f"bert-large train {str(dt)[6:]}", dt, 8, 16, 512, 512, 64,
           {"causal": False, "mask": _key_mask(BERT_KEY_LENS, 512)})
          for dt in (bf, torch.float16)),
        ("per-head tiles", bf, 2, 4, 1024, 1024, 64,
         {"mask": tile_mask(2, 4, 1024, 1024)}),
        ("f32 per-batch tiles", f32, 2, 4, 1000, 1000, 64,
         {"causal": False, "mask": tile_mask(2, 1, 1000, 1000)}),
        ("alibi+window+softcap", bf, 2, 4, 1024, 1024, 64,
         {"alibi_slopes": slopes, "window": 256, "softcap": 30.0}),
        ("f32 alibi+window+softcap", f32, 2, 4, 1000, 1000, 128,
         {"alibi_slopes": slopes, "window": 100, "softcap": 30.0}),
    ] + _width_cases()
    worst = {"dq": 0.0, "dkv": 0.0}
    for name, dtype, B, H, S, Sk, D, kw in cases:
        q = torch.randn(B, H, S, D, device="cuda", generator=g).to(dtype)
        k = torch.randn(B, H, Sk, D, device="cuda", generator=g).to(dtype)
        v = torch.randn(B, H, Sk, D, device="cuda", generator=g).to(dtype)
        do = torch.randn(B, H, S, D, device="cuda", generator=g).to(dtype)
        o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        rq, rk, rv = tfa.flash_attention_bwd_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(), **kw)
        torch.cuda.synchronize()
        dead_q = lse <= -1e29                       # rows with no live key
        dead_k = (rk == 0).all(-1) & (rv == 0).all(-1)   # keys nobody sees
        zeros = max(dq[dead_q].abs().max().item() if dead_q.any() else 0.0,
                    dk[dead_k].abs().max().item() if dead_k.any() else 0.0,
                    dv[dead_k].abs().max().item() if dead_k.any() else 0.0)
        label = (f"flash_attention_bwd {name} {str(dtype)[6:]} B={B} H={H} "
                 f"S={S} Sk={Sk} D={D} dead_q_rows={int(dead_q.sum())} "
                 f"dead_k_rows={int(dead_k.sum())} dead_max={zeros}")
        for gname, out, ref in (("dq", dq, rq), ("dk", dk, rk),
                                ("dv", dv, rv)):
            err = _hold(f"{label} {gname}:", out, ref, dtype == f32,
                        floor=2.0 ** -10)
            key = "dq" if gname == "dq" else "dkv"
            worst[key] = max(worst[key], err)
        if zeros != 0.0:
            fail(f"flash_attention_bwd {name}: dead rows carry {zeros}")
        del q, k, v, do, o, lse, delta, dq, dk, dv, rq, rk, rv
    return worst


def _bs_cases():
    """(name, dtype, B, H, S, D, layout, fine, kwargs) of the block-sparse
    check: every layout family, the window route, the three dtypes, head
    dims 32, 40, 64, 80, 96 and 128, causal and not, a ragged S, the long
    and window legs' own shapes, and two batch rows of the persistent
    wgmma kernels' items (the 16-bit D 64 calls)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    f32, bf, h16 = torch.float32, torch.bfloat16, torch.float16

    def lay(cls, H, S, **kw):
        return tsa.config_layout(cls(num_heads=H, **kw), S), kw["block"]

    def window(H, S, W):
        fine = 64 if S % 64 == 0 else 16
        blocks = -(-(W - 1) // fine) + 1 if W > 1 else 1
        return (tsa.config_layout(tsa.LocalSlidingWindowSparsityConfig(
            num_heads=H, block=fine, num_sliding_window_blocks=blocks), S),
            fine, {"causal": True, "window": W, "layout_exact": False})

    dead = np.ones((4, 1024 // 16, 1024 // 16), dtype=bool)
    dead[:, 5, :] = False                   # query block 5 sees no key
    dead[1, :, 9] = False                   # key block 9 of head 1: nobody
    uni = dict(attention="unidirectional")
    cases = [
        ("train shape fixed-64", bf, 1, 32, 4096, 64,
         *lay(tsa.FixedSparsityConfig, 32, 4096, block=64, **uni),
         {"causal": True}),
        ("fixed-16 causal", bf, 2, 4, 1024, 64,
         *lay(tsa.FixedSparsityConfig, 4, 1024, block=16, **uni),
         {"causal": True}),
        ("f32 fixed-16 causal", f32, 2, 4, 1024, 64,
         *lay(tsa.FixedSparsityConfig, 4, 1024, block=16, **uni),
         {"causal": True}),
        ("fixed-64 bidirectional", bf, 1, 4, 1024, 128,
         *lay(tsa.FixedSparsityConfig, 4, 1024, block=64), {}),
        ("f32 fixed-64 bidirectional D128", f32, 1, 4, 1024, 128,
         *lay(tsa.FixedSparsityConfig, 4, 1024, block=64), {}),
        ("bigbird per-head", bf, 2, 4, 1024, 32,
         *lay(tsa.BigBirdSparsityConfig, 4, 1024, block=16,
              different_layout_per_head=True, num_random_blocks=3), {}),
        ("f32 bigbird per-head causal", f32, 1, 4, 1024, 32,
         *lay(tsa.BigBirdSparsityConfig, 4, 1024, block=16,
              different_layout_per_head=True, num_random_blocks=3),
         {"causal": True}),
        ("bslongformer", bf, 1, 4, 1024, 64,
         *lay(tsa.BSLongformerSparsityConfig, 4, 1024, block=32), {}),
        ("variable causal", bf, 1, 4, 1024, 128,
         *lay(tsa.VariableSparsityConfig, 4, 1024, block=16,
              local_window_blocks=(2, 4, 8), global_block_indices=(0, 7),
              num_random_blocks=2, **uni), {"causal": True}),
        ("ragged S=1008 fixed-16", bf, 1, 4, 1008, 64,
         *lay(tsa.FixedSparsityConfig, 4, 1008, block=16, **uni),
         {"causal": True}),
        ("f32 ragged S=1008 bigbird", f32, 1, 4, 1008, 32,
         *lay(tsa.BigBirdSparsityConfig, 4, 1008, block=16), {}),
        ("window W=1", bf, 1, 4, 1024, 64, *window(4, 1024, 1)),
        ("window W=100", bf, 1, 4, 1024, 64, *window(4, 1024, 100)),
        ("f32 window W=100 ragged", f32, 1, 4, 1008, 64,
         *window(4, 1008, 100)),
        ("window leg shape W=1024", bf, 1, 32, 4096, 64,
         *window(32, 4096, 1024)),
        ("dead rows", bf, 1, 4, 1024, 64, dead, 16, {}),
        ("f32 dead rows", f32, 1, 4, 1024, 64, dead, 16, {}),
        # the padded head dims and fp16
        ("fixed-16 causal D80", bf, 1, 4, 1024, 80,
         *lay(tsa.FixedSparsityConfig, 4, 1024, block=16, **uni),
         {"causal": True}),
        ("bigbird D96 ragged S=1008", bf, 1, 4, 1008, 96,
         *lay(tsa.BigBirdSparsityConfig, 4, 1008, block=16), {}),
        ("f32 fixed-64 D96", f32, 1, 4, 1024, 96,
         *lay(tsa.FixedSparsityConfig, 4, 1024, block=64), {}),
        ("f32 window W=100 D40", f32, 1, 4, 1024, 40, *window(4, 1024, 100)),
        ("fp16 fixed-64 causal", h16, 1, 8, 2048, 64,
         *lay(tsa.FixedSparsityConfig, 8, 2048, block=64, **uni),
         {"causal": True}),
        # the wgmma kernels' items over two batch rows, 4x the CTAs
        ("fixed-64 causal B=2", bf, 2, 16, 2048, 64,
         *lay(tsa.FixedSparsityConfig, 16, 2048, block=64, **uni),
         {"causal": True}),
        ("fp16 window W=100 D80", h16, 1, 4, 1024, 80,
         *window(4, 1024, 100)),
        ("fp16 dead rows D96", h16, 1, 4, 1024, 96, dead, 16, {}),
        # Gemma's head dim and 192: own rows in shared memory, dk/dv over
        # two column halves
        ("fixed-16 causal D256", bf, 1, 4, 1024, 256,
         *lay(tsa.FixedSparsityConfig, 4, 1024, block=16, **uni),
         {"causal": True}),
        ("fp16 bigbird D256 ragged S=1008", h16, 1, 4, 1008, 256,
         *lay(tsa.BigBirdSparsityConfig, 4, 1008, block=16), {}),
        ("f32 fixed-64 D256", f32, 1, 4, 1024, 256,
         *lay(tsa.FixedSparsityConfig, 4, 1024, block=64), {}),
        ("window W=100 D192", bf, 1, 4, 1024, 192, *window(4, 1024, 100)),
        ("fp16 dead rows D192", h16, 1, 4, 1024, 192, dead, 16, {}),
        ("f32 window W=100 D192", f32, 1, 4, 1024, 192,
         *window(4, 1024, 100)),
    ]
    return cases


def check_block_sparse_attention():
    """block_sparse_attention_fwd, _bwd_dq and _bwd_dkv vs their plain
    versions on the same inputs (bf16: the plain version on those values
    cast to f32): o and each gradient row to 2^-6 of its largest |value|
    (gradients with the 2^-10 floor of the case's largest gradient), f32
    to F32_TOL, lse to 1e-4, and
    exact zeros for query rows with no live key and for keys nobody sees.
    Returns the largest absolute error of each kernel."""
    import torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
    g = torch.Generator(device="cuda").manual_seed(11)
    f32 = torch.float32
    worst = {"block_sparse_attention_fwd": 0.0,
             "block_sparse_attention_bwd_dq": 0.0,
             "block_sparse_attention_bwd_dkv": 0.0}
    for name, dtype, B, H, S, D, layout, fine, kw in _bs_cases():
        q, k, v, do = (torch.randn(B, H, S, D, device="cuda", generator=g)
                       .to(dtype) for _ in range(4))
        o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, fine, **kw)
        delta = (do.float() * o.float()).sum(-1)
        dq = tbs.block_sparse_attention_bwd_dq(q, k, v, do, lse, delta,
                                               layout, fine, **kw)
        dk, dv = tbs.block_sparse_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                    layout, fine, **kw)
        sched = tbs.schedule(layout, fine, S, device="cuda",
                             **{key: kw[key] for key in kw})
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        ro, rlse = tbs.block_sparse_attention_reference(qf, kf, vf, layout,
                                                        fine, **kw)
        rq, rk, rv = tbs.block_sparse_attention_bwd_reference(
            qf, kf, vf, dof, lse, delta, layout, fine, **kw)
        torch.cuda.synchronize()
        dead_q = rlse <= -1e29
        dead_k = (rk == 0).all(-1) & (rv == 0).all(-1)
        zeros = max([t[m].abs().max().item() for t, m in (
            (o, dead_q), (dq, dead_q), (dk, dead_k), (dv, dead_k))
            if m.any()] + [0.0])
        lse_err = (lse - rlse)[~dead_q].abs().max().item()
        label = (f"block_sparse_attention {name} {str(dtype)[6:]} B={B} "
                 f"H={H} S={S} D={D} fine={fine} tiles={sched.n_tiles}/"
                 f"{H * sched.visited.shape[1] ** 2} "
                 f"dead_q_rows={int(dead_q.sum())} "
                 f"dead_k_rows={int(dead_k.sum())} dead_max={zeros} "
                 f"lse_err={lse_err:.2e}")
        err = _hold(f"{label} o:", o, ro, dtype == f32)
        worst["block_sparse_attention_fwd"] = max(
            worst["block_sparse_attention_fwd"], err)
        scale = max(t.abs().max().item() for t in (rq, rk, rv))
        for gname, out, ref in (("dq", dq, rq), ("dk", dk, rk),
                                ("dv", dv, rv)):
            err = _hold(f"{label} {gname}:", out, ref, dtype == f32,
                        floor=2.0 ** -10, scale=scale)
            key = ("block_sparse_attention_bwd_dq" if gname == "dq"
                   else "block_sparse_attention_bwd_dkv")
            worst[key] = max(worst[key], err)
        if zeros != 0.0:
            fail(f"block_sparse_attention {name}: dead rows carry {zeros}")
        if not lse_err <= 1e-4:
            fail(f"block_sparse_attention {name}: lse err {lse_err}")
        del q, k, v, do, o, lse, delta, dq, dk, dv, ro, rlse, rq, rk, rv
        torch.cuda.empty_cache()
    return worst


WIDE_DIMS = (264, 320, 512, 1024)


def check_wide_heads():
    """Every attention kernel at head dims above 256 (WIDE_DIMS), in bf16,
    fp16 and f32, against its plain version with the tolerances above
    (16-bit: the plain version on the values cast to f32): flash forward
    and backward (S 200, causal; ALiBi + window + softcap at 264 in bf16),
    decode at T 1, 17 and 64 (cur_len 300 of 512, ALiBi + window at 320),
    paged (ragged contexts, an int8 pool with bf16 queries, a softcap and
    a window), and the three block-sparse kernels (DeepSpeed's fixed
    layout of 16 at S 256, causal). Returns the largest absolute error of
    each kernel."""
    import torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
    from deepspeed_tpu_torch.ops import decode_attention as tda
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    from deepspeed_tpu_torch.quant_format import kv_quantize
    g = torch.Generator(device="cuda").manual_seed(264)
    worst = {k: 0.0 for k in KERNEL_MODULES if k != "quant_matmul"}
    f32, bf, h16 = torch.float32, torch.bfloat16, torch.float16
    rnd = lambda *s, dt=f32: (torch.randn(*s, device="cuda", generator=g)
                              * 0.5).to(dt)

    def keep(name, err):
        worst[name] = max(worst[name], err)

    layout = tsa.config_layout(tsa.FixedSparsityConfig(
        num_heads=2, block=16, attention="unidirectional"), 256)
    for D in WIDE_DIMS:
        for dt in (bf, h16, f32):
            tag = f"{str(dt)[6:]} D={D}"
            is32 = dt == f32
            # flash forward and backward
            extras = D == 264 and dt == bf
            kw = ({"alibi_slopes": [0.5, 0.25], "window": 64,
                   "softcap": 20.0} if extras else {})
            q, k, v, do = (rnd(1, 2, 200, D, dt=dt) for _ in range(4))
            o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
            delta = (do.float() * o.float()).sum(-1)
            dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 **kw)
            ro, rlse = tfa.flash_attention_reference(
                q.float(), k.float(), v.float(), **kw)
            refs = tfa.flash_attention_bwd_reference(
                q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                **kw)
            torch.cuda.synchronize()
            lab = f"wide flash {tag}{' extras' if extras else ''}"
            keep("flash_attention_fwd", _hold(f"{lab} o:", o, ro, is32))
            lse_err = _max_err(lse, rlse)
            if not lse_err <= 1e-4:
                fail(f"{lab}: lse err {lse_err}")
            for gname, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                       refs):
                keep("flash_attention_bwd_dq" if gname == "dq" else
                     "flash_attention_bwd_dkv",
                     _hold(f"{lab} {gname}:", out, ref, is32,
                           floor=2.0 ** -10))
            # block-sparse forward, dq, dk/dv
            q, k, v, do = (rnd(1, 2, 256, D, dt=dt) for _ in range(4))
            o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, 16,
                                                    causal=True)
            delta = (do.float() * o.float()).sum(-1)
            dq = tbs.block_sparse_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   layout, 16, causal=True)
            dk, dv = tbs.block_sparse_attention_bwd_dkv(
                q, k, v, do, lse, delta, layout, 16, causal=True)
            qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
            ro, _ = tbs.block_sparse_attention_reference(qf, kf, vf, layout,
                                                         16, causal=True)
            refs = tbs.block_sparse_attention_bwd_reference(
                qf, kf, vf, dof, lse, delta, layout, 16, causal=True)
            torch.cuda.synchronize()
            lab = f"wide block_sparse {tag}"
            keep("block_sparse_attention_fwd", _hold(f"{lab} o:", o, ro, is32))
            scale = max(r.abs().max().item() for r in refs)
            for gname, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                       refs):
                keep("block_sparse_attention_bwd_dq" if gname == "dq" else
                     "block_sparse_attention_bwd_dkv",
                     _hold(f"{lab} {gname}:", out, ref, is32,
                           floor=2.0 ** -10, scale=scale))
            # decode at T 1, 17 and 64
            kc, vc = (rnd(2, 4, 512, D, dt=dt) for _ in range(2))
            for T in (1, 17, 64):
                dkw = ({"alibi_slopes": [0.5, 0.25, 0.125, 0.0625],
                        "window": 100} if D == 320 else {})
                q = rnd(2, 4, T, D, dt=dt)
                out = tda.decode_attention(q, kc, vc, 300, **dkw)
                ref = tda.decode_attention_reference(
                    q.float(), kc.float(), vc.float(), 300, **dkw)
                torch.cuda.synchronize()
                keep("decode_attention",
                     _hold(f"wide decode_attention {tag} T={T} {sorted(dkw)}",
                           out, ref, is32))
            # paged: ragged contexts in a pool of 16-row blocks
            B, nh, bs, nbk, nblk = 3, 4, 16, 8, 40
            kp, vp = (rnd(1, nh, nblk, bs, D) for _ in range(2))
            bt = (torch.randperm(nblk - 1, device="cuda", generator=g)
                  [:B * nbk] + 1).reshape(B, nbk).to(torch.int32)
            lens = torch.tensor([1, 77, nbk * bs], dtype=torch.int32,
                                device="cuda")
            q = rnd(B, nh, 1, D, dt=dt)
            pkw = {"softcap": 6.0, "window": 50}
            out = tpa.paged_attention(q, kp.to(dt), vp.to(dt), bt, lens,
                                      layer_idx=0, **pkw)
            ref = tpa.paged_attention_reference(
                q.float(), kp.to(dt).float(), vp.to(dt).float(), bt, lens,
                layer_idx=0, **pkw)
            torch.cuda.synchronize()
            keep("paged_attention", _hold(f"wide paged_attention {tag}", out,
                                          ref, is32))
            if dt == bf:
                (kq, ks), (vq, vs) = kv_quantize(kp), kv_quantize(vp)
                out = tpa.paged_attention(q, kq, vq, bt, lens, layer_idx=0,
                                          k_scale=ks, v_scale=vs, **pkw)
                deq = lambda x, s: (x.float() * s.reshape(x.shape[:-1])
                                    [..., None]).to(bf).float()
                ref = tpa.paged_attention_reference(
                    q.float(), deq(kq, ks), deq(vq, vs), bt, lens,
                    layer_idx=0, **pkw)
                torch.cuda.synchronize()
                keep("paged_attention",
                     _hold(f"wide paged_attention int8 {tag}", out, ref,
                           False))
            torch.cuda.empty_cache()
    return worst


# --------------------------------------------------------------- 3. serve

class _Timed:
    """Wraps an engine method: wall seconds and calls (each call ends in a
    host read of sampled tokens, so the device work is inside), and the
    launches of ``counter`` (a kernel wrapper) made inside the calls."""

    def __init__(self, fn, counter=None):
        self.fn, self.secs, self.calls = fn, 0.0, 0
        self.counter, self.launches = counter, 0

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        n0 = self.counter.launches if self.counter else 0
        try:
            return self.fn(*a, **kw)
        finally:
            self.secs += time.perf_counter() - t0
            self.calls += 1
            if self.counter:
                self.launches += self.counter.launches - n0


def _instrument(srv, counter=None):
    srv._run_prefill = _Timed(srv._run_prefill, counter)
    srv._decode_step = _Timed(srv._decode_step, counter)


def _rates(srv, stats0, steps):
    """Prefill and decode rates of the requests run since ``stats0``, from
    the instrumented engine methods."""
    d = {k: srv.stats[k] - stats0[k] for k in srv.stats}
    decode_tokens = d["tokens_generated"] - d["completed"]
    return d, {"prefill_tok_s": d["prefill_tokens"] / srv._run_prefill.secs,
               "decode_tok_s": decode_tokens / srv._decode_step.secs,
               "decode_step_ms": 1e3 * srv._decode_step.secs / steps,
               "mean_decode_lanes": decode_tokens / steps}


def _wrappers():
    """Each kernel's wrapper (the function that carries its counter)."""
    import importlib
    return {name: getattr(importlib.import_module(
        f"deepspeed_tpu_torch.ops.{mod}"), name)
        for name, mod in KERNEL_MODULES.items()}


def _zero_counters():
    for fn in _wrappers().values():
        fn.launches = 0


def _counters():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _run_requests(srv, prompts, new):
    from deepspeed_tpu_torch.serving.scheduler import FINISHED
    reqs = [srv.submit(p, new) for p in prompts]
    srv.run_until_idle()
    for r in reqs:
        if r.state != FINISHED or len(r.output_tokens) != new:
            fail(f"request {r.rid}: state {r.state}, "
                 f"{len(r.output_tokens)} tokens of {new}")
    return reqs


def _decode_inputs(srv, label):
    """The next decode step's inputs of a serving engine's lanes (last
    tokens [B, 1], block tables, context lengths) and the live lanes'
    mask."""
    import numpy as np
    import torch
    live = [s is not None for s in srv._slots]
    if not any(live):
        fail(f"{label}: no live lane for the logits check")
    B, dev = srv.max_batch, srv.device
    toks = np.zeros((B, 1), np.int64)
    ctx = np.zeros((B,), np.int64)
    tables = np.zeros((B, srv.nbk), np.int32)
    for i, s in enumerate(srv._slots):
        if s is not None:
            toks[i, 0], ctx[i], tables[i] = s.last_tok, s.ctx, s.table
    args = [torch.as_tensor(a, device=dev) for a in (toks, tables, ctx)]
    return args, torch.as_tensor(live, device=dev)


def _decode_logits_check(srv, tol_rel, label):
    """One decode step of the live lanes through the kernels and through
    impl="reference", each on its own copy of the pools."""
    import torch
    from deepspeed_tpu_torch.serving.model_runner import paged_forward
    args, rows = _decode_inputs(srv, label)
    out = {}
    with torch.no_grad():
        for impl in ("auto", "reference"):
            pools = {k: v.clone() for k, v in srv.pools.items()}
            logits, _ = paged_forward(srv.cfg, srv.params, args[0], pools,
                                      args[1], args[2], args[2] + 1,
                                      srv.block_size, impl=impl)
            out[impl] = logits[:, -1].float()
            del pools
    torch.cuda.synchronize()
    _hold_logits(f"{label} decode", out["auto"][rows],
                 out["reference"][rows], tol_rel)


def _hold_logits(label, a, b, tol_rel):
    """Hold logits ``a`` (through the kernels) against ``b`` (the plain
    path) to ``tol_rel`` of the largest |b|; log the line, fail beyond
    it. Returns (max_abs_err, max_abs_logit)."""
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"check: {label} logits kernels vs reference "
        f"max_abs_err={err:.4e} max_abs_logit={scale:.4e} "
        f"tol={tol_rel}*max_abs_logit argmax_agree={agree:.3f}")
    if not err <= tol_rel * scale:
        fail(f"{label} logits differ by {err} (> {tol_rel} x {scale})")
    return err, scale


def _numel(tree):
    return sum(_numel(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


def phase_serve(tmp):
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import get_config, init_params
    cfg = get_config("llama-1.1b")                 # full width, bf16
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"serve: llama-1.1b params={_numel(params)} "
        f"init_s={time.perf_counter() - t0:.2f}")
    path = os.path.join(tmp, "ds_inference.json")
    with open(path, "w") as f:
        json.dump({"dtype": "bf16", "serving": SERVING}, f)
    eng = deepspeed_tpu_torch.init_inference(cfg, path,
                                             model_parameters=params)
    srv = eng.serve()
    rng = np.random.default_rng(0)
    # warm-up request (kernel loads, cuBLAS handles); distinct tokens
    _run_requests(srv, [list(rng.integers(20000, 32000, 100))], 4)
    system = list(rng.integers(1, 32000, 2 * SERVING["block_size"]))
    lens = rng.integers(64, 1025, 16)
    prompts = []
    for i, n in enumerate(lens):
        body = list(rng.integers(1, 32000, int(n)))
        prompts.append((system + body)[:max(int(n), 65)] if i % 3 == 0
                       else body)
    _instrument(srv)
    stats0 = dict(srv.stats)
    _zero_counters()
    t0 = time.perf_counter()
    _run_requests(srv, prompts, 64)
    wall = time.perf_counter() - t0
    counts = _counters()
    steps = srv._decode_step.calls
    d, rates = _rates(srv, stats0, steps)
    log(f"serve: requests={len(prompts)} finished={d['completed']} "
        f"prefill_tokens={d['prefill_tokens']} "
        f"prefix_hit_tokens={d['prefix_hit_tokens']} decode_steps={steps} "
        f"launches={json.dumps(counts)} wall_s={wall:.2f}")
    if d["prefix_hit_tokens"] <= 0:
        fail("no prefix-cache hit on the shared system prompt")
    if counts["paged_attention"] < LLAMA_LAYERS * steps or steps == 0:
        fail(f"paged_attention launched {counts['paged_attention']} times "
             f"for {steps} decode steps of {LLAMA_LAYERS} layers")
    # a fresh batch in flight for the logits check
    for p in prompts[:8]:
        srv.submit(p[:256], 8)
    srv.step()
    _decode_logits_check(srv, 5e-2, "bf16")
    srv.run_until_idle()
    profile_decode(srv)
    return eng, srv, cfg, counts["paged_attention"], rates


def profile_decode(srv, steps=5, label="decode step"):
    """Device busy share of steady decode steps (8 lanes): kernel time
    summed by torch.profiler over the host wall time of the same steps,
    and the kernels that take the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import numpy as np
    rng = np.random.default_rng(5)
    for _ in range(srv.max_batch):
        srv.submit(list(rng.integers(1, 32000, 500)), steps + 4)
    srv.step()                                  # admit: prefill + decode
    srv.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            srv.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    srv.run_until_idle()
    _report_profile(label, prof, wall_ms, steps)


def _report_profile(label, prof, wall_ms, steps, averages=None):
    """Device busy ms per step (kernel time summed by torch.profiler), the
    idle share of the host wall time, and the kernels that take the most
    (``averages``: ``_key_averages(prof)`` when the caller has it)."""
    import torch
    averages = _key_averages(prof) if averages is None else averages
    kern = [e for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    if busy_ms <= 0:
        log(f"time: {label} profile wall_ms={wall_ms:.3f} "
            "device_busy_ms=not measured (no device time in the trace)")
        return None
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    # quant_matmul's kernels (this build's three, the earlier two) by launches
    qm = {e.key[:60]: e.count / steps for e in kern
          if any(k in e.key for k in QM_KERNEL_NAMES)}
    log(f"time: {label} profile wall_ms={wall_ms:.3f} "
        f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / wall_ms:.3f} "
        "top=" + json.dumps({e.key[:60]: round(
            e.self_device_time_total / 1e3 / steps, 4) for e in top})
        + (" quant_matmul_launches_per_step=" + json.dumps(qm) if qm else ""))
    return busy_ms


def profile_generate(cfg, params, ids, steps=5, tag="", tp=None):
    """Device busy share of the generate leg's prefill and of its steady
    greedy decode steps (forward_with_cache + argmax, 8 sequences); ``tag``
    follows the labels; ``tp``: a tensor-parallel rank's context over its
    shards. Returns the decode step's wall, busy and NCCL ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.models.generation import (forward_with_cache,
                                                       init_cache,
                                                       padded_cache_len)
    B, T = ids.shape
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad():
        cache = init_cache(cfg, B, padded_cache_len(T + GEN_NEW),
                           device="cuda", tp=tp)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, cache = forward_with_cache(cfg, params, ids, cache,
                                               prefill_flash=True, tp=tp)
            tok = logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        _report_profile("generate prefill" + tag, prof, wall_ms, 1)
        for _ in range(2):
            logits, cache = forward_with_cache(cfg, params, tok[:, None],
                                               cache, tp=tp)
            tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = forward_with_cache(cfg, params, tok[:, None],
                                                   cache, tp=tp)
                tok = logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        busy = _report_profile("generate decode step" + tag, prof, wall_ms,
                               steps)
    nccl = sum(e.self_device_time_total for e in _key_averages(prof)
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "nccl" in e.key.lower()) / 1e3 / steps
    return {"decode_step_wall_ms": wall_ms,
            "decode_step_busy_ms": "not measured" if busy is None else busy,
            "decode_step_nccl_ms": nccl if busy is not None
            else "not measured"}


# ---------------------------------------------------------------- 4. int8

INT8_LENS, INT8_NEW = (96, 200, 333, 512), 16
QM_KERNEL_NAMES = ("gemv_kernel", "gemm_kernel", "simt_kernel",
                   "quant_matmul_kernel", "sum_partials_kernel")
QM_PER_FORWARD = LLAMA_LAYERS * 5 + 1      # qkv, proj, gate, fc, mlp proj; head


def phase_int8(eng):
    import numpy as np
    srv = eng.serve(dict(SERVING, kv_cache_dtype="int8",
                         weight_dtype="int8"))
    _run_requests(srv, [list(range(1, 41))], 2)             # warm-up
    counts, rates, by_path = _int8_leg(srv, 1)
    log(f"int8: requests={len(INT8_LENS)} launches={json.dumps(counts)} "
        f"quant_matmul_by_path={json.dumps(by_path)}")
    if counts["quant_matmul"] <= 0 or counts["paged_attention"] <= 0:
        fail(f"int8 leg launched {counts}")
    rng = np.random.default_rng(2)
    for _ in INT8_LENS:
        srv.submit(list(rng.integers(1, 32000, 128)), 4)
    srv.step()
    _decode_logits_check(srv, 5e-2, "int8")
    srv.run_until_idle()
    profile_decode(srv, label="int8 decode step")
    return srv, counts["quant_matmul"], by_path, rates


def _int8_leg(srv, seed):
    """The int8 leg's requests (prompts of INT8_LENS tokens drawn from
    ``seed``, so no prefix is shared with an earlier run), timed: launch
    counts, prefill and decode rates, and quant_matmul's launches by path,
    each a multiple of the 111 matmuls of one forward."""
    import numpy as np
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(1, 32000, int(n))) for n in INT8_LENS]
    _instrument(srv, tqm.quant_matmul)
    stats0 = dict(srv.stats)
    _zero_counters()
    _run_requests(srv, prompts, INT8_NEW)
    counts = _counters()
    pre, dec = srv._run_prefill, srv._decode_step
    _, rates = _rates(srv, stats0, dec.calls)
    by_path = {"decode": dec.launches, "prefill": pre.launches}
    del srv._run_prefill, srv._decode_step          # the engine's own again
    if (pre.launches != QM_PER_FORWARD * pre.calls
            or dec.launches != QM_PER_FORWARD * dec.calls
            or pre.launches + dec.launches != counts["quant_matmul"]):
        fail(f"int8 leg: quant_matmul launches {by_path} for {pre.calls} "
             f"prefills and {dec.calls} decode steps")
    return counts, rates, by_path


# ------------------------------------------------------------ 5. generate

def _generate_logits_check(cfg, params, ids, tol_rel, label="generate"):
    """The prefill (flash kernel) and one decode step (decode kernel) of
    forward_with_cache vs impl="reference"; the decode step of both runs
    from the same copy of the kernel-prefilled cache."""
    import torch
    from deepspeed_tpu_torch.models.generation import (forward_with_cache,
                                                       init_cache,
                                                       padded_cache_len)
    B, T = ids.shape
    caches, pre = {}, {}
    with torch.no_grad():
        for impl in ("auto", "reference"):
            cache = init_cache(cfg, B, padded_cache_len(T + GEN_NEW),
                               device="cuda")
            logits, caches[impl] = forward_with_cache(
                cfg, params, ids, cache, prefill_flash=True, impl=impl)
            pre[impl] = logits
        tok = pre["reference"][:, -1].argmax(-1)[:, None]
        ref_cache = {k: (v.clone() if torch.is_tensor(v) else v)
                     for k, v in caches["auto"].items()}
        dec = {impl: forward_with_cache(cfg, params, tok, c, impl=impl)[0]
               for impl, c in (("auto", caches["auto"]),
                               ("reference", ref_cache))}
    torch.cuda.synchronize()
    for step, out in (("prefill", pre), ("decode", dec)):
        _hold_logits(f"{label} {step}", out["auto"], out["reference"],
                     tol_rel)
    del pre, dec, caches, ref_cache


def _short_generate_legs(cfg, params):
    """The routes around the kernels, on 4 layers of the same model: a
    left-padded ragged batch and the int8 cache (plain cache path: no new
    kernel launch), a dtype "int8" engine, and seeded sampling."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    params4 = dict(params, blocks={
        n: {k: t[:4] for k, t in sub.items()}
        for n, sub in params["blocks"].items()})
    eng4 = deepspeed_tpu_torch.init_inference(cfg4, {"dtype": "bf16"},
                                              model_parameters=params4)
    rng = np.random.default_rng(8)
    B, T, new = 4, 96, 8
    ids = torch.as_tensor(rng.integers(1, 32000, (B, T)), device="cuda")
    mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
    for b, npad in enumerate((0, 10, 40, 95)):
        mask[b, :npad] = 0
    shape = (B, T + new)
    legs = {}
    for name, kw in (("ragged", {"attention_mask": mask}),
                     ("int8_kv_cache", {"kv_cache_dtype": "int8"})):
        _zero_counters()
        out = eng4.generate(ids, max_new_tokens=new, **kw)
        torch.cuda.synchronize()
        c = _counters()
        legs[name] = c
        if tuple(out.shape) != shape or \
                c["flash_attention_fwd"] or c["decode_attention"]:
            fail(f"generate {name}: shape {tuple(out.shape)}, launches {c}")
    eng8 = deepspeed_tpu_torch.init_inference(cfg4, {"dtype": "int8"},
                                              model_parameters=params4)
    logits = eng8.forward(ids)
    out = eng8.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    if tuple(logits.shape) != (B, T, cfg.vocab_size) or \
            not torch.isfinite(logits).all() or tuple(out.shape) != shape:
        fail(f"int8 engine: logits {tuple(logits.shape)}, out "
             f"{tuple(out.shape)}")
    sampled = []
    for _ in range(2):
        g = torch.Generator(device="cuda").manual_seed(11)
        sampled.append(eng4.generate(ids, max_new_tokens=new,
                                     temperature=0.8, top_k=50, top_p=0.9,
                                     repetition_penalty=1.2, generator=g))
    if tuple(sampled[0].shape) != shape or \
            not torch.equal(sampled[0], sampled[1]):
        fail("seeded sampling did not reproduce")
    log(f"generate: 4-layer legs ragged/int8-kv launches="
        f"{json.dumps(legs)} int8-engine logits={tuple(logits.shape)} "
        f"sampled={tuple(sampled[0].shape)} reproduced=True")


def phase_generate(tmp, served):
    """init_inference(JSON config).generate() on llama-1.1b at full width
    and depth, from the serve leg's seeded bf16 weights (no copy)."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.generation import padded_cache_len
    cfg, params = served.cfg, served.params
    path = os.path.join(tmp, "ds_generate.json")
    with open(path, "w") as f:
        json.dump({"dtype": "bf16"}, f)
    eng = deepspeed_tpu_torch.init_inference(cfg, path,
                                             model_parameters=params)
    rng = np.random.default_rng(7)
    ids = torch.as_tensor(rng.integers(1, 32000, (GEN_BATCH, GEN_PROMPT)),
                          device="cuda")
    eng.generate(ids[:, :64], max_new_tokens=2)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(ids, max_new_tokens=1)                   # prefill + 1 pick
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    _zero_counters()
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=GEN_NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = _counters()
    steps = GEN_NEW - 1
    log(f"generate: llama-1.1b B={GEN_BATCH} prompt={GEN_PROMPT} "
        f"new={GEN_NEW} cache_len={padded_cache_len(GEN_PROMPT + GEN_NEW)} "
        f"out={tuple(out.shape)} "
        f"launches={json.dumps(counts)} wall_s={total_s:.3f}")
    if tuple(out.shape) != (GEN_BATCH, GEN_PROMPT + GEN_NEW) or \
            not torch.equal(out[:, :GEN_PROMPT], ids):
        fail(f"generate returned {tuple(out.shape)}")
    if counts["flash_attention_fwd"] != LLAMA_LAYERS or \
            counts["decode_attention"] != LLAMA_LAYERS * steps:
        fail(f"generate launched {counts}: expected flash "
             f"{LLAMA_LAYERS}, decode {LLAMA_LAYERS * steps}")
    rates = {"prefill_tok_s": GEN_BATCH * GEN_PROMPT / prefill_s,
             "decode_tok_s": GEN_BATCH * steps / (total_s - prefill_s),
             "decode_step_ms": 1e3 * (total_s - prefill_s) / steps,
             "prefill_ms": 1e3 * prefill_s}
    _generate_logits_check(cfg, params, ids, 5e-2)
    profile_generate(cfg, params, ids)
    _short_generate_legs(cfg, params)
    return counts, rates


# ------------------------------------------------------ 6b. head dim 256

# google/gemma-2b's attention geometry (config.json: num_attention_heads 8,
# num_key_value_heads 1, head_dim 256) on llama-1.1b's preset, depth cut
# to 2 layers
GEMMA_ATTN = dict(num_layers=2, num_heads=8, num_kv_heads=1,
                  head_dim_override=256)
GEMMA_LAYERS = GEMMA_ATTN["num_layers"]


def phase_gemma(tmp):
    """The entry points at head dim 256: llama-1.1b's preset cut to 2
    layers with google/gemma-2b's attention (8 query heads, 1 KV head of
    256), random weights from a seed. serve() answers 4 requests
    (paged_attention every decode step), generate() prefills 4 x 512 and
    decodes 16 (flash_attention_fwd, then decode_attention), and two
    train_batch steps at seq 1024 run the forward and both backward flash
    kernels; the launch counters hold each path to its kernels, the
    prefill and decode logits to the plain path's, one micro-batch's loss
    and grad norm to attention_impl="reference"."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import (build_model,
                                                        get_config,
                                                        init_params)
    cfg = get_config("llama-1.1b", **GEMMA_ATTN)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    path = os.path.join(tmp, "ds_gemma.json")
    with open(path, "w") as f:
        json.dump({"dtype": "bf16", "serving": SERVING}, f)
    srv = deepspeed_tpu_torch.init_inference(
        cfg, path, model_parameters=params).serve()
    rng = np.random.default_rng(9)
    prompts = [list(rng.integers(1, 32000, int(n)))
               for n in (100, 257, 600, 1000)]
    _instrument(srv)
    _zero_counters()
    _run_requests(srv, prompts, 16)
    serve = _counters()
    steps = srv._decode_step.calls
    log(f"gemma: serve head_dim={cfg.head_dim} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} layers={cfg.num_layers} requests={len(prompts)} "
        f"decode_steps={steps} launches={json.dumps(serve)}")
    if steps == 0 or serve["paged_attention"] != GEMMA_LAYERS * steps:
        fail(f"gemma serve: paged_attention launched "
             f"{serve['paged_attention']} times for {steps} decode steps")
    del srv
    eng = deepspeed_tpu_torch.init_inference(cfg, {"dtype": "bf16"},
                                             model_parameters=params)
    ids = torch.as_tensor(rng.integers(1, 32000, (4, 512)), device="cuda")
    eng.generate(ids[:, :64], max_new_tokens=2)           # warm-up
    _zero_counters()
    out = eng.generate(ids, max_new_tokens=16)
    torch.cuda.synchronize()
    gen = _counters()
    log(f"gemma: generate out={tuple(out.shape)} launches={json.dumps(gen)}")
    if tuple(out.shape) != (4, 528) or not torch.equal(out[:, :512], ids):
        fail(f"gemma generate returned {tuple(out.shape)}")
    if gen["flash_attention_fwd"] != GEMMA_LAYERS or \
            gen["decode_attention"] != GEMMA_LAYERS * 15:
        fail(f"gemma generate launched {gen}")
    _generate_logits_check(cfg, params, ids, 5e-2)
    del eng, params
    model, _ = build_model("llama-1.1b", fused_loss=True, loss_chunk=256,
                           seed=0, device="cuda", **GEMMA_ATTN)
    with open(os.path.join(tmp, "ds_gemma_train.json"), "w") as f:
        json.dump(TRAIN_CONFIG, f)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=os.path.join(tmp, "ds_gemma_train.json"))
    del model
    batch = {"input_ids": rng.integers(1, cfg.vocab_size,
                                       (TRAIN_MICRO * TRAIN_GAS, TRAIN_SEQ))}
    train = dict.fromkeys(FLASH_KERNELS, 0)
    for step in range(2):
        _zero_counters()
        m = engine.train_batch(batch)
        c = _counters()
        log(f"gemma: train step {step} loss={m['loss']:.5f} "
            f"grad_norm={m['grad_norm']:.4f} launches={json.dumps(c)}")
        if not np.isfinite(m["loss"]) or m["overflow"] or any(
                c[k] != GEMMA_LAYERS * TRAIN_GAS for k in FLASH_KERNELS):
            fail(f"gemma train step {step}: {m}, launches {c}")
        for k in FLASH_KERNELS:
            train[k] += c[k]
    micro = {"input_ids": torch.as_tensor(batch["input_ids"][:TRAIN_MICRO],
                                          device="cuda")}
    got = _micro_loss_and_norm(engine.module, micro)
    _set_attention_impl(engine.module, "reference")
    ref = _micro_loss_and_norm(engine.module, micro)
    rl, rn = (abs(a - b) / abs(b) for a, b in zip(got, ref))
    log(f"check: gemma train micro-batch kernels vs attention_impl="
        f"reference loss={got[0]:.5f}/{ref[0]:.5f} rel_err={rl:.3e} "
        f"tol=1e-3 grad_norm={got[1]:.5f}/{ref[1]:.5f} rel_err={rn:.3e} "
        f"tol=1e-2")
    if not (rl <= 1e-3 and rn <= 1e-2):
        fail("gemma train: the kernel path's loss or grad norm is off the "
             "reference path's")
    del engine
    torch.cuda.empty_cache()
    return {"serve": serve, "generate": gen, "train": train}


# ------------------------------------------------------------ 6c. HF import

# microsoft/phi-2's config.json (the fields load_hf_phi reads)
PHI2_CONFIG = dict(vocab_size=51200, hidden_size=2560, intermediate_size=10240,
                   num_hidden_layers=32, num_attention_heads=32,
                   num_key_value_heads=32, partial_rotary_factor=0.4,
                   rope_theta=10000.0, layer_norm_eps=1e-5,
                   max_position_embeddings=2048, hidden_act="gelu_new",
                   qk_layernorm=False, tie_word_embeddings=False)
# bert-large-uncased's config.json (the fields load_hf_bert reads)
BERT_LARGE_CONFIG = dict(vocab_size=30522, hidden_size=1024,
                         num_hidden_layers=24, num_attention_heads=16,
                         intermediate_size=4096, hidden_act="gelu",
                         max_position_embeddings=512, type_vocab_size=2,
                         layer_norm_eps=1e-12)
PHI2_BATCH, PHI2_PROMPT, PHI2_NEW, PHI2_REQUESTS = 4, 1024, 32, 8
BERT_BATCH, BERT_SEQ, BERT_STEPS = 8, 512, 3
BERT_TRAIN_CONFIG = {
    "train_batch_size": BERT_BATCH, "train_micro_batch_size_per_gpu": BERT_BATCH,
    "gradient_accumulation_steps": 1, "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "gradient_clipping": 1.0, "steps_per_print": 1000,
}


def _phi2_shapes():
    """PhiForCausalLM's state-dict names and shapes at phi-2's widths."""
    c = PHI2_CONFIG
    H, I, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    shapes = [("model.embed_tokens.weight", (V, H))]
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes += [(p + "input_layernorm.weight", (H,)),
                   (p + "input_layernorm.bias", (H,))]
        for n in ("q_proj", "k_proj", "v_proj", "dense"):
            shapes += [(p + f"self_attn.{n}.weight", (H, H)),
                       (p + f"self_attn.{n}.bias", (H,))]
        shapes += [(p + "mlp.fc1.weight", (I, H)), (p + "mlp.fc1.bias", (I,)),
                   (p + "mlp.fc2.weight", (H, I)), (p + "mlp.fc2.bias", (H,))]
    return shapes + [("model.final_layernorm.weight", (H,)),
                     ("model.final_layernorm.bias", (H,)),
                     ("lm_head.weight", (V, H)), ("lm_head.bias", (V,))]


def _bert_large_shapes():
    """BertForMaskedLM's state-dict names and shapes at bert-large's
    widths."""
    c = BERT_LARGE_CONFIG
    H, I, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    e = "bert.embeddings."
    shapes = [(e + "word_embeddings.weight", (V, H)),
              (e + "position_embeddings.weight",
               (c["max_position_embeddings"], H)),
              (e + "token_type_embeddings.weight", (c["type_vocab_size"], H)),
              (e + "LayerNorm.weight", (H,)), (e + "LayerNorm.bias", (H,))]
    for i in range(c["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}."
        for n, (o, k) in (("attention.self.query", (H, H)),
                          ("attention.self.key", (H, H)),
                          ("attention.self.value", (H, H)),
                          ("attention.output.dense", (H, H)),
                          ("intermediate.dense", (I, H)),
                          ("output.dense", (H, I))):
            shapes += [(p + n + ".weight", (o, k)), (p + n + ".bias", (o,))]
        for n in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes += [(p + n + ".weight", (H,)), (p + n + ".bias", (H,))]
    t = "cls.predictions."
    return shapes + [(t + "transform.dense.weight", (H, H)),
                     (t + "transform.dense.bias", (H,)),
                     (t + "transform.LayerNorm.weight", (H,)),
                     (t + "transform.LayerNorm.bias", (H,)),
                     (t + "bias", (V,))]


def _seeded_state_dict(shapes, seed):
    """f32 weights on the card as HF initializes them, from a seed:
    matrices and embeddings normal with std 0.02, LayerNorm weights 1,
    biases 0."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}
    for name, shape in shapes:
        if name.endswith("bias"):
            sd[name] = torch.zeros(shape, device="cuda")
        elif len(shape) == 1:
            sd[name] = torch.ones(shape, device="cuda")
        else:
            sd[name] = torch.randn(shape, generator=g, device="cuda") * 0.02
    return sd


def phase_hf(smi):
    """The HF import at full width and depth, each model's weights a
    seeded state dict under HF's names with its published config as a
    plain object. Phi-2 (microsoft/phi-2: 32 layers of 32 heads of 80,
    partial rotary over 32 channels, parallel residual):
    replace_transformer_layer -> init_inference (bf16) -> generate()
    (4 x 1024 prompt tokens, 32 greedy new) and serve() (8 greedy requests
    of 64..1024 prompt tokens, 32 new each); the launch counters hold the
    prefill to 32 flash_attention_fwd launches, each decode step to 32
    decode_attention or paged_attention launches, and the prefill, decode
    and serve decode logits to the plain path's. BERT-large
    (bert-large-uncased: post-LN, token types, the MLM head): load_hf ->
    init_inference(...).forward on 8 x 512 ids with a ragged key mask
    (BERT_KEY_LENS, live 128..512) and two token-type segments, 24
    flash_attention_fwd launches and MLM logits on live rows vs
    attention_impl="reference", and a control: the same forward without
    the key mask must fail that limit; then initialize (bf16, AdamW, micro
    8 x gas 1) and three train_batch steps with MLM labels on 15% of the
    live positions, each launching the three flash kernels 24 times with
    the key mask; the loss falls, and the batch's loss and grad norm
    through the kernels agree with attention_impl="reference"."""
    import numpy as np
    import torch
    from types import SimpleNamespace
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.hf import load_hf
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        masked_lm_loss)
    counts, rates = {}, {}
    # ------------------------------------------------------------ Phi-2
    t0 = time.perf_counter()
    sd = _seeded_state_dict(_phi2_shapes(), seed=2)
    module, params, cfg = deepspeed_tpu_torch.replace_transformer_layer(
        sd, config=SimpleNamespace(**PHI2_CONFIG), arch="PhiForCausalLM")
    # init_inference serves `params` and reads only the config: the
    # module's own copy of the weights goes at once
    del sd, module
    n_params = _numel(params)
    eng = deepspeed_tpu_torch.init_inference(
        cfg, {"dtype": "bf16", "serving": SERVING}, model_parameters=params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    L = cfg.num_layers
    log(f"hf: phi-2 params={n_params} layers={L} heads={cfg.num_heads} "
        f"head_dim={cfg.head_dim} rotary_dim={cfg.rotary_dim} "
        f"parallel_residual={cfg.parallel_residual} "
        f"map_s={time.perf_counter() - t0:.2f} "
        f"mem_gb={torch.cuda.memory_allocated() / 1e9:.2f}")
    if (cfg.head_dim, cfg.rotary_dim, L) != (80, 32, 32):
        fail(f"phi-2 mapped to {cfg}")
    rng = np.random.default_rng(12)
    V = cfg.vocab_size
    ids = torch.as_tensor(rng.integers(1, V, (PHI2_BATCH, PHI2_PROMPT)),
                          device="cuda")
    eng.generate(ids, max_new_tokens=2)                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(ids, max_new_tokens=1)                   # prefill + 1 pick
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    _zero_counters()
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=PHI2_NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    gen = _counters()
    steps = PHI2_NEW - 1
    log(f"hf: phi-2 generate B={PHI2_BATCH} prompt={PHI2_PROMPT} "
        f"new={PHI2_NEW} out={tuple(out.shape)} launches={json.dumps(gen)} "
        f"wall_s={total_s:.3f}")
    if tuple(out.shape) != (PHI2_BATCH, PHI2_PROMPT + PHI2_NEW) or \
            not torch.equal(out[:, :PHI2_PROMPT], ids):
        fail(f"phi-2 generate returned {tuple(out.shape)}")
    if gen["flash_attention_fwd"] != L or \
            gen["decode_attention"] != L * steps:
        fail(f"phi-2 generate launched {gen}: expected flash {L}, decode "
             f"{L * steps}")
    counts["phi2_generate"] = gen
    _generate_logits_check(eng.cfg, eng.params, ids, 5e-2,
                           label="hf phi-2 generate")
    prof = profile_generate(eng.cfg, eng.params, ids, tag=" phi-2")
    rates["phi2_generate"] = {
        "prefill_tok_s": PHI2_BATCH * PHI2_PROMPT / prefill_s,
        "decode_tok_s": PHI2_BATCH * steps / (total_s - prefill_s),
        "decode_step_ms": 1e3 * (total_s - prefill_s) / steps,
        "prefill_ms": 1e3 * prefill_s, **prof}
    srv = eng.serve()
    _run_requests(srv, [list(rng.integers(1, V, 100))], 4)   # warm-up
    prompts = [list(rng.integers(1, V, int(n)))
               for n in rng.integers(64, 1025, PHI2_REQUESTS)]
    _instrument(srv)
    stats0 = dict(srv.stats)
    _zero_counters()
    _run_requests(srv, prompts, PHI2_NEW)
    serve = _counters()
    steps = srv._decode_step.calls
    _, rates["phi2_serve"] = _rates(srv, stats0, steps)
    log(f"hf: phi-2 serve requests={len(prompts)} decode_steps={steps} "
        f"launches={json.dumps(serve)}")
    if steps == 0 or serve["paged_attention"] != L * steps:
        fail(f"phi-2 serve: paged_attention launched "
             f"{serve['paged_attention']} times for {steps} decode steps")
    counts["phi2_serve"] = serve
    for p in prompts:
        srv.submit(p[:256], 8)
    srv.step()
    _decode_logits_check(srv, 5e-2, "hf phi-2 serve")
    srv.run_until_idle()
    profile_decode(srv, label="hf phi-2 serve decode step")
    log("time: hf phi-2 " + json.dumps(rates) + f" [{smi}]")
    del srv, eng
    torch.cuda.empty_cache()
    # ------------------------------------------------------- BERT-large
    t0 = time.perf_counter()
    sd = _seeded_state_dict(_bert_large_shapes(), seed=3)
    params, cfg = load_hf(sd, arch="BertForMaskedLM",
                          config=SimpleNamespace(**BERT_LARGE_CONFIG))
    del sd
    L, V, B, S = cfg.num_layers, cfg.vocab_size, BERT_BATCH, BERT_SEQ
    log(f"hf: bert-large params={_numel(params)} layers={L} "
        f"post_ln={cfg.post_ln} mlm_head={cfg.mlm_head} "
        f"map_s={time.perf_counter() - t0:.2f}")
    if not (cfg.post_ln and cfg.mlm_head and not cfg.causal):
        fail(f"bert-large mapped to {cfg}")
    lens = np.asarray(BERT_KEY_LENS)
    live = np.arange(S)[None] < lens[:, None]
    batch = {"input_ids": np.where(live, rng.integers(1000, V, (B, S)), 0),
             "attention_mask": live.astype(np.int64),
             # two segments: sentence A, then sentence B from mid-sample
             "token_type_ids": (live & (np.arange(S)[None]
                                        >= lens[:, None] // 2)).astype(
                                            np.int64)}
    eng = deepspeed_tpu_torch.init_inference(cfg, {"dtype": "bf16"},
                                             model_parameters=params)
    eng.forward(batch)                                    # warm-up
    torch.cuda.synchronize()
    _zero_counters()
    logits = eng.forward(batch)
    torch.cuda.synchronize()
    fwd = _counters()
    fwd_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.forward(batch)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
    # negative control: the kernels with the key mask dropped
    nomask = {k: v for k, v in batch.items() if k != "attention_mask"}
    ctrl = eng.forward(nomask)
    _set_attention_impl(eng._module, "reference")
    ref = eng.forward(batch)
    torch.cuda.synchronize()
    log(f"hf: bert-large forward B={B} S={S} live={lens.tolist()} "
        f"launches={json.dumps(fwd)}")
    if tuple(logits.shape) != (B, S, V):
        fail(f"bert-large MLM logits have shape {tuple(logits.shape)}")
    rows = torch.as_tensor(live, device="cuda")
    _, scale = _hold_logits("hf bert-large MLM (live rows)", logits[rows],
                            ref[rows], 5e-2)
    # the check must see a forward that ignores the key mask
    err = (ctrl[rows] - ref[rows]).abs().max().item()
    log(f"check: hf bert-large control, key mask dropped, vs reference "
        f"max_abs_err={err:.4e} must exceed 5e-2*max_abs_logit="
        f"{5e-2 * scale:.4e}")
    if not err > 5e-2 * scale:
        fail(f"bert-large: the logits check passes a forward without the "
             f"key mask ({err} <= 5e-2 x {scale})")
    if fwd["flash_attention_fwd"] != L or fwd["flash_attention_bwd_dq"]:
        fail(f"bert-large forward launched {fwd}: expected flash {L}")
    counts["bert_forward"] = fwd
    del eng, logits, ref, ctrl
    torch.cuda.empty_cache()
    model = Transformer(cfg, params)
    del params
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=BERT_TRAIN_CONFIG, loss_fn=masked_lm_loss)
    del model
    pick = (rng.random((B, S)) < 0.15) & live
    batch["labels"] = np.where(pick, batch["input_ids"], -100)
    train = dict.fromkeys(FLASH_KERNELS, 0)
    metrics, step_s = [], []
    for step in range(BERT_STEPS):
        _zero_counters()
        t0 = time.perf_counter()
        m = engine.train_batch(batch)           # ends in a host read
        step_s.append(time.perf_counter() - t0)
        c = _counters()
        metrics.append(m)
        log(f"hf: bert-large train step {step} loss={m['loss']:.5f} "
            f"grad_norm={m['grad_norm']:.4f} step_ms={1e3 * step_s[-1]:.1f} "
            f"launches={json.dumps(c)}")
        if not np.isfinite(m["loss"]) or m["overflow"] or any(
                c[k] != L for k in FLASH_KERNELS):
            fail(f"bert-large train step {step}: {m}, launches {c}")
        for k in FLASH_KERNELS:
            train[k] += c[k]
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        fail(f"bert-large train: loss did not fall "
             f"({metrics[0]['loss']} -> {metrics[-1]['loss']})")
    counts["bert_train"] = train
    # the micro-batch (the whole batch) through the kernels, both backward
    # kernels with the key mask, vs the plain attention's loss and grads
    micro = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    got = _micro_loss_and_norm(engine.module, micro, masked_lm_loss)
    _set_attention_impl(engine.module, "reference")
    ref = _micro_loss_and_norm(engine.module, micro, masked_lm_loss)
    _set_attention_impl(engine.module, "auto")
    del micro
    torch.cuda.empty_cache()
    rl, rn = (abs(a - b) / abs(b) for a, b in zip(got, ref))
    log(f"check: hf bert-large train micro-batch kernels vs "
        f"attention_impl=reference loss={got[0]:.5f}/{ref[0]:.5f} "
        f"rel_err={rl:.3e} tol=1e-3 grad_norm={got[1]:.5f}/{ref[1]:.5f} "
        f"rel_err={rn:.3e} tol=1e-2")
    if not (rl <= 1e-3 and rn <= 1e-2):
        fail("bert-large train: the kernel path's loss or grad norm is off "
             "the reference path's")
    dt = float(np.median(step_s[1:]))
    rates = {"forward_ms": 1e3 * float(np.median(fwd_s)),
             "forward_tok_s": B * S / float(np.median(fwd_s)),
             "train_step_ms": 1e3 * dt, "train_tok_s": B * S / dt,
             "train_step_ms_all": [round(1e3 * x, 3) for x in step_s],
             "labels": int(pick.sum())}
    rates["train_step_busy_ms"], _ = profile_train(
        engine, batch, 1e3 * dt, label="hf bert-large train step")
    log("time: hf bert-large " + json.dumps(rates) + f" [{smi}]")
    del engine
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- 6. train

def _micro_loss_and_norm(module, micro, loss_fn=None):
    """Loss and global grad norm (f32) of one micro-batch through the
    module's compute parameters, leaving no grads behind; ``loss_fn``
    (outputs, batch) -> loss for a module that returns logits."""
    import torch
    loss = module(micro, train=True)
    if loss_fn is not None:
        loss = loss_fn(loss, micro)
    loss.backward()
    sq = sum(float(p.grad.float().square().sum()) for p in module.parameters()
             if p.grad is not None)
    module.zero_grad(set_to_none=True)
    return float(loss.detach()), sq ** 0.5


def _set_attention_impl(module, impl):
    _set_config(module, dataclasses.replace(module.cfg, attention_impl=impl))


def _set_config(module, cfg):
    """A Transformer's config on the module, its blocks and their MoE
    layers (the compute dtype)."""
    module.cfg = cfg
    for blk in module.blocks:
        blk.cfg = cfg
        if hasattr(blk, "moe"):
            blk.moe.dtype = cfg.dtype


def phase_train(tmp):
    """initialize(JSON ds_config) on llama-1.1b at full width and depth
    (22 layers, seeded f32 weights, bf16 compute with an fp32 master,
    AdamW + WarmupLR, clipping, ZeRO stage 1), seq 1024, micro 2 x gas 2:
    TRAIN_STEPS train_batch steps on one repeated batch, each launching
    the three flash kernels 22 x 2 times; the loss falls; one micro-batch's
    loss and grad norm through the kernels vs attention_impl="reference";
    one forward/backward/step cycle; the trained weights into generate()."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.convert import scan_params
    from deepspeed_tpu_torch.models.transformer import build_model
    t0 = time.perf_counter()
    model, cfg = build_model("llama-1.1b", fused_loss=True, loss_chunk=256,
                             seed=0, device="cuda")
    path = os.path.join(tmp, "ds_train.json")
    with open(path, "w") as f:
        json.dump(TRAIN_CONFIG, f)
    engine, opt, _, sched = deepspeed_tpu_torch.initialize(model=model,
                                                           config=path)
    del model
    n_params = sum(p.numel() for p in engine.module.parameters())
    torch.cuda.synchronize()
    log(f"train: llama-1.1b params={n_params} layers={cfg.num_layers} "
        f"hidden={cfg.hidden_size} seq={TRAIN_SEQ} micro={TRAIN_MICRO} "
        f"gas={TRAIN_GAS} optimizer={opt.name} schedule="
        f"{type(sched).__name__} init_s={time.perf_counter() - t0:.2f} "
        f"mem_gb={torch.cuda.memory_allocated() / 1e9:.2f}")
    rng = np.random.default_rng(3)
    B = TRAIN_MICRO * TRAIN_GAS
    batch = {"input_ids": rng.integers(1, cfg.vocab_size, (B, TRAIN_SEQ))}
    per_step = LLAMA_LAYERS * TRAIN_GAS
    kernels = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
    metrics, step_s, total = [], [], dict.fromkeys(kernels, 0)
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        _zero_counters()
        t1 = time.perf_counter()
        m = engine.train_batch(batch)       # ends in a host read
        step_s.append(time.perf_counter() - t1)
        c = _counters()
        metrics.append(m)
        for k in kernels:
            total[k] += c[k]
        if any(c[k] != per_step for k in kernels):
            fail(f"train step {step} launched {c}: expected {per_step} of "
                 f"each flash kernel")
        if not np.isfinite(m["loss"]) or m["overflow"]:
            fail(f"train step {step}: {m}")
        log(f"train: step {step} loss={m['loss']:.5f} "
            f"grad_norm={m['grad_norm']:.4f} lr={m['lr']:.3e} "
            f"step_ms={1e3 * step_s[-1]:.1f} launches={json.dumps(c)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    micros = [{"input_ids": torch.as_tensor(
        batch["input_ids"][i * TRAIN_MICRO:(i + 1) * TRAIN_MICRO],
        device="cuda")} for i in range(TRAIN_GAS)]
    with torch.no_grad():      # the batch's loss after the last step
        final = float(np.mean([float(engine.module(mb)) for mb in micros]))
    # step 1 reports the batch's loss after the first step
    log(f"train: batch loss after the first step={metrics[1]['loss']:.5f} "
        f"after the last step={final:.5f}")
    if not final < metrics[1]["loss"]:
        fail(f"train: loss did not fall ({metrics[1]['loss']} -> {final})")
    micro = micros[0]
    # one micro-batch through the kernels vs the plain attention
    got = _micro_loss_and_norm(engine.module, micro)
    _set_attention_impl(engine.module, "reference")
    ref = _micro_loss_and_norm(engine.module, micro)
    _set_attention_impl(engine.module, "auto")
    torch.cuda.empty_cache()
    rl, rn = (abs(a - b) / abs(b) for a, b in zip(got, ref))
    # both paths compute in bf16 and round at different points (the
    # reference rounds q k^T to bf16, the kernels keep f32 scores)
    log(f"check: train micro-batch kernels vs attention_impl=reference "
        f"loss={got[0]:.5f}/{ref[0]:.5f} rel_err={rl:.3e} tol=1e-3 "
        f"grad_norm={got[1]:.5f}/{ref[1]:.5f} rel_err={rn:.3e} tol=1e-2")
    if not (rl <= 1e-3 and rn <= 1e-2):
        fail("train: the kernel path's loss or grad norm is off the "
             "reference path's")
    # the micro-batch API
    half = {"input_ids": batch["input_ids"][:TRAIN_MICRO]}
    for _ in range(TRAIN_GAS):
        engine.forward(half)
        engine.backward()
    m = engine.step()
    if m is None or not np.isfinite(m["loss"]):
        fail(f"train: forward/backward/step gave {m}")
    log(f"train: forward/backward/step loss={m['loss']:.5f} "
        f"grad_norm={m['grad_norm']:.4f} steps={engine.global_steps} "
        f"skipped={engine.skipped_steps}")
    # the trained weights into generate()
    gen = deepspeed_tpu_torch.init_inference(
        cfg, {"dtype": "bf16"}, model_parameters=scan_params(engine.module))
    prompt = torch.as_tensor(batch["input_ids"][:2, :64], device="cuda")
    out = gen.generate(prompt, max_new_tokens=4)
    torch.cuda.synchronize()
    if tuple(out.shape) != (2, 68) or not torch.equal(out[:, :64], prompt):
        fail(f"train: generate from the trained weights gave "
             f"{tuple(out.shape)}")
    log(f"train: generate from the trained weights out={tuple(out.shape)} "
        f"new={out[:, 64:].tolist()}")
    del gen
    # timing: the steady steps (the first pays the first-call costs)
    dt = float(np.median(step_s[1:]))
    tokens = B * TRAIN_SEQ
    rates = {"step_ms": 1e3 * dt, "tokens_s": tokens / dt,
             "model_tflops_6n": 6.0 * n_params * tokens / dt / 1e12,
             "step_ms_all": [round(1e3 * x, 3) for x in step_s],
             "peak_mem_gb": peak_gb}
    profile_train(engine, batch, 1e3 * dt)
    return engine, batch, total, rates


def profile_train(engine, batch, step_ms, label="train step",
                  split_bmm=False):
    """Device busy share of one steady train_batch step, against the
    profiled step's wall time and against the unprofiled median step
    (the profiler slows the host), and the device time by kind.
    ``split_bmm``: the kernels that ``aten::bmm`` launched (the MoE
    experts' batched products, forward and backward) are their own kind,
    ``expert_bmm``, taken out of the kind their names put them in."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    averages = _key_averages(prof)          # one aggregation, three reads
    _report_profile(label, prof, wall_ms, 1, averages)
    kinds = {"flash_attention": ("flash_",),
             "block_sparse_attention": ("bs_fwd", "bs_dq", "bs_dkv"),
             "gemm": ("nvjet", "gemm",
                                                      "cutlass", "sm90_"),
             "optimizer_foreach": ("multi_tensor",),
             "nccl": ("nccl",)}
    by_kind = dict.fromkeys(list(kinds) + ["other"], 0.0)
    kind_of = lambda name: next((k for k, keys in kinds.items()
                                 if any(x in name for x in keys)), "other")
    for e in averages:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_kind[kind_of(e.key)] += e.self_device_time_total / 1e3
    if split_bmm:
        by_kind["expert_bmm"] = 0.0
        for e in prof.events():
            if e.name != "aten::bmm":
                continue
            for k in getattr(e, "kernels", ()):
                by_kind[kind_of(k.name)] -= k.duration / 1e3
                by_kind["expert_bmm"] += k.duration / 1e3
    busy = sum(by_kind.values())
    host = sorted((e for e in averages
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    log(f"time: {label} host ms by op (self, profiled) " + json.dumps(
        {e.key[:48]: [round(e.self_cpu_time_total / 1e3, 3), e.count]
         for e in host}))
    log(f"time: {label} device ms by kind "
        + json.dumps({k: round(v, 3) for k, v in by_kind.items()})
        + f" busy_ms={busy:.3f} unprofiled_step_ms={step_ms:.3f} "
        f"idle_share_of_unprofiled_step={1 - busy / step_ms:.3f}")
    return busy, by_kind


# ----------------------------------------------------------------- 7. long

def _long_batch(vocab, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, vocab, (2, LONG_SEQ))}


def _cut_depth_check(module, micro, label, ref_micro=None, ref_impl=None,
                     control_impl=None):
    """One micro-batch's loss and grad norm through the first
    LONG_CHECK_LAYERS blocks of the trained weights, through the kernels
    and through the plain path (``ref_impl`` as attention_impl, or
    ``ref_micro``, the same tokens with an all-ones attention_mask, which
    sends every layer of the sparse impl to its dense-mask route).
    ``control_impl``: also read a wrong-attention control (that impl, on
    ``micro``) against the plain path, to show whether the limits would
    catch it; the control is a reading, not a check."""
    import torch
    blocks = module.blocks
    impl = module.cfg.attention_impl
    module.blocks = torch.nn.ModuleList(list(blocks)[:LONG_CHECK_LAYERS])
    got = _micro_loss_and_norm(module, micro)
    if ref_impl is not None:
        _set_attention_impl(module, ref_impl)
    ref = _micro_loss_and_norm(module, ref_micro or micro)
    ctl = None
    if control_impl is not None:
        _set_attention_impl(module, control_impl)
        ctl = _micro_loss_and_norm(module, micro)
    _set_attention_impl(module, impl)
    module.blocks = blocks
    torch.cuda.empty_cache()
    rl, rn = (abs(a - b) / abs(b) for a, b in zip(got, ref))
    log(f"check: {label} loss={got[0]:.5f}/{ref[0]:.5f} rel_err={rl:.3e} "
        f"tol=1e-3 grad_norm={got[1]:.5f}/{ref[1]:.5f} rel_err={rn:.3e} "
        "tol=1e-2")
    if ctl is not None:
        cl, cn = (abs(a - b) / abs(b) for a, b in zip(ctl, ref))
        caught = not (cl <= 1e-3 and cn <= 1e-2)
        log(f"control: {label}, attention_impl={control_impl} in place of "
            f"the kernels: loss={ctl[0]:.5f} rel_err={cl:.3e} grad_norm="
            f"{ctl[1]:.5f} rel_err={cn:.3e} "
            f"{'outside' if caught else 'within'} the limits")
    if not (rl <= 1e-3 and rn <= 1e-2):
        fail(f"{label}: the kernel path's loss or grad norm is off the "
             "plain path's")


def _train_leg(engine, batch, steps, per_step, name):
    """``steps`` train_batch steps on one batch with the counters zeroed
    before each: every block-sparse kernel launches ``per_step`` times a
    step and no flash kernel; the batch's loss after the last step is
    below its loss after the first. Returns (metrics, step seconds,
    launches summed over the steps)."""
    import numpy as np
    import torch
    metrics, step_s, total = [], [], dict.fromkeys(BS_KERNELS, 0)
    for step in range(steps):
        _zero_counters()
        t1 = time.perf_counter()
        m = engine.train_batch(batch)       # ends in a host read
        step_s.append(time.perf_counter() - t1)
        c = _counters()
        metrics.append(m)
        for k in BS_KERNELS:
            total[k] += c[k]
        if any(c[k] != per_step for k in BS_KERNELS) or \
                any(c[k] for k in FLASH_KERNELS):
            fail(f"{name} step {step} launched {c}: expected {per_step} of "
                 "each block-sparse kernel and no flash kernel")
        if not np.isfinite(m["loss"]) or m["overflow"]:
            fail(f"{name} step {step}: {m}")
        log(f"{name}: step {step} loss={m['loss']:.5f} "
            f"grad_norm={m['grad_norm']:.4f} step_ms={1e3 * step_s[-1]:.1f} "
            f"launches={json.dumps({k: c[k] for k in BS_KERNELS})}")
    micros = [{"input_ids": torch.as_tensor(batch["input_ids"][i:i + 1],
                                            device="cuda")} for i in (0, 1)]
    with torch.no_grad():      # the batch's loss after the last step
        final = float(np.mean([float(engine.module(mb)) for mb in micros]))
    log(f"{name}: batch loss after the first step={metrics[1]['loss']:.5f} "
        f"after the last step={final:.5f}")
    if not final < metrics[1]["loss"]:
        fail(f"{name}: loss did not fall ({metrics[1]['loss']} -> {final})")
    return metrics, step_s, total, micros


def phase_long(tmp, old_bs=None):
    """initialize(JSON ds_config with a sparse_attention section) on
    llama-1.1b at full width and depth, seq 4096, micro 1 x gas 2:
    LONG_STEPS train_batch steps, each launching the three block-sparse
    kernels 22 x 2 times and no flash kernel; the loss falls; one
    micro-batch through the kernels vs the dense-mask route on the first
    LONG_CHECK_LAYERS layers of the trained weights (a dense reference at
    seq 4096 holds [1, 32, 4096, 4096] f32 logits, 2.1 GB a layer before
    autograd's copies, so 22 layers do not fit); a profiled step. Then the
    window leg: WINDOW_LAYERS layers with a uniform window of WINDOW, no
    sparse_attention section, WINDOW_STEPS steps through the same kernels
    (layout_exact off), checked against attention_impl="reference" on the
    first LONG_CHECK_LAYERS layers."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import build_model
    t0 = time.perf_counter()
    model, cfg = build_model("llama-1.1b", max_seq_len=LONG_SEQ,
                             fused_loss=True, loss_chunk=256, seed=0,
                             device="cuda")
    path = os.path.join(tmp, "ds_long.json")
    with open(path, "w") as f:
        json.dump(LONG_CONFIG, f)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=path)
    del model
    mcfg = engine.module.cfg
    if mcfg.attention_impl != "sparse" or not mcfg.sparse_attention:
        fail(f"long: the sparse_attention section was not wired "
             f"({mcfg.attention_impl})")
    torch.cuda.synchronize()
    log(f"long: llama-1.1b layers={cfg.num_layers} hidden={cfg.hidden_size} "
        f"seq={LONG_SEQ} micro=1 gas=2 sparse_attention="
        f"{json.dumps(SPARSE_SECTION)} init_s={time.perf_counter() - t0:.2f}")
    batch = _long_batch(cfg.vocab_size, 5)
    torch.cuda.reset_peak_memory_stats()
    per_step = LLAMA_LAYERS * 2
    metrics, step_s, total, micros = _train_leg(engine, batch, LONG_STEPS,
                                                per_step, "long")
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
    routes = {kname: route(cfg.head_dim, torch.bfloat16) for kname, route in
              zip(BS_KERNELS, (tbs.fwd_route, tbs.dq_route, tbs.dkv_route))}
    log(f"long: routes {json.dumps(routes)} launches {json.dumps(total)}")
    if set(routes.values()) != {"wgmma"}:
        fail(f"long: the leg's calls do not take the wgmma kernels: {routes}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ones = dict(micros[0], attention_mask=torch.ones_like(
        micros[0]["input_ids"]))
    _cut_depth_check(engine.module, micros[0],
                     f"long micro-batch on {LONG_CHECK_LAYERS} layers, "
                     "kernels vs the dense-mask route (mha_reference with "
                     "the layout as a mask; 22 layers of dense S=4096 "
                     "logits do not fit)", ref_micro=ones,
                     control_impl="reference")
    import numpy as np
    dt = float(np.median(step_s[1:]))
    tokens = 2 * LONG_SEQ
    n_params = sum(p.numel() for p in engine.module.parameters())
    rates = {"step_ms": 1e3 * dt, "tokens_s": tokens / dt,
             "model_tflops_6n": 6.0 * n_params * tokens / dt / 1e12,
             "step_ms_all": [round(1e3 * x, 3) for x in step_s],
             "peak_mem_gb": peak_gb}
    profile_train(engine, batch, 1e3 * dt, "long step")
    if old_bs is not None:
        ab_long(engine, batch, old_bs)
    del engine
    torch.cuda.empty_cache()

    model, wcfg = build_model("llama-1.1b", num_layers=WINDOW_LAYERS,
                              max_seq_len=LONG_SEQ,
                              layer_windows=(WINDOW,) * WINDOW_LAYERS,
                              fused_loss=True, loss_chunk=256, seed=1,
                              device="cuda")
    wconf = {k: v for k, v in LONG_CONFIG.items() if k != "sparse_attention"}
    path = os.path.join(tmp, "ds_window.json")
    with open(path, "w") as f:
        json.dump(wconf, f)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=path)
    del model
    _, wstep_s, wtotal, wmicros = _train_leg(
        engine, _long_batch(wcfg.vocab_size, 6), WINDOW_STEPS,
        WINDOW_LAYERS * 2, "window")
    _cut_depth_check(engine.module, wmicros[0],
                     f"window micro-batch on {LONG_CHECK_LAYERS} layers, "
                     "kernels vs attention_impl=reference",
                     ref_impl="reference")
    rates["window_step_ms"] = 1e3 * float(np.median(wstep_s[1:]))
    del engine
    torch.cuda.empty_cache()
    return total, wtotal, rates


# ---------------------------------------------------------------- 8. time

def time_paged_attention():
    """One decode step's attention: 22 launches (one per layer) over 8
    lanes at ctx 1024 in a bf16 pool of the serving geometry."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    L, B, nh, hd, bs, ctx = LLAMA_LAYERS, 8, 32, 64, 32, 1024
    per = ctx // bs
    nblk = B * per + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    k = torch.randn(L, nh, nblk, bs, hd, device="cuda", generator=g).to(bf)
    v = torch.randn(L, nh, nblk, bs, hd, device="cuda", generator=g).to(bf)
    q = torch.randn(B, nh, 1, hd, device="cuda", generator=g).to(bf)
    bt = (torch.randperm(nblk - 1, device="cuda", generator=g)[:B * per] + 1
          ).reshape(B, per).to(torch.int32)
    lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    # the library yardstick: SDPA on K/V already gathered contiguous
    kc = k[:, :, bt.long()].permute(0, 2, 1, 3, 4, 5).reshape(L, B, nh, ctx, hd)
    vc = v[:, :, bt.long()].permute(0, 2, 1, 3, 4, 5).reshape(L, B, nh, ctx, hd)

    def step(fn):
        return lambda: [fn(li) for li in range(L)]

    t = timings(
        step(lambda li: tpa.paged_attention(q, k, v, bt, lens, layer_idx=li)),
        step(lambda li: tpa.paged_attention_reference(q, k, v, bt, lens,
                                                      layer_idx=li)),
        step(lambda li: F.scaled_dot_product_attention(q, kc[li], vc[li])))
    nbytes = L * (2 * B * nh * ctx * hd * 2 + 2 * B * nh * hd * 2
                  + B * per * 4 + B * 4)
    bnd, by = bound_ms(nbytes, L * 4 * B * nh * ctx * hd)
    return {**t, "bound_ms": bnd, "bound_by": by,
            "work": f"one decode step: {L} launches, B={B}, ctx={ctx}, "
                    f"nh={nh}, hd={hd}, bf16 pool"}


def _int8_mats(params):
    """The int8 leg's 111 packed matrices of ``params`` in forward order:
    22 layers x (qkv, proj, gate, fc, mlp_proj) with each layer's own
    weights, then the LM head; and their bf16-dequantized copies (the
    library yardstick's operands, made here only)."""
    import torch
    from deepspeed_tpu_torch.models.generation import _kernel_of
    blocks, head = params["blocks"], params["lm_head"]
    names = ("attn_qkv", "attn_proj", "mlp_gate", "mlp_fc", "mlp_proj")
    mats = [(blocks[n]["kernel"][li], blocks[n]["kernel_qscale"][li])
            for li in range(LLAMA_LAYERS) for n in names]
    mats.append((head["kernel"], head["kernel_qscale"]))
    dense = [_kernel_of({"kernel": q, "kernel_qscale": s}, torch.bfloat16)
             for q, s in mats]
    return mats, dense


def _qm_inputs(mats, M, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {K: torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
            for K in {q.shape[0] for q, _ in mats}}


def _qm_forward(mats, xs):
    """One forward's quant_matmul calls (111 launches)."""
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    return lambda: [tqm.quant_matmul(xs[q.shape[0]], q, s) for q, s in mats]


def _qm_bound(mats, M):
    nbytes = sum(q.numel() + 4 * s.numel() + 2 * M * (q.shape[0] + q.shape[1])
                 for q, s in mats)
    flops = sum(2 * M * q.shape[0] * q.shape[1] for q, _ in mats)
    bnd, by = bound_ms(nbytes, flops)
    return nbytes, {"bound_ms": bnd, "bound_by": by,
                    "bound_bytes_ms": 1e3 * nbytes / HBM_BYTES_S,
                    "bound_ops_ms": 1e3 * flops / BF16_FLOPS}


def time_quant_matmul(mats, dense, M):
    """One forward's int8 matmuls at M rows of bf16 x (M=8: a decode step
    of 8 lanes; M=512: a 512-token prefill): 111 launches, beside the
    plain version and torch.matmul on the dequantized bf16 weights."""
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    xs = _qm_inputs(mats, M, 3)
    t = timings(
        _qm_forward(mats, xs),
        lambda: [tqm.quant_matmul_reference(xs[q.shape[0]], q, s)
                 for q, s in mats],
        lambda: [xs[w.shape[0]] @ w for w in dense])
    nbytes, bound = _qm_bound(mats, M)
    what = "one decode step" if M <= 16 else f"one {M}-token prefill"
    return {**t, **bound,
            "work": f"{what}: {len(mats)} launches at M={M} "
                    f"({LLAMA_LAYERS} layers x 5 + head), "
                    f"{nbytes / 1e9:.3f} GB"}


QM_PREFILL_MS = (96, 224, 352)        # the int8 leg's other prefill lengths
QM_TIMED_BLOCKS = (256, 8, 40, 100)


def time_quant_matmul_blocks(dense):
    """One forward's int8 matmuls (111 launches: layer 0's five matrices
    22 times, then the LM head, packed from the dequantized weights) at
    scale blocks 256, 8, 40 and 100, at M 8 (a decode step) and M 512 (a
    prefill): device ms each, in one process. Blocks that are not a
    multiple of 16 have no target; 256 is the main path's."""
    import torch
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    ws = [w.float() for w in dense[:5]] + [dense[-1].float()]
    out = {}
    for block in QM_TIMED_BLOCKS:
        packed = [tqm.pack_kernel(w, block) for w in ws]
        mats = packed[:5] * LLAMA_LAYERS + packed[5:]
        row = {}
        for M in (8, 512):
            xs = _qm_inputs(mats, M, 5)
            row[f"M{M}"] = device_ms(_qm_forward(mats, xs))
        out[block] = row
        del packed, mats
    log(f"time: quant_matmul by scale block, device ms a forward (111 "
        f"launches): " + json.dumps({b: {k: round(v, 4) for k, v in r.items()}
                                     for b, r in out.items()}))
    torch.cuda.empty_cache()
    return out


def time_wide_heads():
    """What head dims above 256 cost: device ms of each attention kernel
    at D 256 (the widest of the narrow kernels) beside 264 and 512 (the
    wide ones), bf16: flash forward, dq and dk/dv at [1, 16, 1024, D]
    causal; block-sparse forward, dq and dk/dv at [1, 16, 1024, D] with the
    long leg's fixed layout; decode at T 1 and 64 and paged at T 1, 8
    sequences x 16 heads at cur_len 1056 (one launch each)."""
    import torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
    from deepspeed_tpu_torch.ops import decode_attention as tda
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    g = torch.Generator(device="cuda").manual_seed(15)
    bf = torch.bfloat16
    cfg = tsa.build_sparsity_config(num_heads=16, **SPARSE_SECTION)
    layout = tsa.config_layout(cfg, 1024)
    out = {}
    for D in (256, 264, 512):
        row = {}
        q, k, v, do = (torch.randn(1, 16, 1024, D, device="cuda",
                                   generator=g).to(bf) for _ in range(4))
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(-1)
        row["flash_fwd"] = device_ms(lambda: tfa.flash_attention_fwd(
            q, k, v, causal=True))
        row["flash_dq"] = device_ms(lambda: tfa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta))
        row["flash_dkv"] = device_ms(lambda: tfa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta))
        kw = {"causal": True}
        o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, 64, **kw)
        delta = (do.float() * o.float()).sum(-1)
        row["bs_fwd"] = device_ms(lambda: tbs.block_sparse_attention_fwd(
            q, k, v, layout, 64, **kw))
        row["bs_dq"] = device_ms(lambda: tbs.block_sparse_attention_bwd_dq(
            q, k, v, do, lse, delta, layout, 64, **kw))
        row["bs_dkv"] = device_ms(lambda: tbs.block_sparse_attention_bwd_dkv(
            q, k, v, do, lse, delta, layout, 64, **kw))
        del q, k, v, do, o, lse, delta
        kc, vc = (torch.randn(8, 16, 1280, D, device="cuda",
                              generator=g).to(bf) for _ in range(2))
        for T in (1, 64):
            qd = torch.randn(8, 16, T, D, device="cuda", generator=g).to(bf)
            row[f"decode_T{T}"] = device_ms(lambda: tda.decode_attention(
                qd, kc, vc, 1056))
        nbk, bs = 33, 32
        bt = torch.arange(8 * nbk, device="cuda", dtype=torch.int32
                          ).reshape(8, nbk)
        kp = kc[:, :, :nbk * bs].reshape(8, 16, nbk, bs, D).transpose(0, 1
                                                                      ).reshape(16, 8 * nbk, bs, D)
        vp = vc[:, :, :nbk * bs].reshape(8, 16, nbk, bs, D).transpose(0, 1
                                                                      ).reshape(16, 8 * nbk, bs, D)
        lens = torch.full((8,), 1056, dtype=torch.int32, device="cuda")
        qd = torch.randn(8, 16, 1, D, device="cuda", generator=g).to(bf)
        row["paged"] = device_ms(lambda: tpa.paged_attention(
            qd, kp, vp, bt, lens))
        out[D] = row
        del kc, vc, kp, vp
        torch.cuda.empty_cache()
    log("time: wide heads, device ms a launch, bf16: " + json.dumps(
        {d: {k: round(v, 4) for k, v in r.items()} for d, r in out.items()}))
    return out


def time_quant_matmul_prefill_lengths(mats):
    """The kernel's device ms for one forward at each of QM_PREFILL_MS."""
    return {str(M): device_ms(_qm_forward(mats, _qm_inputs(mats, M, 4)))
            for M in QM_PREFILL_MS}


def _parent_quant_matmul(src):
    """The parent commit's quant_matmul library, built from its source file
    ``src`` (the same C interface: its wrapper's plan and launch run
    unchanged)."""
    import ctypes
    lib = _parent_lib(src, "quant_matmul")
    lib.quant_matmul_launch.argtypes = ([ctypes.c_void_p] * 4 +
                                        [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.quant_matmul_launch.restype = ctypes.c_int
    return lib


AB_ORDER = ("parent", "new", "new", "parent")


def ab_quant_matmul(mats, old):
    """The parent commit's kernel (library ``old``) against this one in one
    process, each reading in the order parent, new, new, parent: one
    forward's 111 launches at the decode and prefill Ms."""
    import torch
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    libs = {"parent": old, "new": tqm._lib()}
    xs = _qm_inputs(mats, 8, 5)
    q, s = mats[-1]
    ref = tqm.quant_matmul(xs[q.shape[0]], q, s)
    with _using(tqm, "_lib", old):
        theirs = tqm.quant_matmul(xs[q.shape[0]], q, s)
    log(f"time: quant_matmul parent vs new LM head M=8 max_abs_diff="
        f"{_max_err(theirs, ref):.3e}")
    for M in (8,) + QM_PREFILL_MS + (512,):
        fwd = _qm_forward(mats, _qm_inputs(mats, M, 6))
        res = {"parent": [], "new": []}
        for who in AB_ORDER:
            with _using(tqm, "_lib", libs[who]):
                res[who].append(device_ms(fwd))
        log(f"time: quant_matmul parent vs new M={M} ms={json.dumps(res)}")
        torch.cuda.empty_cache()


def ab_int8(srv8, old):
    """The int8 leg's rates under the parent's kernel and this one, in the
    order parent, new, new, parent, and a decode step's busy share under
    each."""
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    libs = {"parent": old, "new": tqm._lib()}
    for i, who in enumerate(AB_ORDER):
        with _using(tqm, "_lib", libs[who]):
            _, rates, _ = _int8_leg(srv8, 100 + i)
            log(f"time: int8 {who} kernel " + json.dumps(rates))
            if i < 2:
                profile_decode(srv8, label=f"int8 decode step, {who} kernel")


def time_decode_attention():
    """One generate decode step's attention: 22 launches (one per layer)
    over 8 sequences at cur_len 1056 (the mean of the leg's steps) in the
    stacked bf16 cache of max_len 1280, 32 heads of 64."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import decode_attention as tda
    L, B, nh, hd, cur, max_len = LLAMA_LAYERS, GEN_BATCH, 32, 64, 1056, 1280
    g = torch.Generator(device="cuda").manual_seed(6)
    bf = torch.bfloat16
    k = torch.randn(L, B, nh, max_len, hd, device="cuda", generator=g).to(bf)
    v = torch.randn(L, B, nh, max_len, hd, device="cuda", generator=g).to(bf)
    q = torch.randn(B, nh, 1, hd, device="cuda", generator=g).to(bf)

    def step(fn):
        return lambda: [fn(li) for li in range(L)]

    t = timings(
        step(lambda li: tda.decode_attention(q, k, v, cur, layer_idx=li)),
        step(lambda li: tda.decode_attention_reference(q, k, v, cur,
                                                       layer_idx=li)),
        step(lambda li: F.scaled_dot_product_attention(
            q, k[li, :, :, :cur], v[li, :, :, :cur])))
    nbytes = L * (2 * B * nh * cur * hd * 2 + 2 * B * nh * hd * 2)
    bnd, by = bound_ms(nbytes, L * 4 * B * nh * cur * hd)
    del k, v
    return {**t, "bound_ms": bnd, "bound_by": by,
            "work": f"one decode step: {L} launches, B={B}, cur_len={cur}, "
                    f"nh={nh}, hd={hd}, bf16 cache of {max_len}"}


def sweep_decode_splits():
    """decode_attention at T = 1 with the context split over 1 to 4 CTAs
    (the wrapper's split_plan replaced for the sweep), 22 launches over 8
    sequences at cur_len 1056 in the stacked bf16 cache of 1280: 32 heads
    of 64 (the generate step), 16 of 96 and 16 of 256. Device ms; the plan's
    own choice is marked."""
    import torch
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops import decode_attention as tda
    g = torch.Generator(device="cuda").manual_seed(16)
    L, B, cur = LLAMA_LAYERS, GEN_BATCH, 1056
    own = tda.split_plan
    out = {}
    try:
        for nh, hd in ((32, 64), (16, 96), (16, 256)):
            k, v = (torch.randn(L, B, nh, 1280, hd, device="cuda",
                                generator=g).to(torch.bfloat16)
                    for _ in range(2))
            q = torch.randn(B, nh, 1, hd, device="cuda",
                            generator=g).to(torch.bfloat16)
            plan = own(B, nh, 1, hd, cur, build.sm_count(q.device))
            row = {}
            for splits in (1, 2, 3, 4):
                tda.split_plan = lambda *a, s=splits: s
                row[splits] = device_ms(lambda: [tda.decode_attention(
                    q, k, v, cur, layer_idx=li) for li in range(L)])
            out[f"{nh}x{hd} (plan {plan})"] = row
            del k, v
            torch.cuda.empty_cache()
    finally:
        tda.split_plan = own
    log("time: decode_attention splits sweep, device ms a step of "
        f"{L} launches: " + json.dumps(
            {k: {s: round(v, 4) for s, v in r.items()}
             for k, r in out.items()}))
    return out


def time_decode_attention_multi(T=64):
    """decode_attention at T = 64 queries (off the generate path, which
    decodes one token a step) at the generate leg's shape: 22 launches
    over 8 sequences at cur_len 1056 in the stacked bf16 cache of 1280.
    The library yardstick is SDPA with the bottom-right causal mask on the
    live slice."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import decode_attention as tda
    L, B, nh, hd, cur, max_len = LLAMA_LAYERS, GEN_BATCH, 32, 64, 1056, 1280
    g = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16
    k = torch.randn(L, B, nh, max_len, hd, device="cuda", generator=g).to(bf)
    v = torch.randn(L, B, nh, max_len, hd, device="cuda", generator=g).to(bf)
    q = torch.randn(B, nh, T, hd, device="cuda", generator=g).to(bf)
    mask = (torch.arange(cur, device="cuda")[None, :]
            <= torch.arange(cur - T, cur, device="cuda")[:, None])

    def step(fn):
        return lambda: [fn(li) for li in range(L)]

    t = timings(
        step(lambda li: tda.decode_attention(q, k, v, cur, layer_idx=li)),
        step(lambda li: tda.decode_attention_reference(q, k, v, cur,
                                                       layer_idx=li)),
        step(lambda li: F.scaled_dot_product_attention(
            q, k[li, :, :, :cur], v[li, :, :, :cur], attn_mask=mask)))
    pairs = T * (cur - T) + T * (T + 1) // 2     # live (query, key) pairs
    nbytes = L * (2 * B * nh * cur * hd * 2 + 2 * B * nh * T * hd * 2)
    bnd, by = bound_ms(nbytes, L * 4 * B * nh * pairs * hd)
    del k, v
    return {**t, "bound_ms": bnd, "bound_by": by,
            "work": f"{L} launches, B={B}, T={T}, cur_len={cur}, nh={nh}, "
                    f"hd={hd}, bf16 cache of {max_len}"}


def time_flash_attention():
    """One generate prefill's attention: 22 launches (one per layer) at
    B=8, 32 heads, S = Sk = 1024, D = 64, causal, bf16."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    L, B, H, S, D = LLAMA_LAYERS, GEN_BATCH, 32, GEN_PROMPT, 64
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(B, H, S, D, device="cuda", generator=g).to(
        torch.bfloat16) for _ in range(3))

    def step(fn):
        return lambda: [fn() for _ in range(L)]

    t = timings(
        step(lambda: tfa.flash_attention_fwd(q, k, v, causal=True)),
        step(lambda: tfa.flash_attention_reference(q, k, v, causal=True)),
        step(lambda: F.scaled_dot_product_attention(q, k, v,
                                                    is_causal=True)))
    nbytes = L * (4 * B * H * S * D * 2 + B * H * S * 4)
    flops = L * 4 * B * H * D * S * (S + 1) // 2      # live (q, k) pairs
    bnd, by = bound_ms(nbytes, flops)
    return {**t, "bound_ms": bnd, "bound_by": by,
            "work": f"one prefill: {L} launches, B={B}, H={H}, S=Sk={S}, "
                    f"D={D}, causal, bf16"}


def _bwd_inputs(seed, H=32, D=64, dtype=None):
    """The train leg's attention call: B 2 (micro), H heads, S = Sk =
    1024, head dim D, causal, bf16 unless ``dtype``, with its forward's o
    and lse."""
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(TRAIN_MICRO, H, TRAIN_SEQ, D, device="cuda",
                               generator=g).to(dtype or torch.bfloat16)
                   for _ in range(4))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, o, lse, delta


def time_flash_attention_bwd():
    """One train step's attention backward: 22 layers x 2 micro-batches =
    44 launches of each kernel at the train leg's shape. plain_ms is the
    plain backward (dq, dk and dv together) and library_ms SDPA's backward
    (dq, dk and dv together) on the same inputs, each per step."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    q, k, v, do, o, lse, delta = _bwd_inputs(8)
    n = LLAMA_LAYERS * TRAIN_GAS
    B, H, S, D = q.shape

    def step(fn):
        return lambda: [fn() for _ in range(n)]

    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib = device_ms(step(lambda: torch.autograd.grad(
        so, (qs, ks, vs), do, retain_graph=True)))
    plain = device_ms(step(lambda: tfa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=True)), reps=2)
    pairs = B * H * S * (S + 1) // 2             # live (q, k) pairs, causal
    elem = B * H * S * D * 2                     # one bf16 [B, H, S, D]
    rows = B * H * S * 4                         # one f32 [B, H, S]
    out = {}
    for name, fn, nbytes, flops in (
            ("flash_attention_bwd_dq",
             lambda: tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
             5 * elem + 2 * rows, 6 * D * pairs),
            ("flash_attention_bwd_dkv",
             lambda: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
             6 * elem + 2 * rows, 8 * D * pairs)):
        bnd, by = bound_ms(n * nbytes, n * flops)
        out[name] = {"ms": device_ms(step(fn)), "plain_ms": plain,
                     "library_ms": lib, "wall_ms": wall_ms(step(fn)),
                     "bound_ms": bnd, "bound_by": by,
                     "bound_bytes_ms": 1e3 * n * nbytes / HBM_BYTES_S,
                     "bound_ops_ms": 1e3 * n * flops / BF16_FLOPS,
                     "work": f"one train step: {n} launches ({LLAMA_LAYERS} "
                             f"layers x {TRAIN_GAS} micro), B={B}, H={H}, "
                             f"S=Sk={S}, D={D}, causal, bf16; plain and "
                             "library compute dq, dk and dv together"}
    del q, k, v, do, o, lse, delta, qs, ks, vs, so
    return out


# (head dim, heads, presets of that width): the head dims other than
# llama-1.1b's 64 that the port's presets use
# (D, heads, preset, fp16 too): fp16 timed where its kernels differ most
# from bf16's (PRs 6-7 found fp16 within 1.5% of bf16 at D 80 and 96)
HEAD_DIM_CASES = ((64, 32, "llama-1.1b", True), (80, 32, "gpt2-2.7b", False),
                  (96, 16, "gpt2-760m", False), (128, 32, "gpt2-6.7b", True),
                  (256, 16, "google/gemma-7b attention", True))


def time_head_dims():
    """The attention kernels at head dims 64, 80, 96, 128 and 256 (each
    with its preset's heads; 256: google/gemma-7b's 16 heads of 256) in
    bf16 (and fp16 at 64, 128 and 256) beside SDPA on the same inputs, device
    ms per step as the paths run them: flash forward and the backward pair
    at the train leg's call (B 2, S = Sk = 1024, causal; 44 calls), paged
    attention at the serve leg's decode (B 8, ctx 1024, blocks of 32) and
    decode attention at the generate leg's (B 8, cur_len 1056 of 1280;
    22 calls each). Timed by :func:`queued_ms`; D 64 bf16, the paths' own
    case, sets these beside the rows' profiler times."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import decode_attention as tda
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    nf, nd = LLAMA_LAYERS * TRAIN_GAS, LLAMA_LAYERS

    def steps(fn, n):
        return queued_ms(lambda: [fn() for _ in range(n)])

    for D, H, preset, fp16 in HEAD_DIM_CASES:
        for dt in (torch.bfloat16, torch.float16)[:2 if fp16 else 1]:
            q, k, v, do, o, lse, delta = _bwd_inputs(10, H, D, dt)
            B, _, S, _ = q.shape
            pairs = B * H * S * (S + 1) // 2
            elem, rows = B * H * S * D * 2, B * H * S * 4
            qs, ks, vs = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            r = {"fwd": steps(lambda: tfa.flash_attention_fwd(
                     q, k, v, causal=True), nf),
                 "fwd_bound": bound_ms(nf * (4 * elem + rows),
                                       nf * 4 * D * pairs)[0],
                 "sdpa_fwd": steps(lambda: F.scaled_dot_product_attention(
                     q, k, v, is_causal=True), nf),
                 "dq": steps(lambda: tfa.flash_attention_bwd_dq(
                     q, k, v, do, lse, delta), nf),
                 "dq_bound": bound_ms(nf * (5 * elem + 2 * rows),
                                      nf * 6 * D * pairs)[0],
                 "dkv": steps(lambda: tfa.flash_attention_bwd_dkv(
                     q, k, v, do, lse, delta), nf),
                 "dkv_bound": bound_ms(nf * (6 * elem + 2 * rows),
                                       nf * 8 * D * pairs)[0],
                 "sdpa_bwd": steps(lambda: torch.autograd.grad(
                     so, (qs, ks, vs), do, retain_graph=True), nf)}
            del q, k, v, do, o, lse, delta, qs, ks, vs, so
            g = torch.Generator(device="cuda").manual_seed(11)
            Bd, bs, ctx = 8, 32, 1024
            per = ctx // bs
            nblk = Bd * per + 1
            kp, vp = (torch.randn(1, H, nblk, bs, D, device="cuda",
                                  generator=g).to(dt) for _ in range(2))
            qd = torch.randn(Bd, H, 1, D, device="cuda", generator=g).to(dt)
            bt = (torch.randperm(nblk - 1, device="cuda", generator=g)
                  [:Bd * per] + 1).reshape(Bd, per).to(torch.int32)
            lens = torch.full((Bd,), ctx, dtype=torch.int32, device="cuda")
            kc, vc = (t[0][:, bt.long()].permute(1, 0, 2, 3, 4).reshape(
                Bd, H, ctx, D) for t in (kp, vp))
            r["paged"] = steps(lambda: tpa.paged_attention(
                qd, kp, vp, bt, lens, layer_idx=0), nd)
            r["paged_bound"] = bound_ms(
                nd * (2 * Bd * H * ctx * D * 2 + 2 * Bd * H * D * 2
                      + Bd * per * 4), nd * 4 * Bd * H * ctx * D)[0]
            r["sdpa_paged"] = steps(
                lambda: F.scaled_dot_product_attention(qd, kc, vc), nd)
            del kp, vp, kc, vc
            cur, max_len = 1056, 1280
            kd, vd = (torch.randn(1, Bd, H, max_len, D, device="cuda",
                                  generator=g).to(dt) for _ in range(2))
            r["decode"] = steps(lambda: tda.decode_attention(
                qd, kd, vd, cur, layer_idx=0), nd)
            r["decode_bound"] = bound_ms(
                nd * (2 * Bd * H * cur * D * 2 + 2 * Bd * H * D * 2),
                nd * 4 * Bd * H * cur * D)[0]
            r["sdpa_decode"] = steps(
                lambda: F.scaled_dot_product_attention(
                    qd, kd[0, :, :, :cur], vd[0, :, :, :cur]), nd)
            del kd, vd, qd
            torch.cuda.empty_cache()
            log(f"time: head_dim D={D} H={H} ({preset}) "
                f"{str(dt).split('.')[-1]} device ms per step "
                + json.dumps({key: round(val, 4) for key, val in r.items()})
                + f" [flash: {nf} calls, B={B}, S=Sk={S}, causal; paged: "
                f"{nd} calls, B={Bd}, ctx={ctx}, blocks of {bs}; decode: "
                f"{nd} calls, B={Bd}, cur_len={cur} of {max_len}]")


def _parent_lib(src, name):
    """The library of kernel ``name`` built from a parent commit's
    ``csrc/<name>.cu`` at ``src`` (with the headers it includes beside
    it), with its register report logged."""
    import ctypes
    import hashlib
    from deepspeed_tpu_torch.ops import build
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = build.BUILD_DIR / f"other_{name}-{digest}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                          str(lib_path), src], check=True,
                         capture_output=True, text=True, timeout=600)
    for kname, regs, st, ld in ptxas_report(out.stdout + out.stderr):
        log(f"build: {src} {kname} registers={regs} spill_stores={st} "
            f"spill_loads={ld}")
    return ctypes.CDLL(str(lib_path))


def _parent_flash_bwd(src):
    """The parent's flash backward library (the same C interface)."""
    import ctypes
    lib = _parent_lib(src, "flash_attention_bwd")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, n_ptr in ((lib.flash_attention_bwd_dq_launch, 10),
                      (lib.flash_attention_bwd_dkv_launch, 11)):
        fn.argtypes = [P] * n_ptr + [I] * 8 + [F] * 2 + [I, P]
        fn.restype = ctypes.c_int
    return lib


def _parent_flash_fwd(src):
    """The parent's flash forward library (the same C interface)."""
    import ctypes
    lib = _parent_lib(src, "flash_attention_fwd")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_launch.argtypes = [P] * 8 + [I] * 8 + [F] * 2 + [I, P]
    lib.flash_attention_fwd_launch.restype = ctypes.c_int
    return lib


def _parent_paged(src):
    """The parent's paged library (the same C interface)."""
    import ctypes
    lib = _parent_lib(src, "paged_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_launch.argtypes = (
        [P] * 9 + [I] * 8 + [F] * 2 + [I, I, I, P])
    lib.paged_attention_launch.restype = ctypes.c_int
    return lib


def _parent_decode(src):
    """The parent's decode library (the same C interface)."""
    import ctypes
    lib = _parent_lib(src, "decode_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_launch.argtypes = (
        [P] * 5 + [I] * 8 + [F] * 2 + [I, I, P])
    lib.decode_attention_launch.restype = ctypes.c_int
    return lib


class _ListlessBlockSparse:
    """The parent's block-sparse library behind this wrapper's calls: its
    forward and dq entry points take no per-CTA item lists and no layout
    bits (arguments 8-10 of this forward's, 11-13 of this dq's)."""

    def __init__(self, lib):
        self.lib = lib

    def block_sparse_attention_fwd_launch(self, *a):
        return self.lib.block_sparse_attention_fwd_launch(*a[:8], *a[11:])

    def block_sparse_attention_bwd_dq_launch(self, *a):
        return self.lib.block_sparse_attention_bwd_dq_launch(*a[:11], *a[14:])

    def __getattr__(self, name):
        return getattr(self.lib, name)


def _parent_block_sparse(src):
    import ctypes
    lib = _parent_lib(src, "block_sparse_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, n_ptr in ((lib.block_sparse_attention_fwd_launch, 10),
                      (lib.block_sparse_attention_bwd_dq_launch, 12),
                      (lib.block_sparse_attention_bwd_dkv_launch, 15)):
        fn.argtypes = [P] * n_ptr + [I] * 7 + [F, I, P]
        fn.restype = ctypes.c_int
    return _ListlessBlockSparse(lib)


class _using:
    """with _using(module, "_lib", lib): the module's kernel wrappers
    launch from ``lib``."""

    def __init__(self, module, attr, lib):
        self.module, self.attr, self.lib = module, attr, lib

    def __enter__(self):
        self.own = getattr(self.module, self.attr)
        setattr(self.module, self.attr, lambda: self.lib)

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.own)


def _under_bwd(lib, fn):
    """fn() with the flash backward wrappers launching from ``lib``."""
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    with _using(tfa, "_bwd_lib", lib):
        return fn()


def _ab_kernel(kernel, call, fns, libs, under, n, extra=""):
    """Device ms of ``n`` launches of each fn in ``fns`` (one call form
    each) under the parent's library and this one's, in the order parent,
    new, new, parent; logged with their ratio."""
    for form, fn in fns.items():
        res = {label: [] for label in libs}
        for label in AB_ORDER:
            with under(libs[label]):
                res[label].append(device_ms(lambda: [fn() for _ in range(n)]))
        mean = {label: sum(r) / len(r) for label, r in res.items()}
        log(f"time: {kernel} parent vs new {call} {form} ms="
            f"{json.dumps(res)} new_over_parent="
            f"{mean['new'] / mean['parent']:.3f}{extra} [{n} launches]")


def ab_flash_fwd(old):
    """The parent's flash forward (library ``old``) against this one at
    the generate prefill's call (22 x [8, 32, 1024, 64]) and the train
    leg's (44 x [2, 32, 1024, 64]), causal bf16, beside SDPA; and the
    parent's outputs against these on the same inputs."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    libs = {"parent": old, "new": tfa._lib()}
    under = lambda lib: _using(tfa, "_lib", lib)
    g = torch.Generator(device="cuda").manual_seed(7)
    for call, B, n in (("generate prefill", GEN_BATCH, LLAMA_LAYERS),
                       ("train step", TRAIN_MICRO, LLAMA_LAYERS * TRAIN_GAS)):
        q, k, v = (torch.randn(B, 32, 1024, 64, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(3))
        mine = tfa.flash_attention_fwd(q, k, v, causal=True)
        with under(old):
            theirs = tfa.flash_attention_fwd(q, k, v, causal=True)
        sdpa = device_ms(lambda: [F.scaled_dot_product_attention(
            q, k, v, is_causal=True) for _ in range(n)])
        log(f"time: flash_attention_fwd parent vs new {call} max_abs_diff "
            f"o={_max_err(mine[0], theirs[0]):.3e} "
            f"lse={_max_err(mine[1], theirs[1]):.3e}")
        _ab_kernel("flash_attention_fwd", call, {"bf16 causal": lambda:
                   tfa.flash_attention_fwd(q, k, v, causal=True)},
                   libs, under, n, f" sdpa_ms={sdpa:.4f}")
        del q, k, v, mine, theirs
    torch.cuda.empty_cache()


def ab_paged(old, srv):
    """The parent's paged kernel (``old``) against this one: the serve
    step's call (22 x B 8, 32 heads of 64, ctx 1024, blocks of 32) in a
    bf16 and an int8 pool, and D 96 with 16 heads; then the serve leg's
    decode step profiled under each, in the order parent, new, new,
    parent."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.quant_format import kv_quantize
    libs = {"parent": old, "new": tpa._lib()}
    under = lambda lib: _using(tpa, "_lib", lib)
    g = torch.Generator(device="cuda").manual_seed(2)
    B, bs, ctx, L = 8, 32, 1024, LLAMA_LAYERS
    per = ctx // bs
    nblk = B * per + 1
    bt = (torch.randperm(nblk - 1, device="cuda", generator=g)[:B * per] + 1
          ).reshape(B, per).to(torch.int32)
    lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    for call, nh, hd in (("serve step", 32, 64), ("D96 x 16 heads", 16, 96)):
        k32, v32 = (torch.randn(1, nh, nblk, bs, hd, device="cuda",
                                generator=g) for _ in range(2))
        q = torch.randn(B, nh, 1, hd, device="cuda",
                        generator=g).to(torch.bfloat16)
        k, v = k32.to(torch.bfloat16), v32.to(torch.bfloat16)
        (kq, ks), (vq, vs) = kv_quantize(k32), kv_quantize(v32)
        kc, vc = (t[0][:, bt.long()].permute(1, 0, 2, 3, 4).reshape(
            B, nh, ctx, hd) for t in (k, v))
        sdpa = device_ms(lambda: [F.scaled_dot_product_attention(q, kc, vc)
                                  for _ in range(L)])
        mine = tpa.paged_attention(q, k, v, bt, lens, layer_idx=0)
        with under(old):
            theirs = tpa.paged_attention(q, k, v, bt, lens, layer_idx=0)
        splits = tpa.split_plan(B, nh, ctx, build.sm_count(q.device))
        log(f"time: paged_attention parent vs new {call} max_abs_diff="
            f"{_max_err(mine, theirs):.3e} splits={splits}")
        fns = {"bf16": lambda: tpa.paged_attention(q, k, v, bt, lens,
                                                   layer_idx=0),
               "int8": lambda: tpa.paged_attention(
                   q, kq, vq, bt, lens, layer_idx=0, k_scale=ks,
                   v_scale=vs)}
        if call != "serve step":
            fns.pop("int8")
        _ab_kernel("paged_attention", call, fns, libs, under, L,
                   f" sdpa_ms={sdpa:.4f}")
        del k32, v32, k, v, kq, vq, kc, vc
    torch.cuda.empty_cache()
    for label in AB_ORDER:
        with under(libs[label]):
            profile_decode(srv, label=f"serve decode step, {label} paged")


DECODE_AB = (   # (call, heads, head dim, T, dtypes): 22 layers, B 8, cur 1056
    ("generate step", 32, 64, 1, ("bf16", "fp16")),
    ("D96 x 16 heads", 16, 96, 1, ("bf16", "fp16")),
    ("D80 x 32 heads", 32, 80, 1, ("bf16",)),
    ("D256 x 16 heads", 16, 256, 1, ("bf16",)),
    ("T=64", 32, 64, 64, ("bf16", "fp16")))


def ab_decode(old):
    """The parent's decode kernel (``old``) against this one at the
    generate step's call (22 launches over 8 sequences at cur_len 1056 in
    the stacked cache of 1280, 32 heads of 64), at D 96 x 16, D 80 x 32 and
    D 256 x 16 heads, and at T = 64; bf16 (and fp16 where listed), beside
    SDPA on the live slice (with the bottom-right causal mask at T = 64),
    in the order parent, new, new, parent."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops import decode_attention as tda
    libs = {"parent": old, "new": tda._lib()}
    under = lambda lib: _using(tda, "_lib", lib)
    g = torch.Generator(device="cuda").manual_seed(8)
    L, B, cur, max_len = LLAMA_LAYERS, GEN_BATCH, 1056, 1280
    for call, nh, hd, T, dts in DECODE_AB:
        k, v = (torch.randn(L, B, nh, max_len, hd, device="cuda",
                            generator=g).to(torch.bfloat16) for _ in range(2))
        q = torch.randn(B, nh, T, hd, device="cuda",
                        generator=g).to(torch.bfloat16)
        mask = None
        if T > 1:
            mask = (torch.arange(cur, device="cuda")[None, :]
                    <= torch.arange(cur - T, cur, device="cuda")[:, None])
        sdpa = device_ms(lambda: [F.scaled_dot_product_attention(
            q, k[li, :, :, :cur], v[li, :, :, :cur], attn_mask=mask)
            for li in range(L)])
        mine = tda.decode_attention(q, k, v, cur, layer_idx=L - 1)
        with under(old):
            theirs = tda.decode_attention(q, k, v, cur, layer_idx=L - 1)
        splits = tda.split_plan(B, nh, T, hd, cur, build.sm_count(q.device))
        log(f"time: decode_attention parent vs new {call} max_abs_diff="
            f"{_max_err(mine, theirs):.3e} route={tda.route(T, hd, q.dtype)} "
            f"splits={splits}")
        fns = {}
        for dt in dts:
            tdt = torch.bfloat16 if dt == "bf16" else torch.float16
            kk, vv, qq = ((k, v, q) if dt == "bf16" else
                          (k.to(tdt), v.to(tdt), q.to(tdt)))
            fns[dt] = (lambda kk=kk, vv=vv, qq=qq: [
                tda.decode_attention(qq, kk, vv, cur, layer_idx=li)
                for li in range(L)])
        _ab_kernel("decode_attention", call, fns, libs, under, 1,
                   f" sdpa_ms={sdpa:.4f} (x{L} layers a launch list)")
        del k, v, q, mine, theirs, fns
        torch.cuda.empty_cache()


def ab_block_sparse(old):
    """The parent's block-sparse kernels (``old``) against these: 44
    launches of each at [1, 32, 4096, 64] bf16 causal (one long step) over
    the four layouts of time_block_sparse_scaling (the long leg's, the
    window leg's, fixed-16, dense causal), in the order parent, new, new,
    parent; and the parent's outputs against these on the same inputs (o,
    lse, dq, dk, dv) at each layout."""
    import torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    libs = {"parent": old, "new": tbs._lib()}
    under = lambda lib: _using(tbs, "_lib", lib)
    H, S, D, n = 32, LONG_SEQ, 64, LLAMA_LAYERS * 2
    g = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, do = (torch.randn(1, H, S, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    for name, (cfg, kw) in _scaling_layouts(H).items():
        layout, fine = tsa.config_layout(cfg, S), cfg.block
        o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, fine, **kw)
        delta = (do.float() * o.float()).sum(-1)

        def outputs():              # both libraries on the same inputs
            fo, flse = tbs.block_sparse_attention_fwd(q, k, v, layout, fine,
                                                      **kw)
            dq = tbs.block_sparse_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   layout, fine, **kw)
            dk, dv = tbs.block_sparse_attention_bwd_dkv(
                q, k, v, do, lse, delta, layout, fine, **kw)
            return {"o": fo, "lse": flse, "dq": dq, "dk": dk, "dv": dv}
        mine = outputs()
        with under(old):
            theirs = outputs()
        log(f"time: block_sparse parent vs new {name} max_abs_diff "
            + " ".join(f"{key}={_max_err(mine[key], theirs[key]):.3e}"
                       for key in mine))
        fns = {
            "fwd": lambda: tbs.block_sparse_attention_fwd(
                q, k, v, layout, fine, **kw),
            "dq": lambda: tbs.block_sparse_attention_bwd_dq(
                q, k, v, do, lse, delta, layout, fine, **kw),
            "dkv": lambda: tbs.block_sparse_attention_bwd_dkv(
                q, k, v, do, lse, delta, layout, fine, **kw)}
        _ab_kernel("block_sparse", name, fns, libs, under, n)
        del o, lse, delta, mine, theirs
    del q, k, v, do
    torch.cuda.empty_cache()


def ab_long(engine, batch, old, steps=2):
    """The long leg's step under the parent's block-sparse kernels
    (``old``) and these, in the order parent, new, new, parent: the median
    wall ms of ``steps`` steps and one profiled step's busy ms and
    block-sparse kernel ms."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
    libs = {"parent": old, "new": tbs._lib()}
    for label in AB_ORDER:
        with _using(tbs, "_lib", libs[label]):
            wall = []
            for _ in range(steps):
                t0 = time.perf_counter()
                engine.train_batch(batch)
                wall.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            ms = float(np.median(wall))
            busy, kinds = profile_train(engine, batch, ms,
                                        label=f"long step, {label} bs")
        log(f"time: long {label} block_sparse step_ms={ms:.3f} "
            f"busy_ms={busy:.3f} "
            f"block_sparse_ms={kinds['block_sparse_attention']:.3f}")


def ab_generate(old, cfg, params):
    """The generate leg's prefill and decode step profiled under the
    parent's flash forward (``old``) and this one, in the order parent,
    new, new, parent."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    rng = np.random.default_rng(7)
    ids = torch.as_tensor(rng.integers(1, 32000, (GEN_BATCH, GEN_PROMPT)),
                          device="cuda")
    libs = {"parent": old, "new": tfa._lib()}
    for label in AB_ORDER:
        with _using(tfa, "_lib", libs[label]):
            profile_generate(cfg, params, ids, tag=f", {label} fwd")


def ab_flash_bwd(old, fb):
    """The parent's flash backward kernels (library ``old``) against these
    on the train leg's call, one step's 44 launches of each, device ms in
    the order parent, new, new, parent, beside SDPA's backward and the
    bounds of ``fb`` (time_flash_attention_bwd's readings); and the
    parent's outputs against these on the same inputs."""
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    q, k, v, do, o, lse, delta = _bwd_inputs(8)
    n = LLAMA_LAYERS * TRAIN_GAS
    libs = {"parent": old, "new": tfa._bwd_lib()}
    fns = {"dq": lambda: tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
           "dkv": lambda: tfa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta)}
    mine = (fns["dq"](),) + fns["dkv"]()
    theirs = _under_bwd(old, lambda: (fns["dq"](),) + fns["dkv"]())
    diff = {g: _max_err(a, b) for g, a, b in zip(("dq", "dk", "dv"),
                                                  mine, theirs)}
    log(f"time: flash_attention_bwd parent vs new max_abs_diff="
        f"{json.dumps(diff)}")
    res = {g: {label: [] for label in libs} for g in fns}
    for label in AB_ORDER:
        for g, fn in fns.items():
            res[g][label].append(_under_bwd(libs[label], lambda: device_ms(
                lambda: [fn() for _ in range(n)])))
    mean = {g: {label: sum(r) / len(r) for label, r in res[g].items()}
            for g in fns}
    for g, name in (("dq", "flash_attention_bwd_dq"),
                    ("dkv", "flash_attention_bwd_dkv")):
        log(f"time: {name} parent vs new ms={json.dumps(res[g])} "
            f"new_over_parent={mean[g]['new'] / mean[g]['parent']:.3f} "
            f"library_ms={fb[name]['library_ms']:.4f} "
            f"bound_ms={fb[name]['bound_ms']:.4f} [one train step: {n} "
            "launches]")
    # the pair's ms a step: dq + dk/dv, each the mean of its readings
    pair = {label: mean["dq"][label] + mean["dkv"][label] for label in libs}
    lib_ms = fb["flash_attention_bwd_dq"]["library_ms"]
    log(f"time: flash_attention_bwd pair ms={json.dumps(pair)} over "
        f"sdpa_bwd=" + json.dumps({k: round(v / lib_ms, 3)
                                   for k, v in pair.items()})
        + f" sdpa_bwd_ms={lib_ms:.4f}")
    del q, k, v, do, o, lse, delta, mine, theirs


def ab_train(engine, batch, old, which="bwd", steps=3):
    """The train leg's step under the parent's flash kernels (library
    ``old``: the backward pair, or with ``which="fwd"`` the forward) and
    under these, in the order parent, new, new, parent: the median wall ms
    of ``steps`` steps and one profiled step's device busy ms and flash
    kernel ms."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    attr = "_bwd_lib" if which == "bwd" else "_lib"
    libs = {"parent": old, "new": getattr(tfa, attr)()}
    for label in AB_ORDER:

        def run():
            wall = []
            for _ in range(steps):
                t0 = time.perf_counter()
                engine.train_batch(batch)       # ends in a host read
                wall.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            ms = float(np.median(wall))
            busy, kinds = profile_train(engine, batch, ms,
                                        label=f"train step, {label} {which}")
            return ms, busy, kinds["flash_attention"]
        with _using(tfa, attr, libs[label]):
            ms, busy, flash = run()
        log(f"time: train {label} flash {which} step_ms={ms:.3f} "
            f"busy_ms={busy:.3f} flash_ms={flash:.3f}")


def time_block_sparse_attention():
    """One long-leg train step's block-sparse attention: 22 layers x 2
    micro-batches = 44 launches of each kernel at [1, 32, 4096, 64] bf16
    with the leg's layout. The bound counts the live (q, k) pairs of the
    dense layout-and-causal mask: 4 D flops a pair for the forward, 6 D for
    dq and 8 D for dk/dv, against the bytes of each input read once and
    each output written once. plain_ms: the plain forward, and the plain
    backward (dq, dk and dv together); library_ms: SDPA with the dense
    [1, 1, S, S] bool mask, its forward, and its backward (dq, dk and dv
    together), each per step; flex_ms: torch's flex_attention with the
    layout as a block mask, where it compiles (timed only)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    H, S, D, n = 32, LONG_SEQ, 64, LLAMA_LAYERS * 2
    cfg = tsa.build_sparsity_config(num_heads=H, **SPARSE_SECTION)
    layout, fine = tsa.config_layout(cfg, S), cfg.block
    kw = {"causal": True}
    g = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, do = (torch.randn(1, H, S, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, fine, **kw)
    delta = (do.float() * o.float()).sum(-1)
    sched = tbs.schedule(layout, fine, S, device="cuda", **kw)
    keep = sched.keep("cuda")
    pairs = int(keep.sum())                         # live (q, k) pairs, B=1
    nT = sched.visited.shape[1]
    log(f"time: block_sparse tiles visited={sched.n_tiles} "
        f"live={int(tbs.coarse_layout(layout, fine, S).sum())} "
        f"causal={H * nT * (nT + 1) // 2} all={H * nT * nT} "
        f"live_pairs={pairs} causal_pairs={H * S * (S + 1) // 2} "
        f"share={pairs / (H * S * (S + 1) / 2):.4f}")
    t1 = time.perf_counter()
    for _ in range(n):                  # the cache key hashes the layout
        tbs.schedule(layout, fine, S, device="cuda", **kw)
    log(f"time: block_sparse schedule cache hit "
        f"{1e6 * (time.perf_counter() - t1) / n:.1f} us a call on the host "
        f"({n} calls a long step)")

    def step(fn):
        return lambda: [fn() for _ in range(n)]

    mask = keep[:1][None]                           # one layout for all heads
    if not bool((keep == keep[:1]).all()):
        fail("the long leg's layout differs across heads")
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    lib_fwd = device_ms(step(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)))
    lib_bwd = device_ms(step(lambda: torch.autograd.grad(
        so, (qs, ks, vs), do, retain_graph=True)))
    plain_fwd = device_ms(step(lambda: tbs.block_sparse_attention_reference(
        q, k, v, layout, fine, **kw)), reps=2)
    plain_bwd = device_ms(step(
        lambda: tbs.block_sparse_attention_bwd_reference(
            q, k, v, do, lse, delta, layout, fine, **kw)), reps=2)
    flex = _flex_ms(q, k, v, do, keep[0], n)
    elem = H * S * D * 2                            # one bf16 [1, H, S, D]
    rows = H * S * 4                                # one f32 [1, H, S]
    out = {}
    for name, fn, nbytes, flops, plain, lib in (
            ("block_sparse_attention_fwd",
             lambda: tbs.block_sparse_attention_fwd(q, k, v, layout, fine,
                                                    **kw),
             4 * elem + rows, 4 * D * pairs, plain_fwd, lib_fwd),
            ("block_sparse_attention_bwd_dq",
             lambda: tbs.block_sparse_attention_bwd_dq(
                 q, k, v, do, lse, delta, layout, fine, **kw),
             5 * elem + 2 * rows, 6 * D * pairs, plain_bwd, lib_bwd),
            ("block_sparse_attention_bwd_dkv",
             lambda: tbs.block_sparse_attention_bwd_dkv(
                 q, k, v, do, lse, delta, layout, fine, **kw),
             6 * elem + 2 * rows, 8 * D * pairs, plain_bwd, lib_bwd)):
        bnd, by = bound_ms(n * nbytes, n * flops)
        out[name] = {"ms": device_ms(step(fn)), "plain_ms": plain,
                     "library_ms": lib, "wall_ms": wall_ms(step(fn)),
                     "bound_ms": bnd, "bound_by": by,
                     "bound_bytes_ms": 1e3 * n * nbytes / HBM_BYTES_S,
                     "bound_ops_ms": 1e3 * n * flops / BF16_FLOPS,
                     "flex_ms": flex["fwd" if name.endswith("fwd")
                                     else "bwd"],
                     "work": f"one long step: {n} launches ({LLAMA_LAYERS} "
                             f"layers x 2 micro), B=1, H={H}, S={S}, D={D}, "
                             f"fixed layout block {fine}, causal, bf16; "
                             "backward plain, library and flex compute dq, "
                             "dk and dv together"}
    del q, k, v, do, o, lse, delta, qs, ks, vs, so, keep, mask
    torch.cuda.empty_cache()
    return out


def _scaling_layouts(H):
    """{name: (sparsity config, kernel options)} of the four layouts the
    block-sparse kernels are timed over."""
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    uni = dict(attention="unidirectional")
    win = -(-(WINDOW - 1) // 64) + 1
    return {
        "fixed-64 (long leg)": (tsa.FixedSparsityConfig(
            num_heads=H, block=64, **uni), {"causal": True}),
        f"window {WINDOW} (window leg)": (
            tsa.LocalSlidingWindowSparsityConfig(
                num_heads=H, block=64, num_sliding_window_blocks=win),
            {"causal": True, "window": WINDOW, "layout_exact": False}),
        "fixed-16": (tsa.FixedSparsityConfig(num_heads=H, block=16, **uni),
                     {"causal": True}),
        "dense causal": (tsa.DenseSparsityConfig(num_heads=H, block=64),
                         {"causal": True}),
    }


def time_block_sparse_scaling():
    """The three block-sparse kernels, and the flash kernels, at the long
    leg's shape [1, 32, 4096, 64] bf16 causal, 44 launches each (one long
    step's worth), over four layouts: the leg's (fixed, block 64, 640 of
    2080 causal tiles a head), the window leg's (W 1024, 952 tiles, no
    layout lookup), DeepSpeed's default block of 16 (fixed, every causal
    tile visited, each with the per-element layout lookup) and a dense
    causal layout (2080 tiles, the flash kernels' work). Device ms per 44
    launches; a yardstick for where the time goes, not a check."""
    import torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    H, S, D, n = 32, LONG_SEQ, 64, LLAMA_LAYERS * 2
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, do = (torch.randn(1, H, S, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    out = {}
    for name, (cfg, kw) in _scaling_layouts(H).items():
        layout, fine = tsa.config_layout(cfg, S), cfg.block
        sched = tbs.schedule(layout, fine, S, device="cuda", **kw)
        o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, fine, **kw)
        delta = (do.float() * o.float()).sum(-1)
        row = {"tiles": sched.n_tiles,
               "masked_tiles": int((sched.flags[sched.visited] != 0).sum())}
        for kname, fn in (
                ("fwd", lambda: tbs.block_sparse_attention_fwd(
                    q, k, v, layout, fine, **kw)),
                ("dq", lambda: tbs.block_sparse_attention_bwd_dq(
                    q, k, v, do, lse, delta, layout, fine, **kw)),
                ("dkv", lambda: tbs.block_sparse_attention_bwd_dkv(
                    q, k, v, do, lse, delta, layout, fine, **kw))):
            row[kname] = device_ms(lambda: [fn() for _ in range(n)], reps=3)
        out[name] = row
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    out["flash (dense causal)"] = {
        kname: device_ms(lambda: [fn() for _ in range(n)], reps=3)
        for kname, fn in (
            ("fwd", lambda: tfa.flash_attention_fwd(q, k, v, causal=True)),
            ("dq", lambda: tfa.flash_attention_bwd_dq(q, k, v, do, lse,
                                                      delta)),
            ("dkv", lambda: tfa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                        delta)))}
    log(f"time: block_sparse scaling, device ms per {n} launches at "
        f"[1, {H}, {S}, {D}] bf16 causal: "
        + json.dumps({k: {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                          for kk, vv in r.items()} for k, r in out.items()}))
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return out


ITEM_COSTS = (0, 1, 2, 3, 4, 6, 8)


def sweep_item_cost():
    """The per-item cost of the query side's host balance (``ITEM_COST["q"]``
    of ops/block_sparse_attention.py: the forward's and dq's items) swept
    over ITEM_COSTS at the long leg's call, 44 launches of [1, 32, 4096,
    64] bf16 with the leg's layout: each kernel's device ms at each cost
    (the costs in order, then back) and the costliest CTA's list in tiles
    and items."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops import sparse_attention as tsa
    H, S, D, n = 32, LONG_SEQ, 64, LLAMA_LAYERS * 2
    cfg = tsa.build_sparsity_config(num_heads=H, **SPARSE_SECTION)
    layout, fine, kw = tsa.config_layout(cfg, S), cfg.block, {"causal": True}
    g = torch.Generator(device="cuda").manual_seed(15)
    q, k, v, do = (torch.randn(1, H, S, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, fine, **kw)
    delta = (do.float() * o.float()).sum(-1)
    sched = tbs.schedule(layout, fine, S, device=q.device, **kw)
    fns = {"fwd": lambda: tbs.block_sparse_attention_fwd(
               q, k, v, layout, fine, **kw),
           "dq": lambda: tbs.block_sparse_attention_bwd_dq(
               q, k, v, do, lse, delta, layout, fine, **kw)}
    own = tbs.ITEM_COST["q"]
    ms = {kernel: {c: [] for c in ITEM_COSTS} for kernel in fns}
    worst = {}
    tiles = sched.visited.sum(2).reshape(-1)
    for c in ITEM_COSTS + ITEM_COSTS[::-1]:
        tbs.ITEM_COST["q"] = c
        ptr, items = (t.cpu().numpy() for t in sched.cta_slots(
            "q", build.sm_count(q.device)))
        per = np.add.reduceat(tiles[items], ptr[:-1]) * (np.diff(ptr) > 0)
        w = int(np.argmax(per + c * np.diff(ptr)))
        worst[c] = {"tiles": int(per[w]), "items": int(np.diff(ptr)[w])}
        for kernel, fn in fns.items():
            ms[kernel][c].append(device_ms(
                lambda: [fn() for _ in range(n)], reps=3))
    tbs.ITEM_COST["q"] = own
    log(f"time: block_sparse item cost sweep, device ms per {n} launches "
        f"at [1, {H}, {S}, {D}] bf16, the long leg's layout (B=1: an item "
        "a (head, query tile)): "
        + json.dumps({kernel: {c: [round(x, 4) for x in r]
                               for c, r in by.items()}
                      for kernel, by in ms.items()})
        + f" costliest_cta={json.dumps(worst)} [in use: {own}]")
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()


def _flex_ms(q, k, v, do, keep, n):
    """flex_attention (torch.compile'd) with the layout as a block mask:
    forward and backward ms per step of n calls, or None where it does not
    compile on this card (a yardstick only: the port never calls it)."""
    import torch
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        live = keep

        def mask_mod(b, h, qi, ki):
            return live[qi, ki]

        S = q.shape[2]
        bm = create_block_mask(mask_mod, 1, 1, S, S, device="cuda")
        fx = torch.compile(flex_attention)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        so = fx(qs, ks, vs, block_mask=bm)
        fwd = device_ms(lambda: [fx(q, k, v, block_mask=bm)
                                 for _ in range(n)], reps=3)
        bwd = device_ms(lambda: [torch.autograd.grad(
            so, (qs, ks, vs), do, retain_graph=True) for _ in range(n)],
            reps=3)
        return {"fwd": fwd, "bwd": bwd}
    except Exception as e:          # a yardstick that does not build
        log(f"time: flex_attention did not run here: {type(e).__name__}: "
            f"{str(e)[:200]}")
        return {"fwd": None, "bwd": None}


# ------------------------------------------------------ 9. checkpoints

CKPT_TRAIN_STEPS, CKPT_RESUME_STEPS = 2, 3
CKPT_SMALL_LAYERS = 1               # the resilience leg's depth cut
# the tag's depth: 8 of llama-1.1b's 22 layers (6.8 of its 15.4 GB), so
# the whole script keeps inside its time limit with the pp leg
# a depth cut to 2 of 22 layers: the script's time limit and the 45 GiB
# cap on what one run may write to the card host's disk
CKPT_LAYERS = 2
CKPT_BYTES_PER_PARAM = 14           # bf16 params + f32 master, m and v
CKPT_LENS = (96, 200, 352, 512)     # the served leg's prompts
CKPT_NEW = 16


def _train_engine(tmp, name, config, seed, **model_kw):
    """initialize(JSON ds_config) on llama-1.1b at full width (seeded f32
    weights), as the train leg builds it."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import build_model
    model, cfg = build_model("llama-1.1b", fused_loss=True, loss_chunk=256,
                             seed=seed, device="cuda", **model_kw)
    path = os.path.join(tmp, f"ds_{name}.json")
    with open(path, "w") as f:
        json.dump(config, f)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=path)
    return engine, cfg


def _ckpt_batch(vocab, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, vocab,
                                      (TRAIN_MICRO * TRAIN_GAS, TRAIN_SEQ))}


def _ckpt_step(engine, batch, label):
    """One train_batch, held to the train leg's flash launches."""
    import numpy as np
    _zero_counters()
    m = engine.train_batch(batch)
    c = _counters()
    per_step = engine.module.cfg.num_layers * TRAIN_GAS
    if any(c[k] != per_step for k in FLASH_KERNELS):
        fail(f"ckpt: {label} launched {c}: expected {per_step} of each "
             "flash kernel")
    if not np.isfinite(m["loss"]) or m["overflow"]:
        fail(f"ckpt: {label}: {m}")
    return m, c


def _differing_leaves(a, b):
    """Paths of the two engines' checkpoint leaves (parameters, master,
    moments) that differ bitwise."""
    import torch
    bad = []
    for la, lb in zip(a._ckpt_leaves(), b._ckpt_leaves()):
        for path in (la or {}):
            pa, pb = la[path].parts, lb[path].parts
            if len(pa) != len(pb) or not all(
                    x.dtype == y.dtype and torch.equal(x, y)
                    for x, y in zip(pa, pb)):
                bad.append(path)
    return bad


def _tag_bytes(tag_dir):
    return {n: os.path.getsize(os.path.join(tag_dir, n))
            for n in sorted(os.listdir(tag_dir))}


def phase_ckpt(tmp):
    """Checkpoints on the train leg's model and config (llama-1.1b, bf16 +
    fp32 master, AdamW, WarmupLR, ZeRO 1, micro 2 x gas 2, seq 1024): two
    steps, a sync save (bytes, seconds, GB/s, the digest pass timed
    apart); a fresh engine from another seed loads it (tag=None, verified)
    and must hold every parameter, master and moment bitwise; both engines
    then take the same 3 steps, whose losses must agree within 1e-6
    relative, each step launching the flash kernels as the train leg does.
    The state is then served from the checkpoint (:func:`_ckpt_served`)
    and the resilience leg runs at a CKPT_SMALL_LAYERS cut
    (:func:`_ckpt_resilience`). CKPT_LAYERS deep (2 of llama-1.1b's 22:
    the script's time limit and the card host's disk-write cap),
    less if the temp dir cannot hold the tag (the depth is cut, never the
    width, and a line says so)."""
    import shutil
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.convert import scan_params
    from deepspeed_tpu_torch.runtime import checkpointing as ck
    from deepspeed_tpu_torch.models.transformer import get_config
    full = get_config("llama-1.1b")
    per_layer = CKPT_BYTES_PER_PARAM * (
        full.hidden_size * (full.num_heads + 2 * full.kv_heads) * full.head_dim
        + full.num_heads * full.head_dim * full.hidden_size
        + 3 * full.hidden_size * full.mlp_dim + 2 * full.hidden_size)
    rest = CKPT_BYTES_PER_PARAM * (2 * full.vocab_size * full.hidden_size
                                   + full.hidden_size)
    free = shutil.disk_usage(tmp).free
    # the full tag, the 16-bit file and three small tags at once
    need_small = 3 * (rest + CKPT_SMALL_LAYERS * per_layer) + rest // 7
    layers = min(CKPT_LAYERS, int((free - need_small - rest) // per_layer))
    log(f"ckpt: temp dir free_gb={free / 1e9:.1f} full_tag_gb="
        f"{(rest + LLAMA_LAYERS * per_layer) / 1e9:.2f} layers={layers}"
        + ("" if layers == LLAMA_LAYERS else
           f" (depth cut from {LLAMA_LAYERS}: "
           + ("the script's time limit" if layers == CKPT_LAYERS else
              "the temp dir cannot hold the tag") + ")"))
    if layers < CKPT_SMALL_LAYERS:
        fail(f"ckpt: {free / 1e9:.1f} GB free in {tmp}")
    over = {} if layers == LLAMA_LAYERS else {"num_layers": layers}
    a, cfg = _train_engine(tmp, "ckpt", TRAIN_CONFIG, 0, **over)
    for s in range(CKPT_TRAIN_STEPS):
        _ckpt_step(a, _ckpt_batch(cfg.vocab_size, 40 + s), f"step {s}")
    d = os.path.join(tmp, "ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tag_dir = a.save_checkpoint(d)
    save_s = time.perf_counter() - t0
    sizes = _tag_bytes(tag_dir)
    nbytes = sum(sizes.values())
    t0 = time.perf_counter()
    for name in sizes:
        ck.file_digest(os.path.join(tag_dir, name))
    digest_s = time.perf_counter() - t0
    log(f"ckpt: save layers={cfg.num_layers} tag={os.path.basename(tag_dir)}"
        f" bytes={nbytes} files={json.dumps(sizes)} save_s={save_s:.3f} "
        f"save_gb_s={nbytes / save_s / 1e9:.3f} digest_s={digest_s:.3f} "
        f"(one sha256 pass over the tag, inside save_s too)")
    b, _ = _train_engine(tmp, "ckpt", TRAIN_CONFIG, 1, **over)
    if not _differing_leaves(a, b):
        fail("ckpt: engines from two seeds already agree")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.load_checkpoint(d)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reason = ck.verify_tag(tag_dir, check_digests=True)
    verify_s = time.perf_counter() - t0
    bad = _differing_leaves(a, b)
    log(f"ckpt: load (tag=None, verify_load) load_s={load_s:.3f} "
        f"load_gb_s={nbytes / load_s / 1e9:.3f} verify_s={verify_s:.3f} "
        f"(the digest check, inside load_s too) verify={reason} "
        f"leaves_bitwise_equal={not bad} step={b.step_count} "
        f"global_steps={b.global_steps} lr={b.get_lr()[0]:.6e}")
    if bad or reason is not None:
        fail(f"ckpt: restored state differs from the saved one: {bad[:5]}")
    if (b.step_count, b.global_steps, b.data_position, b.get_lr()) != \
            (a.step_count, a.global_steps, a.data_position, a.get_lr()):
        fail(f"ckpt: counters differ after the load: {b.step_count} "
             f"{b.global_steps} {b.get_lr()} vs {a.step_count} "
             f"{a.global_steps} {a.get_lr()}")
    worst, resumed = 0.0, {}
    for s in range(CKPT_RESUME_STEPS):
        batch = _ckpt_batch(cfg.vocab_size, 50 + s)
        ma, ca = _ckpt_step(a, batch, f"uninterrupted step {s}")
        mb, cb = _ckpt_step(b, batch, f"resumed step {s}")
        resumed = {k: resumed.get(k, 0) + n for k, n in cb.items()}
        rel = abs(ma["loss"] - mb["loss"]) / abs(ma["loss"])
        worst = max(worst, rel)
        log(f"ckpt: step {CKPT_TRAIN_STEPS + s} loss uninterrupted="
            f"{ma['loss']:.7f} resumed={mb['loss']:.7f} rel={rel:.3e} "
            f"grad_norm={ma['grad_norm']:.6f}/{mb['grad_norm']:.6f} "
            f"lr={ma['lr']:.6e}/{mb['lr']:.6e} launches={json.dumps(cb)}")
        if ma["lr"] != mb["lr"]:
            fail("ckpt: the resumed schedule differs")
    log(f"ckpt: resumed losses max_rel_diff={worst:.3e} tol=1e-6 "
        f"bitwise={worst == 0.0}")
    if worst > 1e-6:
        fail(f"ckpt: resumed losses differ by {worst:.3e}")
    del a
    torch.cuda.empty_cache()
    path16 = b.save_16bit_model(os.path.join(tmp, "model16"))
    params = scan_params(b.module)
    del b
    torch.cuda.empty_cache()
    served = _ckpt_served(cfg, params, path16)
    del params
    os.remove(path16)
    shutil.rmtree(d)
    torch.cuda.empty_cache()
    small = _ckpt_resilience(tmp)
    launches = {"resumed_steps": resumed, **served.pop("launches")}
    return {"layers": cfg.num_layers, "tag_bytes": nbytes, "save_s": save_s,
            "digest_s": digest_s, "load_s": load_s, "verify_s": verify_s,
            "resume_max_rel": worst, "launches": launches, **served,
            **small}


def _ckpt_served(cfg, params, path16):
    """``save_16bit_model``'s file served: int8 ``serve()`` (weights and KV
    cache in int8) of 4 greedy requests from an engine whose seeded
    weights ``load_checkpoint(path16)`` replaces, against the engine given
    the same weights in memory (tokens identical; the file engine's run
    launches paged_attention and quant_matmul); then a bf16 engine's
    ``generate()`` (flash prefill, decode steps), and a ``dtype: "int8"``
    engine's logits, the same way."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import init_params
    init = deepspeed_tpu_torch.init_inference
    other = init_params(cfg, torch.Generator(device="cuda").manual_seed(9))
    serving = dict(SERVING, kv_cache_dtype="int8", weight_dtype="int8")
    rng = np.random.default_rng(60)
    prompts = [list(rng.integers(1, cfg.vocab_size, n)) for n in CKPT_LENS]
    tokens, counts = {}, {}
    t0 = time.perf_counter()
    from_file = init(cfg, {"dtype": "bf16"},
                     model_parameters=other).load_checkpoint(path16)
    torch.cuda.synchronize()
    load16_s = time.perf_counter() - t0
    for name, eng in (("memory", init(cfg, {"dtype": "bf16"},
                                      model_parameters=params)),
                      ("file", from_file)):
        srv = eng.serve(serving)
        _zero_counters()
        tokens[name] = [r.output_tokens for r in
                        _run_requests(srv, prompts, CKPT_NEW)]
        counts[name] = _counters()
        del srv
    log(f"ckpt: int8 serve from the 16-bit file load_s={load16_s:.3f} "
        f"requests={len(prompts)} tokens_equal="
        f"{tokens['file'] == tokens['memory']} launches="
        f"{json.dumps(counts['file'])}")
    if tokens["file"] != tokens["memory"]:
        fail("ckpt: int8 serve from the checkpoint gave other tokens")
    if counts["file"]["paged_attention"] <= 0 or \
            counts["file"]["quant_matmul"] <= 0:
        fail(f"ckpt: the int8 serve launched {counts['file']}")
    serve_counts = counts["file"]
    ids = torch.as_tensor(rng.integers(1, cfg.vocab_size, (4, 256)),
                          device="cuda")
    outs = {}
    for name, eng in (("memory", init(cfg, {"dtype": "bf16"},
                                      model_parameters=params)),
                      ("file", from_file)):
        _zero_counters()
        outs[name] = eng.generate(ids, max_new_tokens=CKPT_NEW)
        counts[name] = _counters()
    L = cfg.num_layers
    log(f"ckpt: bf16 generate from the 16-bit file tokens_equal="
        f"{torch.equal(outs['file'], outs['memory'])} launches="
        f"{json.dumps(counts['file'])}")
    if not torch.equal(outs["file"], outs["memory"]):
        fail("ckpt: generate from the checkpoint gave other tokens")
    if counts["file"]["flash_attention_fwd"] != L or \
            counts["file"]["decode_attention"] != L * (CKPT_NEW - 1):
        fail(f"ckpt: generate from the checkpoint launched {counts['file']}")
    q_mem = init(cfg, {"dtype": "int8"}, model_parameters=params)
    q_file = init(cfg, {"dtype": "int8"},
                  model_parameters=other).load_checkpoint(path16)
    logits = [e.forward(ids[:2, :64]) for e in (q_mem, q_file)]
    log(f"ckpt: dtype int8 engine from the 16-bit file logits_equal="
        f"{torch.equal(*logits)}")
    if not torch.equal(*logits):
        fail("ckpt: the re-quantized int8 engine's logits differ")
    return {"launches": {"int8_serve": serve_counts,
                         "bf16_generate": counts["file"]},
            "load16_s": load16_s}


def _ckpt_resilience(tmp):
    """At a CKPT_SMALL_LAYERS cut of llama-1.1b (full width): the async
    writer saves three tags with keep_last=2 and commits; the newest tag's
    model_states.npz is truncated; a fresh engine's load_checkpoint
    (tag=None) rolls back to the previous tag and repairs ``latest``;
    inspect_checkpoint summarizes it; the zero_to_fp32 CLI's output
    equals the resumed engine's fp32 master bitwise."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.checkpoint import inspect_checkpoint
    from deepspeed_tpu_torch.runtime import checkpointing as ck
    cut = {"num_layers": CKPT_SMALL_LAYERS}
    conf = dict(TRAIN_CONFIG, checkpoint={"async_save": True, "keep_last": 2})
    e, cfg = _train_engine(tmp, "ckpt_async", conf, 0, **cut)
    d = os.path.join(tmp, "ckpt_small")
    t0 = time.perf_counter()
    for s in range(3):
        _ckpt_step(e, _ckpt_batch(cfg.vocab_size, 70 + s),
                   f"small-cut step {s}")
        e.save_checkpoint(d)
    res = e.wait_for_checkpoints()
    async_s = time.perf_counter() - t0
    tags = ck.list_tags(d)
    log(f"ckpt: async keep_last=2 commit={res!r} tags={tags} "
        f"latest={ck.get_latest_tag(d)} wall_s={async_s:.3f}")
    if not res or tags != ["global_step2", "global_step3"]:
        fail(f"ckpt: async saves gave {res!r}, tags {tags}")
    if not e.close():
        fail("ckpt: closing the async writer failed")
    npz = os.path.join(d, "global_step3", "model_states.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    f_eng, _ = _train_engine(tmp, "ckpt", TRAIN_CONFIG, 1, **cut)
    f_eng.load_checkpoint(d)
    latest = ck.get_latest_tag(d)
    log(f"ckpt: truncated global_step3 -> resumed global_steps="
        f"{f_eng.global_steps} latest={latest}")
    if f_eng.global_steps != 2 or latest != "global_step2":
        fail("ckpt: no rollback over the truncated tag")
    summary = inspect_checkpoint(d)
    log(f"ckpt: inspect_checkpoint {json.dumps(summary)}")
    n_params = sum(p.numel() for p in f_eng.module.parameters())
    if summary["step"] != 2 or summary["num_parameters"] != n_params:
        fail(f"ckpt: inspect_checkpoint gave {summary}")
    out = os.path.join(tmp, "fp32.npz")
    env = dict(os.environ, PYTHONPATH=HERE)
    run = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.utils.zero_to_fp32", d,
         out], cwd=HERE, env=env, capture_output=True, text=True,
        timeout=600)
    if run.returncode != 0:
        fail(f"ckpt: zero_to_fp32 exited {run.returncode}: {run.stderr}")
    master = ck.consolidated_fp32_state_dict(f_eng._ckpt_state())
    with np.load(out) as z:
        same = sorted(z.files) == sorted(master) and all(
            np.array_equal(z[k], v) for k, v in master.items())
    log(f"ckpt: zero_to_fp32 {run.stdout.strip()} equals_master={same}")
    if not same:
        fail("ckpt: zero_to_fp32's output differs from the fp32 master")
    del e, f_eng
    torch.cuda.empty_cache()
    return {"async_s": async_s}


# ---------------------------------------------------------- 10. remat

REMAT_POLICIES = (None, "dots", "attn", "full")
REMAT_TIMED_STEPS = 3
REMAT_LAYERS = 6            # depth cut 22 -> 6 (the script's time limit)


def phase_remat(tmp):
    """llama-1.1b at full width, REMAT_LAYERS deep, with the train leg's
    config, one engine per block policy (remat off, "dots", "attn",
    "full"), each from
    the same seeded weights. The first step runs through the micro-batch
    API: the memory the first micro-batch's forward holds for its backward
    and the peak of its forward + backward (both above the engine's
    state), the step's own peak (the optimizer's temporaries included),
    its loss and grad norm against remat off (within 1e-5 relative,
    bitwise expected) and the flash launches (the forward layers x gas,
    twice that under "full", whose backward recomputes it; each backward
    kernel layers x gas).
    Then the median wall ms of REMAT_TIMED_STEPS train_batch steps, and
    one profiled step's device busy ms and time by kind."""
    import numpy as np
    import torch
    out, ref = {}, None
    b1, b2 = (_ckpt_batch(32000, s) for s in (80, 81))
    micros = [{"input_ids": b1["input_ids"][i * TRAIN_MICRO:
                                            (i + 1) * TRAIN_MICRO]}
              for i in range(TRAIN_GAS)]
    for policy in REMAT_POLICIES:
        kw = ({} if policy is None else
              {"remat": True, "remat_policy": policy})
        # a trained engine is freed only by the cycle collector: collect
        # now, or an earlier leg's state is freed during this forward and
        # the held memory reads low
        gc.collect()
        torch.cuda.empty_cache()
        e, cfg = _train_engine(tmp, "remat", TRAIN_CONFIG, 0,
                               num_layers=REMAT_LAYERS, **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters()
        for i, micro in enumerate(micros):
            loss = e.forward(micro)
            if i == 0:
                held = torch.cuda.memory_allocated() - base
            e.backward(loss)
            if i == 0:
                fwd_bwd = torch.cuda.max_memory_allocated() - base
        m = e.step()
        c = _counters()
        peak = torch.cuda.max_memory_allocated() - base
        walls = []
        for _ in range(REMAT_TIMED_STEPS):
            t0 = time.perf_counter()
            e.train_batch(b2)                   # ends in a host read
            walls.append(1e3 * (time.perf_counter() - t0))
        step_ms = float(np.median(walls))
        busy, _ = profile_train(e, b2, step_ms,
                                label=f"remat {policy or 'off'} step")
        per = cfg.num_layers * TRAIN_GAS
        want = {"flash_attention_fwd": 2 * per if policy == "full" else per,
                "flash_attention_bwd_dq": per, "flash_attention_bwd_dkv": per}
        got = {k: c[k] for k in want}
        name = policy or "off"
        if ref is None:
            ref = m
        rl = abs(m["loss"] - ref["loss"]) / abs(ref["loss"])
        rn = abs(m["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
        out[name] = {"held_gb": held / 1e9, "fwd_bwd_peak_gb": fwd_bwd / 1e9,
                     "step_peak_gb": peak / 1e9, "state_gb": base / 1e9,
                     "step_ms": step_ms, "busy_ms": busy, "launches": got,
                     "loss_rel": rl, "grad_norm_rel": rn}
        log(f"remat: policy={name} state_gb={base / 1e9:.2f} "
            f"held_after_forward_gb={held / 1e9:.3f} "
            f"fwd_bwd_peak_gb={fwd_bwd / 1e9:.3f} "
            f"step_peak_gb={peak / 1e9:.3f} (above the state; one "
            f"micro-batch of {TRAIN_MICRO} x {TRAIN_SEQ}) step_ms="
            f"{step_ms:.1f} busy_ms={busy:.1f} loss={m['loss']:.7f} "
            f"rel={rl:.3e} grad_norm="
            f"{m['grad_norm']:.6f} rel={rn:.3e} bitwise="
            f"{(m['loss'], m['grad_norm']) == (ref['loss'], ref['grad_norm'])}"
            f" launches={json.dumps(got)}")
        if got != want:
            fail(f"remat {name}: launched {got}, expected {want}")
        if rl > 1e-5 or rn > 1e-5 or not np.isfinite(m["loss"]):
            fail(f"remat {name}: loss / grad norm off remat off's")
        del e, loss
        torch.cuda.empty_cache()
    held = [out[p]["held_gb"] for p in ("full", "attn", "dots", "off")]
    log(f"remat: held after the forward, GB, full/attn/dots/off: "
        f"{[round(x, 3) for x in held]}")
    if not held[0] < held[1] < held[2] < held[3]:
        fail("remat: the policies do not order full < attn < dots < off")
    return out


# ----------------------------------------------------------------- 12. zero

def _zero_engine(tmp, name, seed, config=None):
    """initialize(ds_zero3.json: ``config``, default ZERO_CONFIG) on
    gpt2-1.3b at full width, ZERO_LAYERS deep, seeded weights, "dots"
    remat and the fused chunked CE."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import build_model
    model, cfg = build_model("gpt2-1.3b", fused_loss=True, loss_chunk=256,
                             remat=True, remat_policy="dots", seed=seed,
                             device="cuda", num_layers=ZERO_LAYERS)
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(config or ZERO_CONFIG, f)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=path)
    return engine, cfg


def _zero_step(engine, batch, label):
    """One train_batch with the launch and collective counters zeroed
    just before it and read just after: 24 launches of each flash kernel
    a micro-batch ("dots" keeps the attention forward), and at least one
    all-gather a block in the forward and one in the backward's
    recomputation, and one reduce-scatter a block, all on NCCL."""
    import numpy as np
    import torch.distributed as dist
    from deepspeed_tpu_torch import comm
    _zero_counters()
    comm.reset_op_counts()
    t0 = time.perf_counter()
    m = engine.train_batch(batch)           # ends in a host read
    dt = time.perf_counter() - t0
    c, ops = _counters(), comm.op_counts()
    per = ZERO_LAYERS * ZERO_GAS
    if any(c[k] != per for k in FLASH_KERNELS):
        fail(f"zero: {label} launched {c}: expected {per} of each flash "
             "kernel")
    if (dist.get_backend() != "nccl" or ops.get("all_gather", 0) < 2 * per
            or ops.get("reduce_scatter", 0) < per):
        fail(f"zero: {label} issued {ops} on {dist.get_backend()}: "
             f"expected NCCL, >= {2 * per} all-gathers and >= {per} "
             "reduce-scatters")
    if not np.isfinite(m["loss"]) or m["overflow"]:
        fail(f"zero: {label}: {m}")
    return m, dt, {k: c[k] for k in FLASH_KERNELS}, ops


def _zero_state(engine):
    """Every live tensor of a data-parallel engine: parameter shards,
    master slabs and moments."""
    return ([p.data for p in engine._params] + list(engine.dp.masters)
            + [t for slot in sorted(engine.opt_state)
               for t in engine.opt_state[slot]])


def time_flash_d128():
    """The zero leg's attention at D 128 (gpt2-1.3b: 16 heads of 128, B
    2, S = Sk = 1024, causal, bf16): one step's ZERO_LAYERS x ZERO_GAS
    launches of each kernel, beside SDPA's forward and backward on the
    same inputs and the bounds."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    n = ZERO_LAYERS * ZERO_GAS
    q, k, v, do, o, lse, delta = _bwd_inputs(12, H=16, D=128)
    B, H, S, D = q.shape

    def step(fn):
        return lambda: [fn() for _ in range(n)]

    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib_bwd = device_ms(step(lambda: torch.autograd.grad(
        so, (qs, ks, vs), do, retain_graph=True)))
    lib_fwd = device_ms(step(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True)))
    plain_fwd = device_ms(step(lambda: tfa.flash_attention_reference(
        q, k, v, causal=True)), reps=2)
    plain_bwd = device_ms(step(lambda: tfa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=True)), reps=2)
    pairs = B * H * S * (S + 1) // 2             # live (q, k) pairs, causal
    elem = B * H * S * D * 2                     # one bf16 [B, H, S, D]
    rows = B * H * S * 4                         # one f32 [B, H, S]
    out = {}
    for name, fn, nbytes, flops, plain, lib in (
            ("flash_attention_fwd",
             lambda: tfa.flash_attention_fwd(q, k, v, causal=True),
             4 * elem + rows, 4 * D * pairs, plain_fwd, lib_fwd),
            ("flash_attention_bwd_dq",
             lambda: tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
             5 * elem + 2 * rows, 6 * D * pairs, plain_bwd, lib_bwd),
            ("flash_attention_bwd_dkv",
             lambda: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
             6 * elem + 2 * rows, 8 * D * pairs, plain_bwd, lib_bwd)):
        bnd, by = bound_ms(n * nbytes, n * flops)
        out[name] = {"ms": device_ms(step(fn)), "plain_ms": plain,
                     "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                     "work": f"one zero step: {n} launches ({ZERO_LAYERS} "
                             f"layers x {ZERO_GAS} micro), B={B}, H={H}, "
                             f"S=Sk={S}, D={D}, causal, bf16; the backward's "
                             "plain and library calls compute dq, dk and "
                             "dv together"}
        t = out[name]
        log(f"time: zero d128 {name} ms={t['ms']:.4f} bound_ms="
            f"{bnd:.4f} ({by}) plain_ms={plain:.4f} library_ms={lib:.4f} "
            f"[{t['work']}]")
    del q, k, v, do, o, lse, delta, qs, ks, vs, so
    return out


def phase_zero(tmp):
    """bench.py's north-star leg through the port's ZeRO-3 path in a
    1-rank NCCL world: gpt2-1.3b at full width and depth (24 layers,
    hidden 2048, seeded weights), ZeRO stage 3, pure bf16 state, bf16
    grad accumulation, AdamW lr 1e-4, "dots" remat, the fused chunked CE,
    seq 1024, micro 2 (cut: gas 128 -> ZERO_GAS, ZERO_STEPS steps). First
    the same weights and batch through an engine without a process
    group: the first step's loss and grad norm must match within 1e-6
    relative. Then comm.init_distributed (NCCL, world 1) and ZERO_STEPS
    train_batch steps on one batch, each held to its flash launches and
    its NCCL all-gathers and reduce-scatters; the loss falls. One sharded
    save_checkpoint loads bitwise into a fresh engine and the next step's
    loss matches. Readings: step ms, tokens/s and model TFLOP/s (6N, and
    with attention), peak memory, the profiled step's device ms by kind
    and busy share, and the flash kernels at D 128."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import set_global_mesh
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    B = ZERO_MICRO * ZERO_GAS
    batch = {"input_ids": rng.integers(1, 50257, (B, ZERO_SEQ))}
    log(f"zero: gpt2-1.3b ZeRO-3 pure bf16, grad_accum bf16, dots remat, "
        f"fused CE, seq {ZERO_SEQ}, micro {ZERO_MICRO}; cut: gas 128 -> "
        f"{ZERO_GAS}, 5 x 128 micro-batches -> {ZERO_STEPS} steps of "
        f"{ZERO_GAS}")
    if comm.is_initialized():
        fail("zero: a process group is already up")
    ref_engine, _ = _zero_engine(tmp, "ds_zero3_ref", 0)
    _zero_counters()
    ref = ref_engine.train_batch(batch)
    if ref_engine.dp is not None:
        fail("zero: the reference engine ran data parallel")
    del ref_engine
    gc.collect()                # a trained engine sits in a reference cycle
    torch.cuda.empty_cache()
    comm.init_distributed(world_size=1, rank=0)
    try:
        engine, cfg = _zero_engine(tmp, "ds_zero3", 0)
        n_params = sum(int(np.prod(e.shape)) for e in engine.dp.entries)
        sharded = sum(e.gathered for e in engine.dp.entries)
        log(f"zero: backend={dist.get_backend()} world="
            f"{dist.get_world_size()} params={n_params} layers="
            f"{cfg.num_layers} hidden={cfg.hidden_size} gathered leaves="
            f"{sharded}/{len(engine.dp.entries)} "
            f"init_s={time.perf_counter() - t0:.2f} "
            f"mem_gb={torch.cuda.memory_allocated() / 1e9:.2f}")
        torch.cuda.reset_peak_memory_stats()
        metrics, step_s, launches, ops = [], [], None, None
        for step in range(ZERO_STEPS):
            m, dt, c, o = _zero_step(engine, batch, f"step {step}")
            metrics.append(m)
            step_s.append(dt)
            launches, ops = launches or c, ops or o
            log(f"zero: step {step} loss={m['loss']:.6f} grad_norm="
                f"{m['grad_norm']:.5f} step_ms={1e3 * dt:.1f} "
                f"launches={json.dumps(c)} collectives={json.dumps(o)}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        first = metrics[0]
        rl = abs(first["loss"] - ref["loss"]) / abs(ref["loss"])
        rn = abs(first["grad_norm"] - ref["grad_norm"]) / abs(
            ref["grad_norm"])
        bitwise = (first["loss"], first["grad_norm"]) == (
            ref["loss"], ref["grad_norm"])
        log(f"check: zero first step vs the engine without a process group "
            f"loss={first['loss']:.9f}/{ref['loss']:.9f} rel={rl:.3e} "
            f"grad_norm={first['grad_norm']:.9f}/{ref['grad_norm']:.9f} "
            f"rel={rn:.3e} tol=1e-6 bitwise={bitwise}")
        if not (rl <= 1e-6 and rn <= 1e-6):
            fail("zero: the sharded path's first step is off the "
                 "single-process engine's")
        log(f"zero: loss {[round(m['loss'], 6) for m in metrics]}")
        if not metrics[-1]["loss"] < metrics[0]["loss"]:
            fail(f"zero: loss did not fall {[m['loss'] for m in metrics]}")
        # one sharded save, loaded into a fresh engine of other weights
        ck = os.path.join(tmp, "zero_ck")
        t1 = time.perf_counter()
        engine.save_checkpoint(ck)
        save_s = time.perf_counter() - t1
        tag = os.path.join(ck, f"global_step{ZERO_STEPS}")
        files = sorted(os.listdir(tag))
        fresh, _ = _zero_engine(tmp, "ds_zero3_fresh", 1)
        t1 = time.perf_counter()
        fresh.load_checkpoint(ck)
        load_s = time.perf_counter() - t1
        same = all(torch.equal(a, b) for a, b in
                   zip(_zero_state(engine), _zero_state(fresh)))
        nxt = _zero_step(engine, batch, "next step")[0]
        nxt_fresh = _zero_step(fresh, batch, "resumed step")[0]
        log(f"zero: sharded save {save_s:.2f} s files={files} load "
            f"{load_s:.2f} s restored bitwise={same} next loss "
            f"{nxt['loss']:.9f} resumed {nxt_fresh['loss']:.9f}")
        if "model_states-shard0.npz" not in files or not same or \
                nxt["loss"] != nxt_fresh["loss"]:
            fail("zero: the sharded checkpoint did not restore the state")
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
        dt = float(np.median(step_s[1:]))
        tokens = B * ZERO_SEQ
        model_flops = 6.0 * n_params * tokens
        attn_flops = (12.0 * cfg.num_layers * cfg.hidden_size * ZERO_SEQ
                      * tokens)
        busy, by_kind = profile_train(engine, batch, 1e3 * dt,
                                      label="zero step")
        rates = {"step_ms": 1e3 * dt, "tokens_s": tokens / dt,
                 "model_tflops_6n": model_flops / dt / 1e12,
                 "model_tflops_with_attention":
                     (model_flops + attn_flops) / dt / 1e12,
                 "step_ms_all": [round(1e3 * x, 3) for x in step_s],
                 "peak_mem_gb": peak_gb, "busy_ms": busy,
                 "device_ms_by_kind": by_kind,
                 "idle_share": 1 - busy / (1e3 * dt),
                 "first_step": {"loss_rel": rl, "grad_norm_rel": rn,
                                "bitwise": bitwise},
                 "save_s": save_s, "load_s": load_s,
                 "launches": launches, "collectives": ops,
                 "cuts": {"gas": [128, ZERO_GAS],
                          "micro_batches": [5 * 128, ZERO_STEPS * ZERO_GAS]}}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        set_global_mesh(None)
        dist.destroy_process_group()
    rates["d128"] = time_flash_d128()
    torch.cuda.empty_cache()
    return rates


def _zero_config(world, group=True):
    """The zero leg's ds_config for a global batch of ``world`` ranks'
    micro-batches; ``group=False``: the same global batch through one
    engine without a process group (micro ZERO_MICRO x world)."""
    micro = ZERO_MICRO if group else ZERO_MICRO * world
    return dict(ZERO_CONFIG, train_batch_size=ZERO_MICRO * ZERO_GAS * world,
                train_micro_batch_size_per_gpu=micro)


def _zero_batch(world):
    import numpy as np
    rng = np.random.default_rng(12)
    return {"input_ids": rng.integers(1, 50257,
                                      (ZERO_MICRO * ZERO_GAS * world,
                                       ZERO_SEQ))}


def phase_zero_ranks(tmp, n):
    """``--zero-ranks N``: the zero leg across N GPUs of one host, one
    process each through the port's launcher. First the global batch (N x
    ZERO_MICRO rows a micro-batch) through one engine without a process
    group on GPU 0, one step; then ``launch --nproc_per_node N`` runs
    :func:`zero_worker` on every GPU: ZERO_STEPS steps, each held to its
    flash launches and NCCL collectives, the first step's loss and grad
    norm within 1e-3 / 1e-2 of the single engine's (the ranks reduce the
    bf16 grads in another order), the loss falling, a sharded save of N
    shard pairs restored bitwise into a fresh N-rank engine, and the step
    time, tokens/s, model TFLOP/s a GPU and each rank's peak memory."""
    import torch
    ref_engine, _ = _zero_engine(tmp, "ds_zero3_ref", 0,
                                 _zero_config(n, group=False))
    _zero_counters()
    ref = ref_engine.train_batch(_zero_batch(n))
    del ref_engine
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "zero_ranks.json")
    env = dict(os.environ, PYTHONPATH=HERE)
    rc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
         "--nproc_per_node", str(n), os.path.join(HERE, "chip_smoke.py"),
         "--zero-worker", out], cwd=HERE, env=env, timeout=1200).returncode
    if rc != 0:
        fail(f"zero ranks: the launcher exited {rc}")
    with open(out) as f:
        res = json.load(f)
    first = res["metrics"][0]
    rl = abs(first["loss"] - ref["loss"]) / abs(ref["loss"])
    rn = abs(first["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
    log(f"check: zero ranks={n} first step vs one engine without a process "
        f"group loss={first['loss']:.7f}/{ref['loss']:.7f} rel={rl:.3e} "
        f"tol=1e-3 grad_norm={first['grad_norm']:.6f}/"
        f"{ref['grad_norm']:.6f} rel={rn:.3e} tol=1e-2")
    if not (rl <= 1e-3 and rn <= 1e-2):
        fail("zero ranks: the first step is off the single engine's")
    res.update(loss_rel=rl, grad_norm_rel=rn)
    return res


def zero_worker(out):
    """One rank of ``--zero-ranks``, started by the port's launcher (NCCL
    on cuda:LOCAL_RANK); rank 0 writes the readings to ``out``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch import comm
    comm.init_distributed()
    rank, world = comm.get_rank(), comm.get_world_size()
    tmp = os.path.dirname(out)
    batch = _zero_batch(world)
    engine, cfg = _zero_engine(tmp, f"ds_zero3_rank{rank}", 0,
                               _zero_config(world))
    n_params = sum(int(np.prod(e.shape)) for e in engine.dp.entries)
    torch.cuda.reset_peak_memory_stats()
    metrics, step_s, launches, ops = [], [], None, None
    for step in range(ZERO_STEPS):
        m, dt, c, o = _zero_step(engine, batch, f"rank {rank} step {step}")
        metrics.append(m)
        step_s.append(dt)
        launches, ops = c, o
        if rank == 0:
            log(f"zero ranks={world}: step {step} loss={m['loss']:.6f} "
                f"grad_norm={m['grad_norm']:.5f} step_ms={1e3 * dt:.1f} "
                f"launches={json.dumps(c)} collectives={json.dumps(o)}")
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        fail(f"zero ranks: loss did not fall {[m['loss'] for m in metrics]}")
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                        device="cuda")
    peaks = comm.all_gather(peak).tolist()
    dt = float(np.median(step_s[1:]))
    if rank == 0:
        busy, by_kind = profile_train(engine, batch, 1e3 * dt,
                                      label=f"zero ranks={world} step")
    else:
        engine.train_batch(batch)
        busy, by_kind = None, None
    ck = os.path.join(tmp, "zero_ranks_ck")
    t1 = time.perf_counter()
    engine.save_checkpoint(ck)
    save_s = time.perf_counter() - t1
    files = sorted(os.listdir(os.path.join(ck, f"global_step{ZERO_STEPS + 1}")))
    fresh, _ = _zero_engine(tmp, f"ds_zero3_fresh{rank}", 1,
                            _zero_config(world))
    t1 = time.perf_counter()
    fresh.load_checkpoint(ck)
    load_s = time.perf_counter() - t1
    same = all(torch.equal(a, b) for a, b in
               zip(_zero_state(engine), _zero_state(fresh)))
    flag = torch.tensor([1.0 if same else 0.0], device="cuda")
    comm.all_reduce(flag, op=comm.ReduceOp.MIN)
    nxt = _zero_step(engine, batch, "next step")[0]
    nxt_fresh = _zero_step(fresh, batch, "resumed step")[0]
    if flag.item() != 1.0 or nxt["loss"] != nxt_fresh["loss"] or \
            len(files) != 2 * world + 2:
        fail(f"zero ranks: the sharded checkpoint ({files}) did not restore "
             "the state on every rank")
    tokens = ZERO_MICRO * ZERO_GAS * world * ZERO_SEQ
    res = {"world": world, "backend": dist.get_backend(),
           "metrics": metrics, "step_ms": 1e3 * dt,
           "step_ms_all": [round(1e3 * x, 3) for x in step_s],
           "tokens_s": tokens / dt,
           "model_tflops_6n_per_gpu": 6.0 * n_params * tokens / dt / world
           / 1e12, "peak_mem_gb_by_rank": peaks, "busy_ms_rank0": busy,
           "device_ms_by_kind_rank0": by_kind, "launches_per_rank": launches,
           "collectives_per_rank": ops, "save_s": save_s, "load_s": load_s,
           "shard_files": files, "resumed_loss": nxt_fresh["loss"]}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
        log("time: zero ranks " + json.dumps(res))
    del engine, fresh
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------------ 12. sp

def _sp_engine(tmp, name, impl, config=None, seed=0):
    """initialize(ds_sp.json: ``config``, default SP_CONFIG) on llama-1.1b
    at full width, SP_LAYERS deep, with max_seq_len SP_SEQ, seeded
    weights, remat "full", the fused chunked CE and attention_impl
    ``impl``."""
    return _train_engine(tmp, name, config or SP_CONFIG, seed,
                         max_seq_len=SP_SEQ, remat=True, remat_policy="full",
                         attention_impl=impl, num_layers=SP_LAYERS)


def _sp_batch(vocab):
    import numpy as np
    rng = np.random.default_rng(13)
    return {"input_ids": rng.integers(1, vocab, (1, SP_SEQ))}


def _ring_counters():
    from deepspeed_tpu_torch.parallel import ring_attention as tra
    fn = tra.ring_attention
    return {"chunk_steps": fn.chunk_steps, "rotations": fn.rotations,
            "returns": fn.returns}


def _zero_ring_counters():
    from deepspeed_tpu_torch.parallel import ring_attention as tra
    tra.ring_attention.chunk_steps = 0
    tra.ring_attention.rotations = 0
    tra.ring_attention.returns = 0


def _sp_step(engine, batch, label, want, want_ring):
    """One train_batch with the kernel, ring and collective counters zeroed
    just before it and read just after; each must equal ``want`` /
    ``want_ring`` (point-to-point ops: ``want_ring["rotations"] +
    want_ring["returns"]``)."""
    import numpy as np
    from deepspeed_tpu_torch import comm
    _zero_counters()
    _zero_ring_counters()
    comm.reset_op_counts()
    t0 = time.perf_counter()
    m = engine.train_batch(batch)           # ends in a host read
    dt = time.perf_counter() - t0
    c, ring, ops = _counters(), _ring_counters(), comm.op_counts()
    p2p = ops.get("ppermute_async", 0) + ops.get("ppermute", 0)
    got = {k: c[k] for k in FLASH_KERNELS}
    if got != want or ring != want_ring or \
            p2p != want_ring["rotations"] + want_ring["returns"] or \
            any(c[k] for k in BS_KERNELS):
        fail(f"{label}: launched {c}, ring {ring}, point-to-point {p2p}: "
             f"expected {want}, ring {want_ring}")
    if not np.isfinite(m["loss"]) or m["overflow"]:
        fail(f"{label}: {m}")
    return m, dt, got, ring, ops


def _sp_want(layers, sp, r, mode):
    """One step's flash launches and ring counters on rank ``r`` of a seq
    group of ``sp`` under remat "full" (the forward runs twice a layer):
    the ring computes r + 1 chunks a forward (the causal diagonal and the
    earlier ranks' chunks) and rotates K/V sp - 1 times a forward and a
    backward, with one dK/dV hop home a backward; Ulysses one flash call
    a layer over the whole sequence."""
    n = r + 1 if mode == "ring" else 1
    want = {"flash_attention_fwd": 2 * layers * n,
            "flash_attention_bwd_dq": layers * n,
            "flash_attention_bwd_dkv": layers * n}
    rot = sp - 1 if mode == "ring" else 0
    ring = {"chunk_steps": 2 * layers * n if mode == "ring" else 0,
            "rotations": 3 * layers * rot,
            "returns": layers if mode == "ring" and sp > 1 else 0}
    return want, ring


def check_ring_chunks():
    """The ring's chunk logic on one device: ``emulate_ring`` over SP_EMU
    virtual ranks of one [1, 8, 4096, 64] bf16 sample, causal and full.
    Each virtual rank runs the ring's own forward and backward: the same
    chunk steps (the flash forward kernel) with their causal / full /
    skip choice, the lse merge, and the flash backward kernels on each
    chunk with the merged o and lse; the rotation is indexing. o, dq, dk
    and dv are held against the plain version (the whole sequence's
    attention forward and backward on the inputs cast to f32, with the
    ring's o) at the flash checks' limits. Returns the largest error of
    each."""
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    from deepspeed_tpu_torch.parallel import ring_attention as tra
    g = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, do = (torch.randn(1, 8, 4096, 64, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    worst = {}
    for causal in (True, False):
        _zero_counters()
        o, dq, dk, dv = tra.emulate_ring(q, k, v, SP_EMU, causal=causal,
                                         do=do)
        torch.cuda.synchronize()
        c = _counters()
        # causal: virtual rank r computes r + 1 chunks; full: SP_EMU each
        n = (SP_EMU * (SP_EMU + 1) // 2 if causal else SP_EMU * SP_EMU)
        if any(c[kname] != n for kname in FLASH_KERNELS):
            fail(f"ring chunks causal={causal}: launched {c}, expected {n} "
                 "of each flash kernel")
        f = [t.float() for t in (q, k, v, do)]
        ro, lse = tfa.flash_attention_reference(*f[:3], causal=causal)
        rq, rk, rv = tfa.flash_attention_bwd_reference(
            *f[:3], o.float(), lse, f[3], causal=causal)
        label = (f"ring chunks sp={SP_EMU} causal={causal} [1, 8, 4096, 64] "
                 f"bf16 launches={n}")
        for name, out, ref, floor in (("o", o, ro, 0.0), ("dq", dq, rq, 2.0 ** -10),
                                      ("dk", dk, rk, 2.0 ** -10),
                                      ("dv", dv, rv, 2.0 ** -10)):
            err = _hold(f"{label} {name}:", out, ref, False, floor=floor)
            worst[name] = max(worst.get(name, 0.0), err)
        del o, dq, dk, dv, ro, lse, rq, rk, rv, f
    torch.cuda.empty_cache()
    return worst


def _sp_rates(engine, batch, step_s, n_params, cfg, label, world=1):
    """The sp leg's readings: the median step (after the first), tokens/s,
    model TFLOP/s (6N, and with attention), peak memory, and one profiled
    step's busy ms and device ms by kind."""
    import numpy as np
    import torch
    dt = float(np.median(step_s[1:]))
    tokens = SP_SEQ
    model_flops = 6.0 * n_params * tokens
    attn_flops = 12.0 * cfg.num_layers * cfg.hidden_size * SP_SEQ * tokens
    busy, by_kind = profile_train(engine, batch, 1e3 * dt, label=label)
    return {"step_ms": 1e3 * dt, "tokens_s": tokens / dt,
            "model_tflops_6n": model_flops / dt / 1e12 / world,
            "model_tflops_with_attention":
                (model_flops + attn_flops) / dt / 1e12 / world,
            "step_ms_all": [round(1e3 * x, 3) for x in step_s],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "busy_ms": busy, "device_ms_by_kind": by_kind,
            "idle_share": 1 - busy / (1e3 * dt) if busy else None}


def phase_sp(tmp):
    """Sequence parallelism on one card: llama-1.1b (TinyLlama shapes, 22
    layers, hidden 2048, 32 heads of 64, 4 KV heads) at full width and
    depth with max_seq_len raised to SP_SEQ, seeded weights, one sample of
    SP_SEQ tokens a step, bf16 with an fp32 master, AdamW, ZeRO 1, remat
    "full". First the chunk-logic check (:func:`check_ring_chunks`).
    Then the reference: the same engine with attention_impl="flash" and
    no process group, one step. Then comm.init_distributed (NCCL, world
    1) and, for "ring" and "ulysses", SP_STEPS train_batch steps on the
    sample, each held to its flash launches (the ring: one chunk step a
    layer and forward, no point-to-point op at seq-world 1); the first
    step's loss within 1e-3 and grad norm within 1e-2 of the reference;
    the loss falls. Readings: step ms, tokens/s, model TFLOP/s, peak
    memory, device ms by kind."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import set_global_mesh
    out = {"ring_chunks": check_ring_chunks()}
    if comm.is_initialized():
        fail("sp: a process group is already up")
    gc.collect()
    torch.cuda.empty_cache()
    ref_engine, cfg = _sp_engine(tmp, "sp_ref", "flash")
    batch = _sp_batch(cfg.vocab_size)
    log(f"sp: llama-1.1b layers={cfg.num_layers} hidden={cfg.hidden_size} "
        f"heads={cfg.num_heads}x{cfg.head_dim} kv_heads={cfg.kv_heads} "
        f"max_seq_len={cfg.max_seq_len}, one sample of {SP_SEQ} tokens, "
        "bf16 + fp32 master, AdamW, ZeRO 1, remat full")
    want, _ = _sp_want(cfg.num_layers, 1, 0, "ulysses")
    ref = _sp_step(ref_engine, batch, "sp flash reference", want,
                   dict.fromkeys(("chunk_steps", "rotations", "returns"),
                                 0))[0]
    del ref_engine
    gc.collect()
    torch.cuda.empty_cache()
    comm.init_distributed(world_size=1, rank=0)
    try:
        for mode in ("ring", "ulysses"):
            t0 = time.perf_counter()
            engine, cfg = _sp_engine(tmp, f"sp_{mode}", mode)
            n_params = sum(p.numel() for p in engine._params)
            log(f"sp: {mode} backend={dist.get_backend()} world="
                f"{dist.get_world_size()} params={n_params} "
                f"init_s={time.perf_counter() - t0:.2f} "
                f"mem_gb={torch.cuda.memory_allocated() / 1e9:.2f}")
            torch.cuda.reset_peak_memory_stats()
            want, want_ring = _sp_want(cfg.num_layers, 1, 0, mode)
            metrics, step_s = [], []
            for step in range(SP_STEPS):
                m, dt, c, ring, ops = _sp_step(engine, batch,
                                               f"sp {mode} step {step}",
                                               want, want_ring)
                metrics.append(m)
                step_s.append(dt)
                log(f"sp: {mode} step {step} loss={m['loss']:.6f} "
                    f"grad_norm={m['grad_norm']:.5f} step_ms={1e3 * dt:.1f} "
                    f"launches={json.dumps(c)} ring={json.dumps(ring)} "
                    f"collectives={json.dumps(ops)}")
            first = metrics[0]
            rl = abs(first["loss"] - ref["loss"]) / abs(ref["loss"])
            rn = abs(first["grad_norm"] - ref["grad_norm"]) / abs(
                ref["grad_norm"])
            log(f"check: sp {mode} first step vs attention_impl=flash "
                f"loss={first['loss']:.7f}/{ref['loss']:.7f} rel={rl:.3e} "
                f"tol=1e-3 grad_norm={first['grad_norm']:.6f}/"
                f"{ref['grad_norm']:.6f} rel={rn:.3e} tol=1e-2")
            if not (rl <= 1e-3 and rn <= 1e-2):
                fail(f"sp {mode}: the first step is off the flash engine's")
            if not metrics[-1]["loss"] < metrics[0]["loss"]:
                fail(f"sp {mode}: loss did not fall "
                     f"{[x['loss'] for x in metrics]}")
            rates = _sp_rates(engine, batch, step_s, n_params, cfg,
                              f"sp {mode} step")
            # the last step's counted launches and ring counters
            rates.update(loss=[x["loss"] for x in metrics],
                         first_step={"loss_rel": rl, "grad_norm_rel": rn},
                         launches=c, ring=ring)
            log(f"time: sp {mode} " + json.dumps(rates))
            out[mode] = rates
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        set_global_mesh(None)
        dist.destroy_process_group()
    out["flash"] = time_flash_sp()
    torch.cuda.empty_cache()
    return out


def time_flash_sp():
    """The flash kernels at the sp leg's calls, one launch each, held
    against the plain version and timed beside SDPA on the same inputs
    (``is_causal``, or no mask for a full chunk) and the bound: the 1-card
    leg's [1, 32, 16384, 64] causal bf16, and an sp = 4 ring's chunks [1,
    32, 4096, 64], causal (the diagonal) and full. The plain version
    runs over ``hs`` heads at a time (at 16384 tokens the f32 scores of
    all 32 heads would take 34 GB): its time is the sum over the groups,
    and the kernels' o, lse, dq, dk and dv are held against its outputs on
    the inputs cast to f32 at the flash checks' limits (:func:`_hold`; lse
    to F32_TOL). Every call here runs for a millisecond or more, so each
    is timed between CUDA events over back-to-back calls
    (:func:`wall_ms`), not by torch.profiler, whose short traces late in
    this process can record nothing."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    g = torch.Generator(device="cuda").manual_seed(15)
    out = {}
    for tag, S, causal, hs in (("sp1 causal", SP_SEQ, True, 4),
                               ("sp4 chunk causal", SP_SEQ // 4, True, 32),
                               ("sp4 chunk full", SP_SEQ // 4, False, 32)):
        q, k, v, do = (torch.randn(1, 32, S, 64, device="cuda",
                                   generator=g).to(torch.bfloat16)
                       for _ in range(4))
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
        delta = (do.float() * o.float()).sum(-1)
        parts = [slice(h, h + hs) for h in range(0, 32, hs)]
        # the kernels' outputs against the plain version's, group by group
        dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                        causal=causal)
        dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                             causal=causal)
        ref = {n: torch.empty(t.shape, dtype=torch.float32, device="cuda")
               for n, t in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk),
                            ("dv", dv))}
        for p in parts:
            f = [t[:, p].float() for t in (q, k, v, o, do)]
            ref["o"][:, p], ref["lse"][:, p] = tfa.flash_attention_reference(
                *f[:3], causal=causal)
            ref["dq"][:, p], ref["dk"][:, p], ref["dv"][:, p] = \
                tfa.flash_attention_bwd_reference(*f[:4], lse[:, p], f[4],
                                                  causal=causal)
            del f
        torch.cuda.synchronize()
        label = f"sp {tag} [1, 32, {S}, 64] bf16"
        err_l = _max_err(lse, ref["lse"])
        log(f"check: {label} lse max_abs_err={err_l:.3e} tol={F32_TOL}")
        if not err_l <= F32_TOL:
            fail(f"{label}: lse err {err_l} > {F32_TOL}")
        errs = {"flash_attention_fwd": _hold(f"{label} o:", o, ref["o"],
                                             False)}
        errs["flash_attention_bwd_dq"] = _hold(f"{label} dq:", dq, ref["dq"],
                                               False, floor=2.0 ** -10)
        errs["flash_attention_bwd_dkv"] = max(
            _hold(f"{label} {n}:", t, ref[n], False, floor=2.0 ** -10)
            for n, t in (("dk", dk), ("dv", dv)))
        del dq, dk, dv, ref
        torch.cuda.empty_cache()
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        lib_bwd = wall_ms(lambda: torch.autograd.grad(
            so, (qs, ks, vs), do, retain_graph=True), reps=5)
        lib_fwd = wall_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), reps=5)
        plain_fwd = wall_ms(lambda: [tfa.flash_attention_reference(
            q[:, p], k[:, p], v[:, p], causal=causal) for p in parts],
            reps=1, warmup=1)
        plain_bwd = wall_ms(lambda: [tfa.flash_attention_bwd_reference(
            q[:, p], k[:, p], v[:, p], o[:, p], lse[:, p], do[:, p],
            causal=causal) for p in parts], reps=1, warmup=1)
        pairs = 32 * (S * (S + 1) // 2 if causal else S * S)
        elem = 32 * S * 64 * 2
        rows = 32 * S * 4
        for name, fn, nbytes, flops, plain, lib in (
                ("flash_attention_fwd",
                 lambda: tfa.flash_attention_fwd(q, k, v, causal=causal),
                 4 * elem + rows, 4 * 64 * pairs, plain_fwd, lib_fwd),
                ("flash_attention_bwd_dq",
                 lambda: tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                    causal=causal),
                 5 * elem + 2 * rows, 6 * 64 * pairs, plain_bwd, lib_bwd),
                ("flash_attention_bwd_dkv",
                 lambda: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                     causal=causal),
                 6 * elem + 2 * rows, 8 * 64 * pairs, plain_bwd, lib_bwd)):
            bnd, by = bound_ms(nbytes, flops)
            t = {"ms": wall_ms(fn, reps=10), "plain_ms": plain,
                 "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                 "max_abs_err": errs[name],
                 "work": f"one launch, B=1, H=32, S=Sk={S}, D=64, "
                         f"{'causal' if causal else 'full'}, bf16, timed "
                         "between CUDA events; the backward's plain and "
                         "library calls compute dq, dk and dv together"}
            out.setdefault(name, {})[tag] = t
            log(f"time: sp {tag} {name} ms={t['ms']:.4f} bound_ms={bnd:.4f} "
                f"({by}) plain_ms={plain:.4f} library_ms={lib:.4f} "
                f"max_abs_err={errs[name]:.3e} [{t['work']}]")
        del q, k, v, do, o, lse, delta, qs, ks, vs, so
        torch.cuda.empty_cache()
    return out


def phase_sp_ranks(tmp, n):
    """``--sp-ranks N``: the sp leg across N GPUs of one host, one process
    each through the port's launcher. First the sample through one engine
    without a process group on GPU 0 (flash, one step); then ``launch
    --nproc_per_node N`` runs :func:`sp_worker` on every GPU: for "ring"
    and "ulysses" at sp = N (SP_SEQ / N tokens a rank), SP_STEPS steps
    held to their flash launches and ring counters (N - 1 rotations a
    layer and direction), the first step's loss within 1e-4 and grad norm
    within 5e-3 of the single engine's, the loss falling, and rank 0's
    step time, tokens/s, peak memory and NCCL device ms."""
    import torch
    ref_engine, cfg = _sp_engine(tmp, "sp_ref", "flash")
    _zero_counters()
    ref = ref_engine.train_batch(_sp_batch(cfg.vocab_size))
    del ref_engine
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "sp_ranks.json")
    env = dict(os.environ, PYTHONPATH=HERE)
    rc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
         "--nproc_per_node", str(n), os.path.join(HERE, "chip_smoke.py"),
         "--sp-worker", out], cwd=HERE, env=env, timeout=1200).returncode
    if rc != 0:
        fail(f"sp ranks: the launcher exited {rc}")
    with open(out) as f:
        res = json.load(f)
    for mode in ("ring", "ulysses"):
        first = res[mode]["metrics"][0]
        rl = abs(first["loss"] - ref["loss"]) / abs(ref["loss"])
        rn = abs(first["grad_norm"] - ref["grad_norm"]) / abs(
            ref["grad_norm"])
        log(f"check: sp ranks={n} {mode} first step vs one engine without "
            f"a process group loss={first['loss']:.7f}/{ref['loss']:.7f} "
            f"rel={rl:.3e} tol=1e-4 grad_norm={first['grad_norm']:.6f}/"
            f"{ref['grad_norm']:.6f} rel={rn:.3e} tol=5e-3")
        if not (rl <= 1e-4 and rn <= 5e-3):
            fail(f"sp ranks {mode}: the first step is off the single "
                 "engine's")
        res[mode].update(loss_rel=rl, grad_norm_rel=rn)
    return res


def sp_worker(out):
    """One rank of ``--sp-ranks``, started by the port's launcher (NCCL on
    cuda:LOCAL_RANK); rank 0 writes the readings to ``out``."""
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import ZERO_AXES
    comm.init_distributed()
    rank, world = comm.get_rank(), comm.get_world_size()
    tmp = os.path.dirname(out)
    res = {"world": world}
    for mode in ("ring", "ulysses"):
        config = dict(SP_CONFIG, sequence_parallel={"sp_size": world,
                                                    "mode": mode})
        engine, cfg = _sp_engine(tmp, f"sp_{mode}_rank{rank}", "auto",
                                 config)
        batch = _sp_batch(cfg.vocab_size)
        n_params = sum(p.numel() for p in engine.module.parameters())
        want, want_ring = _sp_want(cfg.num_layers, world, engine.seq_rank,
                                   mode)
        torch.cuda.reset_peak_memory_stats()
        metrics, step_s = [], []
        for step in range(SP_STEPS):
            m, dt, c, ring, ops = _sp_step(
                engine, batch, f"sp ranks={world} {mode} rank {rank} step "
                f"{step}", want, want_ring)
            metrics.append(m)
            step_s.append(dt)
            if rank == 0:
                log(f"sp ranks={world}: {mode} step {step} loss="
                    f"{m['loss']:.6f} grad_norm={m['grad_norm']:.5f} "
                    f"step_ms={1e3 * dt:.1f} launches={json.dumps(c)} "
                    f"ring={json.dumps(ring)} collectives={json.dumps(ops)}")
        if not metrics[-1]["loss"] < metrics[0]["loss"]:
            fail(f"sp ranks {mode}: loss did not fall "
                 f"{[x['loss'] for x in metrics]}")
        if rank == 0:
            rates = _sp_rates(engine, batch, step_s, n_params, cfg,
                              f"sp ranks={world} {mode} step", world)
        else:
            engine.train_batch(batch)
            rates = {}
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                            device="cuda")
        rates.update(metrics=metrics, launches_rank0=c, ring_rank0=ring,
                     peak_mem_gb_by_rank=comm.all_gather(
                         peak, axis=ZERO_AXES).tolist())
        res[mode] = rates
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
        log("time: sp ranks " + json.dumps(res))
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------- 13. dropout

def _bert_large_params():
    from types import SimpleNamespace
    from deepspeed_tpu_torch.models.hf import load_hf
    sd = _seeded_state_dict(_bert_large_shapes(), seed=3)
    return load_hf(sd, arch="BertForMaskedLM",
                   config=SimpleNamespace(**BERT_LARGE_CONFIG))


def phase_dropout():
    """BERT-large (the hf leg's model, seeded weights) with dropout 0.1,
    BERT's published value, BERT_STEPS train_batch steps on 8 x 512 MLM
    samples with the ragged key mask: the loss falls; every attention
    call takes the plain path (``attention.plain_calls`` 24 a step, no
    flash launch), as the JAX router sends dropout to its reference; a
    second engine with the same seed gives bitwise-equal losses; under
    remat "full" the first step's loss and grad norm equal remat off's
    bitwise (each dropout site's generator is made from its seed inside
    the checkpointed region). The leg runs under
    ``torch.use_deterministic_algorithms``: F.embedding's CUDA backward
    otherwise adds colliding rows in a varying order (the token-type
    table's row 0 takes all 4096 tokens), so its gradient differs in the
    last bits from run to run, remat or not, and a bitwise comparison
    would test that instead of the masks."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        masked_lm_loss)
    from deepspeed_tpu_torch.ops.attention import attention
    rng = np.random.default_rng(16)
    V, B, S = BERT_LARGE_CONFIG["vocab_size"], BERT_BATCH, BERT_SEQ
    lens = np.asarray(BERT_KEY_LENS)
    live = np.arange(S)[None] < lens[:, None]
    ids = np.where(live, rng.integers(1000, V, (B, S)), 0)
    batch = {"input_ids": ids, "attention_mask": live.astype(np.int64),
             "labels": np.where((rng.random((B, S)) < 0.15) & live, ids,
                                -100)}

    def run(steps, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        params, cfg = _bert_large_params()
        cfg = dataclasses.replace(cfg, dropout=BERT_DROPOUT, **kw)
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=Transformer(cfg, params),
            config=dict(BERT_TRAIN_CONFIG, seed=7), loss_fn=masked_lm_loss)
        del params
        metrics, step_s = [], []
        for step in range(steps):
            _zero_counters()
            attention.plain_calls = 0
            t0 = time.perf_counter()
            m = engine.train_batch(batch)       # ends in a host read
            step_s.append(time.perf_counter() - t0)
            c = _counters()
            # under remat "full" the recomputation calls attention again
            calls = cfg.num_layers * (2 if cfg.remat else 1)
            if attention.plain_calls != calls or any(c.values()):
                fail(f"dropout step {step}: {attention.plain_calls} plain "
                     f"attention calls, kernel launches {c}: expected "
                     f"{calls} plain calls and no launch")
            if not np.isfinite(m["loss"]) or m["overflow"]:
                fail(f"dropout step {step}: {m}")
            metrics.append(m)
        del engine
        return metrics, step_s, c

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, step_s, c = run(BERT_STEPS)
        b, _, _ = run(BERT_STEPS)
        r, _, _ = run(1, remat=True, remat_policy="full")
    finally:
        torch.use_deterministic_algorithms(was)
    la, lb = [m["loss"] for m in a], [m["loss"] for m in b]
    log(f"dropout: bert-large dropout={BERT_DROPOUT} losses={la} "
        f"grad_norms={[m['grad_norm'] for m in a]} step_ms="
        f"{[round(1e3 * x, 1) for x in step_s]} plain attention calls a "
        f"step={BERT_LARGE_CONFIG['num_hidden_layers']} launches={c}")
    log(f"check: dropout same seed losses {la} / {lb} bitwise={la == lb}; "
        f"remat full first step loss={r[0]['loss']!r}/{a[0]['loss']!r} "
        f"grad_norm={r[0]['grad_norm']!r}/{a[0]['grad_norm']!r}")
    if la != lb:
        fail("dropout: two runs with one seed gave other losses")
    if (r[0]["loss"], r[0]["grad_norm"]) != (a[0]["loss"],
                                             a[0]["grad_norm"]):
        fail("dropout: remat full's first step differs from remat off's")
    if not la[-1] < la[0]:
        fail(f"dropout: loss did not fall {la}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": la, "step_ms": [round(1e3 * x, 3) for x in step_s],
            "plain_calls_per_step": BERT_LARGE_CONFIG["num_hidden_layers"],
            "remat_full_first": [r[0]["loss"], r[0]["grad_norm"]]}


def time_bert_masked_flash():
    """The BERT-large leg's attention: 24 launches (one a layer) of each
    flash kernel at [8, 16, 512, 64] bf16, non-causal, with the ragged
    key mask BERT_KEY_LENS, beside SDPA with the same boolean mask. Bound:
    the live (q, k) pairs (each sample's keys) at 4 D flops a pair for the
    forward, 6 D for dq and 8 D for dk/dv, against each input read once
    and each output written once."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    B, H, S, D, n = 8, 16, 512, 64, 24
    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, do = (torch.randn(B, H, S, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    mask = _key_mask(BERT_KEY_LENS, S)
    kw = {"causal": False, "mask": mask}
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)

    def step(fn):
        return lambda: [fn() for _ in range(n)]

    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    lib_fwd = device_ms(step(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)))
    lib_bwd = device_ms(step(lambda: torch.autograd.grad(
        so, (qs, ks, vs), do, retain_graph=True)))
    plain_fwd = device_ms(step(lambda: tfa.flash_attention_reference(
        q, k, v, **kw)), reps=3)
    plain_bwd = device_ms(step(lambda: tfa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, **kw)), reps=3)
    pairs = H * S * sum(BERT_KEY_LENS)
    elem, rows, mbytes = B * H * S * D * 2, B * H * S * 4, B * S
    out = {}
    for name, fn, nbytes, flops, plain, lib in (
            ("flash_attention_fwd",
             lambda: tfa.flash_attention_fwd(q, k, v, **kw),
             4 * elem + rows + mbytes, 4 * D * pairs, plain_fwd, lib_fwd),
            ("flash_attention_bwd_dq",
             lambda: tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                **kw),
             5 * elem + 2 * rows + mbytes, 6 * D * pairs, plain_bwd,
             lib_bwd),
            ("flash_attention_bwd_dkv",
             lambda: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 **kw),
             6 * elem + 2 * rows + mbytes, 8 * D * pairs, plain_bwd,
             lib_bwd)):
        bnd, by = bound_ms(n * nbytes, n * flops)
        out[name] = {"ms": device_ms(step(fn)), "plain_ms": plain,
                     "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                     "work": f"one BERT-large step: {n} launches, B={B}, "
                             f"H={H}, S=Sk={S}, D={D}, non-causal, key mask "
                             f"{list(BERT_KEY_LENS)}, bf16; backward plain "
                             "and library compute dq, dk and dv together"}
        r = out[name]
        log(f"time: bert masked {name} ms={r['ms']:.4f} bound_ms="
            f"{bnd:.4f} ({by}) plain_ms={plain:.4f} library_ms={lib:.4f} "
            f"factor={r['ms'] / lib:.3f} [{r['work']}]")
    del q, k, v, do, o, lse, delta, qs, ks, vs, so, mask
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ 14. moe

# mistralai/Mixtral-8x7B-v0.1 config.json (the published widths); depth is
# cut per leg (MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS)
MIXTRAL_CONFIG = dict(
    model_type="mixtral", vocab_size=32000, hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, num_local_experts=8, num_experts_per_tok=2,
    max_position_embeddings=32768, rope_theta=1e6, rms_norm_eps=1e-5,
    sliding_window=None, tie_word_embeddings=False, hidden_act="silu",
    router_aux_loss_coef=0.02)
# served depth cut 8 -> 4 (the script's time limit)
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = 4, 2
MOE_BATCH, MOE_PROMPT, MOE_NEW, MOE_REQUESTS = 4, 1024, 32, 8
MOE_INT8_LENS, MOE_INT8_NEW = (96, 200, 333, 512), 16
MOE_MICRO, MOE_GAS, MOE_SEQ, MOE_STEPS = 2, 2, 1024, 3
MOE_AUX = MIXTRAL_CONFIG["router_aux_loss_coef"]
# the route and logits rule. On this leg's random weights bf16 activations
# move the router's logits by ~1e-2 while 1% of its 2nd-3rd gaps are
# under 6e-3 (measured on an H100, PERF.md), so a bf16 path flips about a
# tenth of the (token, layer) routes against the f32 computation, the
# plain path as much as the kernels, and even with every route pinned two
# bf16 paths of the 8-layer model differ by a tenth of the largest logit.
# So the kernels are held in f32, where only they differ: at most
# MOE_FLIP_LIMIT of the routes may flip between the kernel path and the
# plain path, and the logits of the agreeing tokens are held to the dense
# legs' 5e-2 of the largest. In bf16 the kernel path must be no further
# from the f32 computation than the plain path: its flips against f32
# within 3 standard deviations of the plain path's, and, with the f32
# run's expert choices replayed in both (``_RouteLog(replay=...)``), its
# logits' RMS and largest deviations from f32 within MOE_BF16_RATIO of
# the plain path's (the train check: its loss and grad norm within the
# train leg's 1e-3 / 1e-2 of f32, or MOE_BF16_RATIO of the plain path's
# deviation).
MOE_FLIP_LIMIT = 5e-3
MOE_BF16_RATIO = 1.25
# pure bf16 state and bf16 grad accumulation (the zero leg's), AdamW,
# ZeRO 1, the moe section
MOE_TRAIN_CONFIG = {
    "train_batch_size": MOE_MICRO * MOE_GAS,
    "train_micro_batch_size_per_gpu": MOE_MICRO,
    "gradient_accumulation_steps": MOE_GAS,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "bf16": {"enabled": True, "master_weights": False},
    "data_types": {"grad_accum_dtype": "bf16"},
    "zero_optimization": {"stage": 1},
    "moe": {"enabled": True, "ep_size": 1},
    "steps_per_print": 10_000,
}
# --ep-ranks: one 1024-token sample a rank a micro-batch, gas 2
EP_STEPS = 3


def _mixtral_shapes(layers):
    """MixtralForCausalLM's state-dict names and shapes at the published
    widths and ``layers`` layers."""
    c = MIXTRAL_CONFIG
    H, I, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    nh, kv, E = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["num_local_experts"])
    hd = H // nh
    shapes = [("model.embed_tokens.weight", (V, H))]
    for i in range(layers):
        p = f"model.layers.{i}."
        shapes += [(p + "input_layernorm.weight", (H,)),
                   (p + "post_attention_layernorm.weight", (H,))]
        shapes += [(p + f"self_attn.{n}_proj.weight", (rows * hd, H))
                   for n, rows in (("q", nh), ("k", kv), ("v", kv))]
        shapes.append((p + "self_attn.o_proj.weight", (H, nh * hd)))
        m = p + "block_sparse_moe."
        shapes.append((m + "gate.weight", (E, H)))
        for j in range(E):
            shapes += [(m + f"experts.{j}.w1.weight", (I, H)),
                       (m + f"experts.{j}.w3.weight", (I, H)),
                       (m + f"experts.{j}.w2.weight", (H, I))]
    return shapes + [("model.norm.weight", (H,)),
                     ("lm_head.weight", (V, H))]


def _mixtral_state_dict(layers, seed, device="cuda"):
    """The state dict, bf16 on the card, drawn one tensor at a time from
    a seed as HF initializes it (normal std 0.02, RMSNorm weights 1);
    ``device="meta"``: the shapes only."""
    import torch
    g = (torch.Generator(device=device).manual_seed(seed)
         if device != "meta" else None)
    sd = {}
    for name, shape in _mixtral_shapes(layers):
        if device == "meta":
            sd[name] = torch.empty(shape, device="meta",
                                   dtype=torch.bfloat16)
        elif len(shape) == 1:
            sd[name] = torch.ones(shape, device=device, dtype=torch.bfloat16)
        else:
            sd[name] = torch.randn(shape, generator=g, device=device,
                                   dtype=torch.bfloat16).mul_(0.02)
    return sd


def _replayed_route(logits, k, capacity, expert):
    """``moe.sharded_moe.route`` with the experts given (``expert`` [T,
    k], first choices first): the same queue positions and drop rule,
    the combine weights from these logits' gates (renormalized for
    top-2), the load-balance loss from their argmax."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.moe.sharded_moe import Route, load_balance_loss
    T, E = logits.shape
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    aux = load_balance_loss(gates, F.one_hot(gates.argmax(-1), E).float())
    queued = torch.zeros(E, device=logits.device)
    pos = []
    for j in range(k):
        m = F.one_hot(expert[:, j], E).to(torch.float32)
        pos.append(((torch.cumsum(m, 0) - 1.0 + queued) * m).sum(-1))
        queued = queued + m.sum(0)
    position = torch.stack(pos, 1).long()
    keep = position < capacity
    g = gates.gather(1, expert) * keep
    if k == 2:
        g = g / g.sum(-1, keepdim=True).clamp_min(
            torch.finfo(torch.float32).eps)
    return Route(aux, expert, position, keep, g, capacity)


class _RouteLog:
    """Within the block, every routing decision the MoE layers and the
    decode paths make (``moe.sharded_moe.route``): each call's chosen
    experts [tokens, k] as made (``raw``) and sorted per token
    (``calls``: a set, as the combine weights depend on the set).
    ``replay``: another log's ``raw`` calls, whose experts the calls
    here take in order (:func:`_replayed_route`)."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from deepspeed_tpu_torch.moe import layer, sharded_moe
        self.mods, self.orig = (layer, sharded_moe), sharded_moe.route
        self.calls, self.raw = [], []

        def rec(logits, k, capacity, *a, **kw):
            if self.replay is None:
                r = self.orig(logits, k, capacity, *a, **kw)
            else:
                r = _replayed_route(logits, k, capacity,
                                    self.replay[len(self.raw)])
            self.raw.append(r.expert.detach())
            self.calls.append(r.expert.detach().sort(dim=1).values)
            return r
        for m in self.mods:
            m.route = rec
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.route = self.orig


def _route_flips(a, b, label):
    """(agree [tokens] bool, flipped (token, layer) routes, routes) of two
    runs' route logs (one call a layer, the same tokens)."""
    import torch
    if len(a.calls) != len(b.calls) or not a.calls:
        fail(f"{label}: {len(a.calls)} and {len(b.calls)} routing calls")
    flip = torch.stack([(x != y).any(dim=1)
                        for x, y in zip(a.calls, b.calls)])
    return ~flip.any(dim=0), int(flip.sum()), flip.numel()


def _flip_bound(label, logs):
    """The bf16 route rule (MOE_FLIP_LIMIT's comment): ``logs`` holds the
    "auto" (kernel) and "reference" (plain) bf16 runs and "f32", the
    plain path in f32 on the same weights. Returns the counts."""
    import math
    _, k32, pairs = _route_flips(logs["auto"], logs["f32"], label)
    _, p32, _ = _route_flips(logs["reference"], logs["f32"], label)
    limit = p32 + 3 * math.sqrt(p32) + 5
    log(f"check: {label} routes against the f32 computation: kernels "
        f"flipped={k32} plain={p32} of {pairs} (token, layer) routes, "
        f"limit={limit:.1f} (plain + 3 sqrt(plain) + 5)")
    if k32 > limit:
        fail(f"{label}: the kernel path flips {k32} routes against f32, "
             f"the plain path {p32}")
    return {"kernel_vs_f32": k32, "plain_vs_f32": p32}


def _hold_moe_logits(label, got, ref, logs, tol_rel, limit=None):
    """Count the (token, layer) routes that differ between the kernel
    path and the plain path (at most ``limit`` of them where given), then
    hold the logits [tokens, V] on the tokens whose routes agree in every
    layer to ``tol_rel`` of the largest |logit|."""
    agree, flips, pairs = _route_flips(*logs, label)
    log(f"check: {label} routes kernels vs reference flipped={flips} of "
        f"{pairs} (token, layer) routes rate={flips / pairs:.2e} "
        + (f"limit={limit} " if limit is not None else "")
        + f"tokens held={int(agree.sum())}/{agree.numel()}")
    if limit is not None and flips > limit * pairs:
        fail(f"{label}: {flips} of {pairs} routes flipped")
    if not agree.any():
        fail(f"{label}: no token's routes agree")
    _hold_logits(f"{label} (agreeing routes)", got[agree], ref[agree],
                 tol_rel)
    return {"flips": flips, "routes": pairs,
            "held": int(agree.sum())}


def _moe_hold(label, run, tol_rel):
    """The route and logits rule (MOE_FLIP_LIMIT's comment) over one
    call: ``run(dtype, impl, replay)`` runs it in that compute dtype
    through the kernels ("auto") or the plain path ("reference"),
    replaying a route log's expert choices or not, and returns (logits
    [tokens, V] f32, its _RouteLog)."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    k32, lk32 = run(f32, "auto", None)
    p32, lp32 = run(f32, "reference", None)
    out = {"f32": _hold_moe_logits(f"{label} f32", k32, p32, (lk32, lp32),
                                   tol_rel, limit=MOE_FLIP_LIMIT)}
    del k32
    _, lkb = run(bf16, "auto", None)
    _, lpb = run(bf16, "reference", None)
    out["bf16_flips"] = _flip_bound(f"{label} bf16", {
        "auto": lkb, "reference": lpb, "f32": lp32})
    kb, _ = run(bf16, "auto", lp32.raw)
    pb, _ = run(bf16, "reference", lp32.raw)
    dev = {}
    for name, x in (("kernels", kb), ("plain", pb)):
        d = (x - p32).abs()
        dev[name] = (d.square().mean().sqrt().item(), d.max().item())
    kvp = (kb - pb).abs().max().item()
    agree = (kb.argmax(-1) == pb.argmax(-1)).float().mean().item()
    scale = p32.abs().max().item()
    log(f"check: {label} bf16 with the f32 run's routes replayed, "
        f"deviation from f32 (rms, max): kernels ({dev['kernels'][0]:.4e}, "
        f"{dev['kernels'][1]:.4e}) plain ({dev['plain'][0]:.4e}, "
        f"{dev['plain'][1]:.4e}) limit {MOE_BF16_RATIO} x plain; kernels "
        f"vs plain max_abs_err={kvp:.4e} max_abs_logit={scale:.4e} "
        f"argmax_agree={agree:.3f}")
    if any(dev["kernels"][i] > MOE_BF16_RATIO * dev["plain"][i]
           for i in (0, 1)):
        fail(f"{label}: bf16 kernels deviate from f32 by {dev['kernels']}, "
             f"the plain path by {dev['plain']}")
    out["bf16_vs_f32"] = dev
    del kb, pb, p32
    torch.cuda.empty_cache()
    return out


def _moe_generate_check(cfg, params, ids, tol_rel):
    """The generate prefill (the flash kernel) and one decode step (the
    decode kernel, on a copy of the bf16 kernel path's prefilled cache)
    under :func:`_moe_hold`."""
    import torch
    from deepspeed_tpu_torch.models.generation import (forward_with_cache,
                                                       init_cache,
                                                       padded_cache_len)
    B, T = ids.shape
    kept = {}

    def prefill(dtype, impl, replay):
        c = dataclasses.replace(cfg, dtype=dtype)
        cache = init_cache(c, B, padded_cache_len(T + MOE_NEW),
                           device="cuda")
        with torch.no_grad(), _RouteLog(replay) as lg:
            logits, cache = forward_with_cache(c, params, ids, cache,
                                               prefill_flash=True, impl=impl)
        if dtype == cfg.dtype and impl == "auto" and replay is None:
            kept["cache"] = cache
        return logits.reshape(B * T, -1).float(), lg

    out = {"prefill": _moe_hold("moe generate prefill", prefill, tol_rel)}
    cache = kept.pop("cache")
    tok = ids[:, -1:]

    def decode(dtype, impl, replay):
        c = dataclasses.replace(cfg, dtype=dtype)
        cc = {k: (v.to(dtype if v.is_floating_point() else v.dtype,
                       copy=True) if torch.is_tensor(v) else v)
              for k, v in cache.items()}
        with torch.no_grad(), _RouteLog(replay) as lg:
            logits = forward_with_cache(c, params, tok, cc, impl=impl)[0]
        return logits[:, -1].float(), lg

    out["decode"] = _moe_hold("moe generate decode", decode, tol_rel)
    del cache
    torch.cuda.empty_cache()
    return out


def _moe_decode_check(srv, tol_rel, label):
    """One decode step of the live lanes (paged_forward on copies of the
    pools: the paged kernel, int8 pools dequantized in it) under
    :func:`_moe_hold`; the routes and logits of the live lanes."""
    import torch
    from deepspeed_tpu_torch.serving.model_runner import paged_forward
    args, rows = _decode_inputs(srv, label)

    def step(dtype, impl, replay):
        c = dataclasses.replace(srv.cfg, dtype=dtype)
        pools = {k: v.to(dtype if v.is_floating_point() and k in ("k", "v")
                         else v.dtype, copy=True)
                 for k, v in srv.pools.items()}
        with torch.no_grad(), _RouteLog(replay) as lg:
            logits, _ = paged_forward(c, srv.params, args[0], pools,
                                      args[1], args[2], args[2] + 1,
                                      srv.block_size, impl=impl)
        lg.calls = [x[rows] for x in lg.calls]
        return logits[:, -1].float()[rows], lg

    return _moe_hold(f"{label} decode", step, tol_rel)


def _moe_train_model(cfg, seed, noise=True):
    """The train leg's model: the served config cut to MOE_TRAIN_LAYERS
    layers with the fused chunked CE, seeded f32 weights on the card.
    ``noise=False``: a Transformer whose forward takes no gating seed, so
    the engine trains it without top-2's Gumbel noise (the --ep-ranks
    leg's runs then compute one function)."""
    from deepspeed_tpu_torch.models.transformer import Transformer
    tcfg = dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS,
                               fused_loss=True, loss_chunk=256,
                               max_seq_len=MOE_SEQ)
    if noise:
        return Transformer(tcfg, seed=seed, device="cuda")

    class NoiseFree(Transformer):
        def forward(self, batch, train=False, dropout_seed=None):
            return super().forward(batch, train, dropout_seed)
    return NoiseFree(tcfg, seed=seed, device="cuda")


def _moe_engine(model, config, aux=MOE_AUX, rules=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import (
        fused_loss_passthrough, make_moe_loss)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config,
        loss_fn=make_moe_loss(aux, base_loss=fused_loss_passthrough),
        sharding_rules=rules)
    return engine


def _moe_tp_serve(cfg, served, rules, ids, ref_gen, prompts, ref_serve):
    """The moe leg's served model in the 1-rank NCCL world under the TP
    rules (the experts' columns and rows, and the attention heads, over a
    model axis of one): generate() on the leg's prompts and serve() of
    its requests, each bitwise the engine's without a process group, the
    kernel launches and the model-axis collectives counted (2 reduces a
    layer: the attention projection and the combined experts)."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    L = cfg.num_layers
    eng = deepspeed_tpu_torch.init_inference(
        cfg, {"dtype": "bf16", "serving": SERVING,
              "tensor_parallel": {"tp_size": 1}},
        model_parameters=served, sharding_rules=rules)
    if eng.tp is None:
        fail("moe tp: the engine runs without the TP layers")
    _zero_counters()
    comm.reset_op_counts()
    out = eng.generate(ids, max_new_tokens=MOE_NEW)
    gen, ops = _counters(), _tp_ops()
    same = torch.equal(out, ref_gen)
    log(f"check: moe tp generate tokens equal to the engine without a "
        f"process group: {same}; launches={json.dumps(gen)}")
    if not same or gen["flash_attention_fwd"] != L or \
            gen["decode_attention"] != L * (MOE_NEW - 1):
        fail(f"moe tp generate: tokens or launches off ({gen})")
    _tp_forward_ops("moe tp generate", ops, MOE_NEW, L)
    srv = eng.serve()
    rng = np.random.default_rng(15)
    _run_requests(srv, [list(rng.integers(1, cfg.vocab_size, 24))], 4)
    _instrument(srv)
    _zero_counters()
    comm.reset_op_counts()
    got = [list(r.output_tokens)
           for r in _run_requests(srv, prompts, MOE_NEW)]
    serve, ops = _counters(), _tp_ops()
    steps = srv._decode_step.calls
    log(f"check: moe tp serve requests={len(prompts)} decode_steps={steps} "
        f"outputs equal to the engine without a process group: "
        f"{got == ref_serve}; launches={json.dumps(serve)}")
    if got != ref_serve or serve["paged_attention"] != L * steps:
        fail(f"moe tp serve: outputs or launches off ({serve})")
    _tp_forward_ops("moe tp serve", ops, srv._run_prefill.calls + steps, L)
    del srv._run_prefill, srv._decode_step, srv, eng
    return {"tp_generate": gen, "tp_serve": serve}


def _moe_batch(rows, vocab, seed=21):
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, vocab, (rows, MOE_SEQ))}


def _moe_step(engine, batch, label, per_layer_micro):
    """One train_batch with the kernel and collective counters zeroed
    just before it: each flash kernel launches once a layer and
    micro-batch, and the MoE queues cross the expert group twice a layer
    in each forward and each backward (``comm.all_to_all``)."""
    import numpy as np
    from deepspeed_tpu_torch import comm
    _zero_counters()
    comm.reset_op_counts()
    t0 = time.perf_counter()
    m = engine.train_batch(batch)           # ends in a host read
    dt = time.perf_counter() - t0
    c, ops = _counters(), comm.op_counts()
    want = per_layer_micro
    if any(c[k] != want for k in FLASH_KERNELS) or \
            ops.get("all_to_all", 0) != 4 * want:
        fail(f"{label}: launched {c}, collectives {ops}: expected {want} of "
             f"each flash kernel and {4 * want} all-to-alls")
    if not np.isfinite(m["loss"]) or m["overflow"]:
        fail(f"{label}: {m}")
    return m, dt, {k: c[k] for k in FLASH_KERNELS}, ops


def _expert_flops(cfg, tokens):
    """The expert products' FLOPs of one forward over ``tokens`` tokens a
    layer: every queue slot is computed (C = k T / E x factor slots an
    expert), three [H, I] products a slot."""
    import math
    E, k = cfg.moe_experts, cfg.moe_k
    C = max(math.ceil(k * tokens / E * cfg.moe_capacity_factor), 4)
    return 2.0 * E * C * cfg.hidden_size * cfg.mlp_dim * 3 * cfg.num_layers


def _moe_train_rates(engine, batch, step_s, cfg, label, world=1):
    """Median step (after the first), tokens/s, model TFLOP/s on 6 x
    N_active beside the expert products' FLOPs as computed (every queue
    slot, forward + backward), peak memory, and one profiled step's busy
    ms and device ms by kind with the expert bmms as their own kind."""
    import numpy as np
    import torch
    dt = float(np.median(step_s[1:]))
    tokens = batch["input_ids"].shape[0] * batch["input_ids"].shape[1]
    micro_tokens = tokens // MOE_GAS // world
    n_active, n_all = cfg.num_active_params(), cfg.num_params()
    expert = 3 * _expert_flops(cfg, micro_tokens) * MOE_GAS * world
    busy, by_kind = profile_train(engine, batch, 1e3 * dt, label=label,
                                  split_bmm=True)
    return {"step_ms": 1e3 * dt, "tokens_s": tokens / dt,
            "n_active": n_active, "n_params": n_all,
            "model_tflops_6n_active": 6.0 * n_active * tokens / dt / 1e12
            / world,
            "expert_product_tflop_per_step": expert / 1e12,
            "expert_product_tflops": expert / dt / 1e12 / world,
            "step_ms_all": [round(1e3 * x, 3) for x in step_s],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "busy_ms": busy, "device_ms_by_kind": by_kind,
            "idle_share": 1 - busy / (1e3 * dt) if busy else None}


def _moe_train_check(module, micro, label):
    """One micro-batch's loss and grad norm under the route rule
    (MOE_FLIP_LIMIT's comment): the routes of the kernel path, the plain
    path and the plain path in f32 (a forward each, without noise) and
    the bf16 flip bound; then, the f32 run's routes replayed, the loss
    and grad norm of the kernel path and the plain path in bf16 against
    the plain path in f32: the kernel path within the train leg's 1e-3 /
    1e-2 of f32, or no further than MOE_BF16_RATIO x the plain path."""
    import torch
    from deepspeed_tpu_torch.models.transformer import (
        fused_loss_passthrough, make_moe_loss)
    loss_fn = make_moe_loss(MOE_AUX, base_loss=fused_loss_passthrough)
    logs = {}
    bf16 = module.cfg
    runs = (("auto", "auto", bf16.dtype),
            ("reference", "reference", bf16.dtype),
            ("f32", "reference", torch.float32))
    with torch.no_grad():
        for name, impl, dt in runs:
            _set_config(module, dataclasses.replace(
                bf16, attention_impl=impl, dtype=dt))
            with _RouteLog() as logs[name]:
                module(micro, train=True)
    bound = _flip_bound(label, logs)
    got = {}
    for name, impl, dt in runs:
        _set_config(module, dataclasses.replace(
            bf16, attention_impl=impl, dtype=dt))
        with _RouteLog(logs["f32"].raw):
            got[name] = _micro_loss_and_norm(module, micro, loss_fn)
    _set_config(module, bf16)
    torch.cuda.empty_cache()
    ref = got["f32"]
    rel = {n: [abs(a - b) / abs(b) for a, b in zip(got[n], ref)]
           for n in ("auto", "reference")}
    limits = (1e-3, 1e-2)
    ok = all(rel["auto"][i] <= max(limits[i],
                                   MOE_BF16_RATIO * rel["reference"][i])
             for i in (0, 1))
    log(f"check: {label} with the f32 run's routes replayed, against f32 "
        f"loss={ref[0]:.5f} grad_norm={ref[1]:.5f}: kernels loss rel "
        f"{rel['auto'][0]:.3e} grad_norm rel {rel['auto'][1]:.3e}; plain "
        f"loss rel {rel['reference'][0]:.3e} grad_norm rel "
        f"{rel['reference'][1]:.3e}; limit max(1e-3 / 1e-2, "
        f"{MOE_BF16_RATIO} x plain)")
    if not ok:
        fail(f"{label}: the kernel path is off the f32 computation")
    return {"vs_f32": rel, **bound}


def phase_moe(tmp, smi):
    """Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1's published config: hidden
    4096, 32 heads of 128 with 8 KV heads, 8 SwiGLU experts of 14336, two
    a token, vocab 32000, rope theta 1e6) at full width, as a seeded bf16
    state dict under HF's names built on the card one tensor at a time,
    the config a plain object. Serve and generate, MOE_SERVE_LAYERS (4)
    of 32 layers: replace_transformer_layer (bf16) -> init_inference
    (bf16) -> generate() on 4 x 1024 prompt tokens + 32 new (a
    flash_attention_fwd launch a layer a prefill, a decode_attention a
    layer a step), serve() with 8 requests of 64..1024 tokens and 32 new
    each (a paged_attention a layer a decode step), an int8 serve() (kv_cache_dtype and weight_dtype int8,
    4 requests, 16 new; 17 quant_matmul launches a forward: qkv and out
    projections and the head, the MoE subtree stays bf16); prefill and
    decode logits against impl="reference" under the flip rule. Train, 2
    layers: initialize with the moe section (ep_size 1) in a 1-rank NCCL
    world, make_moe_loss(0.02), pure bf16 state, AdamW, ZeRO 1, seq 1024,
    micro 2 x gas 2, MOE_STEPS steps (4 launches of each flash kernel and
    16 all-to-alls a step, over a group of one); the loss falls; the
    first step's loss and grad norm bitwise those of the same engine
    without a process group; one micro-batch against
    attention_impl="reference" under the flip rule. Readings: rates,
    decode step wall and busy ms, step ms, tokens/s, 6 x N_active TFLOP/s,
    the expert products' FLOPs, peak memory and device ms by kind."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from types import SimpleNamespace
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    from deepspeed_tpu_torch.parallel.mesh import set_global_mesh
    counts, rates = {}, {}
    L = MOE_SERVE_LAYERS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hf_cfg = SimpleNamespace(**dict(MIXTRAL_CONFIG, num_hidden_layers=L))
    # the state dict goes in without a name here, so the mapping frees it
    # before the module's copy is made
    module, params, cfg = deepspeed_tpu_torch.replace_transformer_layer(
        _mixtral_state_dict(L, seed=14), config=hf_cfg,
        arch="MixtralForCausalLM", dtype=torch.bfloat16)
    map_peak = torch.cuda.max_memory_allocated() / 1e9
    del module                          # init_inference reads the config
    n_params = _numel(params)
    eng = deepspeed_tpu_torch.init_inference(
        cfg, {"dtype": "bf16", "serving": SERVING}, model_parameters=params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe: mixtral-8x7b layers={L} params={n_params} "
        f"num_params={cfg.num_params()} active={cfg.num_active_params()} "
        f"experts={cfg.moe_experts} k={cfg.moe_k} capacity_factor="
        f"{cfg.moe_capacity_factor} heads={cfg.num_heads}x{cfg.head_dim} "
        f"kv_heads={cfg.kv_heads} map_s={time.perf_counter() - t0:.2f} "
        f"map_peak_gb={map_peak:.2f} "
        f"mem_gb={torch.cuda.memory_allocated() / 1e9:.2f}")
    if (cfg.moe_experts, cfg.moe_k, cfg.head_dim, cfg.kv_heads, L) != \
            (8, 2, 128, 8, cfg.num_layers) or n_params != cfg.num_params() \
            + 2 * L * cfg.hidden_size + cfg.hidden_size:
        fail(f"mixtral mapped to {cfg} with {n_params} parameters")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(15)
    V = cfg.vocab_size
    ids = torch.as_tensor(rng.integers(1, V, (MOE_BATCH, MOE_PROMPT)),
                          device="cuda")
    eng.generate(ids, max_new_tokens=2)                   # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.generate(ids, max_new_tokens=1)                   # prefill + 1 pick
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    _zero_counters()
    t1 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=MOE_NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t1
    gen = _counters()
    steps = MOE_NEW - 1
    log(f"moe: generate B={MOE_BATCH} prompt={MOE_PROMPT} new={MOE_NEW} "
        f"out={tuple(out.shape)} launches={json.dumps(gen)} "
        f"wall_s={total_s:.3f}")
    if tuple(out.shape) != (MOE_BATCH, MOE_PROMPT + MOE_NEW) or \
            not torch.equal(out[:, :MOE_PROMPT], ids):
        fail(f"moe generate returned {tuple(out.shape)}")
    if gen["flash_attention_fwd"] != L or \
            gen["decode_attention"] != L * steps:
        fail(f"moe generate launched {gen}: expected flash {L}, decode "
             f"{L * steps}")
    counts["generate"] = gen
    checks = {"generate": _moe_generate_check(eng.cfg, eng.params, ids,
                                              5e-2)}
    prof = profile_generate(eng.cfg, eng.params, ids, tag=" moe")
    # the expert products of the prefill: every queue slot at C = T
    prefill_tflop = _expert_flops(cfg, MOE_BATCH * MOE_PROMPT) / 1e12
    rates["generate"] = {
        "prefill_tok_s": MOE_BATCH * MOE_PROMPT / prefill_s,
        "decode_tok_s": MOE_BATCH * steps / (total_s - prefill_s),
        "decode_step_ms": 1e3 * (total_s - prefill_s) / steps,
        "prefill_ms": 1e3 * prefill_s,
        "prefill_expert_tflop": prefill_tflop,
        "prefill_model_tflops_2n_active":
            2.0 * cfg.num_active_params() * MOE_BATCH * MOE_PROMPT
            / prefill_s / 1e12,
        **prof}
    srv = eng.serve()
    _run_requests(srv, [list(rng.integers(1, V, 24))], 4)    # warm-up
    prompts = [list(rng.integers(1, V, int(n))) for n in
               rng.integers(MOE_PROMPT // 16, MOE_PROMPT + 1, MOE_REQUESTS)]
    _instrument(srv)
    stats0 = dict(srv.stats)
    _zero_counters()
    ref_serve = [list(r.output_tokens)
                 for r in _run_requests(srv, prompts, MOE_NEW)]
    serve_prompts = prompts
    serve = _counters()
    steps = srv._decode_step.calls
    _, rates["serve"] = _rates(srv, stats0, steps)
    log(f"moe: serve requests={len(prompts)} decode_steps={steps} "
        f"launches={json.dumps(serve)}")
    if steps == 0 or serve["paged_attention"] != L * steps:
        fail(f"moe serve: paged_attention launched "
             f"{serve['paged_attention']} times for {steps} decode steps")
    counts["serve"] = serve
    for p in prompts:
        srv.submit(p[:256], 8)
    srv.step()
    checks["serve"] = _moe_decode_check(srv, 5e-2, "moe serve")
    srv.run_until_idle()
    profile_decode(srv, label="moe serve decode step")
    del srv._run_prefill, srv._decode_step, srv
    torch.cuda.empty_cache()
    srv8 = eng.serve(dict(SERVING, kv_cache_dtype="int8",
                          weight_dtype="int8"))
    _run_requests(srv8, [list(rng.integers(1, V, 40))], 2)   # warm-up
    prompts = [list(rng.integers(1, V, int(n))) for n in MOE_INT8_LENS]
    _instrument(srv8, tqm.quant_matmul)
    stats0 = dict(srv8.stats)
    _zero_counters()
    _run_requests(srv8, prompts, MOE_INT8_NEW)
    int8 = _counters()
    pre, dec = srv8._run_prefill, srv8._decode_step
    _, rates["int8_serve"] = _rates(srv8, stats0, dec.calls)
    per_forward = 2 * L + 1
    log(f"moe: int8 serve requests={len(prompts)} launches="
        f"{json.dumps(int8)} quant_matmul prefill={pre.launches}/"
        f"{pre.calls} calls decode={dec.launches}/{dec.calls} steps")
    if (pre.launches != per_forward * pre.calls
            or dec.launches != per_forward * dec.calls
            or pre.launches + dec.launches != int8["quant_matmul"]
            or int8["paged_attention"] < L * dec.calls):
        fail(f"moe int8 serve launched {int8}: expected {per_forward} "
             "quant_matmul a forward")
    counts["int8_serve"] = int8
    # the timed wrappers hold the engine's bound methods
    del srv8._run_prefill, srv8._decode_step, pre, dec
    for p in prompts:
        srv8.submit(p[:128], 4)
    srv8.step()
    checks["int8_serve"] = _moe_decode_check(srv8, 5e-2, "moe int8 serve")
    srv8.run_until_idle()
    rates["serve_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("time: moe serve " + json.dumps(rates) + f" [{smi}]")
    # the served weights again, in the 1-rank group under the TP rules
    served = eng.params
    del srv8, eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe: serving legs done mem_gb="
        f"{torch.cuda.memory_allocated() / 1e9:.2f}")

    # ------------------------------------------------------------ train
    if comm.is_initialized():
        fail("moe: a process group is already up")
    batch = _moe_batch(MOE_MICRO * MOE_GAS, V)
    per = MOE_TRAIN_LAYERS * MOE_GAS
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref_engine = _moe_engine(_moe_train_model(cfg, seed=16),
                                 MOE_TRAIN_CONFIG)
        if ref_engine.dp is not None:
            fail("moe: the reference engine ran data parallel")
        _zero_counters()
        ref = ref_engine.train_batch(batch)
        del ref_engine
        gc.collect()
        torch.cuda.empty_cache()
        comm.init_distributed(world_size=1, rank=0)
        try:
            rules = cfg.tp_rules()
            counts.update(_moe_tp_serve(cfg, served, rules, ids, out,
                                        serve_prompts, ref_serve))
            del served
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            # the MoE-under-TP layers: the experts' columns and rows over
            # a model axis of one
            engine = _moe_engine(
                _moe_train_model(cfg, seed=16),
                dict(MOE_TRAIN_CONFIG, tensor_parallel={"tp_size": 1}),
                rules=rules)
            if engine.tp is None or engine.module.blocks[0].moe.tp is None:
                fail("moe: the group's engine runs without the TP layers")
            tcfg = engine.module.cfg
            log(f"moe: train layers={tcfg.num_layers} backend="
                f"{dist.get_backend()} world={dist.get_world_size()} "
                f"params={tcfg.num_params()} active="
                f"{tcfg.num_active_params()} seq {MOE_SEQ}, micro "
                f"{MOE_MICRO} x gas {MOE_GAS}, pure bf16, AdamW, ZeRO 1 "
                f"init_s={time.perf_counter() - t1:.2f} "
                f"mem_gb={torch.cuda.memory_allocated() / 1e9:.2f}")
            metrics, step_s = [], []
            for step in range(MOE_STEPS):
                m, dt, c, ops = _moe_step(engine, batch,
                                          f"moe train step {step}", per)
                # a micro-batch's model-axis collectives: 2 reduces a
                # layer (attention, the combined experts), the
                # embedding's and the CE chunks' (forward and
                # recomputation); the backward sums qkv's input and the
                # experts' tokens and combine weights a layer, and the
                # head's
                chunks = -(-(MOE_SEQ - 1) // 256)
                want = {"tp_reduce_from": MOE_GAS * (
                    2 * tcfg.num_layers + 1 + 2 * chunks),
                    "tp_copy_to": MOE_GAS * (3 * tcfg.num_layers + 1)}
                if {k: ops.get(k, 0) for k in want} != want:
                    fail(f"moe train step {step}: model-axis collectives "
                         f"{ops}, expected {want}")
                metrics.append(m)
                step_s.append(dt)
                log(f"moe: train step {step} loss={m['loss']:.6f} "
                    f"aux={m['aux']:.6f} grad_norm={m['grad_norm']:.5f} "
                    f"step_ms={1e3 * dt:.1f} launches={json.dumps(c)} "
                    f"collectives={json.dumps(ops)} (a group of one: the "
                    "all-to-alls move nothing)")
            first = metrics[0]
            bitwise = (first["loss"], first["grad_norm"]) == (
                ref["loss"], ref["grad_norm"])
            log(f"check: moe train first step vs the engine without a "
                f"process group loss={first['loss']:.9f}/{ref['loss']:.9f} "
                f"grad_norm={first['grad_norm']:.9f}/{ref['grad_norm']:.9f} "
                f"bitwise={bitwise}")
            if not bitwise:
                fail("moe train: the 1-rank group's first step is not the "
                     "single-process engine's")
            if not metrics[-1]["loss"] < metrics[0]["loss"]:
                fail(f"moe train: loss did not fall "
                     f"{[x['loss'] for x in metrics]}")
            train = _moe_train_rates(engine, batch, step_s, tcfg,
                                     "moe train step")
            micro = {"input_ids": torch.as_tensor(
                batch["input_ids"][:MOE_MICRO], device="cuda")}
            train.update(loss=[x["loss"] for x in metrics],
                         aux=[x["aux"] for x in metrics], launches=c,
                         collectives=ops,
                         check=_moe_train_check(engine.module, micro,
                                                "moe train micro-batch"))
            counts["train"] = c
            rates["train"] = train
            log("time: moe train " + json.dumps(train) + f" [{smi}]")
            del engine, micro
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            set_global_mesh(None)
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    return {"launches": counts, "rates": rates, "checks": checks}


def phase_ep_ranks(tmp, n):
    """``--ep-ranks N``: the moe train leg across N GPUs of one host at
    ``ep_size`` N (8 / N experts a rank), one process each through the
    port's launcher, one 1024-token sample a rank a micro-batch, gas 2.
    First the global batch through one engine without a process group on
    GPU 0; then :func:`ep_worker` on every GPU: EP_STEPS steps, each held
    to its flash launches and its all-to-alls (2 a layer in each forward
    and backward), the first step's loss within 1e-4 and grad norm within
    5e-3 of the single engine's (aux weight 0 and capacity E/k: no token
    drops, and without noise the two compute one function), the loss
    falling, rank 0's step time, tokens/s and NCCL device ms."""
    import torch
    cfg = _mixtral_cfg()
    config = dict(MOE_TRAIN_CONFIG, train_batch_size=n * MOE_GAS,
                  train_micro_batch_size_per_gpu=n)
    ref_engine = _moe_engine(_moe_train_model(cfg, 17, noise=False), config,
                             aux=0.0)
    _zero_counters()
    ref = ref_engine.train_batch(_moe_batch(n * MOE_GAS, cfg.vocab_size))
    del ref_engine
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "ep_ranks.json")
    env = dict(os.environ, PYTHONPATH=HERE)
    rc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
         "--nproc_per_node", str(n), os.path.join(HERE, "chip_smoke.py"),
         "--ep-worker", out], cwd=HERE, env=env, timeout=1200).returncode
    if rc != 0:
        fail(f"ep ranks: the launcher exited {rc}")
    with open(out) as f:
        res = json.load(f)
    first = res["metrics"][0]
    rl = abs(first["loss"] - ref["loss"]) / abs(ref["loss"])
    rn = abs(first["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
    log(f"check: ep ranks={n} first step vs one engine without a process "
        f"group loss={first['loss']:.7f}/{ref['loss']:.7f} rel={rl:.3e} "
        f"tol=1e-4 grad_norm={first['grad_norm']:.6f}/"
        f"{ref['grad_norm']:.6f} rel={rn:.3e} tol=5e-3")
    if not (rl <= 1e-4 and rn <= 5e-3):
        fail("ep ranks: the first step is off the single engine's")
    res.update(loss_rel=rl, grad_norm_rel=rn)
    return res


def ep_worker(out):
    """One rank of ``--ep-ranks``, started by the port's launcher (NCCL on
    cuda:LOCAL_RANK); rank 0 writes the readings to ``out``."""
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import ZERO_AXES
    comm.init_distributed()
    rank, world = comm.get_rank(), comm.get_world_size()
    cfg = _mixtral_cfg()
    config = dict(MOE_TRAIN_CONFIG, train_batch_size=world * MOE_GAS,
                  train_micro_batch_size_per_gpu=1,
                  moe={"enabled": True, "ep_size": world})
    engine = _moe_engine(_moe_train_model(cfg, 17, noise=False), config,
                         aux=0.0)
    batch = _moe_batch(world * MOE_GAS, cfg.vocab_size)
    local = sum(e.param.numel() for e in engine.dp.entries
                if e.eslab is not None)
    torch.cuda.reset_peak_memory_stats()
    metrics, step_s = [], []
    for step in range(EP_STEPS):
        m, dt, c, ops = _moe_step(engine, batch, f"ep ranks={world} rank "
                                  f"{rank} step {step}",
                                  MOE_TRAIN_LAYERS * MOE_GAS)
        metrics.append(m)
        step_s.append(dt)
        if rank == 0:
            log(f"ep ranks={world}: step {step} loss={m['loss']:.6f} "
                f"grad_norm={m['grad_norm']:.5f} step_ms={1e3 * dt:.1f} "
                f"launches={json.dumps(c)} collectives={json.dumps(ops)}")
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        fail(f"ep ranks: loss did not fall {[x['loss'] for x in metrics]}")
    if rank == 0:
        rates = _moe_train_rates(engine, batch, step_s, engine.module.cfg,
                                 f"ep ranks={world} step", world)
    else:
        engine.train_batch(batch)
        rates = {}
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                        device="cuda")
    rates.update(metrics=metrics, launches_rank0=c, collectives_rank0=ops,
                 expert_params_rank0=local, world=world,
                 peak_mem_gb_by_rank=comm.all_gather(
                     peak, axis=ZERO_AXES).tolist())
    if rank == 0:
        with open(out, "w") as f:
            json.dump(rates, f)
        log("time: ep ranks " + json.dumps(rates))
    del engine
    dist.destroy_process_group()
    return 0



# ------------------------------------------------------------------- 15. tp

# meta-llama/Llama-2-70b-hf config.json (the published widths); depth is
# cut per leg: TP_SERVE_LAYERS to serve and generate on one card,
# TP_TRAIN_LAYERS to train; --tp-ranks 4 serves the full 80 layers
LLAMA70_CONFIG = dict(
    model_type="llama", vocab_size=32000, hidden_size=8192,
    intermediate_size=28672, num_hidden_layers=80, num_attention_heads=64,
    num_key_value_heads=8, max_position_embeddings=4096, rope_theta=1e4,
    rms_norm_eps=1e-5, tie_word_embeddings=False, hidden_act="silu",
    attention_bias=False, mlp_bias=False)
# served depth cut 8 -> 4 (the script's time limit)
TP_SERVE_LAYERS, TP_TRAIN_LAYERS, TP_SEED = 4, 2, 15
TP_BATCH, TP_PROMPT, TP_NEW = 4, 1024, 32
TP_REQUESTS, TP_SERVE_NEW = 4, 16
TP_INT8_LENS, TP_INT8_NEW = (96, 200, 333, 512), 16
TP_MICRO, TP_GAS, TP_SEQ, TP_STEPS = 2, 2, 1024, 3
# pure bf16 state and bf16 grad accumulation (the zero leg's), AdamW,
# ZeRO 3: the policy composes its splits with the TP shards
TP_TRAIN_CONFIG = {
    "train_batch_size": TP_MICRO * TP_GAS,
    "train_micro_batch_size_per_gpu": TP_MICRO,
    "gradient_accumulation_steps": TP_GAS,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "bf16": {"enabled": True, "master_weights": False},
    "data_types": {"grad_accum_dtype": "bf16"},
    "zero_optimization": {"stage": 3},
    "steps_per_print": 10_000,
}
# --tp-ranks N: inference at tp N; training at tp 2 x data N / 2 (tp 1 on
# one GPU), seq TP_RANKS_SEQ, one sample a data rank a micro-batch, gas
# 2; the full-depth leg serves 80 x N / 4 layers (80 on four GPUs: about
# 34.5 GB of bf16 weights a rank)
TP_RANKS_SEQ, TP_RANKS_STEPS, TP_RANKS_WINDOW = 4096, 3, 64
# the bf16 rule of --tp-ranks (the moe leg's, MOE_FLIP_LIMIT's comment): each
# bf16 path's deviation from the f32 computation within TP_BF16_RATIO of
# the other's
TP_BF16_RATIO = 1.25


def _llama70_layer_shapes(i):
    """LlamaForCausalLM's state-dict names and shapes of layer ``i`` at
    the published widths."""
    c = LLAMA70_CONFIG
    H, I = c["hidden_size"], c["intermediate_size"]
    nh, kv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = H // nh
    p = f"model.layers.{i}."
    return [(p + "input_layernorm.weight", (H,)),
            (p + "post_attention_layernorm.weight", (H,)),
            (p + "self_attn.q_proj.weight", (nh * hd, H)),
            (p + "self_attn.k_proj.weight", (kv * hd, H)),
            (p + "self_attn.v_proj.weight", (kv * hd, H)),
            (p + "self_attn.o_proj.weight", (H, nh * hd)),
            (p + "mlp.gate_proj.weight", (I, H)),
            (p + "mlp.up_proj.weight", (I, H)),
            (p + "mlp.down_proj.weight", (H, I))]


def _llama70_tensor(name, shape, seed, device="cuda"):
    """One state-dict tensor, bf16, drawn from a generator of its own
    (seeded by ``seed`` and its name) as HF initializes it: normal std
    0.02, RMSNorm weights 1. Any subset of the tensors is drawn the same,
    so a rank draws only the layers it builds."""
    import zlib
    import torch
    if len(shape) == 1:
        return torch.ones(shape, device=device, dtype=torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(
        seed * (1 << 32) + zlib.crc32(name.encode()))
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.bfloat16).mul_(0.02)


def _llama70_state_dict(layers, seed, device="cuda"):
    """The HF-named state dict of the first ``layers`` layers (``device=
    "meta"``: the shapes only)."""
    import torch
    c = LLAMA70_CONFIG
    V, H = c["vocab_size"], c["hidden_size"]
    shapes = [("model.embed_tokens.weight", (V, H))]
    for i in range(layers):
        shapes += _llama70_layer_shapes(i)
    shapes += [("model.norm.weight", (H,)), ("lm_head.weight", (V, H))]
    if device == "meta":
        return {n: torch.empty(s, device="meta", dtype=torch.bfloat16)
                for n, s in shapes}
    return {n: _llama70_tensor(n, s, seed, device) for n, s in shapes}


def _llama70_cfg(layers):
    """The TransformerConfig that the Llama policy maps the published
    config to at ``layers`` layers (no weights)."""
    import torch
    from types import SimpleNamespace
    from deepspeed_tpu_torch.models.hf import load_hf
    hf_cfg = SimpleNamespace(**dict(LLAMA70_CONFIG,
                                    num_hidden_layers=layers))
    _, cfg = load_hf(_llama70_state_dict(layers, 0, "meta"),
                     arch="LlamaForCausalLM", config=hf_cfg,
                     dtype=torch.bfloat16)
    return cfg


def _llama70_shards(cfg, seed, tp, device="cuda"):
    """The scan-layout tree of ``cfg.num_layers`` layers with the values
    of :func:`_llama70_state_dict`, built one layer at a time, each whole
    layer mapped by the Llama policy's own ``models.hf.llama_layer`` and
    cut to this rank's shards (``tp``, a TPContext; None: whole). No rank
    holds more than one whole layer."""
    from deepspeed_tpu_torch.models.hf import llama_layer, stack_layers
    from deepspeed_tpu_torch.utils.partitioning import shard_tree
    rules = cfg.tp_rules()
    L, V, H = cfg.num_layers, cfg.vocab_size, cfg.hidden_size
    t = lambda n, s: _llama70_tensor(n, s, seed, device)
    top = shard_tree({
        "wte": {"embedding": t("model.embed_tokens.weight", (V, H))},
        "lm_head": {"kernel": t("lm_head.weight", (V, H)).t()},
        "ln_f": {"scale": t("model.norm.weight", (H,))}}, cfg, tp, rules)

    def local(i):
        w = {n: t(n, s) for n, s in _llama70_layer_shapes(i)}
        layer = llama_layer(lambda name: w["model." + name], i)
        layer = {k: {n: x[None] for n, x in v.items()}
                 for k, v in layer.items()}
        return {k: {n: x[0] for n, x in v.items()} for k, v in shard_tree(
            {"blocks": layer}, cfg, tp, rules)["blocks"].items()}
    return {**top, "blocks": stack_layers(local, L)}


def _trees_equal(a, b):
    import torch
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _trees_equal(a[k], b[k]) for k in a)
    return a.shape == b.shape and torch.equal(a, b)


def _tp_train_model(cfg, seed, seq):
    """The train legs' model: ``cfg`` cut to TP_TRAIN_LAYERS layers with
    the fused chunked CE, seeded f32 weights on the card."""
    from deepspeed_tpu_torch.models.transformer import Transformer
    tcfg = dataclasses.replace(cfg, num_layers=TP_TRAIN_LAYERS,
                               fused_loss=True, loss_chunk=256,
                               max_seq_len=seq)
    return Transformer(tcfg, seed=seed, device="cuda")


def _tp_engine(model, config, rules):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import fused_loss_passthrough
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config, loss_fn=fused_loss_passthrough,
        sharding_rules=rules)
    return engine


def _tp_batch(rows, vocab, seq, seed=21):
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, vocab, (rows, seq))}


def _tp_ops():
    from deepspeed_tpu_torch import comm
    return {k: v for k, v in comm.op_counts().items()
            if k.startswith("tp_") or k in ("all_reduce", "all_gather",
                                            "reduce_scatter")}


def _tp_forward_ops(label, ops, forwards, layers):
    """A TP forward issues 2 model-axis all-reduces a layer (the attention
    and MLP projections' partial sums) and one for the embedding, and
    gathers the vocab-parallel logits once."""
    want = {"tp_reduce_from": forwards * (2 * layers + 1),
            "tp_gather_from": forwards}
    got = {k: ops.get(k, 0) for k in want}
    log(f"check: {label} model-axis collectives {json.dumps(got)} expected "
        f"{json.dumps(want)} ({forwards} forwards x (2 x {layers} layers + "
        "the embedding) all-reduces, one logits gather a forward)")
    if got != want:
        fail(f"{label}: collectives {ops}")


def _tp_step_ops(label, ops, micro, layers, seq, chunk):
    """One train step's model-axis collectives: a micro-batch's forward
    all-reduces 2 a layer, the embedding's and each CE chunk's target
    logit (each chunk recomputed in the backward: its max, sum and target
    again); the backward sums the column-parallel inputs' gradients, 2 a
    layer and the head's."""
    chunks = -(-(seq - 1) // chunk)
    want = {"tp_reduce_from": micro * (2 * layers + 1 + 2 * chunks),
            "tp_copy_to": micro * (2 * layers + 1)}
    got = {k: ops.get(k, 0) for k in want}
    if got != want:
        fail(f"{label}: model-axis collectives {ops}, expected {want}")


def phase_tp(smi):
    """Llama-2-70B (meta-llama/Llama-2-70b-hf's published config: hidden
    8192, 64 heads of 128 over 8 KV heads, SwiGLU 28672, vocab 32000,
    RMSNorm 1e-5, rope 1e4, untied) at full width on one card, the
    tensor-parallel layers in a 1-rank NCCL world. Serve and generate,
    TP_SERVE_LAYERS (4) of 80 layers: a seeded bf16 state dict under HF's
    names -> replace_transformer_layer (and the same tree built layer by
    layer, as --tp-ranks builds it, held equal) -> init_inference without
    a process group: generate() [4, 1024] + 32 and serve() in bf16 and
    int8 (kv_cache_dtype and weight_dtype); then the same in the group
    with sharding_rules=cfg.tp_rules(): tokens bitwise equal, the kernel
    launches (flash L a prefill, decode L a step, paged L a step,
    quant_matmul 5L + 1 a forward) and the model-axis collectives (2 a
    layer forward, the embedding's and the logits gather) counted. Train,
    2 layers: pure bf16 state, AdamW, ZeRO 3, seq 1024, micro 2 x gas 2,
    TP_STEPS steps in the group under the rules, the first bitwise the
    engine's without a process group, the loss falling, each step's flash
    launches and collectives counted. Readings: prefill ms, decode step
    wall / busy / NCCL ms, tokens/s, step ms, 6N TFLOP/s, peak memory."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from types import SimpleNamespace
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    from deepspeed_tpu_torch.parallel.mesh import set_global_mesh
    if comm.is_initialized():
        fail("tp: a process group is already up")
    counts, rates, ops = {}, {}, {}
    L = TP_SERVE_LAYERS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hf_cfg = SimpleNamespace(**dict(LLAMA70_CONFIG, num_hidden_layers=L))
    module, params, cfg = deepspeed_tpu_torch.replace_transformer_layer(
        _llama70_state_dict(L, TP_SEED), config=hf_cfg,
        arch="LlamaForCausalLM", dtype=torch.bfloat16)
    del module
    map_s = time.perf_counter() - t0
    map_peak = torch.cuda.max_memory_allocated() / 1e9
    built = _llama70_shards(cfg, TP_SEED, None)
    same = _trees_equal(built, params)
    del built
    gc.collect()
    torch.cuda.empty_cache()
    n_params = _numel(params)
    log(f"tp: llama-2-70b layers={L} params={n_params} num_params="
        f"{cfg.num_params()} heads={cfg.num_heads}x{cfg.head_dim} kv_heads="
        f"{cfg.kv_heads} mlp={cfg.mlp_dim} map_s={map_s:.2f} map_peak_gb="
        f"{map_peak:.2f} layer_by_layer_tree_equal={same} mem_gb="
        f"{torch.cuda.memory_allocated() / 1e9:.2f}")
    if (cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.mlp_dim,
            cfg.vocab_size, cfg.num_layers) != (64, 8, 128, 28672, 32000, L) \
            or n_params != cfg.num_params() + (2 * L + 1) * cfg.hidden_size:
        fail(f"llama-2-70b mapped to {cfg} with {n_params} parameters")
    if not same:
        fail("tp: the layer-by-layer tree differs from the Llama policy's")
    rng = np.random.default_rng(16)
    V = cfg.vocab_size
    ids = torch.as_tensor(rng.integers(1, V, (TP_BATCH, TP_PROMPT)),
                          device="cuda")
    prompts = [list(rng.integers(1, V, int(n))) for n in
               rng.integers(TP_PROMPT // 16, TP_PROMPT + 1, TP_REQUESTS)]
    prompts8 = [list(rng.integers(1, V, int(n))) for n in TP_INT8_LENS]
    int8_serving = dict(SERVING, kv_cache_dtype="int8", weight_dtype="int8")

    def outputs(reqs):
        return [list(r.output_tokens) for r in reqs]

    # ------------------------------------------- without a process group
    eng = deepspeed_tpu_torch.init_inference(
        cfg, {"dtype": "bf16", "serving": SERVING}, model_parameters=params)
    ref = {"generate": eng.generate(ids, max_new_tokens=TP_NEW)}
    srv = eng.serve()
    ref["serve"] = outputs(_run_requests(srv, prompts, TP_SERVE_NEW))
    del srv
    srv8 = eng.serve(int8_serving)
    ref["int8"] = outputs(_run_requests(srv8, prompts8, TP_INT8_NEW))
    del srv8, eng
    gc.collect()
    torch.cuda.empty_cache()
    batch = _tp_batch(TP_MICRO * TP_GAS, V, TP_SEQ)
    chunk = 256
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref_engine = _tp_engine(_tp_train_model(cfg, 17, TP_SEQ),
                                TP_TRAIN_CONFIG, None)
        if ref_engine.dp is not None or ref_engine.tp is not None:
            fail("tp: the reference engine ran in a group")
        ref["train"] = ref_engine.train_batch(batch)
        del ref_engine
        gc.collect()
        torch.cuda.empty_cache()

        # ---------------------------------------- a 1-rank NCCL world
        comm.init_distributed(world_size=1, rank=0)
        try:
            rules = cfg.tp_rules()
            eng = deepspeed_tpu_torch.init_inference(
                cfg, {"dtype": "bf16", "serving": SERVING,
                      "tensor_parallel": {"tp_size": 1}},
                model_parameters=params, sharding_rules=rules)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            if eng.tp is None or eng.tp.size != 1:
                fail(f"tp: the engine runs without the TP layers ({eng.tp})")
            eng.generate(ids, max_new_tokens=2)             # warm-up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.generate(ids, max_new_tokens=1)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t1
            _zero_counters()
            comm.reset_op_counts()
            t1 = time.perf_counter()
            out = eng.generate(ids, max_new_tokens=TP_NEW)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t1
            gen, ops["generate"] = _counters(), _tp_ops()
            steps = TP_NEW - 1
            same = torch.equal(out, ref["generate"])
            log(f"check: tp generate B={TP_BATCH} prompt={TP_PROMPT} new="
                f"{TP_NEW} tokens equal to the engine without a process "
                f"group: {same}; launches={json.dumps(gen)}")
            if not same:
                fail("tp generate: tokens differ from the single engine's")
            if gen["flash_attention_fwd"] != L or \
                    gen["decode_attention"] != L * steps:
                fail(f"tp generate launched {gen}")
            _tp_forward_ops("tp generate", ops["generate"], TP_NEW, L)
            counts["generate"] = gen
            prof = profile_generate(eng.cfg, eng.params, ids, tag=" tp",
                                    tp=eng.tp)
            rates["generate"] = {
                "prefill_ms": 1e3 * prefill_s,
                "prefill_tok_s": TP_BATCH * TP_PROMPT / prefill_s,
                "decode_tok_s": TP_BATCH * steps / (total_s - prefill_s),
                "decode_step_ms": 1e3 * (total_s - prefill_s) / steps,
                **prof}
            srv = eng.serve()
            _run_requests(srv, [list(rng.integers(1, V, 24))], 4)  # warm
            _instrument(srv)
            stats0 = dict(srv.stats)
            _zero_counters()
            comm.reset_op_counts()
            got = outputs(_run_requests(srv, prompts, TP_SERVE_NEW))
            serve, ops["serve"] = _counters(), _tp_ops()
            steps = srv._decode_step.calls
            fwd = srv._run_prefill.calls + steps
            _, rates["serve"] = _rates(srv, stats0, steps)
            log(f"check: tp serve requests={len(prompts)} decode_steps="
                f"{steps} outputs equal to the engine without a process "
                f"group: {got == ref['serve']}; launches="
                f"{json.dumps(serve)}")
            if got != ref["serve"] or serve["paged_attention"] != L * steps:
                fail(f"tp serve: outputs or launches off ({serve})")
            _tp_forward_ops("tp serve", ops["serve"], fwd, L)
            counts["serve"] = serve
            del srv._run_prefill, srv._decode_step, srv
            torch.cuda.empty_cache()
            srv8 = eng.serve(int8_serving)
            _run_requests(srv8, [list(rng.integers(1, V, 40))], 2)  # warm
            _instrument(srv8, tqm.quant_matmul)
            stats0 = dict(srv8.stats)
            _zero_counters()
            comm.reset_op_counts()
            got = outputs(_run_requests(srv8, prompts8, TP_INT8_NEW))
            int8, ops["int8_serve"] = _counters(), _tp_ops()
            pre, dec = srv8._run_prefill, srv8._decode_step
            _, rates["int8_serve"] = _rates(srv8, stats0, dec.calls)
            per_forward = 5 * L + 1
            log(f"check: tp int8 serve outputs equal to the engine without "
                f"a process group: {got == ref['int8']}; launches="
                f"{json.dumps(int8)} quant_matmul prefill={pre.launches}/"
                f"{pre.calls} decode={dec.launches}/{dec.calls}")
            if (got != ref["int8"]
                    or pre.launches != per_forward * pre.calls
                    or dec.launches != per_forward * dec.calls
                    or int8["paged_attention"] != L * dec.calls):
                fail(f"tp int8 serve: outputs or launches off ({int8})")
            _tp_forward_ops("tp int8 serve", ops["int8_serve"],
                            pre.calls + dec.calls, L)
            counts["int8_serve"] = int8
            del srv8._run_prefill, srv8._decode_step, pre, dec, srv8, eng
            gc.collect()
            torch.cuda.empty_cache()
            rates["serve_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

            # ------------------------------------------------------ train
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            engine = _tp_engine(_tp_train_model(cfg, 17, TP_SEQ),
                                TP_TRAIN_CONFIG, rules)
            tcfg = engine.module.cfg
            Lt = tcfg.num_layers
            log(f"tp: train layers={Lt} backend={dist.get_backend()} world="
                f"{dist.get_world_size()} params={tcfg.num_params()} seq "
                f"{TP_SEQ}, micro {TP_MICRO} x gas {TP_GAS}, pure bf16, "
                f"AdamW, ZeRO 3, tp={engine.tp} init_s="
                f"{time.perf_counter() - t1:.2f} mem_gb="
                f"{torch.cuda.memory_allocated() / 1e9:.2f}")
            metrics, step_s = [], []
            for step in range(TP_STEPS):
                _zero_counters()
                comm.reset_op_counts()
                t1 = time.perf_counter()
                m = engine.train_batch(batch)
                step_s.append(time.perf_counter() - t1)
                c, o = _counters(), _tp_ops()
                metrics.append(m)
                log(f"tp: train step {step} loss={m['loss']:.6f} grad_norm="
                    f"{m['grad_norm']:.5f} step_ms={1e3 * step_s[-1]:.1f} "
                    f"launches={json.dumps({k: c[k] for k in FLASH_KERNELS})}"
                    f" collectives={json.dumps(o)}")
                if any(c[k] != Lt * TP_GAS for k in FLASH_KERNELS) or \
                        not np.isfinite(m["loss"]):
                    fail(f"tp train step {step}: {c} {m}")
                _tp_step_ops(f"tp train step {step}", o, TP_GAS, Lt, TP_SEQ,
                             chunk)
            first, want = metrics[0], ref["train"]
            bitwise = (first["loss"], first["grad_norm"]) == (
                want["loss"], want["grad_norm"])
            log(f"check: tp train first step vs the engine without a "
                f"process group loss={first['loss']:.9f}/{want['loss']:.9f} "
                f"grad_norm={first['grad_norm']:.9f}/"
                f"{want['grad_norm']:.9f} bitwise={bitwise}")
            if not bitwise:
                fail("tp train: the 1-rank group's first step is not the "
                     "single-process engine's")
            if not metrics[-1]["loss"] < metrics[0]["loss"]:
                fail(f"tp train: loss did not fall "
                     f"{[x['loss'] for x in metrics]}")
            dt = float(np.median(step_s[1:]))
            tokens = TP_MICRO * TP_GAS * TP_SEQ
            busy, by_kind = profile_train(engine, batch, 1e3 * dt,
                                          label="tp train step")
            counts["train"] = {k: c[k] for k in FLASH_KERNELS}
            ops["train"] = o
            rates["train"] = {
                "step_ms": 1e3 * dt, "tokens_s": tokens / dt,
                "model_tflops_6n": 6.0 * tcfg.num_params() * tokens / dt
                / 1e12, "n_params": tcfg.num_params(),
                "step_ms_all": [round(1e3 * x, 3) for x in step_s],
                "loss": [x["loss"] for x in metrics],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "busy_ms": busy, "device_ms_by_kind": by_kind,
                "nccl_ms": by_kind["nccl"]}
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            set_global_mesh(None)
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    log("time: tp " + json.dumps(rates) + f" [{smi}]")
    return {"launches": counts, "rates": rates, "collectives": ops}


def time_tp_kernels():
    """Rows 1-6 at a tp-4 rank's shapes of full-depth Llama-2-70B (16
    query heads of 128 a rank over 2 KV heads, repeated before the
    kernels): one decode step's paged attention (80 launches, 8 lanes at
    ctx 1024) and decode attention (80, 4 sequences at cur_len 1040), the
    [4, 1024] prefill's flash forward (80), one decode step's 401
    quant_matmul calls (80 layers x qkv N 2560, projection K 2048, gate
    and fc N 7168, MLP projection K 7168, and the head N 8000; one layer's
    weights reused, each larger than the L2), and the tp-2 train step's
    flash backward at [1, 32, 4096, 128] (4 launches: 2 layers x gas 2);
    each beside its plain version, a library call and its bound. Before
    it is timed, each kernel's output is held against its plain version
    on the same inputs (:func:`_hold`; 16-bit attention against the plain
    version on the inputs cast to f32, one layer's call; quant_matmul to
    2^-7 of the largest |ref|, each of the six matrices), and a miss
    fails. The bounds count the function's bytes: K and V (and dK, dV)
    at the KV heads, q, o, dq and dO at the query heads; the kernels
    read the KV heads repeated (ROADMAP item 0)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import decode_attention as tda
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    L, hd, nh, kvh = 80, 128, 16, 2
    rep = nh // kvh
    g = torch.Generator(device="cuda").manual_seed(70)
    bf = torch.bfloat16
    randn = lambda *s: torch.randn(*s, device="cuda", generator=g).to(bf)
    out = {}

    def step(fn, n=L):
        return lambda: [fn(li) for li in range(n)]

    def keep(name, t, nbytes, flops, work):
        bnd, by = bound_ms(nbytes, flops)
        out[name] = {**t, "bound_ms": bnd, "bound_by": by, "work": work,
                     "max_abs_err": errs[name]}
        log(f"time: tp4 {name} ms={t['ms']:.4f} bound_ms={bnd:.4f} ({by}) "
            f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
            f"max_abs_err={errs[name]:.3e} [{work}]")

    errs = {}
    f32 = lambda *ts: [x.float() for x in ts]

    # paged: one decode step, 8 lanes at ctx 1024, 32-token blocks
    B, bs, ctx = 8, 32, 1024
    per = ctx // bs
    nblk = B * per + 1
    k = randn(L, 2, nblk, bs, hd).repeat_interleave(rep, 1)
    v = randn(L, 2, nblk, bs, hd).repeat_interleave(rep, 1)
    q = randn(B, nh, 1, hd)
    bt = (torch.randperm(nblk - 1, device="cuda", generator=g)[:B * per] + 1
          ).reshape(B, per).to(torch.int32)
    lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    o = tpa.paged_attention(q, k, v, bt, lens, layer_idx=0)
    errs["paged_attention"] = _hold(
        "tp4 paged_attention layer 0", o, tpa.paged_attention_reference(
            *f32(q, k[:1], v[:1]), bt, lens, layer_idx=0), False)
    # the library yardstick: SDPA on K/V already gathered contiguous
    kc = k[:, :, bt.long()].permute(0, 2, 1, 3, 4, 5).reshape(L, B, nh, ctx,
                                                              hd)
    vc = v[:, :, bt.long()].permute(0, 2, 1, 3, 4, 5).reshape(L, B, nh, ctx,
                                                              hd)
    t = timings(
        step(lambda li: tpa.paged_attention(q, k, v, bt, lens, layer_idx=li)),
        step(lambda li: tpa.paged_attention_reference(q, k, v, bt, lens,
                                                      layer_idx=li)),
        step(lambda li: F.scaled_dot_product_attention(q, kc[li], vc[li])))
    keep("paged_attention", t,
         L * (2 * B * kvh * ctx * hd * 2 + 2 * B * nh * hd * 2
              + B * per * 4 + B * 4),
         L * 4 * B * nh * ctx * hd,
         f"one decode step of a tp-4 rank: {L} launches, B={B}, ctx={ctx}, "
         f"nh={nh} over {kvh} KV heads, hd={hd}, bf16 pool")
    del k, v, kc, vc
    # decode: one generate step, 4 sequences at cur_len 1040 of 1280
    B, cur, max_len = TP_BATCH, 1040, 1280
    k = randn(L, B, 2, max_len, hd).repeat_interleave(rep, 2)
    v = randn(L, B, 2, max_len, hd).repeat_interleave(rep, 2)
    q = randn(B, nh, 1, hd)
    o = tda.decode_attention(q, k, v, cur, layer_idx=0)
    errs["decode_attention"] = _hold(
        "tp4 decode_attention layer 0", o, tda.decode_attention_reference(
            *f32(q, k[:1], v[:1]), cur, layer_idx=0), False)
    t = timings(
        step(lambda li: tda.decode_attention(q, k, v, cur, layer_idx=li)),
        step(lambda li: tda.decode_attention_reference(q, k, v, cur,
                                                       layer_idx=li)),
        step(lambda li: F.scaled_dot_product_attention(
            q, k[li, :, :, :cur], v[li, :, :, :cur])))
    keep("decode_attention", t, L * (2 * B * kvh * cur * hd * 2
                                     + 2 * B * nh * hd * 2),
         L * 4 * B * nh * cur * hd,
         f"one generate step of a tp-4 rank: {L} launches, B={B}, "
         f"cur_len={cur}, nh={nh} over {kvh} KV heads, hd={hd}, bf16 "
         f"cache of {max_len}")
    del k, v
    # flash forward: the [4, 1024] prefill, causal
    S = TP_PROMPT
    q = randn(B, nh, S, hd)
    k = randn(B, 2, S, hd).repeat_interleave(rep, 1)
    v = randn(B, 2, S, hd).repeat_interleave(rep, 1)
    pairs = B * nh * S * (S + 1) // 2
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    ro, rl = tfa.flash_attention_reference(*f32(q, k, v), causal=True)
    errs["flash_attention_fwd"] = _hold("tp4 flash_attention_fwd o:", o, ro,
                                        False)
    err_l = _max_err(lse, rl)
    log(f"check: tp4 flash_attention_fwd lse max_abs_err={err_l:.3e} "
        f"tol={F32_TOL}")
    if not err_l <= F32_TOL:
        fail(f"tp4 flash_attention_fwd: lse err {err_l} > {F32_TOL}")
    del o, lse, ro, rl
    t = timings(step(lambda li: tfa.flash_attention_fwd(q, k, v,
                                                        causal=True)),
                step(lambda li: tfa.flash_attention_reference(
                    q, k, v, causal=True)),
                step(lambda li: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True)))
    keep("flash_attention_fwd", t, L * ((2 * nh + 2 * kvh) * B * S * hd * 2
                                        + B * nh * S * 4),
         L * 4 * hd * pairs,
         f"the prefill of a tp-4 rank: {L} launches, B={B}, H={nh}, "
         f"over {kvh} KV heads, S=Sk={S}, D={hd}, causal, bf16")
    del q, k, v
    # flash backward: the tp-2 train step, [1, 32, 4096, 128], 4 launches
    n = TP_TRAIN_LAYERS * 2
    B2, H2, K2, S2 = 1, 32, 4, TP_RANKS_SEQ
    q, do = randn(B2, H2, S2, hd), randn(B2, H2, S2, hd)
    k = randn(B2, K2, S2, hd).repeat_interleave(H2 // K2, 1)
    v = randn(B2, K2, S2, hd).repeat_interleave(H2 // K2, 1)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    # the kernels against the plain backward on the inputs cast to f32,
    # 8 heads at a time (the f32 scores of all 32 would take 8.6 GB)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    ref = [torch.empty(x.shape, dtype=torch.float32, device="cuda")
           for x in (dq, dk, dv)]
    for h in range(0, H2, 8):
        p = slice(h, h + 8)
        fq, fk, fv, fo, fdo = f32(*(x[:, p] for x in (q, k, v, o, do)))
        for r, x in zip(ref, tfa.flash_attention_bwd_reference(
                fq, fk, fv, fo, lse[:, p], fdo, causal=True)):
            r[:, p] = x
        del fq, fk, fv, fo, fdo
    errs["flash_attention_bwd_dq"] = _hold(
        "tp4 flash_attention_bwd dq:", dq, ref[0], False, floor=2.0 ** -10)
    errs["flash_attention_bwd_dkv"] = max(
        _hold(f"tp4 flash_attention_bwd {n}:", x, r, False, floor=2.0 ** -10)
        for n, x, r in (("dk", dk, ref[1]), ("dv", dv, ref[2])))
    del dq, dk, dv, ref
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib = device_ms(step(lambda li: torch.autograd.grad(
        so, (qs, ks, vs), do, retain_graph=True), n=n))
    plain = device_ms(lambda: tfa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=True), reps=1) * n
    pairs = B2 * H2 * S2 * (S2 + 1) // 2
    # one bf16 [B, H, S, D] at the query heads, one at the KV heads
    elem, elem_kv = B2 * H2 * S2 * hd * 2, B2 * K2 * S2 * hd * 2
    rows = B2 * H2 * S2 * 4
    for name, fn, nbytes, flops in (
            ("flash_attention_bwd_dq",
             lambda li: tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
             3 * elem + 2 * elem_kv + 2 * rows, 6 * hd * pairs),
            ("flash_attention_bwd_dkv",
             lambda li: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
             2 * elem + 4 * elem_kv + 2 * rows, 8 * hd * pairs)):
        t = {"ms": device_ms(step(fn, n=n)), "plain_ms": plain,
             "library_ms": lib, "wall_ms": wall_ms(step(fn, n=n))}
        keep(name, t, n * nbytes, n * flops,
             f"a tp-2 rank's train step: {n} launches, B={B2}, H={H2} "
             f"over {K2} KV heads, "
             f"S=Sk={S2}, D={hd}, causal, bf16; plain and library compute "
             "dq, dk and dv together (plain: one call timed, times "
             f"{n})")
    del q, k, v, do, o, lse, delta, qs, ks, vs, so
    # quant_matmul: one decode step of a tp-4 rank (M 8)
    shapes = [(8192, 2560), (2048, 8192), (8192, 7168), (8192, 7168),
              (7168, 8192)]
    gf = torch.Generator(device="cuda").manual_seed(72)
    mats = [tqm.pack_kernel(torch.randn(K, N, device="cuda", generator=gf))
            for K, N in shapes]
    head = tqm.pack_kernel(torch.randn(8192, 8000, device="cuda",
                                       generator=gf))
    dense = [(q_.float().reshape(-1, 256, q_.shape[-1]) * s[:, None]).reshape(
        q_.shape).to(bf) for q_, s in mats + [head]]
    M = 8
    xs = {K: randn(M, K) for K in (8192, 2048, 7168)}
    calls = [m for _ in range(L) for m in range(5)] + [5]
    allm = mats + [head]
    errs["quant_matmul"] = 0.0
    for qw, sw in allm:
        K, N = qw.shape
        got = tqm.quant_matmul(xs[K], qw, sw)
        ref = tqm.quant_matmul_reference(xs[K], qw, sw)
        torch.cuda.synchronize()
        err = _max_err(got, ref)
        tol = 2 ** -7 * ref.float().abs().max().item()
        log(f"check: tp4 quant_matmul M={M} K={K} N={N} x=bf16 "
            f"max_abs_err={err:.3e} tol={tol:.3e}")
        if got.dtype != xs[K].dtype or got.shape != (M, N) or not err <= tol:
            fail(f"tp4 quant_matmul {M}x{K}x{N}: err {err} > {tol}")
        errs["quant_matmul"] = max(errs["quant_matmul"], err)
    t = timings(
        lambda: [tqm.quant_matmul(xs[allm[i][0].shape[0]], *allm[i])
                 for i in calls],
        lambda: [tqm.quant_matmul_reference(xs[allm[i][0].shape[0]],
                                            *allm[i]) for i in calls],
        lambda: [torch.matmul(xs[dense[i].shape[0]], dense[i])
                 for i in calls])
    nbytes = sum(allm[i][0].numel() + 4 * allm[i][1].numel()
                 + 2 * M * sum(allm[i][0].shape) for i in calls)
    flops = sum(2 * M * allm[i][0].numel() for i in calls)
    keep("quant_matmul", t, nbytes, flops,
         f"one decode step of a tp-4 rank: {len(calls)} launches, M={M}, "
         "qkv 8192x2560, proj 2048x8192, gate / fc 8192x7168, mlp proj "
         "7168x8192 (80 layers), head 8192x8000; library: torch.matmul on "
         "the dequantized bf16 weights")
    del mats, head, dense, xs
    torch.cuda.empty_cache()
    return out


def phase_tp_ranks(tmp, n):
    """``--tp-ranks N``: the tp leg across N GPUs of one host, one process
    each through the port's launcher (NCCL on cuda:LOCAL_RANK). First,
    on GPU 0 without a process group: the 8-layer model (the layer-by-
    layer tree of :func:`_llama70_shards`) in f32 and in bf16, each
    engine's forward logits of the prompts' last TP_RANKS_WINDOW positions
    and the f32 engine's greedy generate() tokens; and the TP_TRAIN_LAYERS
    model's first train step on the global batch. Then
    :func:`tp_worker` on every GPU: (a) the same at tp N: the f32 tokens
    must equal, and each bf16 path's logits deviation from its f32
    engine's logits within TP_BF16_RATIO of the other's (RMS and max);
    (b) full-depth Llama-2-70B at tp N in bf16 (80 x N / 4 layers, each
    rank building its shards layer by layer): generate() [4, 1024] + 32
    and an int8 serve() (kv_cache_dtype and weight_dtype), equal on every
    rank, with prefill ms, decode step wall / busy / NCCL ms, tokens/s
    and each rank's peak memory; (c) training at tp 2 x data N / 2 (tp
    1 on one GPU), ZeRO 3, seq TP_RANKS_SEQ: the first step's loss within
    1e-4 and grad norm within 5e-3 of the single engine's, the loss
    falling, step ms, 6N TFLOP/s a GPU and NCCL ms."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    cfg = _llama70_cfg(TP_SERVE_LAYERS)
    ids = _tp_ids(cfg.vocab_size)
    params = _llama70_shards(cfg, TP_SEED, None)
    ref = {}
    for dt in ("float32", "bf16"):
        c = dataclasses.replace(cfg, dtype=torch.float32) \
            if dt == "float32" else cfg
        eng = deepspeed_tpu_torch.init_inference(
            c, {"dtype": dt}, model_parameters=params)
        ref[dt] = _prefill_logits(eng, ids)
        if dt == "float32":
            ref["tokens"] = eng.generate(ids, max_new_tokens=TP_NEW).cpu()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del params
    config = _tp_ranks_config(n, group=False)
    ref_engine = _tp_engine(_tp_train_model(cfg, 17, TP_RANKS_SEQ), config,
                            None)
    ref["train"] = ref_engine.train_batch(_tp_batch(
        config["train_batch_size"], cfg.vocab_size, TP_RANKS_SEQ))
    del ref_engine
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "tp_ranks.json")
    env = dict(os.environ, PYTHONPATH=HERE)
    rc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
         "--nproc_per_node", str(n), os.path.join(HERE, "chip_smoke.py"),
         "--tp-worker", out], cwd=HERE, env=env, timeout=1500).returncode
    if rc != 0:
        fail(f"tp ranks: the launcher exited {rc}")
    with open(out) as f:
        res = json.load(f)
    got = torch.load(out + ".pt")
    same = torch.equal(got["tokens"], ref["tokens"])
    dev = {}
    for name, x in (("tp", got), ("one", ref)):
        d = (x["bf16"].float() - ref["float32"].float())
        dev[name] = (d.square().mean().sqrt().item(), d.abs().max().item())
    f32_err = (got["float32"] - ref["float32"]).abs().max().item()
    log(f"check: tp ranks={n} f32 greedy tokens equal to one engine without "
        f"a process group: {same}; f32 logits max_abs_err={f32_err:.3e}; "
        f"bf16 deviation from f32 (rms, max): tp {dev['tp'][0]:.4e} / "
        f"{dev['tp'][1]:.4e}, one engine {dev['one'][0]:.4e} / "
        f"{dev['one'][1]:.4e}; limit {TP_BF16_RATIO}x each way")
    if not same:
        fail("tp ranks: the f32 tokens differ from the single engine's")
    for i in (0, 1):
        a, b = dev["tp"][i], dev["one"][i]
        if not (a <= TP_BF16_RATIO * b and b <= TP_BF16_RATIO * a):
            fail("tp ranks: the bf16 paths' deviations from f32 differ by "
                 f"more than {TP_BF16_RATIO}x")
    first, want = res["train"]["metrics"][0], ref["train"]
    rl = abs(first["loss"] - want["loss"]) / abs(want["loss"])
    rn = abs(first["grad_norm"] - want["grad_norm"]) / abs(want["grad_norm"])
    log(f"check: tp ranks={n} train first step vs one engine without a "
        f"process group loss={first['loss']:.7f}/{want['loss']:.7f} rel="
        f"{rl:.3e} tol=1e-4 grad_norm={first['grad_norm']:.6f}/"
        f"{want['grad_norm']:.6f} rel={rn:.3e} tol=5e-3")
    if not (rl <= 1e-4 and rn <= 5e-3):
        fail("tp ranks: the first train step is off the single engine's")
    res.update(tokens_equal=same, f32_logits_max_abs_err=f32_err,
               bf16_deviation={k: list(v) for k, v in dev.items()},
               loss_rel=rl, grad_norm_rel=rn)
    return res


def _prefill_logits(eng, ids):
    """The last TP_RANKS_WINDOW positions' f32 logits of the prompts'
    prefill through the generate path (the flash kernel on an empty
    cache), on the host."""
    import torch
    from deepspeed_tpu_torch.models.generation import (
        forward_with_cache, init_cache, padded_cache_len)
    B, T = ids.shape
    with torch.no_grad():
        cache = init_cache(eng.cfg, B, padded_cache_len(T), device="cuda",
                           tp=eng.tp)
        logits, _ = forward_with_cache(eng.cfg, eng.params, ids, cache,
                                       prefill_flash=True, tp=eng.tp)
    return logits[:, -TP_RANKS_WINDOW:].cpu()


def _tp_ids(vocab):
    import numpy as np
    import torch
    rng = np.random.default_rng(16)
    return torch.as_tensor(rng.integers(1, vocab, (TP_BATCH, TP_PROMPT)),
                           device="cuda")


def _tp_ranks_config(world, group=True):
    """--tp-ranks' train config: tp 2 x data world / 2 (tp 1 on one GPU),
    ZeRO 3, pure bf16, one TP_RANKS_SEQ sample a data rank a micro-batch,
    gas 2; ``group=False``: the same global batch on one engine."""
    tp = 2 if world >= 4 else 1
    data = world // tp
    cfg = dict(TP_TRAIN_CONFIG, train_batch_size=data * TP_GAS,
               train_micro_batch_size_per_gpu=1 if group else data)
    if group:
        cfg["tensor_parallel"] = {"tp_size": tp}
    return cfg


def tp_worker(out):
    """One rank of ``--tp-ranks``, started by the port's launcher (NCCL on
    cuda:LOCAL_RANK); rank 0 writes the readings to ``out`` (and the
    logits and tokens to ``out + ".pt"``)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    from deepspeed_tpu_torch.parallel.mesh import STEP_AXES
    from deepspeed_tpu_torch.utils.partitioning import TPContext
    comm.init_distributed()
    rank, world = comm.get_rank(), comm.get_world_size()
    res, tensors = {"world": world}, {}

    def peak_by_rank():
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                            device="cuda")
        return comm.all_gather(peak, axis=STEP_AXES).tolist()

    def agree(label, value):
        """Every rank holds the same ``value`` (tokens, outputs)."""
        import hashlib
        h = hashlib.sha256(json.dumps(value).encode()).digest()[:8]
        mine = torch.tensor(list(h), dtype=torch.int64, device="cuda")
        every = comm.all_gather(mine, axis=STEP_AXES, tiled=False)
        if not bool((every == mine).all()):
            fail(f"tp ranks: {label} differ across ranks")

    # (a) the 8-layer model at tp N, f32 and bf16
    cfg = _llama70_cfg(TP_SERVE_LAYERS)
    rules = cfg.tp_rules()
    ids = _tp_ids(cfg.vocab_size)
    tp = TPContext(rank, world, cfg.vocab_size)
    shards = _llama70_shards(cfg, TP_SEED, tp)
    for dt in ("float32", "bf16"):
        c = dataclasses.replace(cfg, dtype=torch.float32) \
            if dt == "float32" else cfg
        eng = deepspeed_tpu_torch.init_inference(
            c, {"dtype": dt, "tensor_parallel": {"tp_size": world}},
            shards=shards, sharding_rules=rules)
        tensors[dt] = _prefill_logits(eng, ids)
        if dt == "float32":
            tensors["tokens"] = eng.generate(ids,
                                             max_new_tokens=TP_NEW).cpu()
            agree("the f32 tokens", tensors["tokens"].tolist())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del shards
    gc.collect()
    torch.cuda.empty_cache()

    # (b) full depth at tp N in bf16
    torch.cuda.reset_peak_memory_stats()
    full = _llama70_cfg(80 * world // 4)
    t0 = time.perf_counter()
    shards = _llama70_shards(full, TP_SEED, tp)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng = deepspeed_tpu_torch.init_inference(
        full, {"dtype": "bf16", "tensor_parallel": {"tp_size": world},
               "serving": SERVING}, shards=shards, sharding_rules=rules)
    del shards
    gc.collect()
    torch.cuda.empty_cache()
    L = full.num_layers
    weights_gb = _numel(eng.params) * 2 / 1e9
    eng.generate(ids, max_new_tokens=2)                    # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.generate(ids, max_new_tokens=1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    _zero_counters()
    comm.reset_op_counts()
    t1 = time.perf_counter()
    toks = eng.generate(ids, max_new_tokens=TP_NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t1
    gen, gops = _counters(), _tp_ops()
    steps = TP_NEW - 1
    agree("the full-depth tokens", toks.tolist())
    if gen["flash_attention_fwd"] != L or \
            gen["decode_attention"] != L * steps:
        fail(f"tp ranks generate launched {gen}")
    _tp_forward_ops(f"tp ranks={world} rank {rank} generate", gops, TP_NEW,
                    L)
    prof = profile_generate(full, eng.params, ids, tag=f" tp{world}",
                            tp=eng.tp)
    gen_rates = {"layers": L, "build_s": build_s,
                 "weights_gb_a_rank": weights_gb,
                 "prefill_ms": 1e3 * prefill_s,
                 "prefill_tok_s": TP_BATCH * TP_PROMPT / prefill_s,
                 "decode_tok_s": TP_BATCH * steps / (total_s - prefill_s),
                 "decode_step_ms": 1e3 * (total_s - prefill_s) / steps,
                 "launches": gen, "collectives": gops, **prof}
    srv8 = eng.serve(dict(SERVING, kv_cache_dtype="int8",
                          weight_dtype="int8"))
    rng = np.random.default_rng(17)
    prompts8 = [list(rng.integers(1, full.vocab_size, int(k)))
                for k in TP_INT8_LENS]
    _run_requests(srv8, [list(rng.integers(1, full.vocab_size, 40))], 2)
    _instrument(srv8, tqm.quant_matmul)
    stats0 = dict(srv8.stats)
    _zero_counters()
    comm.reset_op_counts()
    reqs = _run_requests(srv8, prompts8, TP_INT8_NEW)
    int8, iops = _counters(), _tp_ops()
    pre, dec = srv8._run_prefill, srv8._decode_step
    _, int8_rates = _rates(srv8, stats0, dec.calls)
    agree("the int8 serve outputs", [r.output_tokens for r in reqs])
    if pre.launches != (5 * L + 1) * pre.calls or \
            dec.launches != (5 * L + 1) * dec.calls or \
            int8["paged_attention"] != L * dec.calls:
        fail(f"tp ranks int8 serve launched {int8}")
    int8_rates.update(launches=int8, collectives=iops)
    del srv8._run_prefill, srv8._decode_step, pre, dec, srv8, eng
    gc.collect()
    torch.cuda.empty_cache()
    res["full_depth"] = {"generate": gen_rates, "int8_serve": int8_rates,
                         "peak_mem_gb_by_rank": peak_by_rank()}
    if rank == 0:
        log(f"time: tp ranks={world} full depth " + json.dumps(
            res["full_depth"]))

    # (c) training at tp 2 x data N / 2
    torch.cuda.reset_peak_memory_stats()
    config = _tp_ranks_config(world)
    engine = _tp_engine(_tp_train_model(cfg, 17, TP_RANKS_SEQ), config,
                        rules)
    tcfg = engine.module.cfg
    batch = _tp_batch(config["train_batch_size"], cfg.vocab_size,
                      TP_RANKS_SEQ)
    metrics, step_s = [], []
    for step in range(TP_RANKS_STEPS):
        _zero_counters()
        comm.reset_op_counts()
        t1 = time.perf_counter()
        m = engine.train_batch(batch)
        step_s.append(time.perf_counter() - t1)
        c, o = _counters(), _tp_ops()
        metrics.append(m)
        if rank == 0:
            log(f"tp ranks={world}: train step {step} loss={m['loss']:.6f} "
                f"grad_norm={m['grad_norm']:.5f} step_ms="
                f"{1e3 * step_s[-1]:.1f} tp={engine.tp} "
                f"launches={json.dumps({k: c[k] for k in FLASH_KERNELS})} "
                f"collectives={json.dumps(o)}")
        if any(c[k] != tcfg.num_layers * TP_GAS for k in FLASH_KERNELS):
            fail(f"tp ranks train step {step} launched {c}")
        _tp_step_ops(f"tp ranks train step {step}", o, TP_GAS,
                     tcfg.num_layers, TP_RANKS_SEQ, 256)
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        fail(f"tp ranks: loss did not fall {[x['loss'] for x in metrics]}")
    dt = float(np.median(step_s[1:]))
    tokens = config["train_batch_size"] * TP_RANKS_SEQ
    if rank == 0:
        busy, by_kind = profile_train(engine, batch, 1e3 * dt,
                                      label=f"tp ranks={world} train step")
    else:                               # the profiled step is collective
        engine.train_batch(batch)
        busy, by_kind = None, {}
    res["train"] = {
        "metrics": metrics, "tp": engine.tp.size, "step_ms": 1e3 * dt,
        "tokens_s": tokens / dt, "n_params": tcfg.num_params(),
        "model_tflops_6n_a_gpu": 6.0 * tcfg.num_params() * tokens / dt
        / 1e12 / world,
        "step_ms_all": [round(1e3 * x, 3) for x in step_s],
        "launches": {k: c[k] for k in FLASH_KERNELS}, "collectives": o,
        "busy_ms_rank0": busy, "device_ms_by_kind_rank0": by_kind,
        "peak_mem_gb_by_rank": peak_by_rank()}
    del engine
    gc.collect()
    if rank == 0:
        torch.save(tensors, out + ".pt")
        with open(out, "w") as f:
            json.dump(res, f)
        log(f"time: tp ranks={world} train " + json.dumps(res["train"]))
    dist.destroy_process_group()
    return 0


# -------------------------------------------------------------- 15b. tp rest

# tiiuae/falcon-7b config.json (the published widths): 71 query heads of 64
# over one KV head (multi-query), parallel attention with one shared
# LayerNorm, rotary, an exact-GELU MLP of 18176, vocab 65024, the head tied
# to the embedding; depth is cut per leg
FALCON7B_CONFIG = dict(
    model_type="falcon", vocab_size=65024, hidden_size=4544,
    num_hidden_layers=32, num_attention_heads=71, multi_query=True,
    parallel_attn=True, alibi=False, bias=False,
    new_decoder_architecture=False, layer_norm_epsilon=1e-5,
    max_position_embeddings=2048, rope_theta=10000.0, activation="gelu",
    ffn_hidden_size=None, rope_scaling=None, tie_word_embeddings=True)
# the one-card falcon leg: FALCON_LAYERS of 32 served and trained at tp 1
FALCON_LAYERS, FALCON_SEED = 2, 19
FALCON_BATCH, FALCON_PROMPT, FALCON_NEW = 2, 512, 16
FALCON_LENS, FALCON_SERVE_NEW = (64, 200, 333, 512), 8
FALCON_SEQ = 1024
# --tp-rest-ranks N: Falcon-7B at tp N (32 layers served, TPR_FALCON_TRAIN
# trained), Mixtral-8x7B at tp N (32 layers served; TPR_MIXTRAL_CUT held to
# one GPU) and trained at tp 2 x ep N / 2, llama-1.1b int8 at tp N, and
# llama-1.1b at sp 2 x tp N / 2 (the sp leg's 16,384-token step)
TPR_BATCH, TPR_PROMPT, TPR_NEW = 2, 256, 16
TPR_LENS, TPR_SERVE_NEW = (64, 200, 333, 512), 16
TPR_FALCON_TRAIN, TPR_MIXTRAL_CUT, TPR_SEQ = 4, 4, 1024
# f32 training for the KV-column gradients (the held values), AdamW,
# ZeRO 1, one 1024-token sample a micro-batch, gas 2
TPR_TRAIN_CONFIG = {
    "train_batch_size": 2, "train_micro_batch_size_per_gpu": 1,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "zero_optimization": {"stage": 1}, "steps_per_print": 10_000,
}
# the KV-column gradients of a tp rank against one GPU's: max |diff| over
# the largest |ref| (f32, the partial sums in another order)
TPR_GRAD_TOL = 1e-3
# the Mixtral step at tp 2 x ep 2 (the moe leg's 2 layers, batch 2 x gas
# 2, AdamW, ZeRO 1) computes in f32, held to one GPU's like the other
# steps: in bf16 compute the row-parallel partial sums in another order
# moved its first loss by 1.6e-4 (pure bf16 state) and 1.2e-4 (an f32
# master), past 1e-4 (PERF.md, the tp-rest runs on four H100s)
TPR_MOE_CONFIG = {k: v for k, v in MOE_TRAIN_CONFIG.items()
                  if k not in ("bf16", "data_types")}


def _falcon_layer_shapes(i):
    """FalconForCausalLM's (7B-style) state-dict names and shapes of
    layer ``i`` at the published widths."""
    c = FALCON7B_CONFIG
    H, nh = c["hidden_size"], c["num_attention_heads"]
    hd, F = H // nh, 4 * H
    p = f"transformer.h.{i}."
    return [(p + "input_layernorm.weight", (H,)),
            (p + "input_layernorm.bias", (H,)),
            (p + "self_attention.query_key_value.weight",
             ((nh + 2) * hd, H)),
            (p + "self_attention.dense.weight", (H, nh * hd)),
            (p + "mlp.dense_h_to_4h.weight", (F, H)),
            (p + "mlp.dense_4h_to_h.weight", (H, F))]


def _falcon_tensor(name, shape, seed, device="cuda"):
    """One Falcon state-dict tensor as HF initializes it: a LayerNorm bias
    zeros, every other tensor as :func:`_llama70_tensor` draws it."""
    import torch
    if name.endswith(".bias"):
        return torch.zeros(shape, device=device, dtype=torch.bfloat16)
    return _llama70_tensor(name, shape, seed, device)


def _falcon_state_dict(layers, seed, device="cuda"):
    """The HF-named state dict of the first ``layers`` layers, each tensor
    drawn by :func:`_falcon_tensor` (``device="meta"``: the shapes
    only)."""
    import torch
    c = FALCON7B_CONFIG
    V, H = c["vocab_size"], c["hidden_size"]
    shapes = [("transformer.word_embeddings.weight", (V, H))]
    for i in range(layers):
        shapes += _falcon_layer_shapes(i)
    shapes += [("transformer.ln_f.weight", (H,)),
               ("transformer.ln_f.bias", (H,))]
    if device == "meta":
        return {n: torch.empty(s, device="meta", dtype=torch.bfloat16)
                for n, s in shapes}
    return {n: _falcon_tensor(n, s, seed, device) for n, s in shapes}


def _falcon_cfg(layers):
    """The TransformerConfig that the Falcon policy maps the published
    config to at ``layers`` layers (no weights)."""
    import torch
    from types import SimpleNamespace
    from deepspeed_tpu_torch.models.hf import load_hf
    hf_cfg = SimpleNamespace(**dict(FALCON7B_CONFIG,
                                    num_hidden_layers=layers))
    _, cfg = load_hf(_falcon_state_dict(layers, 0, "meta"),
                     arch="FalconForCausalLM", config=hf_cfg,
                     dtype=torch.bfloat16)
    return cfg


def _tree_map(fn, tree):
    return ({k: _tree_map(fn, v) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(tree))


def _layer_shards(layer, cfg, tp):
    """One layer's scan-layout tree cut to this rank's shards."""
    from deepspeed_tpu_torch.utils.partitioning import shard_tree
    cut = shard_tree({"blocks": _tree_map(lambda x: x[None], layer)}, cfg,
                     tp, cfg.tp_rules())["blocks"]
    return _tree_map(lambda x: x[0], cut)


def _falcon_shards(cfg, seed, tp, device="cuda"):
    """The scan-layout tree of ``cfg.num_layers`` Falcon-7B layers with
    the values of :func:`_falcon_state_dict`, mapped as the Falcon policy
    maps them, one layer at a time, cut to this rank's shards by the head
    map (``tp``; None: whole). No rank holds more than one whole layer."""
    from deepspeed_tpu_torch.models.hf import stack_layers
    from deepspeed_tpu_torch.utils.partitioning import shard_tree
    V, H = cfg.vocab_size, cfg.hidden_size
    t = lambda n, s: _falcon_tensor(n, s, seed, device)
    top = shard_tree({
        "wte": {"embedding": t("transformer.word_embeddings.weight",
                               (V, H))},
        "ln_f": {"scale": t("transformer.ln_f.weight", (H,)),
                 "bias": t("transformer.ln_f.bias", (H,))}}, cfg, tp,
        cfg.tp_rules())

    def local(i):
        w = {n.split(f".h.{i}.", 1)[1]: t(n, s)
             for n, s in _falcon_layer_shapes(i)}
        return _layer_shards({
            "ln1": {"scale": w["input_layernorm.weight"],
                    "bias": w["input_layernorm.bias"]},
            "attn_qkv": {"kernel":
                         w["self_attention.query_key_value.weight"].t()},
            "attn_proj": {"kernel": w["self_attention.dense.weight"].t()},
            "mlp_fc": {"kernel": w["mlp.dense_h_to_4h.weight"].t()},
            "mlp_proj": {"kernel": w["mlp.dense_4h_to_h.weight"].t()}},
            cfg, tp)
    return {**top, "blocks": stack_layers(local, cfg.num_layers)}


def _mixtral_named_state_dict(layers, seed, device="cuda"):
    """Mixtral's state dict with each tensor drawn from a generator of its
    own (:func:`_llama70_tensor`), so a rank draws any layer alone."""
    return {n: _llama70_tensor(n, s, seed, device)
            for n, s in _mixtral_shapes(layers)}


def _mixtral_shards(cfg, seed, tp, device="cuda"):
    """The scan-layout tree of ``cfg.num_layers`` Mixtral-8x7B layers with
    the values of :func:`_mixtral_named_state_dict`, mapped by the Mixtral
    policy's own ``models.hf.llama_layer`` one layer at a time and cut to
    this rank's shards (``tp``: every expert's ``fc`` / ``gate`` columns
    and ``proj`` rows; None: whole)."""
    from deepspeed_tpu_torch.models.hf import llama_layer, stack_layers
    from deepspeed_tpu_torch.utils.partitioning import shard_tree
    V, H = cfg.vocab_size, cfg.hidden_size
    t = lambda n, s: _llama70_tensor(n, s, seed, device)
    top = shard_tree({
        "wte": {"embedding": t("model.embed_tokens.weight", (V, H))},
        "lm_head": {"kernel": t("lm_head.weight", (V, H)).t()},
        "ln_f": {"scale": t("model.norm.weight", (H,))}}, cfg, tp,
        cfg.tp_rules())
    shapes = _mixtral_shapes(cfg.num_layers)

    def local(i):
        p = f"model.layers.{i}."
        w = {n: t(n, s) for n, s in shapes if n.startswith(p)}
        return _layer_shards(llama_layer(lambda name: w["model." + name], i,
                                         moe_experts=cfg.moe_experts),
                             cfg, tp)
    return {**top, "blocks": stack_layers(local, cfg.num_layers)}


def _falcon_train_model(cfg, seed, layers, seq, params=None):
    """Falcon-7B cut to ``layers`` layers with the fused chunked CE, on the
    card: the given scan-layout weights (whole), else seeded f32."""
    from deepspeed_tpu_torch.models.transformer import Transformer
    tcfg = dataclasses.replace(cfg, num_layers=layers, fused_loss=True,
                               loss_chunk=256, max_seq_len=seq)
    if params is None:
        return Transformer(tcfg, seed=seed, device="cuda")
    return Transformer(tcfg, params=_tree_map(
        lambda x: x.float(), params)).cuda()


def phase_falcon(smi):
    """Falcon-7B (tiiuae/falcon-7b's published config: hidden 4544, 71
    query heads of 64 over one KV head, parallel attention, vocab 65024,
    tied) at full width on one card, FALCON_LAYERS of 32 layers, through
    the head map in a 1-rank NCCL world (rank 0 of one computes heads [0,
    71) and holds KV head 0). A seeded bf16 state dict under HF's names ->
    replace_transformer_layer (the Falcon policy), and the same tree built
    layer by layer as --tp-rest-ranks builds it, held equal. Without a
    process group, then in the group under cfg.tp_rules(): generate()
    [2, 512] + 16, serve() of 4 requests and an int8 serve()
    (kv_cache_dtype and weight_dtype: K 4544 packs at the 256-row grid,
    padded), each bitwise; the launches (flash L a prefill, decode L a
    step, paged L a step, quant_matmul 4L a forward: qkv, proj, fc, mlp
    proj; the tied head stays bf16) and the model-axis collectives
    counted. Train, 2 layers (the tp leg's pure bf16 ZeRO 3 step): the
    first step bitwise the engine's without a group."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from types import SimpleNamespace
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    from deepspeed_tpu_torch.parallel.mesh import set_global_mesh
    if comm.is_initialized():
        fail("falcon: a process group is already up")
    L = FALCON_LAYERS
    t0 = time.perf_counter()
    hf_cfg = SimpleNamespace(**dict(FALCON7B_CONFIG, num_hidden_layers=L))
    module, params, cfg = deepspeed_tpu_torch.replace_transformer_layer(
        _falcon_state_dict(L, FALCON_SEED), config=hf_cfg,
        arch="FalconForCausalLM", dtype=torch.bfloat16)
    del module
    built = _falcon_shards(cfg, FALCON_SEED, None)
    same = _trees_equal(built, params)
    del built
    log(f"falcon: falcon-7b layers={L} params={_numel(params)} heads="
        f"{cfg.num_heads}x{cfg.head_dim} kv_heads={cfg.kv_heads} mlp="
        f"{cfg.mlp_dim} vocab={cfg.vocab_size} parallel_residual="
        f"{cfg.parallel_residual} map_s={time.perf_counter() - t0:.2f} "
        f"layer_by_layer_tree_equal={same}")
    if (cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.mlp_dim,
            cfg.vocab_size) != (71, 1, 64, 18176, 65024) or \
            not cfg.parallel_residual or not cfg.tie_embeddings:
        fail(f"falcon-7b mapped to {cfg}")
    if not same:
        fail("falcon: the layer-by-layer tree differs from the policy's")
    rng = np.random.default_rng(19)
    V = cfg.vocab_size
    ids = torch.as_tensor(rng.integers(1, V, (FALCON_BATCH, FALCON_PROMPT)),
                          device="cuda")
    prompts = [list(rng.integers(1, V, int(n))) for n in FALCON_LENS]
    int8_serving = dict(SERVING, kv_cache_dtype="int8", weight_dtype="int8")

    def legs(eng, label):
        """generate, serve and int8 serve outputs, launches, collectives."""
        out, counts, ops = {}, {}, {}
        _zero_counters()
        comm.reset_op_counts()
        out["generate"] = eng.generate(ids, max_new_tokens=FALCON_NEW)
        counts["generate"], ops["generate"] = _counters(), _tp_ops()
        for key, serving in (("serve", SERVING), ("int8_serve",
                                                   int8_serving)):
            srv = eng.serve(serving)
            _run_requests(srv, [list(rng.integers(1, V, 24))], 2)  # warm
            _instrument(srv, tqm.quant_matmul if key == "int8_serve"
                        else None)
            _zero_counters()
            comm.reset_op_counts()
            out[key] = [list(r.output_tokens) for r in
                        _run_requests(srv, prompts, FALCON_SERVE_NEW)]
            counts[key], ops[key] = _counters(), _tp_ops()
            pre, dec = srv._run_prefill, srv._decode_step
            counts[key]["forwards"] = [pre.calls, dec.calls]
            if key == "int8_serve":
                counts[key]["quant_matmul_by_path"] = [pre.launches,
                                                       dec.launches]
            del srv._run_prefill, srv._decode_step, pre, dec, srv
        log(f"falcon: {label} launches={json.dumps(counts)}")
        return out, counts, ops

    eng = deepspeed_tpu_torch.init_inference(
        cfg, {"dtype": "bf16", "serving": SERVING}, model_parameters=params)
    ref, _, _ = legs(eng, "without a process group")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    batch = _tp_batch(TP_MICRO * TP_GAS, V, FALCON_SEQ)
    torch.use_deterministic_algorithms(True, warn_only=True)
    rates = {}
    try:
        ref_engine = _tp_engine(_falcon_train_model(cfg, 17, TP_TRAIN_LAYERS,
                                                    FALCON_SEQ),
                                TP_TRAIN_CONFIG, None)
        ref["train"] = ref_engine.train_batch(batch)
        del ref_engine
        gc.collect()
        torch.cuda.empty_cache()
        comm.init_distributed(world_size=1, rank=0)
        try:
            rules = cfg.tp_rules()
            eng = deepspeed_tpu_torch.init_inference(
                cfg, {"dtype": "bf16", "serving": SERVING,
                      "tensor_parallel": {"tp_size": 1}},
                model_parameters=params, sharding_rules=rules)
            del params
            if eng.tp is None or eng.tp.head_range(cfg) != (0, 71, 0, 1):
                fail(f"falcon: the engine's head map is {eng.tp}")
            got, counts, ops = legs(eng, "in the 1-rank group")
            for key in ("serve", "int8_serve"):
                log(f"check: falcon {key} outputs equal to the engine "
                    f"without a process group: {got[key] == ref[key]}")
                if got[key] != ref[key]:
                    fail(f"falcon {key}: outputs differ")
            same = torch.equal(got["generate"], ref["generate"])
            log(f"check: falcon generate tokens equal to the engine "
                f"without a process group: {same}")
            if not same:
                fail("falcon generate: tokens differ")
            gen, srv, q8 = (counts["generate"], counts["serve"],
                            counts["int8_serve"])
            if gen["flash_attention_fwd"] != L or \
                    gen["decode_attention"] != L * (FALCON_NEW - 1) or \
                    srv["paged_attention"] != L * srv["forwards"][1] or \
                    q8["quant_matmul_by_path"] != [
                        4 * L * n for n in q8["forwards"]]:
                fail(f"falcon: launches {counts}")
            _tp_forward_ops("falcon generate", ops["generate"], FALCON_NEW,
                            L)
            _tp_forward_ops("falcon serve", ops["serve"],
                            sum(srv["forwards"]), L)
            t1 = time.perf_counter()
            eng.generate(ids, max_new_tokens=FALCON_NEW)
            torch.cuda.synchronize()
            rates["generate_s"] = time.perf_counter() - t1
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            engine = _tp_engine(_falcon_train_model(
                cfg, 17, TP_TRAIN_LAYERS, FALCON_SEQ), TP_TRAIN_CONFIG,
                rules)
            _zero_counters()
            comm.reset_op_counts()
            t1 = time.perf_counter()
            m = engine.train_batch(batch)
            rates["train_step_ms"] = 1e3 * (time.perf_counter() - t1)
            c, o = _counters(), _tp_ops()
            bitwise = (m["loss"], m["grad_norm"]) == (
                ref["train"]["loss"], ref["train"]["grad_norm"])
            log(f"check: falcon train first step vs the engine without a "
                f"process group loss={m['loss']:.9f}/"
                f"{ref['train']['loss']:.9f} grad_norm="
                f"{m['grad_norm']:.9f}/{ref['train']['grad_norm']:.9f} "
                f"bitwise={bitwise} launches="
                f"{json.dumps({k: c[k] for k in FLASH_KERNELS})}")
            if not bitwise or any(c[k] != TP_TRAIN_LAYERS * TP_GAS
                                  for k in FLASH_KERNELS):
                fail("falcon train: the 1-rank group's first step is not "
                     "the single-process engine's, or its launches are off")
            _tp_step_ops("falcon train step", o, TP_GAS, TP_TRAIN_LAYERS,
                         FALCON_SEQ, 256)
            counts["train"] = {k: c[k] for k in FLASH_KERNELS}
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            set_global_mesh(None)
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    log("time: falcon " + json.dumps(rates) + f" [{smi}]")
    return {"launches": {k: {n: v for n, v in c.items()
                             if n in KERNEL_MODULES}
                         for k, c in counts.items()}, "rates": rates}


def time_tp_rest_kernels():
    """Rows 1-6 at this slice's new shard shapes, each held against its
    plain version on the same inputs first (as :func:`time_tp_kernels`
    holds them; a miss fails), then timed beside its plain version, a
    library call and its bound. Falcon-7B's ranks at tp 4 compute 18, 18,
    18 and 17 query heads of 64 over its one KV head (repeated before the
    kernels): paged attention (one decode step, 32 launches, 8 lanes at
    ctx 1024), decode attention (one generate step, 32 launches, 4
    sequences at cur_len 1040), the flash forward ([4, 1024] prefill, 32
    launches) and the flash backward ([1, H, 2048, 64], 8 launches: 4
    layers x gas 2), each held at 18 and 17 heads and timed at 18.
    quant_matmul at a rank's (M, K, N, block) of a row shard off the
    256-row grid: llama-1.1b's mlp_proj at tp 4 (K 1408, block 128),
    Falcon-7B's attn_proj (K 1152 at block 128 on ranks 0-2, K 1088 at
    block 64 on rank 3) and mlp_proj (K 4544, block 64), each held; one
    decode step's row-parallel calls of Falcon-7B's rank 3 (32 layers x
    K 1088 and K 4544, block 64: 64 launches) timed."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import decode_attention as tda
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    L, hd = 32, 64
    g = torch.Generator(device="cuda").manual_seed(71)
    bf = torch.bfloat16
    randn = lambda *s: torch.randn(*s, device="cuda", generator=g).to(bf)
    f32 = lambda *ts: [x.float() for x in ts]
    out, errs = {}, {}

    def step(fn, n=L):
        return lambda: [fn(li) for li in range(n)]

    def keep(name, t, nbytes, flops, work):
        bnd, by = bound_ms(nbytes, flops)
        out[name] = {**t, "bound_ms": bnd, "bound_by": by, "work": work,
                     "max_abs_err": errs[name]}
        log(f"time: tp-rest {name} ms={t['ms']:.4f} bound_ms={bnd:.4f} "
            f"({by}) plain_ms={t['plain_ms']:.4f} library_ms="
            f"{t['library_ms']:.4f} max_abs_err={errs[name]:.3e} [{work}]")

    def heads(t, nh, dim):      # the one KV head repeated to nh query heads
        return t.expand(*t.shape[:dim], nh, *t.shape[dim + 1:]).contiguous()

    # paged: one decode step, 8 lanes at ctx 1024, 32-token blocks
    B, bs, ctx = 8, 32, 1024
    per = ctx // bs
    nblk = B * per + 1
    bt = (torch.randperm(nblk - 1, device="cuda", generator=g)[:B * per] + 1
          ).reshape(B, per).to(torch.int32)
    lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    k1, v1 = randn(L, 1, nblk, bs, hd), randn(L, 1, nblk, bs, hd)
    errs["paged_attention"] = 0.0
    for nh in (17, 18):
        k, v, q = heads(k1, nh, 1), heads(v1, nh, 1), randn(B, nh, 1, hd)
        o = tpa.paged_attention(q, k, v, bt, lens, layer_idx=0)
        errs["paged_attention"] = max(errs["paged_attention"], _hold(
            f"tp-rest paged_attention {nh} heads layer 0", o,
            tpa.paged_attention_reference(*f32(q, k[:1], v[:1]), bt, lens,
                                          layer_idx=0), False))
    kc = k[:, :, bt.long()].permute(0, 2, 1, 3, 4, 5).reshape(L, B, nh, ctx,
                                                              hd)
    vc = v[:, :, bt.long()].permute(0, 2, 1, 3, 4, 5).reshape(L, B, nh, ctx,
                                                              hd)
    t = timings(
        step(lambda li: tpa.paged_attention(q, k, v, bt, lens, layer_idx=li)),
        step(lambda li: tpa.paged_attention_reference(q, k, v, bt, lens,
                                                      layer_idx=li)),
        step(lambda li: F.scaled_dot_product_attention(q, kc[li], vc[li])))
    keep("paged_attention", t,
         L * (2 * B * ctx * hd * 2 + 2 * B * nh * hd * 2 + B * per * 4
              + B * 4),
         L * 4 * B * nh * ctx * hd,
         f"one decode step of Falcon-7B's tp-4 rank 0: {L} launches, B={B}, "
         f"ctx={ctx}, nh={nh} over 1 KV head, hd={hd}, bf16 pool")
    del k, v, kc, vc, k1, v1
    # decode: one generate step, 4 sequences at cur_len 1040 of 1280
    B, cur, max_len = 4, 1040, 1280
    k1, v1 = randn(L, B, 1, max_len, hd), randn(L, B, 1, max_len, hd)
    errs["decode_attention"] = 0.0
    for nh in (17, 18):
        k, v, q = heads(k1, nh, 2), heads(v1, nh, 2), randn(B, nh, 1, hd)
        o = tda.decode_attention(q, k, v, cur, layer_idx=0)
        errs["decode_attention"] = max(errs["decode_attention"], _hold(
            f"tp-rest decode_attention {nh} heads layer 0", o,
            tda.decode_attention_reference(*f32(q, k[:1], v[:1]), cur,
                                           layer_idx=0), False))
    t = timings(
        step(lambda li: tda.decode_attention(q, k, v, cur, layer_idx=li)),
        step(lambda li: tda.decode_attention_reference(q, k, v, cur,
                                                       layer_idx=li)),
        step(lambda li: F.scaled_dot_product_attention(
            q, k[li, :, :, :cur], v[li, :, :, :cur])))
    keep("decode_attention", t, L * (2 * B * cur * hd * 2
                                     + 2 * B * nh * hd * 2),
         L * 4 * B * nh * cur * hd,
         f"one generate step of Falcon-7B's tp-4 rank 0: {L} launches, "
         f"B={B}, cur_len={cur}, nh={nh} over 1 KV head, hd={hd}, bf16 "
         f"cache of {max_len}")
    del k, v, k1, v1
    # flash forward: the [4, 1024] prefill, causal
    S = 1024
    k1, v1 = randn(B, 1, S, hd), randn(B, 1, S, hd)
    errs["flash_attention_fwd"] = 0.0
    for nh in (17, 18):
        k, v, q = heads(k1, nh, 1), heads(v1, nh, 1), randn(B, nh, S, hd)
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
        ro, rl = tfa.flash_attention_reference(*f32(q, k, v), causal=True)
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], _hold(
            f"tp-rest flash_attention_fwd {nh} heads o:", o, ro, False))
        err_l = _max_err(lse, rl)
        log(f"check: tp-rest flash_attention_fwd {nh} heads lse "
            f"max_abs_err={err_l:.3e} tol={F32_TOL}")
        if not err_l <= F32_TOL:
            fail(f"tp-rest flash_attention_fwd: lse err {err_l}")
    del o, lse, ro, rl
    pairs = B * nh * S * (S + 1) // 2
    t = timings(step(lambda li: tfa.flash_attention_fwd(q, k, v,
                                                        causal=True)),
                step(lambda li: tfa.flash_attention_reference(
                    q, k, v, causal=True)),
                step(lambda li: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True)))
    keep("flash_attention_fwd", t, L * ((2 * nh + 2) * B * S * hd * 2
                                        + B * nh * S * 4),
         L * 4 * hd * pairs,
         f"the prefill of Falcon-7B's tp-4 rank 0: {L} launches, B={B}, "
         f"H={nh} over 1 KV head, S=Sk={S}, D={hd}, causal, bf16")
    del q, k, v, k1, v1
    # flash backward: 4 layers x gas 2 of a tp-4 rank's train step
    n = TPR_FALCON_TRAIN * 2
    S2 = 2048
    k1, v1 = randn(1, 1, S2, hd), randn(1, 1, S2, hd)
    errs["flash_attention_bwd_dq"] = errs["flash_attention_bwd_dkv"] = 0.0
    for nh in (17, 18):
        k, v = heads(k1, nh, 1), heads(v1, nh, 1)
        q, do = randn(1, nh, S2, hd), randn(1, nh, S2, hd)
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(-1)
        dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        ref = tfa.flash_attention_bwd_reference(*f32(q, k, v, o), lse,
                                                do.float(), causal=True)
        errs["flash_attention_bwd_dq"] = max(
            errs["flash_attention_bwd_dq"],
            _hold(f"tp-rest flash_attention_bwd {nh} heads dq:", dq, ref[0],
                  False, floor=2.0 ** -10))
        errs["flash_attention_bwd_dkv"] = max(
            errs["flash_attention_bwd_dkv"],
            *(_hold(f"tp-rest flash_attention_bwd {nh} heads {w}:", x, r,
                    False, floor=2.0 ** -10)
              for w, x, r in (("dk", dk, ref[1]), ("dv", dv, ref[2]))))
        del dq, dk, dv, ref
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib = device_ms(step(lambda li: torch.autograd.grad(
        so, (qs, ks, vs), do, retain_graph=True), n=n))
    plain = device_ms(lambda: tfa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=True), reps=1) * n
    pairs = nh * S2 * (S2 + 1) // 2
    elem, elem_kv, rows = nh * S2 * hd * 2, S2 * hd * 2, nh * S2 * 4
    for name, fn, nbytes, flops in (
            ("flash_attention_bwd_dq",
             lambda li: tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
             3 * elem + 2 * elem_kv + 2 * rows, 6 * hd * pairs),
            ("flash_attention_bwd_dkv",
             lambda li: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
             2 * elem + 4 * elem_kv + 2 * rows, 8 * hd * pairs)):
        t = {"ms": device_ms(step(fn, n=n)), "plain_ms": plain,
             "library_ms": lib, "wall_ms": wall_ms(step(fn, n=n))}
        keep(name, t, n * nbytes, n * flops,
             f"Falcon-7B's tp-4 rank 0 train step: {n} launches, B=1, "
             f"H={nh} over 1 KV head, S=Sk={S2}, D={hd}, causal, bf16; "
             f"plain and library compute dq, dk and dv together (plain: "
             f"one call timed, times {n})")
    del q, k, v, do, o, lse, delta, qs, ks, vs, so, k1, v1
    # quant_matmul: a rank's row shard packed at the finer block (M 8)
    M = 8
    cases = [("llama-1.1b mlp_proj, tp 4", 1408, 2048, 128),
             ("falcon-7b attn_proj, tp 4 ranks 0-2", 1152, 4544, 128),
             ("falcon-7b attn_proj, tp 4 rank 3", 1088, 4544, 64),
             ("falcon-7b mlp_proj, tp 4", 4544, 4544, 64)]
    gf = torch.Generator(device="cuda").manual_seed(73)
    mats = {}
    errs["quant_matmul"] = 0.0
    for label, K, N, block in cases:
        qw, sw = tqm.pack_kernel(torch.randn(K, N, device="cuda",
                                             generator=gf), block)
        x = randn(M, K)
        got = tqm.quant_matmul(x, qw, sw)
        ref = tqm.quant_matmul_reference(x, qw, sw)
        torch.cuda.synchronize()
        err = _max_err(got, ref)
        tol = 2 ** -7 * ref.float().abs().max().item()
        log(f"check: tp-rest quant_matmul {label} M={M} K={K} N={N} "
            f"block={block} x=bf16 max_abs_err={err:.3e} tol={tol:.3e}")
        if got.shape != (M, N) or not err <= tol:
            fail(f"tp-rest quant_matmul {M}x{K}x{N}@{block}: err {err}")
        errs["quant_matmul"] = max(errs["quant_matmul"], err)
        mats[K] = (x, qw, sw)
    calls = [mats[K] for _ in range(L) for K in (1088, 4544)]
    dense = {K: (q_.float().reshape(-1, 64, q_.shape[-1])
                 * s[:, None]).reshape(q_.shape).to(bf)
             for K, (_, q_, s) in mats.items() if K in (1088, 4544)}
    t = timings(lambda: [tqm.quant_matmul(*c) for c in calls],
                lambda: [tqm.quant_matmul_reference(*c) for c in calls],
                lambda: [torch.matmul(c[0], dense[c[1].shape[0]])
                         for c in calls])
    nbytes = sum(q_.numel() + 4 * s.numel() + 2 * M * sum(q_.shape)
                 for _, q_, s in calls)
    flops = sum(2 * M * q_.numel() for _, q_, _ in calls)
    keep("quant_matmul", t, nbytes, flops,
         f"one decode step's row-parallel calls of Falcon-7B's tp-4 rank 3: "
         f"{len(calls)} launches, M={M}, attn_proj 1088x4544 and mlp_proj "
         "4544x4544 at scale block 64 (32 layers); library: torch.matmul "
         "on the dequantized bf16 weights")
    del mats, dense, calls
    torch.cuda.empty_cache()
    return out


def phase_tp_rest_ranks(tmp, n):
    """``--tp-rest-ranks N``: the rest of tensor parallelism across N GPUs
    of one host, one process each through the port's launcher (NCCL on
    cuda:LOCAL_RANK). First, on GPU 0 without a process group, the
    references: Falcon-7B at full depth in f32 (greedy generate() [2, 256]
    + 16, and an f32-activation serve() with blockwise-int8 weights),
    Falcon-7B cut to TPR_FALCON_TRAIN layers (f32, the first step's loss
    and its first and last layers' KV-column gradients), Mixtral-8x7B cut
    to TPR_MIXTRAL_CUT layers in f32 (greedy tokens; one layer's tree
    built by the layer builder held equal to the Mixtral policy's), the
    moe leg's 2-layer step at batch 2 x gas 2 in f32 (aux 0, no noise, no
    drop),
    llama-1.1b's f32-activation int8 serve() and the sp leg's 16,384-token
    step. Then :func:`tp_rest_worker` on every GPU; each result is held
    here: the f32 tokens and int8 outputs equal, the first steps' losses
    within 1e-4 and grad norms within 5e-3
    (the KV-column gradients within
    TPR_GRAD_TOL of the largest), and the readings (wall and busy ms,
    weights a rank, peak memory) kept."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from types import SimpleNamespace
    from deepspeed_tpu_torch.models.transformer import get_config, init_params
    ref = {}
    rng = np.random.default_rng(20)

    def f32_engine(cfg, params, dtype="float32"):
        return deepspeed_tpu_torch.init_inference(
            dataclasses.replace(cfg, dtype=torch.float32), {
                "dtype": dtype, "serving": SERVING}, model_parameters=params)

    # Falcon-7B, full depth, f32
    fcfg = _falcon_cfg(32)
    fids = torch.as_tensor(rng.integers(1, fcfg.vocab_size,
                                        (TPR_BATCH, TPR_PROMPT)),
                           device="cuda")
    params = _falcon_shards(fcfg, FALCON_SEED, None)
    eng = f32_engine(fcfg, params)
    del params
    gc.collect()
    ref["falcon_tokens"] = eng.generate(fids, max_new_tokens=TPR_NEW).cpu()
    fprompts = [list(map(int, rng.integers(1, fcfg.vocab_size, int(k))))
                for k in TPR_LENS]
    ref["falcon_int8"] = [list(r.output_tokens) for r in _run_requests(
        eng.serve(dict(SERVING, weight_dtype="int8")), fprompts,
        TPR_SERVE_NEW)]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # Falcon-7B, TPR_FALCON_TRAIN layers, one f32 step
    ref["falcon_train"] = _falcon_kv_step(fcfg, None)
    gc.collect()
    torch.cuda.empty_cache()
    # Mixtral-8x7B: the layer builder against the policy, then the cut
    one = _mixtral_cfg(1)
    module, tree, _ = deepspeed_tpu_torch.replace_transformer_layer(
        _mixtral_named_state_dict(1, TP_SEED), arch="MixtralForCausalLM",
        config=SimpleNamespace(**dict(MIXTRAL_CONFIG, num_hidden_layers=1)),
        dtype=torch.bfloat16)
    del module
    same = _trees_equal(_mixtral_shards(one, TP_SEED, None), tree)
    log(f"check: tp-rest mixtral layer-by-layer tree equal to the policy's: "
        f"{same}")
    if not same:
        fail("tp-rest: the Mixtral layer builder differs from the policy")
    del tree
    mcfg = _mixtral_cfg(TPR_MIXTRAL_CUT)
    mids = torch.as_tensor(rng.integers(1, mcfg.vocab_size,
                                        (TPR_BATCH, TPR_PROMPT)),
                           device="cuda")
    params = _mixtral_shards(mcfg, TP_SEED, None)
    eng = f32_engine(mcfg, params)
    del params
    gc.collect()
    ref["mixtral_tokens"] = eng.generate(mids, max_new_tokens=TPR_NEW).cpu()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    config = dict(TPR_MOE_CONFIG, train_batch_size=2 * MOE_GAS,
                  train_micro_batch_size_per_gpu=2)
    engine = _moe_engine(_moe_train_model(dataclasses.replace(
        _mixtral_cfg(), dtype=torch.float32), 17, noise=False), config,
        aux=0.0)
    ref["mixtral_train"] = engine.train_batch(_moe_batch(2 * MOE_GAS,
                                                         mcfg.vocab_size))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # llama-1.1b: the int8 serve (f32 activations), the sp leg's step
    lcfg = get_config("llama-1.1b")
    lparams = init_params(lcfg, torch.Generator(device="cuda").manual_seed(0))
    eng = f32_engine(lcfg, lparams)
    del lparams
    lprompts = [list(map(int, rng.integers(1, lcfg.vocab_size, int(k))))
                for k in TPR_LENS]
    ref["llama_int8"] = [list(r.output_tokens) for r in _run_requests(
        eng.serve(dict(SERVING, weight_dtype="int8")), lprompts,
        TPR_SERVE_NEW)]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    engine, _ = _sp_engine(tmp, "sp_ref", "flash")
    ref["sp"] = engine.train_batch(_sp_batch(lcfg.vocab_size))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    plan = os.path.join(tmp, "tp_rest_plan.json")
    with open(plan, "w") as f:
        json.dump({"falcon_ids": fids.tolist(), "falcon_prompts": fprompts,
                   "mixtral_ids": mids.tolist(),
                   "llama_prompts": lprompts}, f)
    out = os.path.join(tmp, "tp_rest_ranks.json")
    env = dict(os.environ, PYTHONPATH=HERE)
    rc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
         "--nproc_per_node", str(n), os.path.join(HERE, "chip_smoke.py"),
         "--tp-rest-worker", out], cwd=HERE, env=env,
        timeout=1500).returncode
    if rc != 0:
        fail(f"tp-rest ranks: the launcher exited {rc}")
    with open(out) as f:
        res = json.load(f)
    got = torch.load(out + ".pt")
    for key in ("falcon_tokens", "mixtral_tokens"):
        same = torch.equal(got[key], ref[key])
        new_toks = ref[key][:, -TPR_NEW:].flatten().tolist()
        log(f"check: tp-rest ranks={n} {key} (f32, greedy) equal to one "
            f"engine without a process group: {same} "
            f"({len(set(new_toks))} distinct of {len(new_toks)} new tokens)")
        if not same:
            fail(f"tp-rest ranks: {key} differ from the single engine's")
    for key in ("falcon_int8", "llama_int8"):
        same = res[key]["outputs"] == ref[key]
        toks = [t for o in ref[key] for t in o]
        log(f"check: tp-rest ranks={n} {key} serve outputs (f32 "
            f"activations, blockwise int8 weights, row shards off the "
            f"256 grid) equal to one engine's: {same} ({len(set(toks))} "
            f"distinct of {len(toks)} tokens)")
        if not same:
            fail(f"tp-rest ranks: {key} outputs differ")
    for key, first, want in (
            ("falcon_train", res["falcon_train"], ref["falcon_train"]),
            ("mixtral_train", res["mixtral_train"], ref["mixtral_train"]),
            *((f"sp {m}", res["sp"][m], ref["sp"]) for m in res["sp"])):
        rl = abs(first["loss"] - want["loss"]) / abs(want["loss"])
        rn = abs(first["grad_norm"] - want["grad_norm"]) / abs(
            want["grad_norm"])
        log(f"check: tp-rest ranks={n} {key} first step vs one engine "
            f"without a process group loss={first['loss']:.7f}/"
            f"{want['loss']:.7f} rel={rl:.3e} tol=1e-4 grad_norm="
            f"{first['grad_norm']:.6f}/{want['grad_norm']:.6f} rel="
            f"{rn:.3e} tol=5e-3")
        if not (rl <= 1e-4 and rn <= 5e-3):
            fail(f"tp-rest ranks: {key}'s first step is off the single "
                 "engine's")
    for name, kv in ref["falcon_train"]["kv"].items():
        want = kv.cuda()
        scale = want.abs().max().item()
        worst = max((g.cuda() - want).abs().max().item() / scale
                    for g in got["falcon_kv"][name])
        log(f"check: tp-rest ranks={n} falcon {name} KV-column gradient "
            f"(every rank's copy of the one KV head) max_abs_err/max_ref="
            f"{worst:.3e} tol={TPR_GRAD_TOL}")
        if not worst <= TPR_GRAD_TOL:
            fail(f"tp-rest ranks: falcon {name} KV-column gradients off")
    return res


def _falcon_kv_step(cfg, tp, rules=None):
    """One f32 step of Falcon-7B cut to TPR_FALCON_TRAIN layers (the
    layer builder's weights, f32 compute; a tp rank: its shards through
    the engine):
    the loss, the grad norm, and the first and last layers' KV-column
    gradients (the one KV head's k and v columns of ``attn_qkv``), read
    from the step's gradients before the update."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import fused_loss_passthrough
    c = dataclasses.replace(cfg, num_layers=TPR_FALCON_TRAIN,
                            dtype=torch.float32)
    model = _falcon_train_model(c, 0, TPR_FALCON_TRAIN, TPR_SEQ,
                                params=_falcon_shards(c, FALCON_SEED, None))
    config = dict(TPR_TRAIN_CONFIG)
    if tp is not None:
        config["tensor_parallel"] = {"tp_size": tp.size}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config, loss_fn=fused_loss_passthrough,
        sharding_rules=rules)
    names = {id(p): n for n, p in engine.module.named_parameters()}
    keep = {f"blocks.{li}.attn_qkv.kernel"
            for li in (0, TPR_FALCON_TRAIN - 1)}
    kv = {}
    nh, hd = cfg.num_heads, cfg.head_dim
    ql = nh * hd if tp is None else tp.heads(cfg)[0] * hd

    def grab(params, grads):
        for p, g in zip(params, grads):
            if names.get(id(p)) in keep and names[id(p)] not in kv:
                kv[names[id(p)]] = g[:, ql:ql + 2 * hd].float().cpu()
    if engine.dp is not None:
        step_grads = engine.dp.step_grads

        def wrapped(denom):
            grads = step_grads(denom)
            grab([e.param for e in engine.dp.entries], grads)
            return grads
        engine.dp.step_grads = wrapped
    else:
        finalize = engine._finalize_step

        def wrapped(n_micro, losses):
            denom = float(n_micro) * engine.scale_state.scale
            grab(engine._params, [a / denom for a in engine._accum])
            return finalize(n_micro, losses)
        engine._finalize_step = wrapped
    m = engine.train_batch(_tp_batch(2, cfg.vocab_size, TPR_SEQ))
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": m["loss"], "grad_norm": m["grad_norm"], "kv": kv}


def tp_rest_worker(out):
    """One rank of ``--tp-rest-ranks``, started by the port's launcher
    (NCCL on cuda:LOCAL_RANK); rank 0 writes the readings to ``out`` (and
    the tokens and gradients to ``out + ".pt"``)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.transformer import (get_config,
                                                        init_params)
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    from deepspeed_tpu_torch.parallel.mesh import STEP_AXES, set_global_mesh
    from deepspeed_tpu_torch.utils.partitioning import TPContext
    comm.init_distributed()
    rank, world = comm.get_rank(), comm.get_world_size()
    tmp = os.path.dirname(out)
    with open(os.path.join(tmp, "tp_rest_plan.json")) as f:
        plan = json.load(f)
    res, tensors = {"world": world}, {}

    def all_ranks(value):
        t = torch.tensor([float(value)], device="cuda")
        return comm.all_gather(t, axis=STEP_AXES).tolist()

    def agree(label, value):
        import hashlib
        h = hashlib.sha256(json.dumps(value).encode()).digest()[:8]
        mine = torch.tensor(list(h), dtype=torch.int64, device="cuda")
        every = comm.all_gather(mine, axis=STEP_AXES, tiled=False)
        if not bool((every == mine).all()):
            fail(f"tp-rest ranks: {label} differ across ranks")

    def engine(cfg, shards, dtype, **extra):
        c = dataclasses.replace(cfg, dtype=torch.float32) \
            if dtype == "float32" else cfg
        return deepspeed_tpu_torch.init_inference(
            c, {"dtype": dtype, "serving": SERVING,
                "tensor_parallel": {"tp_size": world}, **extra},
            shards=shards, sharding_rules=cfg.tp_rules())

    def served(eng, prompts, serving, label, per_forward=None):
        """One serve() of ``prompts``: outputs (equal on every rank),
        decode step wall ms, tokens/s and launches."""
        srv = eng.serve(serving)
        _run_requests(srv, [prompts[0][:40]], 2)               # warm-up
        _instrument(srv, tqm.quant_matmul if per_forward else None)
        stats0 = dict(srv.stats)
        _zero_counters()
        reqs = _run_requests(srv, prompts, TPR_SERVE_NEW)
        c = _counters()
        pre, dec = srv._run_prefill, srv._decode_step
        _, rates = _rates(srv, stats0, dec.calls)
        outs = [list(r.output_tokens) for r in reqs]
        agree(label, outs)
        if per_forward and (pre.launches != per_forward * pre.calls
                            or dec.launches != per_forward * dec.calls):
            fail(f"tp-rest ranks {label}: quant_matmul launched "
                 f"{pre.launches}/{dec.launches} for {pre.calls}/"
                 f"{dec.calls} forwards ({per_forward} each)")
        if c["paged_attention"] != eng.cfg.num_layers * dec.calls:
            fail(f"tp-rest ranks {label}: launches {c}")
        del srv._run_prefill, srv._decode_step, pre, dec, srv
        return {"outputs": outs, "launches": c, **rates}

    def generated(eng, ids, label):
        """generate() timed (prefill, decode step), profiled (busy ms)."""
        L = eng.cfg.num_layers
        eng.generate(ids, max_new_tokens=2)                    # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.generate(ids, max_new_tokens=1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        _zero_counters()
        comm.reset_op_counts()
        t1 = time.perf_counter()
        toks = eng.generate(ids, max_new_tokens=TPR_NEW)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t1
        gen, ops = _counters(), _tp_ops()
        agree(label, toks.tolist())
        if gen["flash_attention_fwd"] != L or \
                gen["decode_attention"] != L * (TPR_NEW - 1):
            fail(f"tp-rest ranks {label}: launches {gen}")
        _tp_forward_ops(f"tp-rest ranks {label} rank {rank}", ops, TPR_NEW,
                        L)
        prof = profile_generate(eng.cfg, eng.params, ids, tag=f" {label}",
                                tp=eng.tp)
        return toks, {"layers": L, "prefill_ms": 1e3 * prefill_s,
                      "decode_step_ms": 1e3 * (total_s - prefill_s)
                      / (TPR_NEW - 1), "launches": gen, "collectives": ops,
                      "weights_gb_a_rank": _numel(eng.params) * 2 / 1e9,
                      **prof}

    # (a) Falcon-7B, all 32 layers: f32 tokens, int8 (f32 activations)
    # outputs, then bf16 generate and bf16 int8 serve timed
    fcfg = _falcon_cfg(32)
    tp = TPContext(rank, world, fcfg.vocab_size)
    fids = torch.as_tensor(plan["falcon_ids"], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shards = _falcon_shards(fcfg, FALCON_SEED, tp)
    build_s = time.perf_counter() - t0
    eng = engine(fcfg, shards, "float32")
    tensors["falcon_tokens"] = eng.generate(
        fids, max_new_tokens=TPR_NEW).cpu()
    agree("falcon f32 tokens", tensors["falcon_tokens"].tolist())
    res["falcon_int8"] = served(
        eng, plan["falcon_prompts"], dict(SERVING, weight_dtype="int8"),
        "falcon int8 (f32 activations)", 4 * fcfg.num_layers)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng = engine(fcfg, shards, "bf16")
    del shards
    gc.collect()
    _, res["falcon_generate"] = generated(eng, fids, "falcon bf16")
    res["falcon_generate"]["build_s"] = build_s
    res["falcon_int8_bf16"] = served(
        eng, plan["falcon_prompts"], dict(SERVING, kv_cache_dtype="int8",
                                          weight_dtype="int8"),
        "falcon int8 (bf16)", 4 * fcfg.num_layers)
    res["falcon_peak_gb_by_rank"] = all_ranks(
        torch.cuda.max_memory_allocated() / 1e9)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        log("time: tp-rest falcon " + json.dumps(
            {k: v for k, v in res.items() if k.startswith("falcon")}))
    # (b) Falcon-7B, TPR_FALCON_TRAIN layers, one f32 step at tp N
    step = _falcon_kv_step(fcfg, tp, fcfg.tp_rules())
    kv = torch.stack([step["kv"][n] for n in sorted(step["kv"])]).cuda()
    every = comm.all_gather(kv.contiguous(), axis=STEP_AXES, tiled=False)
    tensors["falcon_kv"] = {n: [every[r, i].cpu() for r in range(world)]
                            for i, n in enumerate(sorted(step["kv"]))}
    res["falcon_train"] = {"loss": step["loss"],
                           "grad_norm": step["grad_norm"]}
    set_global_mesh(None)

    # (c) Mixtral-8x7B: TPR_MIXTRAL_CUT layers in f32, then 32 in bf16
    mids = torch.as_tensor(plan["mixtral_ids"], device="cuda")
    mcut = _mixtral_cfg(TPR_MIXTRAL_CUT)
    tp = TPContext(rank, world, mcut.vocab_size)
    shards = _mixtral_shards(mcut, TP_SEED, tp)
    eng = engine(mcut, shards, "float32")
    del shards
    tensors["mixtral_tokens"] = eng.generate(
        mids, max_new_tokens=TPR_NEW).cpu()
    agree("mixtral f32 tokens", tensors["mixtral_tokens"].tolist())
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # all 32 layers on four GPUs (about 23 GB of bf16 weights a rank),
    # 32 x N / 4 on N
    mfull = _mixtral_cfg(max(32 * world // 4, 1))
    t0 = time.perf_counter()
    shards = _mixtral_shards(mfull, TP_SEED, tp)
    build_s = time.perf_counter() - t0
    eng = engine(mfull, shards, "bf16")
    del shards
    gc.collect()
    _, res["mixtral_generate"] = generated(eng, mids, "mixtral bf16")
    res["mixtral_generate"]["build_s"] = build_s
    res["mixtral_serve"] = served(
        eng, [p[:512] for p in plan["llama_prompts"]], SERVING,
        "mixtral bf16 serve")
    res["mixtral_peak_gb_by_rank"] = all_ranks(
        torch.cuda.max_memory_allocated() / 1e9)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    set_global_mesh(None)
    # (d) Mixtral-8x7B, 2 layers trained at tp 2 x ep N / 2 in f32
    torch.cuda.reset_peak_memory_stats()
    ep = max(world // 2, 1)
    config = dict(TPR_MOE_CONFIG, train_batch_size=2 * MOE_GAS,
                  train_micro_batch_size_per_gpu=2 // ep,
                  moe={"enabled": True, "ep_size": ep},
                  tensor_parallel={"tp_size": world // ep})
    mcfg = dataclasses.replace(_mixtral_cfg(), dtype=torch.float32)
    engine_ = _moe_engine(_moe_train_model(mcfg, 17, noise=False), config,
                          aux=0.0, rules=mcfg.tp_rules())
    batch = _moe_batch(2 * MOE_GAS, mcfg.vocab_size)
    metrics, step_s = [], []
    for i in range(EP_STEPS):
        m, dt, c, ops = _moe_step(engine_, batch, f"tp-rest ranks mixtral "
                                  f"rank {rank} step {i}",
                                  MOE_TRAIN_LAYERS * MOE_GAS)
        metrics.append(m)
        step_s.append(dt)
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        fail(f"tp-rest mixtral: loss did not fall "
             f"{[x['loss'] for x in metrics]}")
    if rank == 0:
        rates = _moe_train_rates(engine_, batch, step_s, engine_.module.cfg,
                                 f"tp-rest mixtral tp {world // ep} x ep "
                                 f"{ep} step", world)
    else:
        engine_.train_batch(batch)
        rates = {}
    res["mixtral_train"] = dict(
        rates, loss=metrics[0]["loss"], grad_norm=metrics[0]["grad_norm"],
        losses=[x["loss"] for x in metrics], launches=c, collectives=ops,
        tp=engine_.tp.size, ep=ep, peak_gb_by_rank=all_ranks(
            torch.cuda.max_memory_allocated() / 1e9))
    del engine_
    gc.collect()
    torch.cuda.empty_cache()
    set_global_mesh(None)

    # (e) llama-1.1b int8 at tp N: mlp_proj row shards of 5632 / N rows
    lcfg = get_config("llama-1.1b")
    tp = TPContext(rank, world, lcfg.vocab_size)
    from deepspeed_tpu_torch.utils.partitioning import shard_tree
    lparams = shard_tree(init_params(lcfg, torch.Generator(
        device="cuda").manual_seed(0)), lcfg, tp, lcfg.tp_rules())
    eng = engine(lcfg, lparams, "float32")
    res["llama_int8"] = served(
        eng, plan["llama_prompts"], dict(SERVING, weight_dtype="int8"),
        "llama int8 (f32 activations)", 5 * lcfg.num_layers + 1)
    del eng
    eng = engine(lcfg, lparams, "bf16")
    del lparams
    res["llama_int8_bf16"] = served(
        eng, plan["llama_prompts"], dict(SERVING, kv_cache_dtype="int8",
                                         weight_dtype="int8"),
        "llama int8 (bf16)", 5 * lcfg.num_layers + 1)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    set_global_mesh(None)

    # (f) llama-1.1b at sp 2 x tp N / 2, the sp leg's 16,384-token step
    # (from two GPUs up: one rank has no seq group to ring over)
    res["sp"] = {}
    sp = 2
    for mode in ("ring", "ulysses") if world >= sp else ():
        torch.cuda.reset_peak_memory_stats()
        config = dict(SP_CONFIG, sequence_parallel={"sp_size": sp,
                                                    "mode": mode},
                      tensor_parallel={"tp_size": world // sp})
        from deepspeed_tpu_torch.models.transformer import build_model
        model, cfg = build_model("llama-1.1b", fused_loss=True,
                                 loss_chunk=256, seed=0, device="cuda",
                                 max_seq_len=SP_SEQ, remat=True,
                                 remat_policy="full", attention_impl="auto",
                                 num_layers=SP_LAYERS)
        engine_, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=config, sharding_rules=cfg.tp_rules())
        batch = _sp_batch(cfg.vocab_size)
        want, want_ring = _sp_want(cfg.num_layers, sp, engine_.seq_rank,
                                   mode)
        metrics, step_s = [], []
        for i in range(SP_STEPS):
            m, dt, c, ring, ops = _sp_step(
                engine_, batch, f"tp-rest sp {sp} x tp {world // sp} {mode} "
                f"rank {rank} step {i}", want, want_ring)
            metrics.append(m)
            step_s.append(dt)
        if not metrics[-1]["loss"] < metrics[0]["loss"]:
            fail(f"tp-rest sp {mode}: loss did not fall")
        n_params = sum(p.numel() for p in engine_.module.parameters())
        if rank == 0:
            rates = _sp_rates(engine_, batch, step_s, n_params, cfg,
                              f"tp-rest sp {sp} x tp {world // sp} {mode} "
                              "step", world)
        else:
            engine_.train_batch(batch)
            rates = {}
        res["sp"][mode] = dict(
            rates, loss=metrics[0]["loss"],
            grad_norm=metrics[0]["grad_norm"],
            losses=[x["loss"] for x in metrics], launches_rank0=c,
            ring_rank0=ring, collectives_rank0=ops,
            world=[engine_.seq_world, engine_.tp.size],
            peak_gb_by_rank=all_ranks(
                torch.cuda.max_memory_allocated() / 1e9))
        del engine_, model
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(tensors, out + ".pt")
        with open(out, "w") as f:
            json.dump(res, f)
        log("time: tp-rest ranks " + json.dumps(
            {k: v for k, v in res.items() if not k.endswith("int8")}))
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------------ 16. pp

# the pp leg: gpt2-1.3b at full width and depth, 4 stages of 6 layers in
# one process (every stage on the one card), 8 micro-batches of 1 x 1024
PP_MODEL, PP_STAGES, PP_MICRO, PP_SEQ, PP_SEED = "gpt2-1.3b", 4, 8, 1024, 16
PP_STEPS = 2
# depth cut 24 -> 12 layers, 3 a stage (the script's time limit)
PP_LAYERS = 12
PP_SAVE_LAYERS = 1          # the save / load check's depth cut
PP_CONFIG = {
    "train_batch_size": PP_MICRO, "train_micro_batch_size_per_gpu": 1,
    "gradient_accumulation_steps": PP_MICRO, "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
    "steps_per_print": 10_000,
}
# --pp-ranks: gpt2-6.7b at full depth (32 layers, 8 a stage at pp 4),
# 1F1B with recompute, the same micro-batches; each rank builds its stage
# from per-layer seeds (models.pipeline.seeded_params)
PP_RANKS_MODEL, PP_RANKS_STEPS, PP_RANKS_SEED = "gpt2-6.7b", 4, 67


def _pp_batch(vocab, seed, rows=PP_MICRO):
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, vocab, (rows, PP_SEQ))}


def _pp_micros(batch, n):
    import torch
    ids = torch.as_tensor(batch["input_ids"], device="cuda")
    return {"input_ids": ids.reshape((n, -1) + tuple(ids.shape[1:]))}


def _pp_want(layers, pp, n, backward):
    """Flash launches of one pipeline step: a forward a layer and
    micro-batch (recompute: again in its backward, but the last stage
    skips the forward tick, as the JAX executor does) and one of each
    backward kernel."""
    fwd = layers * n
    if backward == "recompute":
        fwd += (layers - layers // pp) * n
    return {"flash_attention_fwd": fwd, "flash_attention_bwd_dq": layers * n,
            "flash_attention_bwd_dkv": layers * n}


def _pp_held(label, c, want):
    got = {k: c[k] for k in FLASH_KERNELS}
    if got != want:
        fail(f"pp: {label} launched {got}: expected {want}")
    return got


def _pp_timed(fn):
    """(result, wall ms, busy ms) of one call: wall between host clocks
    around it (synchronized), busy the device time torch.profiler records
    in a second call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in _key_averages(prof)
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return out, wall, busy


def phase_pp(tmp):
    """Pipelines on one card (the tentpole's ``pp`` leg): gpt2-1.3b at
    full width (16 heads x 128, vocab 50,257, seeded weights), PP_LAYERS
    of its 24 layers, as PP_STAGES stages in one process
    (``MPMDPipeline`` over a ``LocalChannel``, every stage on cuda:0),
    PP_MICRO micro-batches of 1 x PP_SEQ. (1) f32: the 1F1B step's loss
    within rel 1e-5 of autograd through the plain ``Transformer``, each
    leaf's grad within 1e-4 of its norm. (2) bf16 under deterministic
    algorithms: gpipe and 1F1B, recompute and store, all four bitwise
    equal; each step's flash launches held to its count; the extra memory
    each holds. (3) The plain engine at gas 8 and the ``PipelineEngine``
    (1F1B recompute, and store) on the same weights: PP_STEPS steps each,
    wall and busy ms. (4) The ``PipelineEngine`` at pp 1 in a 1-rank NCCL
    world: its first step against the plain engine's (loss rel 1e-6, grad
    norm rel 1e-5), and a save at a PP_SAVE_LAYERS-layer cut that loads
    back bitwise."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.convert import scan_params
    from deepspeed_tpu_torch.models.pipeline import PipelinedTransformer
    from deepspeed_tpu_torch.models.transformer import (
        Transformer, causal_lm_loss, get_config, init_params)
    from deepspeed_tpu_torch.parallel.mesh import set_global_mesh
    dev = torch.device("cuda")
    devices = [dev] * PP_STAGES
    res = {"launches": {}}
    if comm.is_initialized():
        fail("pp: a process group is already up")

    # (1) f32 against autograd through the plain model
    cfg = get_config(PP_MODEL, dtype=torch.float32, num_layers=PP_LAYERS)
    L = cfg.num_layers
    batch = _pp_batch(cfg.vocab_size, PP_SEED)
    micros = _pp_micros(batch, PP_MICRO)
    plain = Transformer(cfg, seed=PP_SEED, device="cuda")
    ls = []
    for m in range(PP_MICRO):
        ids = micros["input_ids"][m]
        loss = causal_lm_loss(plain(ids), ids)
        (loss / PP_MICRO).backward()
        ls.append(loss.detach())
    ref_loss = torch.stack(ls).mean().item()
    piped = PipelinedTransformer(cfg, PP_STAGES, PP_MICRO,
                                 params=scan_params(plain))
    _zero_counters()
    loss, grads = piped.pipeline_value_and_grad(micros, schedule="1f1b",
                                                devices=devices)
    c = _pp_held("the f32 1F1B step", _counters(),
                 _pp_want(L, PP_STAGES, PP_MICRO, "recompute"))
    res["launches"]["f32_1f1b_recompute"] = c
    rel = abs(loss.item() - ref_loss) / abs(ref_loss)
    worst, worst_name = 0.0, None
    for name, p in plain.named_parameters():
        r = ((grads[name] - p.grad.float()).norm() / p.grad.norm()).item()
        if r > worst:
            worst, worst_name = r, name
    log(f"check: pp f32 {PP_MODEL} pp={PP_STAGES} n_micro={PP_MICRO} 1F1B "
        f"loss={loss.item():.7f} plain={ref_loss:.7f} rel={rel:.3e} "
        f"tol=1e-5; worst leaf grad rel={worst:.3e} ({worst_name}) tol=1e-4 "
        f"launches={json.dumps(c)}")
    if rel > 1e-5 or worst > 1e-4:
        fail("pp: the f32 pipeline is off autograd through the plain model")
    res["f32"] = {"loss_rel": rel, "worst_grad_rel": worst}
    del plain, piped, grads, loss, ls
    gc.collect()
    torch.cuda.empty_cache()

    # (2) bf16: four (schedule, backward) pairs, bitwise
    cfg = get_config(PP_MODEL, num_layers=PP_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(PP_SEED)
    tree = init_params(cfg, gen, dtype=torch.bfloat16)
    base, runs = None, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for bw in ("recompute", "store"):
            model = PipelinedTransformer(cfg, PP_STAGES, PP_MICRO,
                                         backward=bw, params=tree)
            for sched in ("1f1b", "gpipe"):
                gc.collect()
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                _zero_counters()
                t0 = time.perf_counter()
                loss, grads = model.pipeline_value_and_grad(
                    micros, schedule=sched, devices=devices)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
                extra = (torch.cuda.max_memory_allocated() - held) / 1e9
                c = _pp_held(f"the bf16 {sched} {bw} step", _counters(),
                             _pp_want(L, PP_STAGES, PP_MICRO, bw))
                res["launches"][f"bf16_{sched}_{bw}"] = c
                same = None
                if base is None:
                    base = (loss, grads)
                else:
                    same = bool(torch.equal(loss, base[0]) and all(
                        torch.equal(grads[k], base[1][k]) for k in grads))
                runs[f"{sched}_{bw}"] = {"loss": loss.item(),
                                         "wall_ms": wall,
                                         "extra_peak_gb": extra,
                                         "bitwise_1f1b_recompute": same}
                log(f"pp: bf16 {sched} {bw} loss={loss.item():.7f} "
                    f"wall_ms={wall:.1f} extra_peak_gb={extra:.2f} "
                    f"bitwise_with_1f1b_recompute={same} "
                    f"launches={json.dumps(c)}")
                if same is False:
                    fail(f"pp: bf16 {sched} {bw} differs from 1F1B "
                         "recompute")
                del loss, grads
            del model
    finally:
        torch.use_deterministic_algorithms(False)
    if not runs["gpipe_store"]["extra_peak_gb"] > \
            runs["1f1b_store"]["extra_peak_gb"]:
        fail("pp: gpipe with store held no more memory than 1F1B")
    res["bf16"] = runs
    del base, tree
    gc.collect()
    torch.cuda.empty_cache()

    # (3) the engines, one process, the same seeded weights
    path = os.path.join(tmp, "ds_pp.json")
    steps = {}
    tokens = PP_MICRO * PP_SEQ
    for name, make, extra in (
            ("plain", lambda: Transformer(cfg, seed=PP_SEED, device="cuda"),
             {}),
            ("pipe_1f1b_recompute", lambda: PipelinedTransformer(
                cfg, PP_STAGES, PP_MICRO, seed=PP_SEED, device="cuda"),
             {"pipeline": {"schedule": "1f1b"}}),
            ("pipe_1f1b_store", lambda: PipelinedTransformer(
                cfg, PP_STAGES, PP_MICRO, backward="store", seed=PP_SEED,
                device="cuda"), {"pipeline": {"schedule": "1f1b"}})):
        with open(path, "w") as f:
            json.dump(dict(PP_CONFIG, **extra), f)
        t1 = time.perf_counter()
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=make(), config=path, loss_fn=causal_lm_loss)
        init_s = time.perf_counter() - t1
        n_params = sum(p.numel() for p in engine._params)
        ms, ws = [], []
        for s in range(PP_STEPS):
            _zero_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = engine.train_batch(batch)
            ws.append(1e3 * (time.perf_counter() - t0))
            ms.append(m)
        c = {k: _counters()[k] for k in FLASH_KERNELS}
        want = (_pp_want(L, PP_STAGES, PP_MICRO, engine.module.backward)
                if name != "plain" else {k: L * PP_MICRO
                                         for k in FLASH_KERNELS})
        _pp_held(f"the {name} engine's step", c, want)
        res["launches"][f"engine_{name}"] = c
        step_ms = float(np.median(ws[1:]))
        t1 = time.perf_counter()
        # one profiled engine: a profile costs ~20 s of the script
        busy, by_kind = (profile_train(engine, batch, step_ms,
                                       label=f"pp {name} step")
                         if name == "pipe_1f1b_recompute" else (None, None))
        prof_s = time.perf_counter() - t1
        steps[name] = {"init_s": init_s, "profile_s": prof_s,"loss": [x["loss"] for x in ms],
                       "grad_norm": [x["grad_norm"] for x in ms],
                       "step_ms": step_ms, "busy_ms": busy,
                       "tokens_s": tokens / step_ms * 1e3,
                       "model_tflops_6n": 6.0 * n_params * tokens
                       / step_ms / 1e9, "device_ms_by_kind": by_kind}
        busy_txt = "not measured" if busy is None else f"{busy:.1f}"
        log(f"pp: engine {name} loss="
            f"{[round(x, 6) for x in steps[name]['loss']]} init_s="
            f"{init_s:.1f} profile_s={prof_s:.1f} "
            f"step_ms={step_ms:.1f} busy_ms={busy_txt} tokens_s="
            f"{steps[name]['tokens_s']:.0f} model_tflops_6n="
            f"{steps[name]['model_tflops_6n']:.1f} launches={json.dumps(c)}")
        if not ms[-1]["loss"] < ms[0]["loss"]:
            fail(f"pp: {name}: the loss did not fall")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    res["engines"] = steps

    # (4) the PipelineEngine at pp 1 in a 1-rank NCCL world
    want = steps["plain"]
    comm.init_distributed(world_size=1, rank=0)
    try:
        with open(path, "w") as f:
            json.dump(PP_CONFIG, f)
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=PipelinedTransformer(cfg, 1, PP_MICRO, seed=PP_SEED,
                                       device="cuda"),
            config=path, loss_fn=causal_lm_loss)
        _zero_counters()
        m = engine.train_batch(batch)
        c = _pp_held("the pp-1 engine's step", {
            k: _counters()[k] for k in FLASH_KERNELS},
            _pp_want(L, 1, PP_MICRO, "recompute"))
        res["launches"]["engine_pp1_nccl"] = c
        rl = abs(m["loss"] - want["loss"][0]) / abs(want["loss"][0])
        rn = abs(m["grad_norm"] - want["grad_norm"][0]) / abs(
            want["grad_norm"][0])
        log(f"check: pp PipelineEngine pp=1 backend={dist.get_backend()} "
            f"gas={PP_MICRO} first step loss={m['loss']:.9f}/"
            f"{want['loss'][0]:.9f} rel={rl:.3e} tol=1e-6 grad_norm="
            f"{m['grad_norm']:.9f}/{want['grad_norm'][0]:.9f} rel={rn:.3e} "
            f"tol=1e-5 launches={json.dumps(c)}")
        if rl > 1e-6 or rn > 1e-5:
            fail("pp: the pp-1 PipelineEngine is off the plain engine")
        res["pp1"] = {"loss_rel": rl, "grad_norm_rel": rn}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        cut = dataclasses.replace(cfg, num_layers=PP_SAVE_LAYERS)
        a, *_ = deepspeed_tpu_torch.initialize(
            model=PipelinedTransformer(cut, 1, PP_MICRO, seed=PP_SEED,
                                       device="cuda"),
            config=path, loss_fn=causal_lm_loss)
        a.train_batch(batch)
        ck = os.path.join(tmp, "pp_ck")
        t1 = time.perf_counter()
        a.save_checkpoint(ck)
        save_s = time.perf_counter() - t1
        b, *_ = deepspeed_tpu_torch.initialize(
            model=PipelinedTransformer(cut, 1, PP_MICRO, seed=PP_SEED + 1,
                                       device="cuda"),
            config=path, loss_fn=causal_lm_loss)
        b.load_checkpoint(ck)
        same = all(torch.equal(x, y) for x, y in
                   zip(_zero_state(a), _zero_state(b)))
        na, nb = a.train_batch(batch)["loss"], b.train_batch(batch)["loss"]
        log(f"check: pp save at {PP_SAVE_LAYERS} layers save_s={save_s:.2f} "
            f"loaded bitwise={same} next loss {na:.9f} resumed {nb:.9f}")
        if not same or na != nb:
            fail("pp: the pipeline engine's save did not load back bitwise")
        res["save"] = {"layers": PP_SAVE_LAYERS, "bitwise": same,
                       "save_s": save_s}
        del a, b
    finally:
        set_global_mesh(None)
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    res["moe"] = phase_pp_moe(tmp, res["launches"])
    return res


# the pp leg's MoE piece: Mixtral-8x7B at full width (seeded HF-named
# weights mapped by models/hf.py, as the moe leg maps them), cut to
# PP_MOE_LAYERS layers, pp 2 in one process, PP_MOE_MICRO micro-batches of
# 1 x MOE_SEQ
PP_MOE_LAYERS, PP_MOE_STAGES, PP_MOE_MICRO, PP_MOE_SEED = 2, 2, 4, 17
PP_MOE_STEPS = 2
# the pp-1 engine's config: the moe leg's pure bf16 state at ZeRO 3
PP_MOE_CONFIG = dict(MOE_TRAIN_CONFIG, train_batch_size=PP_MOE_MICRO,
                     train_micro_batch_size_per_gpu=1,
                     gradient_accumulation_steps=PP_MOE_MICRO,
                     zero_optimization={"stage": 3})


def _pp_route_order(pp, n, layers, schedule="gpipe"):
    """(micro-batch, layer) of each routing call of one ``store`` step,
    in the order the executor makes them: every forward tick of the
    tables, the stages of a tick in order, a stage's layers in order (a
    store step routes in its forward ticks only)."""
    from deepspeed_tpu_torch.runtime.pipe.schedule import build_tables
    tables = build_tables(schedule, n, pp)
    per = layers // pp
    out = []
    for t in range(int(tables["ticks"])):
        for s in range(pp):
            m = int(tables["fwd"][t][s])
            if m >= 0:
                out += [(m, s * per + i) for i in range(per)]
    return out


def _pp_route_flips(piped_log, plain_log, order, layers):
    """Routes of a pipeline step (``order``) against the plain model's
    per micro-batch ones (micro-major, then layer): (flipped (token,
    layer) routes, routes)."""
    import torch
    if len(piped_log.calls) != len(order) or \
            len(plain_log.calls) != len(order):
        fail(f"pp moe: {len(piped_log.calls)} pipeline and "
             f"{len(plain_log.calls)} plain routing calls, expected "
             f"{len(order)}")
    flips = routes = 0
    for (m, li), got in zip(order, piped_log.calls):
        want = plain_log.calls[m * layers + li]
        flips += int((got != want).any(dim=1).sum())
        routes += got.shape[0]
    return flips, routes


def phase_pp_moe(tmp, launches):
    """The pp leg's MoE piece: Mixtral-8x7B at full width (hidden 4096,
    32 heads of 128 over 8 KV heads, 8 SwiGLU experts of 14,336, top-2,
    vocab 32,000; a seeded HF-named state dict mapped by
    ``models/hf.py``) at PP_MOE_LAYERS layers as PP_MOE_STAGES stages in
    one process, PP_MOE_MICRO micro-batches of 1 x MOE_SEQ, the routers'
    aux riding the pipe. (1) f32, gpipe with store: the loss, the aux and
    every leaf's grad against autograd through the plain ``Transformer``
    per micro-batch under make_moe_loss (loss and aux rel 1e-5, each
    leaf's grad within 1e-4 of its norm), every (token, layer) route the
    plain model's. (2) bf16 under deterministic algorithms: gpipe and 1F1B,
    recompute and store, bitwise equal; the routes against the plain bf16
    model's within MOE_FLIP_LIMIT. Each step's flash launches held to
    their count. (3) The ``PipelineEngine`` at pp 1 in a 1-rank NCCL
    world with ``sharding_rules=piped.tp_rules()``, ZeRO 3, the moe
    section and make_moe_loss (pure bf16 state): its first step's loss
    and grad norm against the plain engine's at ZeRO 3 (rel 1e-5 / 1e-4);
    PP_MOE_STEPS steps' wall ms, a profiled step's busy ms and the idle
    share. Adds its launches to ``launches``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from types import SimpleNamespace
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.hf import load_hf
    from deepspeed_tpu_torch.models.pipeline import PipelinedTransformer
    from deepspeed_tpu_torch.models.transformer import (
        Transformer, causal_lm_loss, make_moe_loss)
    from deepspeed_tpu_torch.parallel.mesh import set_global_mesh
    dev = torch.device("cuda")
    L, pp, n = PP_MOE_LAYERS, PP_MOE_STAGES, PP_MOE_MICRO
    devices = [dev] * pp
    hf_cfg = SimpleNamespace(**dict(MIXTRAL_CONFIG, num_hidden_layers=L))
    res = {}

    def mapped(dtype):
        return load_hf(_mixtral_state_dict(L, seed=PP_MOE_SEED),
                       arch="MixtralForCausalLM", config=hf_cfg, dtype=dtype)

    # (1) f32 against autograd through the plain model
    t0 = time.perf_counter()
    tree, cfg = mapped(torch.float32)
    cfg = dataclasses.replace(cfg, dtype=torch.float32, max_seq_len=MOE_SEQ)
    if (cfg.moe_experts, cfg.moe_k, cfg.head_dim, cfg.kv_heads,
            cfg.hidden_size, cfg.mlp_dim, cfg.vocab_size) != \
            (8, 2, 128, 8, 4096, 14336, 32000):
        fail(f"pp moe: mixtral mapped to {cfg}")
    batch = _moe_batch(n, cfg.vocab_size, seed=PP_MOE_SEED)
    micros = _pp_micros(batch, n)
    moe_loss = make_moe_loss(MOE_AUX)
    plain = Transformer(cfg, tree)
    piped = PipelinedTransformer(cfg, pp, n, backward="store", params=tree)
    del tree
    log(f"pp moe: mixtral-8x7b layers={L} pp={pp} n_micro={n} "
        f"params={cfg.num_params()} active={cfg.num_active_params()} "
        f"map_s={time.perf_counter() - t0:.1f} "
        f"mem_gb={torch.cuda.memory_allocated() / 1e9:.2f}")
    ls, auxes = [], []
    with _RouteLog() as plain_log:
        for m in range(n):
            ids = micros["input_ids"][m]
            logits, aux = plain(ids)
            loss = moe_loss((logits, aux), ids)
            (loss / n).backward()
            ls.append(loss.detach())
            auxes.append(aux.detach())
    ref_loss = torch.stack(ls).mean().item()
    ref_aux = torch.stack(auxes).mean().item()
    ref = {name: p.grad for name, p in plain.named_parameters()}
    del plain, logits, ls
    gc.collect()
    _zero_counters()
    with _RouteLog() as piped_log:
        loss, grads = piped.pipeline_value_and_grad(
            micros, schedule="gpipe", aux_weight=MOE_AUX, devices=devices)
    c = _pp_held("the mixtral f32 gpipe store step", _counters(),
                 _pp_want(L, pp, n, "store"))
    launches["mixtral_f32_gpipe_store"] = c
    flips, routes = _pp_route_flips(piped_log, plain_log,
                                    _pp_route_order(pp, n, L), L)
    aux = piped.last_aux.item()
    rel = abs(loss.item() - ref_loss) / abs(ref_loss)
    rel_aux = abs(aux - ref_aux) / abs(ref_aux)
    worst, worst_name = 0.0, None
    for name, g in ref.items():
        r = ((grads[name] - g).norm() / g.norm()).item()
        if r > worst:
            worst, worst_name = r, name
    log(f"check: pp moe f32 gpipe store loss={loss.item():.7f} "
        f"plain={ref_loss:.7f} rel={rel:.3e} tol=1e-5 aux={aux:.7f} "
        f"plain={ref_aux:.7f} rel={rel_aux:.3e} tol=1e-5; worst leaf grad "
        f"rel={worst:.3e} ({worst_name}) tol=1e-4; routes flipped={flips} "
        f"of {routes} tol=0 launches={json.dumps(c)}")
    if rel > 1e-5 or rel_aux > 1e-5 or worst > 1e-4 or flips:
        fail("pp moe: the f32 pipeline is off autograd through the plain "
             "model")
    res["f32"] = {"loss_rel": rel, "aux_rel": rel_aux,
                  "worst_grad_rel": worst, "route_flips": flips,
                  "routes": routes}
    del piped, grads, ref, loss
    gc.collect()
    torch.cuda.empty_cache()

    # (2) bf16: four (schedule, backward) pairs, bitwise; routes
    tree, cfg = mapped(torch.bfloat16)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16, max_seq_len=MOE_SEQ)
    plain = Transformer(cfg, tree)
    with torch.no_grad(), _RouteLog() as plain_log:
        for m in range(n):
            plain(micros["input_ids"][m])
    del plain
    gc.collect()
    base, runs = None, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for bw in ("store", "recompute"):
            model = PipelinedTransformer(cfg, pp, n, backward=bw,
                                         params=tree)
            for sched in ("gpipe", "1f1b"):
                gc.collect()
                _zero_counters()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                with _RouteLog() as lg:
                    loss, grads = model.pipeline_value_and_grad(
                        micros, schedule=sched, aux_weight=MOE_AUX,
                        devices=devices)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t1)
                c = _pp_held(f"the mixtral bf16 {sched} {bw} step",
                             _counters(), _pp_want(L, pp, n, bw))
                launches[f"mixtral_bf16_{sched}_{bw}"] = c
                aux = model.last_aux
                same = flips = None
                if base is None:
                    base = (loss, aux, grads)
                    flips, routes = _pp_route_flips(
                        lg, plain_log, _pp_route_order(pp, n, L), L)
                else:
                    same = bool(torch.equal(loss, base[0])
                                and torch.equal(aux, base[1]) and all(
                                    torch.equal(grads[k], base[2][k])
                                    for k in grads))
                runs[f"{sched}_{bw}"] = {"loss": loss.item(),
                                         "aux": aux.item(), "wall_ms": wall,
                                         "bitwise_gpipe_store": same}
                log(f"pp moe: bf16 {sched} {bw} loss={loss.item():.7f} "
                    f"aux={aux.item():.7f} wall_ms={wall:.1f} "
                    f"bitwise_with_gpipe_store={same} "
                    f"launches={json.dumps(c)}")
                if flips is not None:
                    log(f"check: pp moe bf16 routes against the plain "
                        f"model's flipped={flips} of {routes} rate="
                        f"{flips / routes:.2e} limit={MOE_FLIP_LIMIT}")
                    if flips > MOE_FLIP_LIMIT * routes:
                        fail("pp moe: the bf16 pipeline's routes are off "
                             "the plain model's")
                    res["bf16_route_flips"] = {"flips": flips,
                                               "routes": routes}
                if same is False:
                    fail(f"pp moe: bf16 {sched} {bw} differs from gpipe "
                         "store")
                del loss, grads
            del model
    finally:
        torch.use_deterministic_algorithms(False)
    res["bf16"] = runs
    del base, tree
    gc.collect()
    torch.cuda.empty_cache()

    # (3) the engines at ZeRO 3 in a 1-rank NCCL world: the plain one
    # (no gating noise: the pipelined model draws none without dropout),
    # then the PipelineEngine with the pipelined model's rules
    path = os.path.join(tmp, "ds_pp_moe.json")
    with open(path, "w") as f:
        json.dump(PP_MOE_CONFIG, f)
    loss_fn = make_moe_loss(MOE_AUX, base_loss=causal_lm_loss)

    class NoiseFree(Transformer):
        def forward(self, batch, train=False, dropout_seed=None):
            return super().forward(batch, train, dropout_seed)
    comm.init_distributed(world_size=1, rank=0)
    try:
        tree, _ = mapped(torch.bfloat16)
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=NoiseFree(cfg, tree), config=path, loss_fn=loss_fn)
        del tree
        want = engine.train_batch(batch)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        tree, _ = mapped(torch.bfloat16)
        piped = PipelinedTransformer(cfg, 1, n, params=tree)
        del tree
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=piped, config=path, loss_fn=loss_fn,
            sharding_rules=piped.tp_rules())
        del piped
        if engine.dp.stage != 3 or not any(e.gathered
                                           for e in engine.dp.entries):
            fail("pp moe: the pp-1 engine holds no ZeRO-3 slabs")
        torch.cuda.reset_peak_memory_stats()
        ms, ws = [], []
        for s in range(PP_MOE_STEPS):
            _zero_counters()
            comm.reset_op_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = engine.train_batch(batch)
            ws.append(1e3 * (time.perf_counter() - t1))
            ms.append(m)
            c = {k: _counters()[k] for k in FLASH_KERNELS}
            ops = comm.op_counts()
        _pp_held("the mixtral pp-1 ZeRO-3 engine's step", c,
                 _pp_want(L, 1, n, "recompute"))
        launches["mixtral_engine_pp1_zero3"] = c
        m = ms[0]
        rl = abs(m["loss"] - want["loss"]) / abs(want["loss"])
        rn = abs(m["grad_norm"] - want["grad_norm"]) / abs(want["grad_norm"])
        log(f"check: pp moe PipelineEngine pp=1 ZeRO-3 backend="
            f"{dist.get_backend()} rules=piped.tp_rules() first step loss="
            f"{m['loss']:.9f}/{want['loss']:.9f} rel={rl:.3e} tol=1e-5 "
            f"grad_norm={m['grad_norm']:.9f}/{want['grad_norm']:.9f} "
            f"rel={rn:.3e} tol=1e-4 aux={m['aux']:.7f}/{want['aux']:.7f} "
            f"launches={json.dumps(c)} collectives={json.dumps(ops)}")
        if rl > 1e-5 or rn > 1e-4:
            fail("pp moe: the pp-1 ZeRO-3 PipelineEngine is off the plain "
                 "engine")
        step_ms = ws[-1]
        busy, by_kind = profile_train(engine, batch, step_ms,
                                      label="pp moe pp-1 ZeRO-3 step",
                                      split_bmm=True)
        tokens = n * MOE_SEQ
        res["engine_pp1_zero3"] = {
            "loss": [x["loss"] for x in ms],
            "grad_norm": [x["grad_norm"] for x in ms],
            "aux": [x["aux"] for x in ms], "loss_rel": rl,
            "grad_norm_rel": rn, "step_ms_all": ws, "step_ms": step_ms,
            "busy_ms": busy, "idle_share": 1 - busy / step_ms,
            "tokens_s": tokens / step_ms * 1e3,
            "model_tflops_6n_active": 6.0 * cfg.num_active_params()
            * tokens / step_ms / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device_ms_by_kind": by_kind, "collectives": ops}
        log("time: pp moe pp-1 ZeRO-3 engine " + json.dumps(
            res["engine_pp1_zero3"]))
        del engine
    finally:
        set_global_mesh(None)
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_pp_ranks(tmp, n):
    """``--pp-ranks N``: gpt2-6.7b at full depth (32 layers) as N stages,
    one process a GPU through the port's launcher (NCCL on
    cuda:LOCAL_RANK), 1F1B with recompute, PP_MICRO micro-batches of 1 x
    PP_SEQ, bf16 with an fp32 master, AdamW under the train leg's warm-up
    schedule, PP_RANKS_STEPS steps. First,
    on GPU 0 before the pipeline starts: the unpipelined port model from
    the same per-layer seeds, its bf16 forward's global token-mean loss on
    the batch. Checks: the pipeline's first loss within rel 1e-3 of it,
    the loss falling, every rank's ``wte``, ``wpe`` and ``ln_f`` bitwise
    equal after the steps. Readings: step ms, tokens/s, model TFLOP/s a
    GPU, each rank's peak memory, the compute ms of a profiled step (its
    busy ms less NCCL's), the idle share of the unprofiled step beside the
    bubble (N - 1) / (PP_MICRO + N - 1), and one boundary transfer's ms."""
    import torch
    from deepspeed_tpu_torch.models.pipeline import seeded_params
    from deepspeed_tpu_torch.models.transformer import (
        Transformer, causal_lm_loss, get_config)
    cfg = get_config(PP_RANKS_MODEL)
    if cfg.num_layers % n:
        fail(f"pp ranks: {cfg.num_layers} layers do not split into {n}")
    batch = _pp_batch(cfg.vocab_size, PP_RANKS_SEED)
    micros = _pp_micros(batch, PP_MICRO)
    plain = Transformer(cfg, seeded_params(cfg, PP_RANKS_SEED, device="cuda",
                                           dtype=torch.bfloat16))
    with torch.no_grad():
        ref = torch.stack([causal_lm_loss(plain(ids), ids)
                           for ids in micros["input_ids"]]).mean().item()
    log(f"pp ranks: {PP_RANKS_MODEL} unpipelined bf16 forward on one GPU "
        f"loss={ref:.7f}")
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "pp_ranks")
    env = dict(os.environ, PYTHONPATH=HERE)
    rc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
         "--nproc_per_node", str(n), os.path.join(HERE, "chip_smoke.py"),
         "--pp-worker", out], cwd=HERE, env=env, timeout=1500).returncode
    if rc != 0:
        fail(f"pp ranks: the launcher exited {rc}")
    ranks = []
    for r in range(n):
        with open(f"{out}.{r}.json") as f:
            ranks.append(json.load(f))
    bubble = (n - 1) / (PP_MICRO + n - 1)
    for r, x in enumerate(ranks):
        log(f"pp ranks: rank {r} layers={x['layers']} peak_gb="
            f"{x['peak_gb']:.2f} step_ms={x['step_ms']:.1f} "
            f"compute_ms={x['compute_ms']:.1f} (profiled busy "
            f"{x['busy_ms']:.1f} less nccl {x['by_kind']['nccl']:.1f}) "
            f"idle_share={x['idle_share']:.3f} (bubble {bubble:.3f}) "
            f"p2p_ms={x['p2p_ms']:.4f} a {x['p2p_bytes']} B transfer "
            f"ppermutes={x['ppermute']} launches={json.dumps(x['launches'])}")
    first = ranks[-1]["loss"][0]
    rel = abs(first - ref) / abs(ref)
    digests = {json.dumps(r["shared"], sort_keys=True) for r in ranks}
    log(f"check: pp ranks={n} first loss={first:.7f} unpipelined="
        f"{ref:.7f} rel={rel:.3e} tol=1e-3; losses={ranks[-1]['loss']}; "
        f"shared leaves equal on every rank={len(digests) == 1}")
    if rel > 1e-3:
        fail("pp ranks: the first loss is off the unpipelined model's")
    if not ranks[-1]["loss"][-1] < ranks[-1]["loss"][0]:
        fail("pp ranks: the loss did not fall")
    if len(digests) != 1:
        fail("pp ranks: the ranks' embedding / head copies differ")
    step_ms = max(x["step_ms"] for x in ranks)
    n_params = cfg.num_params()
    tokens = PP_MICRO * PP_SEQ
    rates = {"step_ms": step_ms, "tokens_s": tokens / step_ms * 1e3,
             "model_tflops_6n_per_gpu": 6.0 * n_params * tokens / step_ms
             / 1e9 / n, "bubble": bubble, "first_loss_rel": rel,
             "ranks": ranks}
    log("time: pp ranks " + json.dumps(
        {k: v for k, v in rates.items() if k != "ranks"}))
    return rates


def pp_worker(out):
    """One rank of ``--pp-ranks``, started by the port's launcher: stage
    ``rank`` of gpt2-6.7b built from per-layer seeds (never the whole
    model), the ``PipelineEngine``, PP_RANKS_STEPS steps on the global
    batch and a profiled one; writes its readings to ``out.<rank>.json``."""
    import hashlib
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.pipeline import (PipelinedTransformer,
                                                     seeded_params)
    from deepspeed_tpu_torch.models.transformer import (causal_lm_loss,
                                                        get_config)
    comm.init_distributed()
    rank, world = comm.get_rank(), comm.get_world_size()
    cfg = get_config(PP_RANKS_MODEL)
    per = cfg.num_layers // world
    layers = list(range(rank * per, (rank + 1) * per))
    model = PipelinedTransformer(
        cfg, world, PP_MICRO, stage=rank,
        params=seeded_params(cfg, PP_RANKS_SEED, layers, device="cuda"))
    # the train leg's warm-up schedule: at 1e-4 from the first step the
    # random-weight 6.7 B model's loss rose again by its fourth step
    config = dict(PP_CONFIG, scheduler=TRAIN_CONFIG["scheduler"],
                  pipeline={"stages": world, "schedule": "1f1b"})
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                loss_fn=causal_lm_loss)
    del model
    batch = _pp_batch(cfg.vocab_size, PP_RANKS_SEED)
    torch.cuda.reset_peak_memory_stats()
    losses, ws, ops = [], [], None
    for s in range(PP_RANKS_STEPS):
        _zero_counters()
        comm.reset_op_counts()
        comm.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = engine.train_batch(batch)
        ws.append(1e3 * (time.perf_counter() - t0))
        losses.append(m["loss"])
        ops = comm.op_counts()
    launches = {k: _counters()[k] for k in FLASH_KERNELS}
    want = {k: v // world for k, v in _pp_want(
        cfg.num_layers, world, PP_MICRO, "recompute").items()}
    if rank == world - 1:                   # no forward tick there
        want["flash_attention_fwd"] = per * PP_MICRO
    else:
        want["flash_attention_fwd"] = 2 * per * PP_MICRO
    _pp_held(f"rank {rank}'s step", launches, want)
    step_ms = float(np.median(ws[1:]))
    busy, by_kind = profile_train(engine, batch, step_ms,
                                  label=f"pp rank {rank} step")
    # the device computes for busy minus its NCCL time: a p2p kernel
    # spins until the peer's transfer arrives (the bubble shows there),
    # and the profiler slows the ranks' lockstep, so the compute share of
    # the unprofiled step is the measured idle share
    compute = busy - by_kind["nccl"]
    # one neighbour transfer of the boundary ([1, 1024, H] bf16) alone:
    # every stage sends to the next at once, CUDA events around 20
    x = torch.zeros((1, PP_SEQ, cfg.hidden_size), dtype=cfg.dtype,
                    device="cuda")
    perm = [(s, s + 1) for s in range(world - 1)]
    for _ in range(3):
        comm.ppermute(x, perm, axis="pipe")
    comm.barrier()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        comm.ppermute(x, perm, axis="pipe")
    end.record()
    torch.cuda.synchronize()
    p2p_ms = start.elapsed_time(end) / 20
    shared = {n: hashlib.sha256(p.detach().float().cpu().numpy().tobytes())
              .hexdigest() for n, p in engine.module.named_parameters()
              if not n.startswith("blocks.")}
    res = {"rank": rank, "layers": [layers[0], layers[-1]], "loss": losses,
           "step_ms": step_ms, "step_ms_all": ws, "busy_ms": busy,
           "by_kind": by_kind, "compute_ms": compute,
           "idle_share": 1 - compute / step_ms, "p2p_ms": p2p_ms,
           "p2p_bytes": x.numel() * x.element_size(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "ppermute": ops.get("ppermute", 0), "launches": launches,
           "shared": shared}
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)
    comm.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


# --pp-ranks 4 --pp-compose MODE...: pp 2 composed with a second axis of
# 2 across four GPUs, each mode a fresh 4-rank world: "tp" Llama-2-70B at
# full width, 8 of 80 layers, pp 2 x tp 2; "ep" Mixtral-8x7B at full
# width, 4 of 32 layers, pp 2 x ep 2 at ZeRO 1 (the JAX ladder's
# configuration); "zero3" gpt2-1.3b at full depth, pp 2 x data 2 at ZeRO
# 3. 1F1B with recompute, PP_MICRO micro-batches of one 1 x PP_SEQ sample
# a data rank, bf16 with an fp32 master, AdamW under the train leg's
# warm-up schedule, PP_COMPOSE_STEPS steps; weights from per-layer seeds
PP_COMPOSE = {
    "tp": {"layers": 8, "zero": 1, "rules": True,
           "section": {"tensor_parallel": {"tp_size": 2}}},
    "ep": {"layers": 4, "zero": 1, "rules": True,
           "section": {"moe": {"enabled": True, "ep_size": 2}}},
    "zero3": {"layers": 24, "zero": 3, "rules": False, "section": {}},
}
PP_COMPOSE_STEPS, PP_COMPOSE_SEED = 4, 71
# the first loss against the unpipelined model's bf16 forward: the dense
# legs' 1e-3; a MoE model's routes may flip between two bf16 paths
# (MOE_FLIP_LIMIT's comment), so 5e-3 there
PP_COMPOSE_TOL = {"tp": 1e-3, "ep": 5e-3, "zero3": 1e-3}


def _mixtral_cfg(layers=MOE_TRAIN_LAYERS):
    """The TransformerConfig that the Mixtral policy maps the published
    config to at ``layers`` layers (no weights; default the moe train
    leg's depth)."""
    import torch
    from types import SimpleNamespace
    from deepspeed_tpu_torch.models.hf import load_hf
    hf_cfg = SimpleNamespace(**dict(MIXTRAL_CONFIG,
                                    num_hidden_layers=layers))
    _, cfg = load_hf(_mixtral_state_dict(layers, 0, "meta"),
                     arch="MixtralForCausalLM", config=hf_cfg,
                     dtype=torch.bfloat16)
    return cfg


def _compose_cfg(mode):
    """The mode's model config (bf16, max_seq_len at least PP_SEQ)."""
    import torch
    from deepspeed_tpu_torch.models.transformer import get_config
    layers = PP_COMPOSE[mode]["layers"]
    if mode == "tp":
        cfg = _llama70_cfg(layers)
    elif mode == "ep":
        cfg = _mixtral_cfg(layers)
    else:
        cfg = get_config("gpt2-1.3b", num_layers=layers)
    return dataclasses.replace(cfg, dtype=torch.bfloat16,
                               max_seq_len=max(cfg.max_seq_len, PP_SEQ))


def _compose_rows(mode):
    """Samples of the global batch: a micro-batch of one sample a rank
    that takes distinct samples (tp: one; ep, zero3: two)."""
    return PP_MICRO * (1 if mode == "tp" else 2)


def phase_pp_compose(tmp, n, mode):
    """``--pp-ranks 4 --pp-compose MODE``: first, on GPU 0 before the
    world starts, the unpipelined port model from the same per-layer seeds
    and its bf16 forward's loss on the global batch, one sample at a time
    (a MoE model's: the token-mean CE plus MOE_AUX x the samples' mean
    aux, each sample its own gating group as on a rank). Then the four
    ranks through the port's launcher (``pp_compose_worker``). Checks: the
    first loss within PP_COMPOSE_TOL of it, the losses falling, the
    shared leaves (embedding, head, final norm) bitwise equal on the two
    pipe ranks of every (data, expert, model) coordinate. Readings: step
    ms, tokens/s, model TFLOP/s a GPU (6 N, N a MoE model's active
    parameters), each rank's idle share, peak memory and counted
    collectives of a step."""
    import torch
    from deepspeed_tpu_torch.models.pipeline import seeded_params
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        causal_lm_loss)
    if n != 4:
        fail(f"--pp-compose runs pp 2 x 2 on four GPUs, not {n}")
    cfg = _compose_cfg(mode)
    batch = _pp_batch(cfg.vocab_size, PP_COMPOSE_SEED, _compose_rows(mode))
    ids = torch.as_tensor(batch["input_ids"], device="cuda")
    plain = Transformer(cfg, seeded_params(cfg, PP_COMPOSE_SEED,
                                           device="cuda",
                                           dtype=torch.bfloat16))
    ces, auxes = [], []
    with torch.no_grad():
        for row in ids:
            out = plain(row[None])
            if cfg.moe_experts:
                out, aux = out
                auxes.append(aux.float())
            ces.append(causal_lm_loss(out, row[None]))
    ref = torch.stack(ces).mean()
    if auxes:
        ref = ref + MOE_AUX * torch.stack(auxes).mean()
    ref = ref.item()
    log(f"pp compose {mode}: layers={cfg.num_layers} hidden="
        f"{cfg.hidden_size} params={cfg.num_params()} unpipelined bf16 "
        f"forward on one GPU loss={ref:.7f}")
    del plain, out
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(tmp, f"pp_compose_{mode}")
    env = dict(os.environ, PYTHONPATH=HERE)
    rc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
         "--nproc_per_node", str(n), os.path.join(HERE, "chip_smoke.py"),
         "--pp-worker", out, "--pp-compose", mode], cwd=HERE, env=env,
        timeout=1500).returncode
    if rc != 0:
        fail(f"pp compose {mode}: the launcher exited {rc}")
    ranks = []
    for r in range(n):
        with open(f"{out}.{r}.json") as f:
            ranks.append(json.load(f))
    for r, x in enumerate(ranks):
        log(f"pp compose {mode}: rank {r} stage={x['stage']} coord="
            f"{x['coord']} peak_gb={x['peak_gb']:.2f} step_ms="
            f"{x['step_ms']:.1f} compute_ms={x['compute_ms']:.1f} "
            f"(profiled busy {x['busy_ms']:.1f} less nccl "
            f"{x['by_kind']['nccl']:.1f}) idle_share={x['idle_share']:.3f} "
            f"collectives={json.dumps(x['ops'])} "
            f"launches={json.dumps(x['launches'])}")
    losses = ranks[-1]["loss"]
    first = losses[0]
    rel = abs(first - ref) / abs(ref)
    groups = {}
    for x in ranks:
        groups.setdefault(tuple(x["coord"]), set()).add(
            json.dumps(x["shared"], sort_keys=True))
    equal = all(len(v) == 1 for v in groups.values())
    tol = PP_COMPOSE_TOL[mode]
    log(f"check: pp compose {mode} first loss={first:.7f} unpipelined="
        f"{ref:.7f} rel={rel:.3e} tol={tol}; losses={losses}; shared "
        f"leaves equal over pipe in each of {len(groups)} coordinates="
        f"{equal}")
    if rel > tol:
        fail(f"pp compose {mode}: the first loss is off the unpipelined "
             "model's")
    if not losses[-1] < losses[0]:
        fail(f"pp compose {mode}: the loss did not fall")
    if not equal or len(groups) != 2:
        fail(f"pp compose {mode}: the pipe ranks' shared leaves differ")
    step_ms = max(x["step_ms"] for x in ranks)
    tokens = _compose_rows(mode) * PP_SEQ
    n_params = (cfg.num_active_params() if cfg.moe_experts
                else cfg.num_params())
    rates = {"mode": mode, "step_ms": step_ms,
             "tokens_s": tokens / step_ms * 1e3,
             "model_tflops_6n_per_gpu": 6.0 * n_params * tokens / step_ms
             / 1e9 / n, "n_params_6n": n_params, "first_loss": first,
             "unpipelined_loss": ref, "first_loss_rel": rel,
             "losses": losses,
             "idle_share_by_rank": [x["idle_share"] for x in ranks],
             "peak_gb_by_rank": [x["peak_gb"] for x in ranks],
             "collectives_rank0": ranks[0]["ops"],
             "launches_by_rank": [x["launches"] for x in ranks]}
    log(f"time: pp compose {mode} " + json.dumps(rates))
    return rates


def pp_compose_worker(out, mode):
    """One rank of ``--pp-compose MODE``, started by the port's launcher:
    its stage of the mode's model from per-layer seeds (never the whole
    model), the ``PipelineEngine`` on the pipe x second-axis mesh,
    PP_COMPOSE_STEPS steps on the global batch and a profiled one; writes
    its readings to ``out.<rank>.json``."""
    import hashlib
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.pipeline import (PipelinedTransformer,
                                                     seeded_params)
    from deepspeed_tpu_torch.models.transformer import (causal_lm_loss,
                                                        make_moe_loss)
    comm.init_distributed()
    rank, world = comm.get_rank(), comm.get_world_size()
    spec = PP_COMPOSE[mode]
    cfg = _compose_cfg(mode)
    stage = rank // (world // 2)            # the mesh's order: pipe first
    per = cfg.num_layers // 2
    layers = list(range(stage * per, (stage + 1) * per))
    model = PipelinedTransformer(
        cfg, 2, PP_MICRO, stage=stage,
        params=seeded_params(cfg, PP_COMPOSE_SEED, layers, device="cuda"))
    rows = _compose_rows(mode)
    config = dict(PP_CONFIG, scheduler=TRAIN_CONFIG["scheduler"],
                  train_batch_size=rows,
                  zero_optimization={"stage": spec["zero"]},
                  pipeline={"stages": 2, "schedule": "1f1b"},
                  **spec["section"])
    loss_fn = make_moe_loss(MOE_AUX) if cfg.moe_experts else causal_lm_loss
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config, loss_fn=loss_fn,
        sharding_rules=model.tp_rules() if spec["rules"] else None)
    del model
    mesh = engine.mesh
    batch = _pp_batch(cfg.vocab_size, PP_COMPOSE_SEED, rows)
    torch.cuda.reset_peak_memory_stats()
    losses, ws, ops = [], [], None
    for s in range(PP_COMPOSE_STEPS):
        _zero_counters()
        comm.reset_op_counts()
        comm.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = engine.train_batch(batch)
        ws.append(1e3 * (time.perf_counter() - t0))
        losses.append(m["loss"])
        ops = comm.op_counts()
    launches = {k: _counters()[k] for k in FLASH_KERNELS}
    want = {k: per * PP_MICRO for k in FLASH_KERNELS}
    if stage == 0:          # a forward tick and its backward's recompute
        want["flash_attention_fwd"] = 2 * per * PP_MICRO
    _pp_held(f"pp compose {mode} rank {rank}'s step", launches, want)
    step_ms = float(np.median(ws[1:]))
    busy, by_kind = profile_train(engine, batch, step_ms,
                                  label=f"pp compose {mode} rank {rank}",
                                  split_bmm=bool(cfg.moe_experts))
    compute = busy - by_kind["nccl"]
    shared = {n: hashlib.sha256(p.detach().float().cpu().numpy().tobytes())
              .hexdigest() for n, p in engine.module.named_parameters()
              if not n.startswith("blocks.")}
    res = {"rank": rank, "stage": stage, "layers": [layers[0], layers[-1]],
           "coord": [mesh.axis_rank(a) for a in ("data", "expert",
                                                 "model")],
           "loss": losses, "step_ms": step_ms, "step_ms_all": ws,
           "busy_ms": busy, "by_kind": by_kind, "compute_ms": compute,
           "idle_share": 1 - compute / step_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "ops": ops, "launches": launches, "shared": shared}
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)
    comm.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------- fleet

# the serving fleet: thread replicas, the 1 + 1 disaggregated
# pair, process replicas and an int8 thread fleet, on llama-1.1b at full
# width and depth. The prefix cache is off: every request then takes the
# same prefill and decode shapes on every replica, so greedy tokens do not
# depend on which replica served them
FLEET_SERVING = dict(SERVING, prefix_cache=False)
FLEET_KNOBS = {"poll_interval": 0.02, "heartbeat_interval": 0.05,
               "heartbeat_timeout": 60.0}
FLEET_NEW = 32
FLEET_KILL_SKIP = 24        # replica 1's loop iterations before its kill
FLEET_INT8_NEW = 8


def _serve_prompts():
    """The serve leg's 16 prompts: the same draws as ``phase_serve``."""
    import numpy as np
    rng = np.random.default_rng(0)
    rng.integers(20000, 32000, 100)                # its warm-up request
    system = list(rng.integers(1, 32000, 2 * SERVING["block_size"]))
    lens = rng.integers(64, 1025, 16)
    prompts = []
    for i, n in enumerate(lens):
        body = list(rng.integers(1, 32000, int(n)))
        prompts.append((system + body)[:max(int(n), 65)] if i % 3 == 0
                       else body)
    return [[int(t) for t in p] for p in prompts]


def _engine_run(srv, prompts, new):
    """A single engine's tokens, wall seconds and time-to-first-token."""
    t0 = time.monotonic()
    reqs = [srv.submit(p, new) for p in prompts]
    srv.run_until_idle()
    wall = time.monotonic() - t0
    for r in reqs:
        if r.state != "FINISHED" or len(r.output_tokens) != new:
            fail(f"engine request {r.rid}: {r.state}, "
                 f"{len(r.output_tokens)} of {new} tokens")
    return ([list(r.output_tokens) for r in reqs], wall,
            [r.first_token_ts - r.arrival_ts for r in reqs])


def _fleet_run(label, flt, prompts, new, start=False):
    """Submit every prompt (before ``start()`` when ``start``, so a keyed
    kill lands while the victim holds work), drain, and hold the
    ``on_token`` ledger to the outputs (each token emitted once). Returns
    (requests, outputs, ledger {rid: [(t, tok, replica)]}, wall s, ttft s
    list)."""
    ledger = {}

    def on_token(req, tok):
        ledger.setdefault(req.rid, []).append(
            (time.monotonic(), int(tok), req.replica))

    t0 = time.monotonic()
    reqs = [flt.submit(p, new, on_token=on_token) for p in prompts]
    if start:
        flt.start()
    if not flt.drain(timeout=300):
        fail(f"fleet {label}: requests still outstanding after 300 s")
    wall = time.monotonic() - t0
    outs = [list(r.output_tokens) for r in reqs]
    for r, out in zip(reqs, outs):
        if r.state != "FINISHED" or len(out) != new:
            fail(f"fleet {label}: request {r.rid} {r.state} with "
                 f"{len(out)} of {new} tokens ({r.error})")
        if [t for _, t, _ in ledger.get(r.rid, [])] != out:
            fail(f"fleet {label}: request {r.rid}'s on_token ledger is not "
                 "its output (a token fired twice or never)")
    ttft = [ledger[r.rid][0][0] - r.arrival_ts for r in reqs]
    return reqs, outs, ledger, wall, ttft


def _hold_fleet_tokens(label, reqs, outs, want, ledger, deaths, ref_srv,
                       new):
    """Every request's tokens against the unkilled run's (``want``). A
    requeued request (``retries`` > 0) resumes by prefilling prompt +
    its k emitted tokens, where the unkilled run decoded them one at a
    time: in bf16 those are other matmul shapes, so its continuation is
    also held to the single engine serving exactly that replay (prompt +
    k tokens, new - k more). Fails on anything else; returns (requests
    equal to the unkilled run, requests held to their replay)."""
    exact, replays = 0, []
    for r, out, w in zip(reqs, outs, want):
        if out == w:
            exact += 1
            continue
        if r.retries == 0 or not deaths:
            fail(f"fleet {label}: request {r.rid} differs from the unkilled "
                 f"run without a requeue")
        t_dead = min(d["detected_ts"] for d in deaths)
        k = sum(1 for ts, _, _ in ledger[r.rid] if ts < t_dead)
        if out[:k] != w[:k]:
            fail(f"fleet {label}: request {r.rid}'s {k} tokens before the "
                 "kill differ from the unkilled run")
        replays.append((r, out, k))
    if replays:
        subs = [ref_srv.submit(r.prompt + out[:k], new - k)
                for r, out, k in replays]
        ref_srv.run_until_idle()
        for (r, out, k), sub in zip(replays, subs):
            if out[k:] != list(sub.output_tokens):
                fail(f"fleet {label}: request {r.rid} after its requeue at "
                     f"token {k} differs from the replay's continuation")
    return exact, [(r.rid, k) for r, _, k in replays]


def _replica_counts(label, flt, replicas, kernel="paged_attention"):
    """Each replica's launches of ``kernel`` (fleet's per-replica tally);
    fails unless every listed replica launched it."""
    counts = {int(i): dict(c) for i, c in flt.kernel_launches.items()}
    for i in replicas:
        if counts.get(i, {}).get(kernel, 0) <= 0:
            fail(f"fleet {label}: replica {i} launched no {kernel} "
                 f"({counts})")
    return counts


def _proc_fleet(cfg, params, tmp, name, device, env_first=None):
    from deepspeed_tpu_torch.serving import ProcessFleet
    serving = dict(FLEET_SERVING, fleet=dict(FLEET_KNOBS, replicas=2,
                                             placement="process"))
    t0 = time.monotonic()
    flt = ProcessFleet(cfg, params, serving=serving, device=device,
                       workdir=os.path.join(tmp, name),
                       heartbeat_dir=os.path.join(tmp, name + "-hb"),
                       log_dir=os.path.join(tmp, name + "-logs"),
                       env_first=env_first)
    stage_s = time.monotonic() - t0
    return flt, stage_s


def _child_logs(flt):
    for i in range(2):
        path = os.path.join(flt.log_dir or "", f"replica{i}.log")
        if os.path.exists(path):
            with open(path, errors="replace") as f:
                log(f"fleet: replica {i} log tail: "
                    + " | ".join(f.read().splitlines()[-12:]))


def phase_fleet(tmp, eng=None, device="cuda"):
    """The serving fleet on llama-1.1b (22 layers, bf16, seeded weights,
    the serve leg's 16 prompts, 32 new tokens each), against one
    ``ServingEngine`` on the same prompts (prefix cache off everywhere):

    1. a 2-replica thread fleet, token-exact; then again with
       ``serve.replica_kill`` (raise) on replica 1 mid-stream: at least
       one requeue, each token emitted once, tokens equal to the unkilled
       run's (a requeued request's continuation held to its replay);
    2. the 1 + 1 disaggregated pair over one shared pool: token-exact,
       every handoff counted, every block back in the pool; then again
       with its decode replica killed;
    3. a 2-process fleet on this card whose replica 1 dies by
       ``serve.replica_kill`` in kill mode mid-stream: the hub restarts
       the child and the tokens hold; then the pair, the restarted child
       in it, serves the batch again token-exact;
    4. a 2-replica int8-weight thread fleet, which launches quant_matmul.

    Launch counters are zeroed before each part and read after it; each
    replica's own tally (threads) or its reported counts (children) show
    paged_attention ran on every decoding replica. Prints tokens/s of the
    fleet and the engine in this process, time to first token p50, kill
    to serving again, each process's peak memory. ``device="cpu"`` with a
    small ``eng`` (any object with ``cfg`` and ``params``) runs the same
    parts on the plain paths, without the launch and memory readings."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.transformer import get_config, init_params
    from deepspeed_tpu_torch.runtime.heartbeat import read_heartbeats
    from deepspeed_tpu_torch.serving import ServingEngine, ServingFleet
    from deepspeed_tpu_torch.testing import chaos
    t_leg = time.perf_counter()
    if eng is None:
        cfg = get_config("llama-1.1b")
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    else:
        cfg, params = eng.cfg, eng.params
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    prompts = _serve_prompts()
    n_tok = len(prompts) * FLEET_NEW
    res = {"launches": {}, "tok_s": {}, "ttft_p50_s": {}}
    p50 = lambda xs: float(np.median(xs))

    ref = ServingEngine(cfg, params, serving=FLEET_SERVING, device=device)
    _engine_run(ref, [prompts[0][:100]], 4)                  # warm
    _zero_counters()
    want, wall, ttft = _engine_run(ref, prompts, FLEET_NEW)
    res["launches"]["engine"] = _counters()
    res["tok_s"]["engine"] = n_tok / wall
    res["ttft_p50_s"]["engine"] = p50(ttft)

    def thread_fleet(label, serving, arm=None, new=FLEET_NEW, ps=prompts):
        flt = ServingFleet(cfg, params, serving=serving, device=device,
                           heartbeat_dir=os.path.join(tmp, label + "-hb"))
        try:
            if arm:
                arm()
            _zero_counters()
            out = _fleet_run(label, flt, ps, new, start=True)
            res["launches"][label] = {"process": _counters(),
                                      "replicas": flt.kernel_launches}
            return flt, out
        finally:
            chaos.reset_for_tests()
            flt.close()

    # 1. thread replicas
    serving = dict(FLEET_SERVING, fleet=dict(FLEET_KNOBS, replicas=2))
    flt, (reqs, outs, ledger, wall, ttft) = thread_fleet("thread", serving)
    if outs != want:
        fail("fleet thread: tokens differ from the single engine's")
    _replica_counts("thread", flt, (0, 1) if on_card else ())
    res["tok_s"]["thread"] = n_tok / wall
    res["ttft_p50_s"]["thread"] = p50(ttft)
    flt, (reqs, outs, ledger, wall, ttft) = thread_fleet(
        "thread_kill", serving, arm=lambda: chaos.arm(
            "serve.replica_kill", "raise", match="1", skip=FLEET_KILL_SKIP))
    if flt.stats["deaths"] != 1 or flt.stats["requeues"] < 1:
        fail(f"fleet thread_kill: {flt.stats}")
    d = flt.deaths[0]
    exact, replays = _hold_fleet_tokens("thread_kill", reqs, outs, want,
                                        ledger, flt.deaths, ref, FLEET_NEW)
    _replica_counts("thread_kill", flt, (0, 1) if on_card else ())
    # the restarted replica's first emitted token
    restarted = [ts for r in reqs for ts, _, rep in ledger[r.rid]
                 if rep == 1 and ts > (d["restarted_ts"] or 1e30)]
    res["thread_kill"] = {
        "requeues": flt.stats["requeues"], "exact": exact,
        "replayed": replays, "death": {k: d[k] for k in
                                       ("replica", "reason", "action")},
        "restart_s": d["restarted_ts"] - d["detected_ts"],
        "kill_to_serving_s": (min(restarted) - d["detected_ts"]
                              if restarted else None)}
    res["tok_s"]["thread_kill"] = n_tok / wall
    log(f"fleet: thread requests={len(prompts)} tokens equal the engine's; "
        f"kill: deaths=1 requeues={flt.stats['requeues']} "
        f"exact={exact}/{len(prompts)} replayed={replays} "
        f"restart_s={res['thread_kill']['restart_s']:.3f} "
        f"kill_to_serving_s={res['thread_kill']['kill_to_serving_s']}")

    # 2. the disaggregated pair
    serving = dict(FLEET_SERVING, fleet=dict(FLEET_KNOBS, prefill_replicas=1,
                                             decode_replicas=1))
    flt, (reqs, outs, ledger, wall, ttft) = thread_fleet("disagg", serving)
    if outs != want:
        fail("fleet disagg: tokens differ from the single engine's")
    if flt._handoff.pushed != len(prompts) or flt._handoff.popped != \
            len(prompts) or flt._shared.pool.used_count != 0:
        fail(f"fleet disagg: handoffs {flt._handoff.pushed}/"
             f"{flt._handoff.popped}, pool used "
             f"{flt._shared.pool.used_count}")
    # the prefill role runs the plain gather (prefill is outside the paged
    # kernel, as in the single engine); the decode role runs the kernel
    _replica_counts("disagg", flt, (1,) if on_card else ())
    res["tok_s"]["disagg"] = n_tok / wall
    res["ttft_p50_s"]["disagg"] = p50(ttft)
    res["disagg"] = {"handoffs": flt._handoff.pushed}
    flt, (reqs, outs, ledger, wall, ttft) = thread_fleet(
        "disagg_kill", serving, arm=lambda: chaos.arm(
            "serve.replica_kill", "raise", match="1", skip=FLEET_KILL_SKIP))
    flt._drain_quarantine()
    if flt.stats["deaths"] != 1 or flt._shared.pool.used_count != 0:
        fail(f"fleet disagg_kill: {flt.stats}, pool used "
             f"{flt._shared.pool.used_count}")
    exact, replays = _hold_fleet_tokens("disagg_kill", reqs, outs, want,
                                        ledger, flt.deaths, ref, FLEET_NEW)
    _replica_counts("disagg_kill", flt, (1,) if on_card else ())
    res["disagg"].update(kill_requeues=flt.stats["requeues"],
                         kill_exact=exact, kill_replayed=replays)
    log(f"fleet: disagg handoffs={res['disagg']['handoffs']} tokens equal "
        f"the engine's, pool balanced; kill: requeues="
        f"{flt.stats['requeues']} exact={exact}/{len(prompts)} "
        f"replayed={replays} pool balanced")
    hub_peak_gb = (torch.cuda.max_memory_allocated() / 2**30 if on_card
                   else None)

    # 3. process replicas on this card, one fleet: replica 1's first
    # process dies by serve.replica_kill in kill mode (the spec rides the
    # first spawn only) while serving the first batch; the pair, one child
    # restarted, then serves the second batch clean
    spec = f"serve.replica_kill:kill:match=1:skip={FLEET_KILL_SKIP}"
    flt, stage_s = _proc_fleet(cfg, params, tmp, "proc", device,
                               env_first={"DSTPU_CHAOS": spec})
    try:
        _zero_counters()
        reqs, outs, ledger, wall, ttft = _fleet_run(
            "process_kill", flt, prompts, FLEET_NEW, start=True)
        deadline = time.monotonic() + 120
        while not (flt.deaths and flt._replicas[1].ready):
            if time.monotonic() > deadline:
                fail(f"fleet process_kill: no restart ({flt.stats})")
            time.sleep(0.02)
        d = flt.deaths[0]
        back_ready = time.monotonic()
        if d["replica"] != 1 or d["action"] != "restart" or \
                d["reason"] != "process exit rc=13":
            fail(f"fleet process_kill: death {d}")
        exact, replays = _hold_fleet_tokens(
            "process_kill", reqs, outs, want, ledger, flt.deaths, ref,
            FLEET_NEW)
        requeues = flt.stats["requeues"]
        _zero_counters()          # the replays above ran in this process
        reqs, outs, ledger, wall, ttft = _fleet_run("process", flt, prompts,
                                                    FLEET_NEW)
        if outs != want:
            fail("fleet process: tokens differ from the single engine's")
        firsts = [ts for r in reqs for ts, _, rep in ledger[r.rid]
                  if rep == 1]
        counts = _replica_counts("process", flt, (0, 1) if on_card else ())
        if on_card and not flt._replicas[1].launches.get("paged_attention"):
            fail("fleet process: the restarted child launched no "
                 "paged_attention")
        if any(_counters().values()):
            fail(f"fleet process: the hub launched kernels {_counters()}")
        peaks = {i: rec.get("gauges", {}).get("peak_mb") for i, rec in
                 read_heartbeats(flt.heartbeat_dir).items()}
    except BaseException:
        _child_logs(flt)
        raise
    finally:
        flt.close()
    res["launches"]["process"] = {"replicas": counts}
    res["tok_s"]["process"] = n_tok / wall
    res["ttft_p50_s"]["process"] = p50(ttft)
    res["process"] = {
        "stage_s": stage_s, "child_peak_mb": peaks, "requeues": requeues,
        "kill_exact": exact, "kill_replayed": replays,
        "restarts": flt.stats["restarts"],
        "kill_to_ready_s": back_ready - d["detected_ts"],
        "kill_to_serving_s": (min(firsts) - d["detected_ts"] if firsts
                              else None)}
    log(f"fleet: process kill: restarts={flt.stats['restarts']} requeues="
        f"{requeues} exact={exact}/{len(prompts)} replayed={replays} "
        f"kill_to_ready_s={res['process']['kill_to_ready_s']:.2f} "
        f"kill_to_serving_s={res['process']['kill_to_serving_s']}; then "
        f"requests={len(prompts)} tokens equal the engine's "
        f"stage_s={stage_s:.2f} child_peak_mb={json.dumps(peaks)}")

    # 4. int8 weights
    serving = dict(FLEET_SERVING, weight_dtype="int8",
                   fleet=dict(FLEET_KNOBS, replicas=2))
    flt, (reqs, outs, ledger, wall, ttft) = thread_fleet(
        "int8", serving, new=FLEET_INT8_NEW)
    _replica_counts("int8", flt, (0, 1) if on_card else ())
    _replica_counts("int8", flt, (0, 1) if on_card else (), "quant_matmul")
    res["tok_s"]["int8"] = len(prompts) * FLEET_INT8_NEW / wall
    res["ttft_p50_s"]["int8"] = p50(ttft)
    del flt
    res["hub_peak_gb"] = hub_peak_gb
    res["total_s"] = time.perf_counter() - t_leg
    log(f"fleet: tok_s={json.dumps(res['tok_s'])} ttft_p50_s="
        f"{json.dumps(res['ttft_p50_s'])} hub_peak_gb={hub_peak_gb} "
        f"launches={json.dumps(res['launches'])} "
        f"total_s={res['total_s']:.1f}")
    return res


# the run leg: llama-1.1b at full width through the port's runner and
# the MPMD driver, every sub-leg in child processes
# the card host caps what one run writes to its disk at 45 GiB (freed
# blocks count too): the run leg writes the full-depth emergency tag
# (15.4 GB), one tag at the small legs' 2-layer cut, each MPMD stage's
# step-0 tag once (the two MPMD runs share the work dir) and the killed
# run's tags at step MPMD_KILL_SKIP
RUN_STEPS, RUN_PREEMPT_AT, RUN_SMALL_LAYERS = 6, 3, 2
RUN_STALL_S, RUN_GRACE_S = 10.0, 30.0
# the 2-layer chain: a twin that takes RUN_TWIN_STEPS clean steps and
# then hangs (the stall sub-leg); a run sent SIGTERM from inside step
# RUN_MID_AT, whose emergency tag is the sentinel's audited-clean tag;
# the sentinel's run resumed from it, spiked on its calls
# RUN_SPIKE_SKIP + 1 and + 2
RUN_TWIN_STEPS, RUN_MID_AT = 9, 5
RUN_SENTINEL_CALLS, RUN_SPIKE_SKIP = 8, 4
# zmax: a x1000 spike reads z ~ 1e5; after the rollback the restored
# state's early-training grad norms read z ~ 60 against the warm-up
# window, which must stay below the rung
RUN_SENTINEL = {"enabled": True, "metrics": ["loss", "grad_norm"],
                "window": 8, "warmup_steps": 3, "zmax": 1000.0,
                "cooldown_steps": 0, "rollback_after": 2,
                "strike_window": 20, "audit_interval": 1}
MPMD_STEPS, MPMD_MICRO, MPMD_MB, MPMD_SEED, MPMD_LR = 4, 4, 1, 5, 1e-4
# stage 1 dies at the top of its step 3 (of 0-3), just after the killed
# run's tags at step 3: at step 2 the run would write tags at 2 and 4
MPMD_KILL_SKIP = 3
MPMD_SPEC = "chip_smoke:mpmd_llama_spec"
RUN_CHILD = r"""
import argparse, json, os, signal, sys, time
import numpy as np
import torch
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models.transformer import build_model
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.runtime import checkpointing as ckl
from deepspeed_tpu_torch.runtime import sentinel as sl
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

ap = argparse.ArgumentParser()
ap.add_argument("--config", required=True)
ap.add_argument("--ckpt", required=True)
ap.add_argument("--layers", type=int, required=True)
ap.add_argument("--steps", type=int, default=0)
ap.add_argument("--calls", type=int, default=0)
ap.add_argument("--weighted", action="store_true")
ap.add_argument("--probe", type=int, default=0)
ap.add_argument("--sigterm-at", type=int, default=0)
a = ap.parse_args()
t_start = time.time()
# F.embedding's CUDA backward adds colliding rows in a varying order:
# bitwise trajectories across processes need the deterministic kernels
torch.use_deterministic_algorithms(True, warn_only=True)
model, cfg = build_model("llama-1.1b", fused_loss=True, loss_chunk=256,
                         seed=0, device="cuda", num_layers=a.layers)
# the 2-layer chain's batch carries a float per-sample weight: the
# poisoned batch of ``sentinel.spike`` scales float features
micro = [0]


def weighted_loss(out, b):
    # ``--sigterm-at N``: SIGTERM from inside step N, at its second
    # micro-batch's loss (the first one's grads accumulated)
    if a.sigterm_at and eng.global_steps == a.sigterm_at - 1:
        micro[0] += 1
        if micro[0] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    return out * b["w"].float().mean()


eng, *_ = ds.initialize(model=model, config=a.config,
                        loss_fn=weighted_loss if a.weighted else None)
del model
B, S = 4, 1024
batches = []
for i in range(8):
    b = {"input_ids": np.random.default_rng(60 + i).integers(
        1, cfg.vocab_size, (B, S))}
    if a.weighted:
        b["w"] = np.ones(B, np.float32)
    batches.append(b)
loader = RepeatingLoader(batches)
resumed = None
if ckl.get_latest_tag(a.ckpt):
    eng.load_checkpoint(a.ckpt)
    resumed = {"step": eng.global_steps,
               "skipped": eng.fast_forward_dataloader(loader)}
eng.install_preemption_handler(a.ckpt, grace_secs=600)
print("RUN_READY " + json.dumps({"t": time.time(), "start": t_start,
                                 "resumed": resumed}), flush=True)
kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
           fa.flash_attention_bwd_dkv)
total = {k.__name__: 0 for k in kernels}
torch.cuda.reset_peak_memory_stats()
calls = 0
while (calls < a.calls) if a.calls else (eng.global_steps < a.steps):
    before = [k.launches for k in kernels]
    t0 = time.perf_counter()
    m = eng.train_batch(next(loader))
    ms = 1e3 * (time.perf_counter() - t0)
    calls += 1
    c = {k.__name__: k.launches - n for k, n in zip(kernels, before)}
    for k, n in c.items():
        total[k] += n
    print("RUN_STEP " + json.dumps({
        "call": calls, "step": eng.global_steps, "t": time.time(),
        "ms": ms, "loss": m["loss"], "grad_norm": m["grad_norm"],
        "lr": m["lr"], "skip": bool(m.get("anomaly_skip", False)),
        "verdict": eng.sentinel.last_verdict,
        "rollbacks": eng.sentinel.rollbacks_done,
        "data_position": eng.data_position, "launches": c}), flush=True)
peak = torch.cuda.max_memory_allocated()
# what the deterministic kernels cost: more steps without them, after the
# checked ones
torch.use_deterministic_algorithms(False)
for _ in range(a.probe):
    t0 = time.perf_counter()
    m = eng.train_batch(next(loader))
    print("RUN_PROBE " + json.dumps({
        "ms": 1e3 * (time.perf_counter() - t0), "loss": m["loss"]}),
        flush=True)
print("RUN_DONE " + json.dumps({
    "peak_bytes": peak, "launches": total,
    "audited_clean": sl.read_last_audited_clean(a.ckpt),
    "latest": ckl.get_latest_tag(a.ckpt)}), flush=True)
eng.close()
"""


def mpmd_llama_spec(args):
    """The run leg's MPMD stage (``--spec chip_smoke:mpmd_llama_spec``):
    llama-1.1b at full width and depth as 2 stages of 11 layers through
    the ``PipelinedTransformer``'s stage selector (the embedding on stage
    0, the head and the CE on stage 1), each stage's layers drawn from
    their own seeds, bf16 compute on an fp32 master, SGD; micro-batches
    of ``--mb`` x 1024 tokens drawn per step."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.pipeline import (PipelinedTransformer,
                                                     seeded_params)
    from deepspeed_tpu_torch.models.transformer import get_config
    from deepspeed_tpu_torch.ops.optimizers import sgd
    # bitwise twins across processes (F.embedding's backward)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = get_config("llama-1.1b")
    per = cfg.num_layers // args.pp
    layers = list(range(args.stage * per, (args.stage + 1) * per))
    module = PipelinedTransformer(
        cfg, args.pp, args.n_micro, stage=args.stage,
        params=seeded_params(cfg, args.seed, layers, device="cuda"))

    def data(step):
        rng = np.random.default_rng(args.seed * 1009 + step)
        return {"input_ids": torch.as_tensor(rng.integers(
            1, cfg.vocab_size, (args.n_micro, args.mb, TRAIN_SEQ)))}

    return {"module": module, "data": data, "dtype": torch.bfloat16,
            "optimizer": sgd(lr=args.lr)}


def _run_lines(out, tag):
    return [json.loads(ln.split(tag + " ", 1)[1])
            for ln in out.splitlines() if ln.startswith(tag + " ")]


def _runner_child(tmp, name, layers, config, steps=0, calls=0, chaos=None,
                  weighted=False, ckpt=None, timeout=900, probe=0,
                  sigterm_at=0):
    """The child script through ``python -m deepspeed_tpu_torch.launcher.
    runner`` (a ``localhost slots=1`` hostfile, ``--launcher local``,
    ``--heartbeat_dir``); returns its rc, its lines and the seconds from
    the launch to its return."""
    import socket
    script = os.path.join(tmp, "run_child.py")
    if not os.path.exists(script):
        with open(script, "w") as f:
            f.write(RUN_CHILD)
        with open(os.path.join(tmp, "hostfile"), "w") as f:
            f.write("localhost slots=1\n")
    cfg_path = os.path.join(tmp, f"ds_{name}.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    ckpt = ckpt or os.path.join(tmp, f"ck_{name}")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=HERE,
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    for var in ("DSTPU_CHAOS", "DSTPU_HEARTBEAT_DIR", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    if chaos:
        env["DSTPU_CHAOS"] = chaos
    hb_dir = os.path.join(tmp, f"hb_{name}")
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
           "-H", os.path.join(tmp, "hostfile"), "--launcher", "local",
           "--master_port", str(port), "--grace_secs", str(RUN_GRACE_S),
           "--heartbeat_dir", hb_dir, script, "--config", cfg_path,
           "--ckpt", ckpt, "--layers", str(layers)]
    cmd += ["--steps", str(steps)] if steps else ["--calls", str(calls)]
    if sigterm_at:
        cmd += ["--sigterm-at", str(sigterm_at)]
    if weighted:
        cmd.append("--weighted")
    if probe:
        cmd += ["--probe", str(probe)]
    t0 = time.time()
    p = subprocess.run(cmd, env=env, cwd=tmp, capture_output=True,
                       text=True, timeout=timeout)
    t1 = time.time()
    out = p.stdout + p.stderr
    with open(os.path.join(tmp, f"{name}.log"), "w") as f:
        f.write(out)
    res = {"rc": p.returncode, "t0": t0, "t1": t1, "s": t1 - t0,
           "steps": _run_lines(out, "RUN_STEP"),
           "ready": (_run_lines(out, "RUN_READY") or [None])[-1],
           "probe": _run_lines(out, "RUN_PROBE"),
           "done": (_run_lines(out, "RUN_DONE") or [None])[-1],
           "hb": hb_dir, "ckpt": ckpt, "out": out}
    if res["steps"]:
        res["first_step_s"] = res["steps"][0]["t"] - t0
    return res


def _run_fail(label, res, why):
    tail = res["out"][-3000:] if isinstance(res, dict) else ""
    fail(f"run: {label}: {why}\n{tail}")


def _run_launches(label, res, layers):
    """Each step of a child launched every flash kernel layers x gas
    times (a step the sentinel skipped too: the grads were computed).
    Returns the child's launches over its steps."""
    per = layers * TRAIN_GAS
    for st in res["steps"]:
        if any(st["launches"].get(k) != per for k in FLASH_KERNELS):
            _run_fail(label, res, f"step {st['step']} launched "
                      f"{st['launches']}: expected {per} of each")
    return {k: sum(st["launches"][k] for st in res["steps"])
            for k in FLASH_KERNELS}


def _run_health(hb_dir):
    """``python -m deepspeed_tpu_torch.launcher health <dir>``: rc, table."""
    p = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher",
                        "health", hb_dir], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=HERE), timeout=120)
    return p.returncode, p.stdout.strip()


def _run_config():
    return dict(TRAIN_CONFIG, watchdog={"stall_timeout": 300.0},
                straggler={"enabled": True})


def _mpmd(tmp, name, specs, save_interval=0):
    """MPMD_STEPS 1F1B steps of llama-1.1b as two stage workers on the
    one card under ``MPMDStageSupervisor``; returns its readings. Every
    run shares one work dir: the first writes each stage's step-0 tag, a
    later run starts from it (the same seeded state) and writes a tag
    every ``save_interval`` steps (none at 0)."""
    from deepspeed_tpu_torch.runtime.pipe.mpmd import MPMDStageSupervisor
    work = os.path.join(tmp, "mpmd")
    logs = os.path.join(tmp, f"mpmd_{name}")
    sup = MPMDStageSupervisor(
        2, workdir=work, steps=MPMD_STEPS, n_micro=MPMD_MICRO,
        schedule="1f1b", specs=specs, log_dir=os.path.join(logs, "logs"),
        heartbeat_dir=os.path.join(logs, "hb"), grace_secs=RUN_GRACE_S,
        park_ack_timeout=120.0, restart_timeout=600.0,
        worker_args=["--spec", MPMD_SPEC,
                     "--save-interval", str(save_interval),
                     "--mb", str(MPMD_MB),
                     "--seed", str(MPMD_SEED), "--lr", str(MPMD_LR),
                     "--barrier-timeout", "600", "--park-timeout", "600",
                     "--stall-timeout", "600"])
    t0 = time.time()
    rc = sup.run()
    secs = time.time() - t0
    text = {}
    for s in range(2):
        with open(os.path.join(logs, "logs", f"stage{s}.log")) as f:
            text[s] = f.read()
    hb_dir = os.path.join(logs, "hb")
    logs = text
    steps = {s: [json.loads(ln.split(": ", 1)[1]) for ln in
                 logs[s].splitlines() if ln.startswith("mpmd_stage_step: ")]
             for s in range(2)}
    losses = {}
    for ln in logs[1].splitlines():
        if ln.startswith("mpmd_step: "):
            rec = json.loads(ln[len("mpmd_step: "):])
            losses[rec["step"]] = rec["loss"]
    ends = {s: [json.loads(ln.split(": ", 1)[1]) for ln in
                logs[s].splitlines() if ln.startswith("mpmd_launches: ")]
            for s in range(2)}
    parks = {s: [json.loads(ln.split(": ", 1)[1]) for ln in
                 logs[s].splitlines() if ln.startswith("mpmd_park: ")]
             for s in range(2)}
    return {"rc": rc, "s": secs, "t0": t0, "restarts": list(sup.restarts),
            "losses": [losses[k] for k in sorted(losses)],
            "steps": steps, "ends": ends, "parks": parks, "logs": logs,
            "hb": hb_dir}


def phase_run(tmp):
    """Run-side resilience through the port's launcher stack, on
    llama-1.1b at full width (hidden 2048, 32 heads over 4 KV heads,
    bf16 on an fp32 master, the train leg's TRAIN_CONFIG at micro 2 x gas
    2 x 1024 tokens), every sub-leg in child processes:

    1. clean: ``python -m deepspeed_tpu_torch.launcher.runner`` runs the
       rank as one local process with ``--heartbeat_dir`` and the
       watchdog and straggler sections, RUN_STEPS steps at full depth:
       rc 0, ``health`` reads the records, every step launches the flash
       kernels 22 x 2 times in the child;
    2. preempt: the same with ``DSTPU_CHAOS=run.preempt:sigterm`` at the
       entry of step RUN_PREEMPT_AT + 1: rc 114 and an intact emergency
       tag; a relaunch resumes from it with the loader fast-forwarded and
       its steps equal the clean run's (bitwise, else within the ckpt
       leg's 1e-6);
    3. stall, at 2 layers: a twin takes RUN_TWIN_STEPS clean steps, then
       ``run.hang`` wedges it: rc 117 within stall_timeout + the grace;
    4. preempt mid-step, at 2 layers: SIGTERM from inside step
       RUN_MID_AT (at its second micro-batch's loss): rc 114 after the
       step ends, an intact emergency tag of that step;
    5. sentinel: the run resumed from that tag, with
       ``sentinel.spike:flag:factor=1000`` on calls RUN_SPIKE_SKIP + 1
       and + 2: skip + strike, then skip + rollback to the same tag, now
       the last audited-clean one (the ladder's steps for rollback_after
       2, cooldown 0); its steps before the spike equal the twin's, so
       the tag saved from inside a step holds the whole step;
    6. MPMD: ``MPMDStageSupervisor`` runs 2 stage workers (11 + 11
       layers, ``mpmd_llama_spec``) for MPMD_STEPS 1F1B steps of 4
       micro-batches, then again with tags at step MPMD_KILL_SKIP and
       ``pipe.stage_kill`` on stage 1 at its step MPMD_KILL_SKIP: stage 1
       alone restarts from its tag, stage 0 parks and resyncs to it, the
       losses equal the uninjected twin's, each worker's flash launches
       match the steps it ran.

    The children run in two waves that share the card: the clean launch
    (3 more steps at its end without the deterministic kernels the
    bitwise checks need) beside the preempted one; then the resumed run
    beside the two MPMD runs, one after the other, and the 2-layer chain
    (stall, mid-step preemption, sentinel). Every time is read under that
    contention: each reading names its wave."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    from deepspeed_tpu_torch.runtime import checkpointing as ck
    from deepspeed_tpu_torch.runtime.pipe.mpmd import StageWorkerSpec
    out = {"launches": {}}
    L, S4 = LLAMA_LAYERS, RUN_SMALL_LAYERS
    pool = ThreadPoolExecutor(max_workers=3)
    small_cfg = dict(TRAIN_CONFIG, integrity=RUN_SENTINEL)

    def small():
        stall = _runner_child(
            tmp, "stall", S4,
            dict(small_cfg, watchdog={"stall_timeout": RUN_STALL_S}),
            steps=RUN_TWIN_STEPS + 1, weighted=True,
            chaos=f"run.hang:hang:skip={RUN_TWIN_STEPS}")
        mid = _runner_child(tmp, "mid", S4, small_cfg, steps=RUN_STEPS,
                            weighted=True, sigterm_at=RUN_MID_AT)
        sen = _runner_child(
            tmp, "sentinel", S4, small_cfg, calls=RUN_SENTINEL_CALLS,
            weighted=True, ckpt=mid["ckpt"],
            chaos=(f"sentinel.spike:flag:skip={RUN_SPIKE_SKIP}:times=2:"
                   "factor=1000"))
        return stall, mid, sen

    def mpmd():
        env = {"PYTHONPATH": HERE, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        twin = _mpmd(tmp, "twin",
                     [StageWorkerSpec(env=env) for _ in range(2)])
        kill = _mpmd(tmp, "kill", [StageWorkerSpec(env=env), StageWorkerSpec(
            env=env, env_first={"DSTPU_CHAOS": "pipe.stage_kill:kill:"
                                f"match=1:skip={MPMD_KILL_SKIP}"})],
                     save_interval=MPMD_KILL_SKIP)
        return twin, kill

    # what this process still caches is the card's memory the children
    # need: each full-depth child peaks at ~29 GB, the stage workers at
    # ~9 GB, the 2-layer children at a few
    gc.collect()
    torch.cuda.empty_cache()
    # wave 1: the clean launch beside the preempted one (~57 GB)
    pre_f = pool.submit(
        _runner_child, tmp, "preempt", L, _run_config(), steps=RUN_STEPS,
        chaos=f"run.preempt:sigterm:skip={RUN_PREEMPT_AT}")
    clean = _runner_child(tmp, "clean", L, _run_config(), steps=RUN_STEPS,
                          probe=3)
    pre = pre_f.result()
    # wave 2: the resumed run beside the two MPMD runs and the 2-layer
    # chain, each chain one run after the other (~53 GB)
    mpmd_f = pool.submit(mpmd)
    small_f = pool.submit(small)
    res = _runner_child(tmp, "resume", L, _run_config(), steps=RUN_STEPS,
                        ckpt=pre["ckpt"])
    stall, mid, sen = small_f.result()
    twin, kill = mpmd_f.result()
    pool.shutdown()
    wave1 = "wave 1: clean beside preempt"
    wave2 = ("wave 2: resume beside the MPMD twin then kill, and the "
             "2-layer stall, mid, sentinel")
    out["waves"] = {"wave1": ["clean", "preempt"],
                    "wave2": ["resume", "mpmd twin then mpmd kill",
                              "stall then mid then sentinel"]}
    # 1. clean
    if clean["rc"] != 0 or len(clean["steps"]) != RUN_STEPS:
        _run_fail("clean", clean, f"rc {clean['rc']}")
    out["launches"]["clean"] = _run_launches("clean", clean, L)
    hrc, table = _run_health(clean["hb"])
    log("run: health of the clean run rc=" + str(hrc) + "\n" + table)
    if hrc != 0 or "clean exit" not in table:
        _run_fail("clean", clean, f"health rc {hrc}")
    ms = [st["ms"] for st in clean["steps"]]
    out["clean"] = {"wave": wave1,
                    "launch_to_first_step_s": clean["first_step_s"],
                    "step_ms": float(np.median(ms[1:])),
                    "step_ms_nondeterministic": float(np.median(
                        [p["ms"] for p in clean["probe"]])),
                    "step_ms_all": [round(x, 3) for x in ms],
                    "peak_gb": clean["done"]["peak_bytes"] / 1e9,
                    "s": clean["s"]}
    log("run: clean " + json.dumps(out["clean"]))
    # 2. preempt and resume
    tag = f"global_step{RUN_PREEMPT_AT}"
    if pre["rc"] != 114 or [st["step"] for st in pre["steps"]] != \
            list(range(1, RUN_PREEMPT_AT + 1)):
        _run_fail("preempt", pre, f"rc {pre['rc']} (want 114)")
    if ck.get_latest_tag(pre["ckpt"]) != tag or \
            ck.verify_tag(os.path.join(pre["ckpt"], tag)) is not None:
        _run_fail("preempt", pre, f"no intact emergency tag {tag}")
    tag_bytes = sum(_tag_bytes(os.path.join(pre["ckpt"], tag)).values())
    if res["rc"] != 0 or res["ready"]["resumed"] != \
            {"step": RUN_PREEMPT_AT, "skipped": RUN_PREEMPT_AT}:
        _run_fail("resume", res, f"rc {res['rc']} {res['ready']}")
    out["launches"]["resumed"] = _run_launches("resume", res, L)
    want = clean["steps"][RUN_PREEMPT_AT:]
    if [st["step"] for st in res["steps"]] != [st["step"] for st in want]:
        _run_fail("resume", res, "the resumed steps are not the clean "
                  "run's")
    worst = 0.0
    for a, b in zip(want, res["steps"]):
        for k in ("loss", "grad_norm"):
            worst = max(worst, abs(a[k] - b[k]) / abs(a[k]))
        log(f"run: step {b['step']} clean loss={a['loss']:.7f} "
            f"grad_norm={a['grad_norm']:.6f} resumed loss={b['loss']:.7f} "
            f"grad_norm={b['grad_norm']:.6f} lr={a['lr']:.6e}/"
            f"{b['lr']:.6e}")
        if a["lr"] != b["lr"]:
            _run_fail("resume", res, "the resumed schedule differs")
    if worst > 1e-6:
        _run_fail("resume", res, f"resumed steps differ by {worst:.3e}")
    out["preempt"] = {
        "wave": f"preempt {wave1}; resume {wave2}",
        "rc": pre["rc"], "tag": tag, "tag_bytes": tag_bytes,
        "save_and_exit_s": pre["t1"] - pre["steps"][-1]["t"],
        "resume_launch_to_first_step_s": res["first_step_s"],
        "kill_to_resumed_s": res["steps"][0]["t"] - pre["steps"][-1]["t"],
        "max_rel_diff": worst, "bitwise": worst == 0.0,
        "peak_gb": res["done"]["peak_bytes"] / 1e9}
    log("run: preempt/resume " + json.dumps(out["preempt"]))
    shutil.rmtree(pre["ckpt"], ignore_errors=True)
    # 3. stall at a depth cut, after the twin's clean steps
    last = stall["steps"][-1]["t"] if stall["steps"] else stall["t0"]
    wait = stall["t1"] - last
    if stall["rc"] != 117 or len(stall["steps"]) != RUN_TWIN_STEPS or \
            wait > RUN_STALL_S + RUN_GRACE_S:
        _run_fail("stall", stall, f"rc {stall['rc']} after {wait:.1f} s")
    if "no step progress" not in stall["out"]:
        _run_fail("stall", stall, "no stack dump of the stall")
    out["launches"]["stall"] = _run_launches("stall", stall, S4)
    out["stall"] = {"wave": wave2, "rc": stall["rc"],
                    "last_step_to_rc_s": wait,
                    "stall_timeout_s": RUN_STALL_S, "grace_s": RUN_GRACE_S}
    log("run: stall " + json.dumps(out["stall"]))
    twin_steps = {st["step"]: st for st in stall["steps"]}

    def same_as_twin(label, r, steps):
        worst = 0.0
        for st in steps:
            tw = twin_steps[st["step"]]
            for k in ("loss", "grad_norm"):
                worst = max(worst, abs(st[k] - tw[k]) / abs(tw[k]))
        if worst > 1e-6:
            _run_fail(label, r, f"steps differ from the 2-layer twin's by "
                      f"{worst:.3e}")
        return worst

    # 4. SIGTERM inside a step: the save waits for the step's end
    mid_tag = f"global_step{RUN_MID_AT}"
    if mid["rc"] != 114 or [st["step"] for st in mid["steps"]] != \
            list(range(1, RUN_MID_AT)):
        _run_fail("mid", mid, f"rc {mid['rc']} (want 114)")
    if "emergency save failed" in mid["out"] or \
            ck.get_latest_tag(mid["ckpt"]) != mid_tag or \
            ck.verify_tag(os.path.join(mid["ckpt"], mid_tag)) is not None:
        _run_fail("mid", mid, f"no intact emergency tag {mid_tag}")
    out["launches"]["mid"] = _run_launches("mid", mid, S4)
    same_as_twin("mid", mid, mid["steps"])
    # 5. the sentinel's ladder, resumed from the mid-step tag
    if sen["rc"] != 0 or sen["ready"]["resumed"] != \
            {"step": RUN_MID_AT, "skipped": RUN_MID_AT}:
        _run_fail("sentinel", sen, f"rc {sen['rc']} {sen['ready']}")
    out["launches"]["sentinel"] = _run_launches("sentinel", sen, S4)
    rows = [(st["call"], st["skip"], st["verdict"], st["step"],
             st["rollbacks"], st["data_position"]) for st in sen["steps"]]
    a1, a2 = RUN_SPIKE_SKIP + 1, RUN_SPIKE_SKIP + 2
    want_rows = []
    for c in range(1, RUN_SENTINEL_CALLS + 1):
        spiked = c in (a1, a2)
        verdict = ("strike" if c == a1 else "rollback" if c == a2 else "ok")
        step = RUN_MID_AT + (c if c < a2 else c - a2)
        want_rows.append((c, spiked, verdict, step, int(c >= a2),
                          RUN_MID_AT + c))
    log(f"run: sentinel (call, skip, verdict, global step, rollbacks, data "
        f"position) {json.dumps(rows)} audited_clean="
        f"{sen['done']['audited_clean']}")
    if rows != want_rows:
        _run_fail("sentinel", sen, f"the ladder's steps: want {want_rows}")
    if sen["done"]["audited_clean"] != mid_tag or \
            f"(tag {mid_tag})" not in sen["out"]:
        _run_fail("sentinel", sen, f"rolled back to another tag than the "
                  f"audited-clean {mid_tag}")
    # the resumed steps before the spike: the twin's, bit for bit
    mid_diff = same_as_twin("sentinel", sen, sen["steps"][:RUN_SPIKE_SKIP])
    out["mid"] = {"wave": wave2, "rc": mid["rc"], "tag": mid_tag,
                  "save_and_exit_s": mid["t1"] - mid["steps"][-1]["t"],
                  "resumed_max_rel_diff_vs_twin": mid_diff, "s": mid["s"]}
    log("run: mid-step preempt " + json.dumps(out["mid"]))
    out["sentinel"] = {"wave": wave2, "skips": [a1, a2], "rollback_at": a2,
                       "restored": mid_tag, "s": sen["s"]}
    # 6. MPMD on the one card
    if twin["rc"] != 0 or twin["restarts"] != [0, 0] or \
            len(twin["losses"]) != MPMD_STEPS:
        fail(f"run: mpmd twin rc {twin['rc']}: {twin['logs'][1][-2000:]}")
    log(f"run: mpmd losses twin={twin['losses']} killed={kill['losses']} "
        f"restarts={kill['restarts']} parks={json.dumps(kill['parks'])}")
    if kill["rc"] != 0 or kill["restarts"] != [0, 1]:
        fail(f"run: mpmd kill rc {kill['rc']} restarts {kill['restarts']}"
             f": {kill['logs'][1][-2000:]}")
    # stage 1 restarts from its step-MPMD_KILL_SKIP tag, the survivor
    # restores its own, and both replay from there
    if not kill["parks"][0] or \
            kill["parks"][0][-1]["resync_step"] != MPMD_KILL_SKIP:
        fail(f"run: mpmd survivor parks {kill['parks']}")
    for s in range(2):
        if [x["step"] for x in kill["steps"][s]] != list(range(MPMD_STEPS)):
            fail(f"run: mpmd kill stage {s} ran steps "
                 f"{[x['step'] for x in kill['steps'][s]]}")
    if kill["losses"] != twin["losses"]:
        fail(f"run: mpmd the restarted trajectory {kill['losses']} is not "
             f"the twin's {twin['losses']}")
    per_stage = LLAMA_LAYERS // 2
    mp = {"wave": wave2}
    for name, r in (("twin", twin), ("kill", kill)):
        for s in range(2):
            if not r["ends"][s]:
                fail(f"run: mpmd {name} stage {s} reported no launches")
            c = r["ends"][s][-1]["launches"]
            # a stage's backward recomputes its forward; the last stage
            # skips the forward its backward recomputes
            fwd = per_stage * MPMD_MICRO * (2 if s == 0 else 1)
            want_c = {"flash_attention_fwd": fwd,
                      "flash_attention_bwd_dq": per_stage * MPMD_MICRO,
                      "flash_attention_bwd_dkv": per_stage * MPMD_MICRO}
            st = r["steps"][s]
            for x in st:
                if x["launches"] != want_c:
                    fail(f"run: mpmd {name} stage {s} step {x['step']} "
                         f"launched {x['launches']}: expected {want_c}")
            # the process that printed the totals: the restarted stage 1
            # ran the replayed steps alone; the survivor also ran part of
            # the step it abandoned at the park
            n = (MPMD_STEPS - MPMD_KILL_SKIP if (name, s) == ("kill", 1)
                 else MPMD_STEPS)
            extra = {k: c[k] - n * v for k, v in want_c.items()}
            partial = (name, s) == ("kill", 0)
            if any(e < 0 or e >= (want_c[k] if partial else 1)
                   for k, e in extra.items()):
                fail(f"run: mpmd {name} stage {s} launched {c}: expected "
                     f"{n} x {want_c}"
                     + (" and part of the abandoned step" if partial
                        else ""))
            out["launches"][f"mpmd_{name}_stage{s}"] = c
            mp[f"{name}_stage{s}"] = {
                "step_ms": [round(x["ms"], 3) for x in st],
                "bytes_a_step": [x["bytes_sent"] + x["bytes_recv"]
                                 for x in st],
                "wait_ms": [round(x["wait_ms"], 3) for x in st],
                "peak_gb": r["ends"][s][-1]["peak_bytes"] / 1e9}
        mp[f"{name}_s"] = r["s"]
    # the killed stage's last step before the kill to its first replayed
    # step after the restart
    s1 = kill["steps"][1]
    mp["restart_s"] = s1[MPMD_KILL_SKIP]["t"] - s1[MPMD_KILL_SKIP - 1]["t"]
    mp["twin_launch_to_first_step_s"] = min(
        twin["steps"][s][0]["t"] for s in range(2)) - twin["t0"]
    out["mpmd"] = mp
    log("run: mpmd " + json.dumps(mp))
    return out


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-quant-matmul", metavar="SRC",
                    help="also time the quant_matmul kernel built from SRC "
                         "(a parent commit's csrc/quant_matmul.cu) against "
                         "this one, in one process")
    ap.add_argument("--old-flash-bwd", metavar="SRC",
                    help="also time the flash backward kernels built from "
                         "SRC (a parent commit's csrc/flash_attention_bwd.cu"
                         ", with the headers it includes beside it) against "
                         "these, in one process: the train leg's call and "
                         "its step")
    ap.add_argument("--old-flash-fwd", metavar="SRC",
                    help="also time the flash forward kernel built from SRC "
                         "(a parent commit's csrc/flash_attention_fwd.cu, "
                         "with the headers it includes beside it) against "
                         "this one, in one process: the generate prefill's "
                         "and the train leg's calls, the generate prefill "
                         "and decode step and the train step")
    ap.add_argument("--old-decode", metavar="SRC",
                    help="also time the decode kernel built from SRC (a "
                         "parent commit's csrc/decode_attention.cu, with "
                         "the headers it includes beside it) against this "
                         "one, in one process: the generate step's call, "
                         "D 96 x 16, D 80 x 32 and D 256 x 16 heads, T = 64")
    ap.add_argument("--old-block-sparse", metavar="SRC",
                    help="also time the block-sparse kernels built from "
                         "SRC (a parent commit's csrc/block_sparse_"
                         "attention.cu, with the headers it includes beside "
                         "it) against these, in one process: 44 launches "
                         "of each over four layouts, and the long step")
    ap.add_argument("--sweep-item-cost", action="store_true",
                    help="also sweep the block-sparse forward's and dq's "
                         "per-item cost of the host balance at the long "
                         "leg's call")
    ap.add_argument("--old-paged", metavar="SRC",
                    help="also time the paged kernel built from SRC (a "
                         "parent commit's csrc/paged_attention.cu) against "
                         "this one, in one process: the serve step's call "
                         "(bf16 and int8 pools), D 96 x 16 heads, and the "
                         "serve decode step")
    ap.add_argument("--only", nargs="+", metavar="PHASE",
                    choices=("ckpt", "remat", "hf", "bert-masked", "zero",
                             "sp", "dropout", "moe", "tp", "pp", "fleet",
                             "run"),
                    help="build the kernels, then run only these phases "
                         "(ckpt, remat, hf, bert-masked, zero, sp, dropout, "
                         "moe, tp, pp, fleet, run) and a result line that "
                         "names them; no kernels line")
    ap.add_argument("--zero-ranks", type=int, metavar="N",
                    help="build the kernels, then run only the zero leg "
                         "across N GPUs of this host (one process each, "
                         "through the port's launcher) and a result line "
                         "that names it")
    ap.add_argument("--zero-worker", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--sp-ranks", type=int, metavar="N",
                    help="build the kernels, then run only the sp leg "
                         "across N GPUs of this host (ring and Ulysses at "
                         "sp = N, one process each, through the port's "
                         "launcher) and a result line that names it")
    ap.add_argument("--sp-worker", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--ep-ranks", type=int, metavar="N",
                    help="build the kernels, then run only the moe train "
                         "leg across N GPUs of this host at ep_size N (one "
                         "process each, through the port's launcher) and a "
                         "result line that names it")
    ap.add_argument("--ep-worker", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--tp-ranks", type=int, metavar="N",
                    help="build the kernels, then run only the tp legs "
                         "across N GPUs of this host (Llama-2-70B at tp N, "
                         "full depth at N = 4; training at tp 2 x data N / "
                         "2; one process each, through the port's "
                         "launcher) and a result line that names it")
    ap.add_argument("--tp-worker", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--tp-rest-ranks", type=int, metavar="N",
                    help="build the kernels, then run only the rest of "
                         "the tp legs across N GPUs of this host "
                         "(Falcon-7B at tp N, bf16 and int8, 32 layers; "
                         "Mixtral-8x7B at tp N, 32 layers, and trained at "
                         "tp 2 x ep N / 2; llama-1.1b int8 at tp N and at "
                         "sp 2 x tp N / 2; one process each, through the "
                         "port's launcher) and a result line that names it")
    ap.add_argument("--tp-rest-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--pp-ranks", type=int, metavar="N",
                    help="build the kernels, then run only the pp leg "
                         "across N GPUs of this host (gpt2-6.7b as N "
                         "pipeline stages, 1F1B; one process each, through "
                         "the port's launcher) and a result line that names "
                         "it")
    ap.add_argument("--pp-compose", nargs="+", metavar="MODE",
                    choices=tuple(PP_COMPOSE),
                    help="with --pp-ranks 4: instead of gpt2-6.7b, pp 2 "
                         "composed with a second axis, each MODE a fresh "
                         "4-rank world (tp: Llama-2-70B at pp 2 x tp 2; "
                         "ep: Mixtral-8x7B at pp 2 x ep 2, ZeRO 1; zero3: "
                         "gpt2-1.3b at pp 2 x data 2, ZeRO 3)")
    ap.add_argument("--pp-worker", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs only on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "deepspeed_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(deepspeed_tpu_torch/ is not beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import deepspeed_tpu_torch
    if not os.path.abspath(deepspeed_tpu_torch.__file__).startswith(HERE):
        fail("deepspeed_tpu_torch imported from outside this checkout")
    if args.zero_worker:
        return zero_worker(args.zero_worker)
    if args.sp_worker:
        return sp_worker(args.sp_worker)
    if args.ep_worker:
        return ep_worker(args.ep_worker)
    if args.tp_worker:
        return tp_worker(args.tp_worker)
    if args.tp_rest_worker:
        return tp_rest_worker(args.tp_rest_worker)
    if args.pp_worker:
        if args.pp_compose:
            return pp_compose_worker(args.pp_worker, args.pp_compose[0])
        return pp_worker(args.pp_worker)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _PHASE_T[0] = t0
    phase_build()
    _mark("build")
    if args.zero_ranks:
        if torch.cuda.device_count() < args.zero_ranks:
            fail(f"--zero-ranks {args.zero_ranks}: this host has "
                 f"{torch.cuda.device_count()} GPUs")
        with tempfile.TemporaryDirectory() as tmp:
            phase_zero_ranks(tmp, args.zero_ranks)
        log(f"total_s={time.perf_counter() - t0:.1f}")
        log(smi)
        log(json.dumps({"ok": True, "zero_ranks": args.zero_ranks,
                        "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}))
        return 0
    if args.tp_rest_ranks:
        if torch.cuda.device_count() < args.tp_rest_ranks:
            fail(f"--tp-rest-ranks {args.tp_rest_ranks}: this host has "
                 f"{torch.cuda.device_count()} GPUs")
        with tempfile.TemporaryDirectory() as tmp:
            phase_tp_rest_ranks(tmp, args.tp_rest_ranks)
        log(f"total_s={time.perf_counter() - t0:.1f}")
        log(smi)
        log(json.dumps({"ok": True, "tp_rest_ranks": args.tp_rest_ranks,
                        "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}))
        return 0
    if args.sp_ranks:
        if torch.cuda.device_count() < args.sp_ranks:
            fail(f"--sp-ranks {args.sp_ranks}: this host has "
                 f"{torch.cuda.device_count()} GPUs")
        with tempfile.TemporaryDirectory() as tmp:
            phase_sp_ranks(tmp, args.sp_ranks)
        log(f"total_s={time.perf_counter() - t0:.1f}")
        log(smi)
        log(json.dumps({"ok": True, "sp_ranks": args.sp_ranks,
                        "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}))
        return 0
    if args.ep_ranks:
        if torch.cuda.device_count() < args.ep_ranks:
            fail(f"--ep-ranks {args.ep_ranks}: this host has "
                 f"{torch.cuda.device_count()} GPUs")
        with tempfile.TemporaryDirectory() as tmp:
            phase_ep_ranks(tmp, args.ep_ranks)
        log(f"total_s={time.perf_counter() - t0:.1f}")
        log(smi)
        log(json.dumps({"ok": True, "ep_ranks": args.ep_ranks,
                        "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}))
        return 0
    if args.tp_ranks:
        if torch.cuda.device_count() < args.tp_ranks:
            fail(f"--tp-ranks {args.tp_ranks}: this host has "
                 f"{torch.cuda.device_count()} GPUs")
        with tempfile.TemporaryDirectory() as tmp:
            phase_tp_ranks(tmp, args.tp_ranks)
        log(f"total_s={time.perf_counter() - t0:.1f}")
        log(smi)
        log(json.dumps({"ok": True, "tp_ranks": args.tp_ranks,
                        "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}))
        return 0
    if args.pp_ranks:
        if torch.cuda.device_count() < args.pp_ranks:
            fail(f"--pp-ranks {args.pp_ranks}: this host has "
                 f"{torch.cuda.device_count()} GPUs")
        with tempfile.TemporaryDirectory() as tmp:
            if args.pp_compose:
                for mode in args.pp_compose:
                    phase_pp_compose(tmp, args.pp_ranks, mode)
            else:
                phase_pp_ranks(tmp, args.pp_ranks)
        log(f"total_s={time.perf_counter() - t0:.1f}")
        log(smi)
        log(json.dumps({"ok": True, "pp_ranks": args.pp_ranks,
                        **({"pp_compose": args.pp_compose}
                           if args.pp_compose else {}),
                        "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}))
        return 0
    if args.only:
        with tempfile.TemporaryDirectory() as tmp:
            for phase in args.only:
                res = {"ckpt": lambda: phase_ckpt(tmp),
                       "remat": lambda: phase_remat(tmp),
                       "hf": lambda: phase_hf(smi),
                       "bert-masked": time_bert_masked_flash,
                       "zero": lambda: phase_zero(tmp),
                       "sp": lambda: phase_sp(tmp),
                       "dropout": phase_dropout,
                       "moe": lambda: phase_moe(tmp, smi),
                       "tp": lambda: {"phase": phase_tp(smi),
                                      "tp4_calls": time_tp_kernels(),
                                      "falcon": phase_falcon(smi),
                                      "tp_rest_calls":
                                          time_tp_rest_kernels()},
                       "pp": lambda: phase_pp(tmp),
                       "fleet": lambda: phase_fleet(tmp),
                       "run": lambda: phase_run(tmp)
                       }[phase]()
                _mark(phase)
                log(f"time: {phase} " + json.dumps(res, default=str))
        log("time: phases_s " + json.dumps(_PHASE_S))
        log(f"total_s={time.perf_counter() - t0:.1f}")
        log(smi)
        # a partial run names its phases, so its last line is never the
        # full run's
        log(json.dumps({"ok": True, "only": args.only, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    old_fwd = (_parent_flash_fwd(args.old_flash_fwd)
               if args.old_flash_fwd else None)
    old_paged = _parent_paged(args.old_paged) if args.old_paged else None
    errs = phase_check()
    _mark("check")
    with tempfile.TemporaryDirectory() as tmp:
        eng, srv, cfg, pa_launches, rates = phase_serve(tmp)
    if old_paged:
        ab_paged(old_paged, srv)
    del srv
    torch.cuda.empty_cache()
    _mark("serve")
    srv8, qm_launches, qm_by_path, int8_rates = phase_int8(eng)
    _mark("int8")
    with tempfile.TemporaryDirectory() as tmp:
        gen_counts, gen_rates = phase_generate(tmp, eng)
    if old_fwd:
        ab_generate(old_fwd, eng.cfg, eng.params)
    torch.cuda.empty_cache()
    _mark("generate")
    with tempfile.TemporaryDirectory() as tmp:
        fleet = phase_fleet(tmp, eng)
    torch.cuda.empty_cache()
    _mark("fleet")
    log("time: fleet " + json.dumps({k: v for k, v in fleet.items()
                                     if k != "launches"}, default=str))
    log("time: serve " + json.dumps(rates))
    log("time: generate " + json.dumps(gen_rates))
    log("time: int8 " + json.dumps(int8_rates))
    pa = time_paged_attention()
    mats, dense = _int8_mats(srv8.params)
    qm = time_quant_matmul(mats, dense, 8)
    qm["prefill"] = time_quant_matmul(mats, dense, 512)
    qm["prefill"]["ms_by_m"] = time_quant_matmul_prefill_lengths(mats)
    time_quant_matmul_blocks(dense)
    del dense
    torch.cuda.empty_cache()
    if args.old_quant_matmul:
        old = _parent_quant_matmul(args.old_quant_matmul)
        ab_quant_matmul(mats, old)
        ab_int8(srv8, old)
    del srv8, eng, mats
    torch.cuda.empty_cache()
    da = time_decode_attention()
    sweep_decode_splits()
    torch.cuda.empty_cache()
    if args.old_decode:
        ab_decode(_parent_decode(args.old_decode))
    dm = time_decode_attention_multi()
    torch.cuda.empty_cache()
    fa = time_flash_attention()
    if old_fwd:
        ab_flash_fwd(old_fwd)
    torch.cuda.empty_cache()
    _mark("time_serving_kernels")
    with tempfile.TemporaryDirectory() as tmp:
        trainer, batch, train_counts, train_rates = phase_train(tmp)
    log("time: train " + json.dumps(train_rates))
    old_bwd = (_parent_flash_bwd(args.old_flash_bwd)
               if args.old_flash_bwd else None)
    if old_bwd:
        ab_train(trainer, batch, old_bwd)
    if old_fwd:
        ab_train(trainer, batch, old_fwd, which="fwd")
    del trainer
    torch.cuda.empty_cache()
    _mark("train")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = phase_ckpt(tmp)
        _mark("ckpt")
        remat = phase_remat(tmp)
        _mark("remat")
    log("time: ckpt " + json.dumps(ckpt))
    log("time: remat " + json.dumps(remat))
    fb = time_flash_attention_bwd()
    if old_bwd:
        ab_flash_bwd(old_bwd, fb)
    torch.cuda.empty_cache()
    time_head_dims()
    time_wide_heads()
    bert = time_bert_masked_flash()
    _mark("time_train_kernels")
    with tempfile.TemporaryDirectory() as tmp:
        gemma_counts = phase_gemma(tmp)
    _mark("gemma")
    hf_counts = phase_hf(smi)
    _mark("hf")
    old_bs = (_parent_block_sparse(args.old_block_sparse)
              if args.old_block_sparse else None)
    with tempfile.TemporaryDirectory() as tmp:
        long_counts, window_counts, long_rates = phase_long(tmp, old_bs)
    log("time: long " + json.dumps(long_rates))
    _mark("long")
    with tempfile.TemporaryDirectory() as tmp:
        zero = phase_zero(tmp)
    _mark("zero")
    log("time: zero " + json.dumps({k: v for k, v in zero.items()
                                    if k != "d128"}))
    with tempfile.TemporaryDirectory() as tmp:
        sp = phase_sp(tmp)
    _mark("sp")
    dropout = phase_dropout()
    log("time: dropout " + json.dumps(dropout))
    _mark("dropout")
    with tempfile.TemporaryDirectory() as tmp:
        moe = phase_moe(tmp, smi)
    log("time: moe " + json.dumps(moe["rates"]))
    _mark("moe")
    tp = phase_tp(smi)
    tp4 = time_tp_kernels()
    falcon = phase_falcon(smi)
    tpr = time_tp_rest_kernels()
    _mark("tp")
    with tempfile.TemporaryDirectory() as tmp:
        pp = phase_pp(tmp)
    log("time: pp " + json.dumps({k: v for k, v in pp.items()
                                  if k != "launches"}, default=str))
    _mark("pp")
    with tempfile.TemporaryDirectory() as tmp:
        run = phase_run(tmp)
    log("time: run " + json.dumps({k: v for k, v in run.items()
                                   if k != "launches"}, default=str))
    _mark("run")
    bs = time_block_sparse_attention()
    time_block_sparse_scaling()
    if old_bs is not None:
        ab_block_sparse(old_bs)
    if args.sweep_item_cost:
        sweep_item_cost()
    _mark("time_block_sparse")
    kernels = []
    for kname, launches, t, src, tpu in (
            ("paged_attention", pa_launches, pa,
             "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
             "deepspeed_tpu/ops/pallas/paged_attention.py:50"),
            ("quant_matmul", qm_launches, qm,
             "deepspeed_tpu_torch/ops/csrc/quant_matmul.cu",
             "deepspeed_tpu/ops/pallas/quant_matmul.py:95"),
            ("decode_attention", gen_counts["decode_attention"], da,
             "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
             "deepspeed_tpu/ops/pallas/decode_attention.py:43"),
            ("flash_attention_fwd", gen_counts["flash_attention_fwd"], fa,
             "deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
             "deepspeed_tpu/ops/pallas/flash_attention.py:154"),
            ("flash_attention_bwd_dq", train_counts["flash_attention_bwd_dq"],
             fb["flash_attention_bwd_dq"],
             "deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
             "deepspeed_tpu/ops/pallas/flash_attention.py:285"),
            ("flash_attention_bwd_dkv",
             train_counts["flash_attention_bwd_dkv"],
             fb["flash_attention_bwd_dkv"],
             "deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
             "deepspeed_tpu/ops/pallas/flash_attention.py:330"),
            *((kname, long_counts[kname], bs[kname],
               "deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
               f"deepspeed_tpu/ops/pallas/block_sparse_attention.py:{line}")
              for kname, line in zip(BS_KERNELS, (69, 116, 156)))):
        row = {"name": kname, "route": "cuda", "source": src,
               "replaces": tpu, "launches": launches,
               "max_abs_err": errs[kname]}
        if kname == "flash_attention_fwd":
            row["launches_by_path"] = {
                "generate": launches,
                "train": train_counts["flash_attention_fwd"]}
        # the head-dim-256 leg's launches by entry point
        row["launches_head_dim_256"] = {
            path: c[kname] for path, c in gemma_counts.items()
            if c.get(kname)}
        # the HF import legs' (Phi-2, BERT-large) launches by entry point
        row["launches_hf"] = {path: c[kname] for path, c in hf_counts.items()
                              if c.get(kname)}
        if kname in bert:   # BERT-large's masked calls beside SDPA's
            row["bert_masked"] = bert[kname]
        # this slice's legs: the checkpoint leg's resumed steps and served
        # engines, and the remat leg's step under each policy
        row["launches_ckpt"] = {path: c[kname] for path, c in
                                ckpt["launches"].items() if c.get(kname)}
        row["launches_remat"] = {policy: r["launches"][kname]
                                 for policy, r in remat.items()
                                 if r["launches"].get(kname)}
        if kname in FLASH_KERNELS:  # the zero leg's step and D 128 calls
            row["launches_zero"] = zero["launches"][kname]
            row["zero_d128"] = zero["d128"][kname]
            # the sp leg's step under each impl, and its calls' times
            row["launches_sp"] = {mode: sp[mode]["launches"][kname]
                                  for mode in ("ring", "ulysses")}
            row["sp_calls"] = sp["flash"][kname]
        if kname in BS_KERNELS:
            row["launches_by_path"] = {"sparse_train": launches,
                                       "window_train": window_counts[kname]}
        # the moe leg's (Mixtral-8x7B) launches by entry point
        row["launches_moe"] = {path: c[kname] for path, c in
                               moe["launches"].items() if c.get(kname)}
        # the tp leg's (Llama-2-70B, TP layers in a 1-rank world) launches
        # by entry point, and the calls at a tp-4 rank's shapes
        row["launches_tp"] = {path: c[kname] for path, c in
                              tp["launches"].items() if c.get(kname)}
        if kname in tp4:
            row["tp4_calls"] = tp4[kname]
        # the falcon leg's (Falcon-7B through the head map in a 1-rank
        # world) launches by entry point, and the calls at this slice's
        # new shard shapes (uneven heads over one KV head; int8 row shards
        # off the 256-row grid)
        row["launches_falcon"] = {path: c[kname] for path, c in
                                  falcon["launches"].items()
                                  if c.get(kname)}
        if kname in tpr:
            row["tp_rest_calls"] = tpr[kname]
        # the pp leg's (gpt2-1.3b, 4 stages in one process) launches by
        # run: the f32 and bf16 pipeline steps, the engines' steps
        if kname in FLASH_KERNELS:
            row["launches_pp"] = {path: c[kname] for path, c in
                                  pp["launches"].items()}
            # the run leg's children: each launched run's total and each
            # MPMD stage worker's report
            row["launches_run"] = {path: c[kname] for path, c in
                                   run["launches"].items()}
        if kname == "quant_matmul":
            row["launches_by_path"] = qm_by_path
        if kname in ("paged_attention", "quant_matmul"):
            # the fleet leg's launches by part: per replica (a thread
            # replica's own tally, a child process's report), and the
            # process-wide count of the thread parts
            row["launches_fleet"] = {
                part: {str(i): c.get(kname, 0)
                       for i, c in v["replicas"].items()}
                for part, v in fleet["launches"].items()
                if isinstance(v, dict) and "replicas" in v}
        row.update(t)
        kernels.append(row)
        both = (f" [bytes {t['bound_bytes_ms']:.4f}, operations "
                f"{t['bound_ops_ms']:.4f}]" if "bound_ops_ms" in t else "")
        log(f"time: {kname} ms={t['ms']:.4f} bound_ms={t['bound_ms']:.4f} "
            f"({t['bound_by']}){both} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms']:.4f} "
            f"wall_ms={t['wall_ms']:.4f}"
            + (f" flex_ms={t['flex_ms']}" if "flex_ms" in t else "")
            + f" [{t['work']}]")
    p = qm["prefill"]
    log(f"time: quant_matmul prefill ms={p['ms']:.4f} "
        f"bound_ms={p['bound_ms']:.4f} ({p['bound_by']}) [bytes "
        f"{p['bound_bytes_ms']:.4f}, operations {p['bound_ops_ms']:.4f}] "
        f"plain_ms={p['plain_ms']:.4f} library_ms={p['library_ms']:.4f} "
        f"wall_ms={p['wall_ms']:.4f} ms_by_m={json.dumps(p['ms_by_m'])} "
        f"[{p['work']}]")
    log(f"time: decode_attention T=64 ms={dm['ms']:.4f} "
        f"bound_ms={dm['bound_ms']:.4f} ({dm['bound_by']}) "
        f"plain_ms={dm['plain_ms']:.4f} library_ms={dm['library_ms']:.4f} "
        f"wall_ms={dm['wall_ms']:.4f} [{dm['work']}]")
    _mark("report")
    log("time: phases_s " + json.dumps(_PHASE_S))
    log(f"total_s={time.perf_counter() - t0:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
