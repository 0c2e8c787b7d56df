#!/usr/bin/env python3
"""End-to-end check of deepspeed_tpu_torch on one CUDA GPU (Hopper).

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
GPU, ``nvcc`` and nothing from the network, and it imports neither JAX
nor ``deepspeed_tpu``. Phases, each reported on its own line:

1. **build** — compile the hand-written kernels of
   ``deepspeed_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in parallel).
2. **check** — each kernel against its plain PyTorch version at the
   serving path's shapes, with the tolerance printed on the line.
3. **serve** — ``init_inference`` from a JSON config file, llama-1.1b at
   full width (22 layers, seeded random bf16 weights), ``.serve()``, 16
   greedy requests of 64..1024 prompt tokens (6 start with one 2-block
   system prompt) and 64 new tokens each; then one decode step's logits through
   the kernels vs ``impl="reference"``.
4. **int8** — a short leg with ``kv_cache_dtype`` and ``weight_dtype``
   int8.
5. **time** — prefill and decode tokens/s from the serve leg, the device
   busy share of a decode step (torch.profiler), and each kernel's device
   time per decode step beside its bound, its plain version's and a
   library call's (timed here only; the port never calls it).

Launch counters are zeroed just before each serving leg and read just
after it. Any failed check raises, so the script exits non-zero and
prints no result. The last lines are the ``kernels`` JSON, the card's
``nvidia-smi`` name and power limit, and the result JSON.
"""

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
SERVING = {"block_size": 32, "pool_blocks": 256, "max_batch": 8,
           "max_blocks_per_seq": 64}


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


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


def device_ms(fn, reps=10, warmup=2):
    """Device time per call: the CUDA kernel time torch.profiler records
    over ``reps`` calls, summed, so host gaps between launches do not
    count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        fail("torch.profiler recorded no device time for a timed call")
    return us / 1e3 / reps


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

def phase_build():
    from deepspeed_tpu_torch.ops import build
    secs = build.build()
    for name in build.KERNELS:
        info = [ln.strip() for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"build: {name} " + " | ".join(info))
    log(f"build: seconds={secs:.2f} kernels={list(build.KERNELS)}")


# --------------------------------------------------------------- 2. check

def _max_err(out, ref):
    return (out.float() - ref.float()).abs().max().item()


def phase_check():
    import torch
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    from deepspeed_tpu_torch.quant_format import kv_quantize
    errs = {"paged_attention": 0.0, "quant_matmul": 0.0}
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
    # bf16: the plain version rounds the scores to bf16 before the softmax
    # (as the JAX reference does) and the kernel keeps them f32; with
    # scores up to ~16, one bf16 ulp (1/16) moves p by a few percent, so
    # O(1) outputs may differ by ~3e-2. f32: both exact to rounding.
    cases = [
        ("bf16", q32.to(bf), k32.to(bf), v32.to(bf), {}, 3e-2),
        ("f32", q32, k32, v32, {}, 1e-4),
        ("int8", q32.to(bf), kq, vq, {"k_scale": ks, "v_scale": vs}, 3e-2),
        ("bf16+alibi+softcap+window", q32.to(bf), k32.to(bf), v32.to(bf),
         {"alibi_slopes": slopes, "softcap": 30.0, "window": 100}, 3e-2),
    ]
    live = lens > 0
    for name, q, k, v, kw, tol in cases:
        out = tpa.paged_attention(q, k, v, bt, lens, layer_idx=1, **kw)
        ref = tpa.paged_attention_reference(q, k, v, bt, lens, layer_idx=1,
                                            **kw)
        torch.cuda.synchronize()
        err = _max_err(out[live], ref[live])
        zero = out[~live].abs().max().item()
        errs["paged_attention"] = max(errs["paged_attention"], err)
        log(f"check: paged_attention {name} max_abs_err={err:.3e} "
            f"tol={tol} zero_lane_max={zero}")
        if not err <= tol or zero != 0.0:
            fail(f"paged_attention {name}: err {err} (tol {tol}), "
                 f"ctx-0 lane {zero}")
    H, F, V = 2048, 5632, 32000
    shapes = [(8, H, 2560), (8, H, H), (8, H, F), (8, H, F), (8, F, H),
              (8, H, V), (512, H, F)]
    for M, K, N in shapes:
        w = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
        x = torch.randn(M, K, device=dev, generator=g).to(bf)
        qw, sw = tqm.pack_kernel(w)
        out = tqm.quant_matmul(x, qw, sw)
        ref = tqm.quant_matmul_reference(x, qw, sw)
        torch.cuda.synchronize()
        # both sum in f32 and round once to bf16: at most ~1 bf16 ulp of
        # the largest output apart
        tol = 2 ** -7 * ref.float().abs().max().item()
        err = _max_err(out, ref)
        errs["quant_matmul"] = max(errs["quant_matmul"], err)
        log(f"check: quant_matmul M={M} K={K} N={N} max_abs_err={err:.3e} "
            f"tol={tol:.3e}")
        if not err <= tol:
            fail(f"quant_matmul {M}x{K}x{N}: err {err} > {tol}")
    return errs


# --------------------------------------------------------------- 3. serve

class _Timed:
    """Wraps an engine method: wall seconds and calls (each call ends in a
    host read of sampled tokens, so the device work is inside)."""

    def __init__(self, fn):
        self.fn, self.secs, self.calls = fn, 0.0, 0

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            self.secs += time.perf_counter() - t0
            self.calls += 1


def _instrument(srv):
    srv._run_prefill = _Timed(srv._run_prefill)
    srv._decode_step = _Timed(srv._decode_step)


def _zero_counters():
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    tpa.paged_attention.launches = 0
    tqm.quant_matmul.launches = 0


def _counters():
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    return {"paged_attention": tpa.paged_attention.launches,
            "quant_matmul": tqm.quant_matmul.launches}


def _run_requests(srv, prompts, new):
    from deepspeed_tpu_torch.serving.scheduler import FINISHED
    reqs = [srv.submit(p, new) for p in prompts]
    srv.run_until_idle()
    for r in reqs:
        if r.state != FINISHED or len(r.output_tokens) != new:
            fail(f"request {r.rid}: state {r.state}, "
                 f"{len(r.output_tokens)} tokens of {new}")
    return reqs


def _decode_logits_check(srv, tol_rel, label):
    """One decode step of the live lanes through the kernels and through
    impl="reference", each on its own copy of the pools."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.serving.model_runner import paged_forward
    live = [s for s in srv._slots if s is not None]
    if not live:
        fail(f"{label}: no live lane for the logits check")
    B, dev = srv.max_batch, srv.device
    toks = np.zeros((B, 1), np.int64)
    ctx = np.zeros((B,), np.int64)
    tables = np.zeros((B, srv.nbk), np.int32)
    for i, s in enumerate(srv._slots):
        if s is not None:
            toks[i, 0], ctx[i], tables[i] = s.last_tok, s.ctx, s.table
    args = [torch.as_tensor(a, device=dev) for a in (toks, tables, ctx)]
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
    rows = torch.as_tensor([s is not None for s in srv._slots], device=dev)
    a, b = out["auto"][rows], out["reference"][rows]
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"check: {label} decode logits kernels vs reference "
        f"max_abs_err={err:.4e} max_abs_logit={scale:.4e} "
        f"tol={tol_rel}*max_abs_logit argmax_agree={agree:.3f}")
    if not err <= tol_rel * scale:
        fail(f"{label} decode logits differ by {err} (> {tol_rel} x {scale})")


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
    d = {k: srv.stats[k] - stats0[k] for k in srv.stats}
    steps = srv._decode_step.calls
    log(f"serve: requests={len(prompts)} finished={d['completed']} "
        f"prefill_tokens={d['prefill_tokens']} "
        f"prefix_hit_tokens={d['prefix_hit_tokens']} decode_steps={steps} "
        f"launches={json.dumps(counts)} wall_s={wall:.2f}")
    if d["prefix_hit_tokens"] <= 0:
        fail("no prefix-cache hit on the shared system prompt")
    if counts["paged_attention"] < LLAMA_LAYERS * steps or steps == 0:
        fail(f"paged_attention launched {counts['paged_attention']} times "
             f"for {steps} decode steps of {LLAMA_LAYERS} layers")
    decode_tokens = d["tokens_generated"] - d["completed"]
    rates = {"prefill_tok_s": d["prefill_tokens"] / srv._run_prefill.secs,
             "decode_tok_s": decode_tokens / srv._decode_step.secs,
             "decode_step_ms": 1e3 * srv._decode_step.secs / steps,
             "mean_decode_lanes": decode_tokens / steps}
    # a fresh batch in flight for the logits check
    for p in prompts[:8]:
        srv.submit(p[:256], 8)
    srv.step()
    _decode_logits_check(srv, 5e-2, "bf16")
    srv.run_until_idle()
    profile_decode(srv)
    return eng, srv, cfg, counts["paged_attention"], rates


def profile_decode(srv, steps=5):
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
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    if busy_ms <= 0:
        log(f"time: decode step profile wall_ms={wall_ms:.3f} "
            "device_busy_ms=not measured (no device time in the trace)")
        return
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log(f"time: decode step profile wall_ms={wall_ms:.3f} "
        f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / wall_ms:.3f} "
        "top=" + json.dumps({e.key[:60]: round(
            e.self_device_time_total / 1e3 / steps, 4) for e in top}))


# ---------------------------------------------------------------- 4. int8

def phase_int8(eng):
    import numpy as np
    srv = eng.serve(dict(SERVING, kv_cache_dtype="int8",
                         weight_dtype="int8"))
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, 32000, int(n)))
               for n in (96, 200, 333, 512)]
    _run_requests(srv, [prompts[0][:40]], 2)            # warm-up
    _zero_counters()
    _run_requests(srv, prompts, 16)
    counts = _counters()
    log(f"int8: requests={len(prompts)} launches={json.dumps(counts)}")
    if counts["quant_matmul"] <= 0 or counts["paged_attention"] <= 0:
        fail(f"int8 leg launched {counts}")
    for p in prompts:
        srv.submit(p[:128], 4)
    srv.step()
    _decode_logits_check(srv, 5e-2, "int8")
    srv.run_until_idle()
    return srv, counts["quant_matmul"]


# ---------------------------------------------------------------- 5. time

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


def time_quant_matmul(srv8):
    """One decode step's int8 matmuls at M=8: 22 layers x (qkv, proj,
    gate, fc, mlp_proj) with each layer's own packed weights, plus the LM
    head."""
    import torch
    from deepspeed_tpu_torch.models.generation import _kernel_of
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    blocks, head = srv8.params["blocks"], srv8.params["lm_head"]
    names = ("attn_qkv", "attn_proj", "mlp_gate", "mlp_fc", "mlp_proj")
    mats = [(blocks[n]["kernel"][li], blocks[n]["kernel_qscale"][li])
            for li in range(LLAMA_LAYERS) for n in names]
    mats.append((head["kernel"], head["kernel_qscale"]))
    M = 8
    g = torch.Generator(device="cuda").manual_seed(3)
    xs = {K: torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
          for K in {q.shape[0] for q, _ in mats}}
    dense = [_kernel_of({"kernel": q, "kernel_qscale": s}, torch.bfloat16)
             for q, s in mats]
    t = timings(
        lambda: [tqm.quant_matmul(xs[q.shape[0]], q, s) for q, s in mats],
        lambda: [tqm.quant_matmul_reference(xs[q.shape[0]], q, s)
                 for q, s in mats],
        lambda: [xs[w.shape[0]] @ w for w in dense])
    nbytes = sum(q.numel() + 4 * s.numel() + 2 * M * (q.shape[0] + q.shape[1])
                 for q, s in mats)
    flops = sum(2 * M * q.shape[0] * q.shape[1] for q, _ in mats)
    bnd, by = bound_ms(nbytes, flops)
    return {**t, "bound_ms": bnd, "bound_by": by,
            "work": f"one decode step: {len(mats)} launches at M={M} "
                    f"({LLAMA_LAYERS} layers x 5 + head), "
                    f"{nbytes / 1e9:.3f} GB"}


def main():
    import torch
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
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    phase_build()
    errs = phase_check()
    with tempfile.TemporaryDirectory() as tmp:
        eng, srv, cfg, pa_launches, rates = phase_serve(tmp)
    del srv
    torch.cuda.empty_cache()
    srv8, qm_launches = phase_int8(eng)
    log("time: serve " + json.dumps(rates))
    pa = time_paged_attention()
    qm = time_quant_matmul(srv8)
    kernels = []
    for kname, launches, t, src, tpu in (
            ("paged_attention", pa_launches, pa,
             "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
             "deepspeed_tpu/ops/pallas/paged_attention.py:50"),
            ("quant_matmul", qm_launches, qm,
             "deepspeed_tpu_torch/ops/csrc/quant_matmul.cu",
             "deepspeed_tpu/ops/pallas/quant_matmul.py:95")):
        row = {"name": kname, "route": "cuda", "source": src,
               "replaces": tpu, "launches": launches,
               "max_abs_err": errs[kname]}
        row.update(t)
        kernels.append(row)
        log(f"time: {kname} ms={t['ms']:.4f} bound_ms={t['bound_ms']:.4f} "
            f"({t['bound_by']}) plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms']:.4f} "
            f"wall_ms={t['wall_ms']:.4f} [{t['work']}]")
    log(f"total_s={time.perf_counter() - t0:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
