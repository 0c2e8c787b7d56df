"""Tensor parallelism across real gloo ranks on the CPU: the port's TP
layers against the JAX package's ``tp_size`` 2 engines and the 1-rank
port.

Two 2-layer models, their flax-initialized f32 weights fed to both
packages: ``llama`` (hidden 64, RMSNorm, GQA 4q / 2kv, rotary, SwiGLU,
untied head, no biases) with vocab 251, which splits unevenly at tp 2
(126 + 125 rows, the second rank's shard padded), and ``gpt2`` (hidden
64, 4 heads, learned positions, LayerNorm, GELU, biased qkv and
projections, the head tied to the embedding) with vocab 256. The JAX
tp-2 engine refuses vocab 251 (``device_put`` of a [251, 64] table over
a model axis of 2 raises on an uneven split), so ``llama``'s runs are
held to the JAX engine at tp 1, the same function, and ``gpt2``'s to
the JAX tp-2 engine. Single-process checks: ``tp_rules()``
and ``build_tp_specs`` against JAX's spec for spec, the ZeRO policy
composed with the TP specs against JAX's, the shard maps (per-head qkv,
padded vocab, assembly) and the raises. Two spawns
(``test_torch_comm._spawn``: a ``file://`` rendezvous, killed and failed
past their own clock):

* **2 ranks, ``tp_size`` 2** (``sharding_rules=cfg.tp_rules()``): each
  rank's shard shapes; f32 ``forward`` logits against the JAX engine's
  at rtol 1e-5; greedy ``generate()`` and ``serve()`` tokens equal to
  the JAX engine's in f32 and through the int8 engine, and
  equal on both ranks (the serve loop's block tables too); a
  topology-free npz loaded at tp 2 gives the tp-1 engine's tokens (JAX
  ``test_inference.py:143``); ``train_batch`` at ZeRO stages 0-3 (and the
  fused CE) within rtol 1e-5 of the 1-rank port and 2e-4 of the JAX
  engine (JAX ``test_models.py:88``), every forward issuing 2
  model-axis all-reduces a layer plus the embedding's.
* **4 ranks, tp 2 x data 2, ZeRO-3**: three steps within rtol 1e-5 of
  the 1-rank port; a sharded save (qkv shards written as their q, k and v
  pieces at their global offsets) loads into a 1-rank port engine and
  into the JAX engine bitwise, and their next steps agree.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.inference.engine import InferenceEngine as JInferenceEngine
from deepspeed_tpu.models import build_model as jbuild_model
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel.mesh import MeshManager
from deepspeed_tpu.runtime.zero import stages as jstages
from deepspeed_tpu.utils.partitioning import build_tp_specs as jbuild_specs

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.runtime.zero import stages as tstages
from deepspeed_tpu_torch.utils import partitioning as tpart

from test_torch_comm import _spawn

V = 251
BASE = dict(hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
            attention_impl="auto")
ARCHS = {
    "llama": dict(BASE, vocab_size=V, num_kv_heads=2, pos_embed="rotary",
                  rotary_interleaved=False, norm="rmsnorm", gated_mlp=True,
                  activation="silu", tie_embeddings=False, use_bias=False,
                  mlp_dim_override=128),
    "gpt2": dict(BASE, vocab_size=256),
    # the replicated leaves used on a rank's share of the model: qk-norm
    # scales on its heads, an untied head's bias and BERT's MLM bias on
    # its vocab rows (their gradients are summed over the model axis)
    "qkn": dict(BASE, vocab_size=256, qk_norm=True, norm="rmsnorm",
                pos_embed="rotary", use_bias=False),
    "hbias": dict(BASE, vocab_size=256, tie_embeddings=False,
                  lm_head_bias=True),
    "bert": dict(BASE, vocab_size=256, causal=False, post_ln=True,
                 embed_ln=True, token_type_vocab=2, mlm_head=True,
                 activation="gelu_exact"),
    # uneven query heads over one kv head (multi-query attention): at tp 2
    # rank 0 computes q heads 0-1 and rank 1 head 2, both read kv head 0
    # (its gradient summed over the two holders); biased qkv, rotary,
    # SwiGLU; every row-parallel shard off the int8 scale grid
    "mqa": dict(BASE, vocab_size=256, hidden_size=48, num_heads=3,
                num_kv_heads=1, pos_embed="rotary", rotary_interleaved=False,
                norm="rmsnorm", gated_mlp=True, activation="silu",
                mlp_dim_override=96),
    # mqa at head dim 128: at tp 2 rank 0's attn_proj shard (rows 0-255)
    # lies on the 256-row int8 scale grid and rank 1's (256-383) is off
    # it; both mlp_proj shards (384 rows each) are off it
    "mqa128": dict(BASE, vocab_size=256, hidden_size=384, num_heads=3,
                   num_kv_heads=1, pos_embed="rotary",
                   rotary_interleaved=False, norm="rmsnorm", gated_mlp=True,
                   activation="silu", mlp_dim_override=768),
}
# the archs of the forward / generate / serve legs
INFER = ("gpt2", "llama")
# the uneven-head arch's legs (the same worker; its shard shapes differ)
UNEVEN = ("mqa",)
# the archs served with int8 weights alone
W8 = ("mqa128",)


def _jax_tp(arch):
    """The JAX engine's tp_size for ``arch``: 2 where its vocab splits
    evenly (module docstring)."""
    return 2 if ARCHS[arch]["vocab_size"] % 2 == 0 else 1
S, NEW = 16, 8
SERVING = {"block_size": 8, "pool_blocks": 32, "max_batch": 4,
           "max_blocks_per_seq": 8}
PROMPTS = [[5, 17, 3, 99, 250, 7], [1, 2, 3], [200, 100, 50, 25, 12, 6, 3,
                                               1, 0, 9]]
# three steps, the first batch again last: the loss falls on it
SEEDS = [100, 101, 100]


def _base(tb, stage, tp=1, fused=False):
    cfg = {"train_batch_size": tb, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "gradient_clipping": 0.5, "steps_per_print": 100,
           "zero_optimization": {"stage": stage,
                                 "stage3_param_persistence_threshold": 64}}
    if tp > 1:
        cfg["tensor_parallel"] = {"tp_size": tp}
    return cfg


_CFGS = {}


def _cfgs(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _CFGS:
        _, jcfg = jbuild_model("gpt2-tiny", **dict(ARCHS[arch], dtype=jax.
                                                   numpy.float32, **over))
        f = {fl.name: getattr(jcfg, fl.name)
             for fl in dataclasses.fields(jcfg)}
        f["dtype"] = torch.float32
        _CFGS[key] = (jcfg, ttr.TransformerConfig(**f))
    return _CFGS[key]


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        p = jax.jit(jtr.Transformer(jcfg).init)(
            jax.random.PRNGKey(7),
            {"input_ids": np.zeros((1, 8), np.int32)})["params"]
        _PARAMS[arch] = jax.tree.map(np.asarray, jax.device_get(p))
    return _PARAMS[arch]


def _ids(B=2, T=S, seed=3):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(
        np.int32)


def _batch(tb, seed):
    return {"input_ids": _ids(tb, S, seed)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _fields(arch, **over):
    _, tcfg = _cfgs(arch, **over)
    f = {fl.name: getattr(tcfg, fl.name) for fl in dataclasses.fields(tcfg)}
    f["dtype"] = "float32"
    return f


@pytest.fixture(autouse=True)
def _no_session_mesh(monkeypatch):
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    monkeypatch.setattr(tmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


# ------------------------------------------------------ single process


@pytest.mark.parametrize("arch", sorted(INFER))
@pytest.mark.parametrize("scan", [True, False])
def test_tp_rules_and_specs_match_jax(arch, scan):
    jcfg, tcfg = _cfgs(arch, scan_layers=scan)
    jr, tr = jcfg.tp_rules(), tcfg.tp_rules()
    assert list(tr) == list(jr)
    for k in jr:
        assert tr[k] == tuple(jr[k]), k
    if not scan:
        return
    jspecs = _flat(jax.tree.map(
        lambda s: "none" if s is None else json.dumps(tuple(s)),
        jbuild_specs(_params(arch), jr),
        is_leaf=lambda x: x is None or hasattr(x, "index")))
    tparams = params_from_jax(_params(arch))
    tspecs = _flat(jax.tree.map(
        lambda s: "none" if s is None else json.dumps(tuple(s)),
        tpart.build_tp_specs(tparams, tr),
        is_leaf=lambda x: x is None or isinstance(x, tuple)))
    assert {k: str(v) for k, v in tspecs.items()} == \
        {k: str(v) for k, v in jspecs.items()}
    assert sum(v != "none" for v in tspecs.values()) >= 6


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_policy_composed_with_tp_matches_jax(world, stage):
    """Each leaf's param / master / grad spec under a model axis of 2
    (the embedding's grad exception included) equals JAX's
    ``ZeroShardingPolicy`` with the same TP spec."""
    jcfg, tcfg = _cfgs("llama")
    mm = MeshManager(devices=jax.devices()[:world], tp_size=2)
    tm = tmesh.MeshManager(devices=list(range(world)), tp_size=2)
    jp = jstages.ZeroShardingPolicy(stage, mm, param_persistence_threshold=64)
    tp = tstages.ZeroShardingPolicy(stage, tm, param_persistence_threshold=64)
    shapes = {k: v.shape for k, v in _flat(_params("llama")).items()}
    shapes["extra/vocab_bias"] = (V,)
    rules = tcfg.tp_rules()
    for path, shape in shapes.items():
        spec = tpart.spec_for(path, rules)
        jspec = None if spec is None else jax.sharding.PartitionSpec(*spec)
        for kind in ("param", "master", "grad"):
            want = tuple(jstages.canonicalize_spec(
                getattr(jp, f"{kind}_spec")(shape, jspec, False, path),
                mm.shape))
            got = getattr(tp, f"{kind}_spec")(shape, spec, False, path)
            assert got == want, (kind, path, got, want)


def test_shard_maps_cut_heads_and_pad_the_vocab():
    _, tcfg = _cfgs("llama")
    nh, kv, hd, H = 4, 2, 16, 64
    qkv = torch.arange(H * (nh + 2 * kv) * hd, dtype=torch.float32).reshape(
        H, (nh + 2 * kv) * hd)
    spec = tpart.spec_for("blocks/attn_qkv/kernel", tcfg.tp_rules())
    maps = [tpart.tp_shard("blocks/attn_qkv/kernel", qkv.shape, spec, tcfg,
                           r, 2) for r in range(2)]
    # rank 1: q heads 2-3, k head 1, v head 1
    cols = torch.cat([torch.arange(32, 64), torch.arange(64 + 16, 64 + 32),
                      torch.arange(96 + 16, 96 + 32)])
    torch.testing.assert_close(maps[1].take(qkv), qkv[:, cols], rtol=0,
                               atol=0)
    torch.testing.assert_close(
        tpart.tp_assemble([m.take(qkv) for m in maps], maps), qkv, rtol=0,
        atol=0)
    wte = torch.randn(V, H)
    spec = tpart.spec_for("wte/embedding", tcfg.tp_rules())
    maps = [tpart.tp_shard("wte/embedding", wte.shape, spec, tcfg, r, 2)
            for r in range(2)]
    assert [m.take(wte).shape[0] for m in maps] == [126, 126]
    assert float(maps[1].take(wte)[-1].abs().sum()) == 0.0   # padding
    torch.testing.assert_close(
        tpart.tp_assemble([m.take(wte) for m in maps], maps), wte, rtol=0,
        atol=0)


def test_tp_raises_name_roadmap():
    _, tcfg = _cfgs("llama")
    rules = dict(tcfg.tp_rules())
    rules.pop(next(iter(rules)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpart.check_tp_rules(rules, tcfg)
    assert tpart.check_tp_rules(None, tcfg) is None
    # uneven query heads, kv-head replication, MoE and ring attention
    # under TP are taken now: each model rank gets its head map
    for over, want in (
            (dict(num_heads=3, num_kv_heads=3, hidden_size=48),
             [(0, 2, 0, 2), (2, 3, 2, 3)]),
            (dict(num_kv_heads=1), [(0, 2, 0, 1), (2, 4, 0, 1)]),
            (dict(moe_experts=2), [(0, 2, 0, 1), (2, 4, 1, 2)]),
            (dict(attention_impl="ring"), [(0, 2, 0, 1), (2, 4, 1, 2)])):
        cfg = dataclasses.replace(tcfg, **over)
        assert tpart.check_tp_model(cfg, 2) is None
        assert [tpart.TPContext(r, 2, V).head_range(cfg)
                for r in range(2)] == want
    with pytest.raises(ValueError, match="no attention head"):
        tpart.check_tp_model(tcfg, 8)
    # a foreign table raises at initialize and init_inference too
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.init_inference(
            tcfg, {"dtype": "float32"}, device="cpu",
            model_parameters=params_from_jax(_params("llama")),
            sharding_rules=rules)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg), config=_base(8, 1), device="cpu",
            loss_fn=ttr.causal_lm_loss, sharding_rules=rules,
            dist_init_required=False)
    # tp_size > 1 needs a process group
    with pytest.raises(ValueError, match="process group"):
        deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg), config=_base(8, 1, tp=2),
            device="cpu", loss_fn=ttr.causal_lm_loss,
            dist_init_required=False)
    # a pipelined model's own table (blocks led by 'pipe') is taken for
    # it, and only for it; its 'pipe' lead is no TP split; MoE under TP
    # runs with a pipe too (tests/test_torch_pipeline_compose_dist.py's
    # moe_tp mode): every block's MoE layer gets the rank's context
    from deepspeed_tpu_torch.models.pipeline import PipelinedTransformer
    piped = PipelinedTransformer(dataclasses.replace(tcfg, num_layers=2),
                                 2, 2)
    table = piped.tp_rules()
    assert tpart.check_tp_rules(table, tcfg, table) == table
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpart.check_tp_rules(table, tcfg)
    path = "blocks/attn_proj/kernel"
    spec = tpart.spec_for(path, table)
    assert spec[0] == "pipe"
    assert tpart.tp_shard(path, (64, 64), spec, tcfg, 1, 2) == \
        tpart.tp_shard(path, (64, 64), tcfg.tp_rules()[
            r"blocks/.*attn_proj/kernel"], tcfg, 1, 2)
    moe = PipelinedTransformer(dataclasses.replace(
        tcfg, num_layers=2, moe_experts=2), 2, 2)
    ctx = tpart.TPContext(0, 2, V)
    moe.set_tp(ctx)
    assert all(blk.moe.tp is ctx for blk in moe.blocks.values())


def test_vocab_parallel_cross_entropy_at_one_rank_is_plain(monkeypatch):
    """Over one model rank (its all-reduces the identity) the
    vocab-parallel CE equals the plain one bit for bit, loss and
    gradient: the card's 1-rank world compares its first step bitwise."""
    from deepspeed_tpu_torch import comm
    monkeypatch.setattr(comm, "all_reduce", lambda t, **kw: t)
    monkeypatch.setattr(comm.comm, "all_reduce", lambda t, **kw: t)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, V, generator=g)
    labels = torch.randint(0, V, (3, 5), generator=g)
    labels[0, 0] = -100
    out = []
    for tp in (None, tpart.TPContext(0, 1, V)):
        logits = x.clone().requires_grad_(True)
        loss = ttr.cross_entropy(logits, labels, tp=tp)
        loss.backward()
        out.append((loss.detach(), logits.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


# --------------------------------------------------------------- spawns


WORKER = r"""
import dataclasses, json, os, sys, hashlib
import numpy as np
import torch
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import params_from_jax

plan = json.load(open(sys.argv[1]))
ds.comm.init_distributed(device="cpu")
rank, world = ds.comm.get_rank(), ds.comm.get_world_size()

def tree(path):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out

def tcfg(fields):
    return ttr.TransformerConfig(**dict(fields, dtype=torch.float32))

def shapes(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(shapes(v, prefix + k + "/"))
        else:
            out[prefix + k] = list(v.shape)
    return out

res = {"rank": rank, "arch": {}, "runs": {}}
ids = np.asarray(plan["ids"], np.int32)
for arch, spec in plan.get("infer", {}).items():
    cfg = tcfg(spec["model"])
    jp = tree(spec["params"])
    out = {}
    for dt in ("float32", "int8"):
        ds.comm.reset_op_counts()
        eng = ds.init_inference(cfg, {"dtype": dt, "tensor_parallel": {
            "tp_size": world}}, model_parameters=params_from_jax(jp),
            sharding_rules=cfg.tp_rules(), device="cpu")
        o = {"shapes": shapes(eng.params)}
        if dt == "float32":
            o["logits"] = eng.forward(torch.from_numpy(ids)).tolist()
            o["forward_ops"] = ds.comm.op_counts()
        o["generate"] = eng.generate(ids, max_new_tokens=plan["new"]
                                     ).tolist()
        srv = eng.serve(plan["serving"])
        digests = []
        fwd = srv._forward
        def logged(params, pools, *args, fwd=fwd):
            digests.append(hashlib.sha256(b"".join(
                np.ascontiguousarray(a).tobytes() for a in args)).hexdigest())
            return fwd(params, pools, *args)
        srv._forward = logged
        o["serve"] = srv.generate_batch(plan["prompts"], plan["new"])
        o["serve_digest"] = hashlib.sha256("".join(digests).encode()
                                           ).hexdigest()
        if dt == "float32":
            # blockwise int8 weights: every row shard here is off the
            # 256-row scale grid
            o["serve_w8"] = eng.serve(dict(plan["serving"],
                                           weight_dtype="int8")
                                      ).generate_batch(plan["prompts"],
                                                       plan["new"])
        out[dt] = o
    eng = ds.init_inference(cfg, {"dtype": "float32", "tensor_parallel": {
        "tp_size": world}}, model_parameters=params_from_jax(jp),
        sharding_rules=cfg.tp_rules(), device="cpu")
    with torch.no_grad():
        for p in [eng.params["wte"]["embedding"]]:
            p.zero_()
    eng.load_checkpoint(spec["ckpt"])
    out["loaded_generate"] = eng.generate(ids, max_new_tokens=plan["new"]
                                          ).tolist()
    res["arch"][arch] = out

res["w8"] = {}
for arch, spec in plan.get("w8", {}).items():
    cfg = tcfg(spec["model"])
    eng = ds.init_inference(cfg, {"dtype": "float32", "tensor_parallel": {
        "tp_size": world}}, model_parameters=params_from_jax(tree(
        spec["params"])), sharding_rules=cfg.tp_rules(), device="cpu")
    res["w8"][arch] = eng.serve(dict(plan["serving"], weight_dtype="int8")
                                ).generate_batch(plan["prompts"], plan["new"])

def batch_of(seed, tb, seq, masked):
    rng = np.random.default_rng(seed)
    b = {"input_ids": rng.integers(0, plan["vocab"], (tb, seq)).astype(
        np.int32)}
    if masked:
        b["labels"] = np.where(rng.random((tb, seq)) < 0.3, b["input_ids"],
                               -100).astype(np.int32)
    return b

from deepspeed_tpu_torch.ops import attention as tatt
masks = []
plain_dropout = tatt.dropout

def recording_dropout(x, rate, generator):
    out = plain_dropout(x, rate, generator)
    if x.dim() == 4:            # the attention probabilities' site
        masks.append(np.packbits(((out != 0) | (x == 0)).numpy()).tobytes()
                     .hex())
    return out

for key, run in plan.get("runs", {}).items():
    cfg = tcfg(run["model"])
    jp = tree(run["params"])
    ds.comm.reset_op_counts()
    loss = {"causal": ttr.causal_lm_loss, "masked": ttr.masked_lm_loss,
            "fused": ttr.fused_loss_passthrough}[run.get("loss", "fused"
                                                          if cfg.fused_loss
                                                          else "causal")]
    seq = run.get("seq", plan["seq"])
    tb = run["config"]["train_batch_size"]
    masked = loss is ttr.masked_lm_loss
    eng, *_ = ds.initialize(
        model=ttr.Transformer(cfg, seed=3), config=run["config"],
        model_parameters=jp, loss_fn=loss,
        sharding_rules=cfg.tp_rules(), device="cpu")
    names = {id(p): n for n, p in eng.module.named_parameters()}
    rep = [names[id(e.param)] for e in eng.dp.entries if e.tp is None]
    grads = {}
    step_grads = eng.dp.step_grads

    qkv = {}

    def keep_grads(denom, step_grads=step_grads):
        out = step_grads(denom)
        if not grads:
            for e, g in zip(eng.dp.entries, out):
                if e.tp is None:
                    grads[names[id(e.param)]] = g.tolist()
                elif run.get("qkv_grads") and "attn_qkv" in \
                        names[id(e.param)]:
                    qkv[names[id(e.param)]] = {
                        "grad": g.tolist(), "segs": e.tp.segs,
                        "shared": e.tp.shared}
        return out
    eng.dp.step_grads = keep_grads
    ev = {}
    if run.get("eval") is not None:
        b = batch_of(run["eval"], tb, seq, masked)
        ev["eval"] = eng.eval_batch(b).tolist()
        eng.eval()
        ev["eval_loss"] = float(eng.forward(b))
        eng.train()
    traj, ops = [], []
    for i, s in enumerate(run["seeds"]):
        b = batch_of(s, tb, seq, masked)
        ds.comm.reset_op_counts()
        tatt.dropout = recording_dropout if i == 0 else plain_dropout
        del masks[:]
        m = eng.train_batch(b)
        tatt.dropout = plain_dropout
        if i == 0:
            ev["masks"] = list(masks)
        ops.append(ds.comm.op_counts())
        traj.append([m["loss"], m["grad_norm"]])
    params = dict(eng.module.named_parameters())
    o = {"traj": traj, "ops": ops[0], "rep_grads": grads, "qkv": qkv,
         "rep_digest": {n: hashlib.sha256(params[n].detach().numpy()
                                          .tobytes()).hexdigest()
                        for n in rep},
         "numel": sum(e.param.numel() for e in eng.dp.entries),
         "full": sum(int(np.prod(e.full_shape)) for e in eng.dp.entries),
         **ev}
    if run.get("save"):
        ck = os.path.join(plan["dir"], key)
        eng.save_checkpoint(ck)
        sd = eng.module_state_dict()
        if rank == 0:
            np.savez(os.path.join(plan["dir"], key + "_state.npz"), **sd)
        m = eng.train_batch(batch_of(run["after"], tb, seq, masked))
        o["after"] = [m["loss"], m["grad_norm"]]
        o["files"] = sorted(os.listdir(os.path.join(
            ck, "global_step%d" % len(run["seeds"]))))
    res["runs"][key] = o
print("RESULT " + json.dumps(res), flush=True)
torch.distributed.destroy_process_group()
"""


def _run(tmp, name, world, plan):
    plan = dict(plan, dir=str(tmp), ids=_ids().tolist(), new=NEW,
                serving=SERVING, prompts=PROMPTS, vocab=V, seq=S)
    (tmp / f"{name}.json").write_text(json.dumps(plan))
    outs = _spawn(WORKER, world, tmp, name, args=[tmp / f"{name}.json"],
                  timeout=300)
    ranks = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    return ranks


def _save_params(tmp, arch):
    path = tmp / f"{arch}_params.npz"
    if not path.exists():
        np.savez(path, **_flat(_params(arch)))
    return str(path)


RUNS2 = {f"llama/{st}": dict(arch="llama", stage=st) for st in range(4)}
RUNS2["gpt2/1"] = dict(arch="gpt2", stage=1)
RUNS2["gpt2/3"] = dict(arch="gpt2", stage=3)
RUNS2["fused/2"] = dict(arch="llama", stage=2, fused=True)


EVAL_SEED = 120

# the replicated leaves, attention dropout and per-head sparse layouts
# under TP: two steps (BigBird's first), each within rtol 1e-5 of the
# 1-rank port; the first three also within 2e-4 of the JAX tp-2 engine
BIGBIRD = {"mode": "bigbird", "block": 16, "num_random_blocks": 2,
           "different_layout_per_head": True}
RUNS_A = {
    "qkn/1": dict(arch="qkn", stage=1),
    "hbias/0": dict(arch="hbias", stage=0),
    "bert/1": dict(arch="bert", stage=1, loss="masked"),
    "dropout/1": dict(arch="gpt2", stage=1, over={"dropout": 0.1}),
    "bigbird/1": dict(arch="qkn", stage=1, seq=128, steps=1,
                      extra={"sparse_attention": BIGBIRD}),
}


def _lamb(config):
    """``config`` with LAMB in place of AdamW (per-leaf trust ratios)."""
    return dict(config, optimizer={"type": "LAMB",
                                   "params": {"lr": 3e-3,
                                              "weight_decay": 0.01}})


def _fused(run):
    return dict(fused_loss=True, loss_chunk=8) if run.get("fused") else {}


# the two-rank spawn's directory (its sharded save)
_TWO_DIR = []


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_two")
    from deepspeed_tpu_torch.runtime.checkpointing import save_tree
    infer = {}
    for arch in INFER + UNEVEN:
        ck = str(tmp / f"{arch}_model_states.npz")
        save_tree(params_from_jax(_params(arch)), ck)
        infer[arch] = {"model": _fields(arch),
                       "params": _save_params(tmp, arch), "ckpt": ck}
    w8 = {arch: {"model": _fields(arch), "params": _save_params(tmp, arch)}
          for arch in W8}
    runs = {}
    for key, run in RUNS2.items():
        runs[key.replace("/", "_")] = {
            "model": _fields(run["arch"], **_fused(run)),
            "params": _save_params(tmp, run["arch"]),
            "config": _base(8, run["stage"], tp=2),
            "seeds": SEEDS, "eval": None if run.get("fused") else EVAL_SEED}
    runs["mqa_lamb"] = {"model": _fields("mqa"),
                        "params": _save_params(tmp, "mqa"),
                        "config": _lamb(_base(8, 1, tp=2)), "seeds": SEEDS,
                        "eval": None}
    runs["mqa_1"] = {"model": _fields("mqa"),
                     "params": _save_params(tmp, "mqa"),
                     "config": _base(8, 1, tp=2), "seeds": SEEDS,
                     "eval": None, "qkv_grads": True, "save": True,
                     "after": 113}
    for key, run in RUNS_A.items():
        config = _base(8, run["stage"], tp=2)
        config.update(run.get("extra", {}))
        runs[key.replace("/", "_")] = {
            "model": _fields(run["arch"], **run.get("over", {})),
            "params": _save_params(tmp, run["arch"]), "config": config,
            "loss": run.get("loss", "causal"), "seq": run.get("seq", S),
            "seeds": SEEDS[:run.get("steps", 2)], "eval": None}
    _TWO_DIR.append(tmp)
    return _run(tmp, "tp_two", 2, {"infer": infer, "w8": w8, "runs": runs})


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_four")
    runs = {"llama_3": {"model": _fields("llama"),
                        "params": _save_params(tmp, "llama"),
                        "config": _base(8, 3, tp=2),
                        "seeds": [110, 111, 112], "save": True,
                        "after": 113}}
    return {"dir": tmp, "ranks": _run(tmp, "tp_four", 4, {"runs": runs})}


_JAX = {}


def _jax_infer(arch, dtype):
    key = (arch, dtype)
    if key not in _JAX:
        jcfg, _ = _cfgs(arch)
        eng = JInferenceEngine(
            model=jtr.Transformer(jcfg), model_parameters=_params(arch),
            config={"dtype": dtype,
                    "tensor_parallel": {"tp_size": _jax_tp(arch)}},
            sharding_rules=jcfg.tp_rules())
        logits = (np.asarray(eng.forward({"input_ids": jnp.asarray(_ids())}))
                  if dtype == "float32" else None)
        gen = np.asarray(eng.generate(jnp.asarray(_ids()),
                                      max_new_tokens=NEW))
        prompts = [np.asarray(eng.generate(jnp.asarray([p]),
                                           max_new_tokens=NEW))[0, len(p):]
                   for p in PROMPTS]
        _JAX[key] = (logits, gen, prompts)
    return _JAX[key]


@pytest.mark.parametrize("arch", sorted(INFER))
def test_each_rank_holds_its_shards(two, arch):
    for r in two:
        shp = r["arch"][arch]["float32"]["shapes"]
        assert shp["blocks/attn_qkv/kernel"] == [2, 64, (4 + 2 * (
            2 if arch == "llama" else 4)) * 16 // 2]
        assert shp["blocks/attn_proj/kernel"] == [2, 32, 64]
        vc = 126 if arch == "llama" else 128
        assert shp["wte/embedding"] == [vc, 64]
        if arch == "llama":
            assert shp["lm_head/kernel"] == [64, vc]
            assert shp["blocks/mlp_gate/kernel"] == [2, 64, 64]
            assert shp["blocks/mlp_proj/kernel"] == [2, 64, 64]
        else:
            assert shp["blocks/attn_qkv/bias"] == [2, 96]
            assert shp["blocks/attn_proj/bias"] == [2, 64]
            assert shp["blocks/mlp_fc/kernel"] == [2, 64, 128]
        q8 = r["arch"][arch]["int8"]["shapes"]
        assert q8["blocks/attn_proj/kernel_scale"] == [2, 1, 64]
        assert q8["blocks/attn_qkv/kernel_scale"][-1] == \
            shp["blocks/attn_qkv/kernel"][-1]


@pytest.mark.parametrize("arch", sorted(INFER + UNEVEN))
def test_forward_logits_match_jax_tp_engine(two, arch):
    logits, *_ = _jax_infer(arch, "float32")
    for r in two:
        got = np.array(r["arch"][arch]["float32"]["logits"])
        np.testing.assert_allclose(got, logits, rtol=1e-5, atol=1e-5)
        ops = r["arch"][arch]["float32"]["forward_ops"]
        # two row-parallel reduces a layer, the embedding's, the gather
        assert ops["tp_reduce_from"] == 2 * 2 + 1
        assert ops["tp_gather_from"] == 1


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", sorted(INFER + UNEVEN))
def test_generate_and_serve_tokens_match_jax_tp_engine(two, arch, dtype):
    _, gen, prompts = _jax_infer(arch, dtype)
    outs = [r["arch"][arch][dtype] for r in two]
    for o in outs:
        np.testing.assert_array_equal(np.array(o["generate"]), gen)
        for got, want in zip(o["serve"], prompts):
            assert got == want.tolist()
    # every rank ran the same scheduler: the same inputs, block tables
    # and positions into every forward
    assert outs[0]["serve_digest"] == outs[1]["serve_digest"]


@pytest.mark.parametrize("arch", sorted(INFER + UNEVEN))
def test_topology_free_npz_loads_at_tp2_with_tp1_tokens(two, arch):
    _, tcfg = _cfgs(arch)
    one = deepspeed_tpu_torch.init_inference(
        tcfg, {"dtype": "float32"},
        model_parameters=params_from_jax(_params(arch)), device="cpu")
    want = one.generate(_ids(), max_new_tokens=NEW).numpy()
    for r in two:
        np.testing.assert_array_equal(
            np.array(r["arch"][arch]["loaded_generate"]), want)


_REF = {}


def _port_engine(arch, stage, tb, seeds, **over):
    """The 1-rank port engine after ``seeds``' steps, and its
    trajectory."""
    key = (arch, stage, tb, tuple(seeds), tuple(sorted(over.items())))
    if key not in _REF:
        _, tcfg = _cfgs(arch, **over)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg, seed=3), config=_base(tb, stage),
            model_parameters=_params(arch), device="cpu",
            loss_fn=(ttr.fused_loss_passthrough if tcfg.fused_loss
                     else ttr.causal_lm_loss), dist_init_required=False)
        _REF[key] = eng, np.array([[m["loss"], m["grad_norm"]] for m in (
            eng.train_batch(_batch(tb, s)) for s in seeds)])
    return _REF[key]


def _port_traj(arch, stage, tb, seeds, **over):
    return _port_engine(arch, stage, tb, seeds, **over)[1]


def _jax_traj(arch, stage, tb, seeds, **over):
    jcfg, _ = _cfgs(arch, **over)
    tp = _jax_tp(arch)
    mm = MeshManager(devices=jax.devices()[:tp], tp_size=tp)
    eng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=_base(tb, stage, tp=tp),
        model_parameters=_params(arch), mesh_manager=mm,
        loss_fn=(jtr.fused_loss_passthrough if jcfg.fused_loss
                 else jtr.causal_lm_loss), sharding_rules=jcfg.tp_rules())
    return eng, np.array([[float(m["loss"]), float(m["grad_norm"])]
                          for m in (jax.device_get(eng.train_batch(
                              _batch(tb, s))) for s in seeds)])


@pytest.mark.parametrize("key", sorted(RUNS2))
def test_train_batch_at_tp2_matches_one_rank_port_and_jax(two, key):
    run = RUNS2[key]
    seeds = SEEDS
    over = _fused(run)
    ref = _port_traj(run["arch"], run["stage"], 8, seeds, **over)
    for r in two:
        got = np.array(r["runs"][key.replace("/", "_")]["traj"])
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    if run["stage"] in (1, 3) or over:
        _, jref = _jax_traj(run["arch"], min(run["stage"], 3), 8, seeds,
                            **over)
        np.testing.assert_allclose(
            np.array(two[0]["runs"][key.replace("/", "_")]["traj"]), jref,
            rtol=2e-4)
    assert ref[-1, 0] < ref[0, 0]
    run0 = two[0]["runs"][key.replace("/", "_")]
    # the TP leaves are half on each rank (the vocab's padded row aside)
    assert run0["numel"] < run0["full"]
    if not over:
        # a forward: 2 model-axis all-reduces a layer + the embedding's
        # and the CE's target logit, each micro-batch (gas 2)
        assert run0["ops"]["tp_reduce_from"] == 2 * (2 * 2 + 2)
    else:
        # the fused CE's 2 chunks of 8 of the 15 shifted positions each
        # reduce their target logit in the forward and its recomputation
        assert run0["ops"]["tp_reduce_from"] == 2 * (2 * 2 + 1 + 2 * 2)
    # the backward sums the column-parallel inputs' gradients: qkv's and
    # the MLP's a layer, and the head's
    assert run0["ops"]["tp_copy_to"] == 2 * (2 * 2 + 1)


@pytest.mark.parametrize("key", sorted(k for k in RUNS2
                                        if not RUNS2[k].get("fused")))
def test_eval_batch_at_tp2_returns_whole_logits(two, key):
    """Before the first step, ``eval_batch`` at tp 2 returns the model's
    whole [B, S, V] logits on every rank, and eval-mode ``forward`` the
    loss, as the 1-rank port does: the vocab-parallel logits reach only
    the engine's loss."""
    run = RUNS2[key]
    eng, _ = _port_engine(run["arch"], run["stage"], 8, [])
    b = _batch(8, EVAL_SEED)
    want = eng.eval_batch(b).numpy()
    eng.eval()
    want_loss = float(eng.forward(b))
    eng.train()
    assert want.shape == (8, S, ARCHS[run["arch"]]["vocab_size"])
    for r in two:
        o = r["runs"][key.replace("/", "_")]
        np.testing.assert_allclose(np.array(o["eval"]), want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(o["eval_loss"], want_loss, rtol=1e-5)


def test_tp2_by_data2_zero3_matches_one_rank_port(four):
    ref = _port_traj("llama", 3, 8, [110, 111, 112])
    for r in four["ranks"]:
        run = r["runs"]["llama_3"]
        np.testing.assert_allclose(np.array(run["traj"]), ref, rtol=1e-5)
        # stage 3 over data 2 within each model rank's shard
        assert run["numel"] * 3 < run["full"]


def test_tp2_by_data2_sharded_save_loads_into_one_rank_port_and_jax(four):
    tmp = four["dir"]
    r0 = four["ranks"][0]["runs"]["llama_3"]
    assert r0["files"] == sorted(
        ["ckpt_meta.json", "meta.json"]
        + [f"{k}-shard{i}.npz" for k in ("model_states", "optim_states")
           for i in range(4)])
    with np.load(tmp / "llama_3_state.npz") as z:
        saved = {k: z[k] for k in z.files}
    assert saved["blocks/attn_qkv/kernel"].shape == (2, 64, 128)
    assert saved["wte/embedding"].shape == (V, 64)
    _, tcfg = _cfgs("llama")
    port, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg, seed=5), config=_base(8, 3),
        loss_fn=ttr.causal_lm_loss, device="cpu", dist_init_required=False)
    port.load_checkpoint(str(tmp / "llama_3"))
    for k, v in port.module_state_dict().items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    m = port.train_batch(_batch(8, 113))
    np.testing.assert_allclose([m["loss"], m["grad_norm"]], r0["after"],
                               rtol=1e-5)
    jeng, _ = _jax_traj("llama", 3, 8, [])
    jeng.load_checkpoint(str(tmp / "llama_3"))
    for k, v in jeng.module_state_dict().items():
        np.testing.assert_array_equal(np.asarray(v, np.float32), saved[k],
                                      err_msg=k)
    jm = jax.device_get(jeng.train_batch(_batch(8, 113)))
    np.testing.assert_allclose([float(jm["loss"]), float(jm["grad_norm"])],
                               r0["after"], rtol=2e-4)


def test_tp2_by_data2_tag_assembles_in_zero_to_fp32_and_inspector(four):
    """``zero_to_fp32`` and the universal inspector read the sharded tag
    (TP pieces, then ZeRO slabs, at their global offsets) as whole
    leaves."""
    from deepspeed_tpu_torch.checkpoint.universal import DeepSpeedCheckpoint
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        convert_zero_checkpoint_to_fp32_state_dict
    tmp = four["dir"]
    with np.load(tmp / "llama_3_state.npz") as z:
        saved = {k: z[k] for k in z.files}
    sd = convert_zero_checkpoint_to_fp32_state_dict(
        str(tmp / "llama_3"), str(tmp / "fp32.npz"))
    assert sorted(sd) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    ck = DeepSpeedCheckpoint(str(tmp / "llama_3"))
    assert ck.global_step == 3
    assert ck.shapes()["blocks/attn_qkv/kernel"] == (2, 64, 128)
    assert ck.shapes()["lm_head/kernel"] == (64, V)
    np.testing.assert_array_equal(
        ck.get_parameter("blocks/attn_qkv/kernel").numpy(),
        saved["blocks/attn_qkv/kernel"])
    assert ck.num_parameters() == sum(v.size for v in saved.values())
    assert any(k.startswith("opt_state/") for k in ck.optimizer_keys())


# ------------------------------------------- replicated leaves under TP


def _mlm_or_causal(run):
    return ttr.masked_lm_loss if run.get("loss") == "masked" \
        else ttr.causal_lm_loss


def _batch_a(run, seed, jax_side=False):
    rng = np.random.default_rng(seed)
    seq = run.get("seq", S)
    b = {"input_ids": rng.integers(0, V, (8, seq)).astype(np.int32)}
    if run.get("loss") == "masked":
        b["labels"] = np.where(rng.random((8, seq)) < 0.3, b["input_ids"],
                               -100).astype(np.int32)
    return b


_REF_A = {}


def _ref_a(key):
    """The 1-rank port's trajectory of ``RUNS_A[key]``, its step-1
    gradients by parameter name and its step-1 attention-dropout masks."""
    if key in _REF_A:
        return _REF_A[key]
    from deepspeed_tpu_torch.ops import attention as tatt
    run = RUNS_A[key]
    _, tcfg = _cfgs(run["arch"], **run.get("over", {}))
    config = _base(8, run["stage"])
    config.update(run.get("extra", {}))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg, seed=3), config=config,
        model_parameters=_params(run["arch"]), device="cpu",
        loss_fn=_mlm_or_causal(run), dist_init_required=False)
    names = {id(p): n for n, p in eng.module.named_parameters()}
    grads, masks = {}, []
    finalize, plain = eng._finalize_step, tatt.dropout

    def keep(n_micro, losses):
        if not grads:
            denom = float(n_micro) * eng.scale_state.scale
            for p, a in zip(eng._params, eng._accum):
                grads[names[id(p)]] = (a.float() / denom).numpy()
        return finalize(n_micro, losses)

    def recording(x, rate, generator):
        out = plain(x, rate, generator)
        if x.dim() == 4:
            masks.append(((out != 0) | (x == 0)).numpy())
        return out
    eng._finalize_step = keep
    traj = []
    try:
        for i, seed in enumerate(SEEDS[:run.get("steps", 2)]):
            tatt.dropout = recording if i == 0 else plain
            m = eng.train_batch(_batch_a(run, seed))
            traj.append([m["loss"], m["grad_norm"]])
    finally:
        tatt.dropout = plain
    _REF_A[key] = np.array(traj), grads, masks
    return _REF_A[key]


@pytest.mark.parametrize("key", sorted(RUNS_A))
def test_replicated_leaves_at_tp2_match_one_rank_port(two, key):
    """Queue 3's TP faults, closed: the qk-norm scales, an untied head's
    bias and BERT's MLM bias have their gradients summed over the model
    axis; each rank's attention-dropout mask is its heads' slice of the
    1-rank mask; per-head BigBird layouts are the model's heads'. The
    trajectory (one step for BigBird) within rtol 1e-5 of the 1-rank
    port, every replicated leaf's step-1 gradient within 1e-6 of its,
    and every replicated leaf bitwise equal on both ranks after the
    two steps."""
    ref, grads, masks = _ref_a(key)
    runs = [r["runs"][key.replace("/", "_")] for r in two]
    for run in runs:
        np.testing.assert_allclose(np.array(run["traj"]), ref, rtol=1e-5)
        assert run["rep_grads"]
        for name, g in run["rep_grads"].items():
            np.testing.assert_allclose(np.array(g), grads[name], rtol=0,
                                       atol=1e-6, err_msg=name)
    assert runs[0]["rep_digest"] == runs[1]["rep_digest"]
    tied = {"qkn/1": "q_norm", "hbias/0": "lm_head.bias",
            "bert/1": "mlm_bias"}.get(key)
    if tied:
        assert any(tied in n for n in runs[0]["rep_grads"])
    if key == "dropout/1":
        # 2 micro-batches x 2 layers of [4, 4, 16, 16] masks, each rank
        # holding its 2 heads' slice of the 1-rank port's
        assert len(masks) == 4
        for r, run in enumerate(runs):
            assert len(run["masks"]) == 4
            for got, want in zip(run["masks"], masks):
                mine = np.packbits(want[:, 2 * r:2 * r + 2]).tobytes().hex()
                assert got == mine
        assert masks[0][:, 0].tobytes() != masks[0][:, 2].tobytes()


@pytest.mark.parametrize("key", ["qkn/1", "hbias/0", "bert/1"])
def test_replicated_leaves_at_tp2_match_jax_tp_engine(two, key):
    run = RUNS_A[key]
    jcfg, _ = _cfgs(run["arch"])
    mm = MeshManager(devices=jax.devices()[:2], tp_size=2)
    loss = jtr.masked_lm_loss if run.get("loss") == "masked" \
        else jtr.causal_lm_loss
    eng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=_base(8, run["stage"], tp=2),
        model_parameters=_params(run["arch"]), mesh_manager=mm,
        loss_fn=loss, sharding_rules=jcfg.tp_rules())
    jref = np.array([[float(m["loss"]), float(m["grad_norm"])]
                     for m in (jax.device_get(eng.train_batch(
                         _batch_a(run, s))) for s in SEEDS[:2])])
    np.testing.assert_allclose(
        np.array(two[0]["runs"][key.replace("/", "_")]["traj"]), jref,
        rtol=2e-4)


# ---------------------------- uneven heads, kv-head replication, int8 rows


def test_uneven_heads_shard_by_the_head_map(two):
    """mqa at tp 2: rank 0 holds q heads 0-1 and kv head 0, rank 1 q head
    2 and kv head 0 again; the ``attn_proj`` rows follow the q heads."""
    for r, rank in enumerate(two):
        shp = rank["arch"]["mqa"]["float32"]["shapes"]
        nq = (2, 1)[r]
        assert shp["blocks/attn_qkv/kernel"] == [2, 48, (nq + 2) * 16]
        assert shp["blocks/attn_qkv/bias"] == [2, (nq + 2) * 16]
        assert shp["blocks/attn_proj/kernel"] == [2, nq * 16, 48]
        assert shp["blocks/mlp_proj/kernel"] == [2, 48, 48]
    _, tcfg = _cfgs("mqa")
    spec = tpart.spec_for("blocks/attn_qkv/kernel", tcfg.tp_rules())
    maps = [tpart.tp_shard("blocks/attn_qkv/kernel", (2, 48, 80), spec,
                           tcfg, r, 2) for r in range(2)]
    # rank 1's kv columns are rank 0's too: written and counted by rank 0
    assert maps[0].shared == () and maps[1].shared == (False, True, True)
    assert maps[1].owned_segs() == ((0, 32, 16),)
    assert tpart.kv_shared(tcfg, 2) and not tpart.kv_shared(
        _cfgs("llama")[1], 2)


@pytest.mark.parametrize("arch", sorted(INFER + UNEVEN + W8))
def test_int8_serve_off_the_scale_grid_matches_one_rank(two, arch):
    """Blockwise-int8 serving at tp 2: each rank's ``attn_proj`` and
    ``mlp_proj`` row shard starts or ends mid-block of the 256-row grid,
    packs at the finer block gcd(offset, rows, 256) with its whole
    blocks' MAX-reduced scales, and serves the 1-rank int8 engine's
    greedy tokens exactly (the sums differ only in f32 order). mqa128:
    rank 0's ``attn_proj`` shard is on the grid and rank 1's is not; the
    two ranks still make the same all-reduces."""
    _, tcfg = _cfgs(arch)
    one = deepspeed_tpu_torch.init_inference(
        tcfg, {"dtype": "float32"},
        model_parameters=params_from_jax(_params(arch)), device="cpu")
    want = one.serve(dict(SERVING, weight_dtype="int8")).generate_batch(
        PROMPTS, NEW)
    for r in two:
        got = r["w8"][arch] if arch in W8 else \
            r["arch"][arch]["float32"]["serve_w8"]
        assert got == want


def test_uneven_heads_train_matches_one_rank_port_and_jax(two):
    """mqa's three steps at tp 2 (ZeRO 1) within rtol 1e-5 of the 1-rank
    port and 2e-4 of the JAX tp-2 engine: the grad norm counts the shared
    kv columns once."""
    ref = _port_traj("mqa", 1, 8, SEEDS)
    for r in two:
        np.testing.assert_allclose(np.array(r["runs"]["mqa_1"]["traj"]),
                                   ref, rtol=1e-5)
    _, jref = _jax_traj("mqa", 1, 8, SEEDS)
    np.testing.assert_allclose(np.array(two[0]["runs"]["mqa_1"]["traj"]),
                               jref, rtol=2e-4)
    assert ref[-1, 0] < ref[0, 0]


def test_uneven_heads_kv_column_grads_match_jax(two):
    """The first step's ``attn_qkv`` kernel and bias gradients: the kv
    columns that both ranks hold are equal on both (summed over the two
    holders), and the assembled whole equals JAX's ``jax.grad`` of the
    same batch's loss within atol 1e-6 (rtol 1e-4)."""
    jcfg, _ = _cfgs("mqa")
    b = _batch(8, SEEDS[0])
    model = jtr.Transformer(jcfg)

    def loss(p):
        return jtr.causal_lm_loss(model.apply({"params": p}, b), b)

    g = jax.grad(loss)(_params("mqa"))["blocks"]["attn_qkv"]
    for leaf in ("kernel", "bias"):
        want = np.asarray(g[leaf])                    # [L, ..., 80]
        for li in range(2):
            name = f"blocks.{li}.attn_qkv.{leaf}"
            whole = np.full(want.shape[1:], np.nan, np.float32)
            for rank in two:
                ent = rank["runs"]["mqa_1"]["qkv"][name]
                got = np.array(ent["grad"], np.float32)
                shared = ent["shared"] or [False] * len(ent["segs"])
                for (ls, ws, n), sh in zip(ent["segs"], shared):
                    piece = got[..., ls:ls + n]
                    if sh:   # the same columns as the lower holder's
                        np.testing.assert_allclose(
                            piece, whole[..., ws:ws + n], rtol=1e-6,
                            atol=1e-7)
                    whole[..., ws:ws + n] = piece
            np.testing.assert_allclose(whole, want[li], rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def test_uneven_heads_sharded_save_loads_everywhere(two):
    """mqa's tp-2 tag (the shared kv columns written once, by rank 0)
    loads into a 1-rank port engine and the JAX engine bitwise, their
    next steps agree, and ``zero_to_fp32`` assembles it."""
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        convert_zero_checkpoint_to_fp32_state_dict
    tmp = _TWO_DIR[0]
    r0 = two[0]["runs"]["mqa_1"]
    with np.load(tmp / "mqa_1_state.npz") as z:
        saved = {k: z[k] for k in z.files}
    assert saved["blocks/attn_qkv/kernel"].shape == (2, 48, 80)
    _, tcfg = _cfgs("mqa")
    port, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg, seed=5), config=_base(8, 1),
        loss_fn=ttr.causal_lm_loss, device="cpu", dist_init_required=False)
    port.load_checkpoint(str(tmp / "mqa_1"))
    for k, v in port.module_state_dict().items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    m = port.train_batch(_batch(8, 113))
    np.testing.assert_allclose([m["loss"], m["grad_norm"]], r0["after"],
                               rtol=1e-5)
    jeng, _ = _jax_traj("mqa", 1, 8, [])
    jeng.load_checkpoint(str(tmp / "mqa_1"))
    for k, v in jeng.module_state_dict().items():
        np.testing.assert_array_equal(np.asarray(v, np.float32), saved[k],
                                      err_msg=k)
    jm = jax.device_get(jeng.train_batch(_batch(8, 113)))
    np.testing.assert_allclose([float(jm["loss"]), float(jm["grad_norm"])],
                               r0["after"], rtol=2e-4)
    sd = convert_zero_checkpoint_to_fp32_state_dict(
        str(tmp / "mqa_1"), str(tmp / "mqa_fp32.npz"))
    for k, v in saved.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)


def test_uneven_heads_lamb_matches_one_rank_port(two):
    """LAMB's trust ratios and the grad norm at tp 2 over mqa's shared KV
    head: each whole leaf's norm counts the shared columns once, so three
    steps stay within rtol 1e-5 of the 1-rank port."""
    _, tcfg = _cfgs("mqa")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg, seed=3), config=_lamb(_base(8, 1)),
        model_parameters=_params("mqa"), device="cpu",
        loss_fn=ttr.causal_lm_loss, dist_init_required=False)
    ref = np.array([[m["loss"], m["grad_norm"]] for m in (
        eng.train_batch(_batch(8, s)) for s in SEEDS)])
    for r in two:
        np.testing.assert_allclose(np.array(r["runs"]["mqa_lamb"]["traj"]),
                                   ref, rtol=1e-5)
    assert ref[-1, 0] < ref[0, 0]
