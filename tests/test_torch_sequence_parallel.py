"""Sequence parallelism across real gloo ranks on the CPU: the port's ring
and Ulysses attention, its point-to-point ops and its sequence-parallel
``train_batch``, against the JAX package on its 8-device virtual mesh and
against the 1-rank port.

One spawn of two ranks (a ``seq`` group of 2; ``test_torch_comm._spawn``:
a ``file://`` rendezvous, killed and failed past its own clock) runs:

* ``ring_attention`` and ``ulysses_attention`` on each rank's chunk of
  numpy-seeded f32 q, k, v [2, 4, 32, 16], causal and not: the gathered
  outputs and the q, k, v grads of sum(o * w) against the JAX functions
  on ``MeshManager(sp_size=4)`` (8 virtual devices) and against JAX
  ``mha_reference``, rtol 5e-5 (atol 5e-5: sums in another order);
* ``ppermute`` (an unlisted rank receives zeros), ``ppermute_async``,
  ``send_recv_next`` / ``send_recv_prev``, ``axis_rank`` / ``axis_size``
  along ``seq``, and the identity along the 1-rank ``data`` axis; before
  the mesh is set, ``seq`` of size 1 (a ring model on a data-parallel
  world computes its whole sequence, at its own positions);
* the Ulysses ``ValueError`` for heads that sp does not divide, the
  ROADMAP Queue 3 raise of a ring call with a mask or ALiBi at sp 2 and
  of dynamic rope scaling, and the engine's refusal of a loss that is
  not one of the in-tree losses;
* ``train_batch`` with ``sequence_parallel.sp_size 2`` on gpt2-tiny
  (learned positions, tied head) and a llama shape (RoPE, GQA 4q/2kv,
  untied head), 2 layers, f32, at ZeRO 1 and 3, six steps: losses against
  the 1-rank port on the same samples (rtol 1e-5) and against the JAX
  engine with ``sp_size 2`` on 8 devices (rtol 2e-4).

A second spawn runs four ranks (data 2 x seq 2) through one llama
trajectory against the 1-rank port (rtol 1e-5).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.ops.attention import mha_reference as jmha
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel.mesh import MeshManager
from deepspeed_tpu.parallel.ring_attention import (ring_attention as jring,
                                                  ulysses_attention as july)

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.ops.attention import mha_reference
from deepspeed_tpu_torch.parallel import ring_attention as tra

from test_torch_comm import _spawn
from test_torch_training import _batch, _cfgs, _params

SHAPE = (2, 4, 32, 16)
STEPS, TB, S = 6, 8, 16
ARCHS = ("gpt2", "llama")
STAGES = (1, 3)


@pytest.fixture(autouse=True)
def _precise():
    with jax.default_matmul_precision("highest"):
        yield


def _qkvw(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _config(stage, sp=2):
    cfg = {"train_batch_size": TB, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3}},
           "gradient_clipping": 1.0, "zero_optimization": {"stage": stage}}
    if sp > 1:
        cfg["sequence_parallel"] = {"sp_size": sp}
    return cfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _fields(arch):
    _, tcfg = _cfgs(arch)
    import dataclasses
    f = {fl.name: getattr(tcfg, fl.name) for fl in dataclasses.fields(tcfg)}
    f["dtype"] = "float32"
    return f


WORKER = r"""
import json, sys
import numpy as np
import torch
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.ops.attention import attention
from deepspeed_tpu_torch.parallel import ring_attention as tra
from deepspeed_tpu_torch.parallel.mesh import MeshManager, set_global_mesh

plan = json.load(open(sys.argv[1]))
comm.init_distributed(device="cpu")
rank, world = comm.get_rank(), comm.get_world_size()
res = {"rank": rank}

def load(path):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree

def batch(seed):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 64, (plan["tb"], plan["seq"]))
            .astype(np.int32)}

if plan["attention"]:
    # no mesh yet: the world is data parallel, "seq" is size 1, and a ring
    # model computes each rank's whole sequence on its own
    kw = dict(hidden_size=32, num_layers=1, num_heads=4, vocab_size=64,
              dtype=torch.float32)
    m_ring, _ = ttr.build_model("gpt2-tiny", attention_impl="ring", **kw)
    m_ref, _ = ttr.build_model("gpt2-tiny", **kw)
    ids = torch.randint(0, 64, (2, 8), generator=torch.Generator()
                        .manual_seed(rank))
    with torch.no_grad():
        same = bool(torch.equal(m_ring(ids), m_ref(ids)))
    res["no_mesh"] = [comm.axis_size("seq"), comm.axis_rank("seq"),
                      tra.chunk_positions(2, 8, "cpu") is None, same,
                      tra.ring_attention.rotations]
    tra.ring_attention.chunk_steps = 0
    set_global_mesh(MeshManager(sp_size=world))
    sp, r = comm.axis_size("seq"), comm.axis_rank("seq")
    res["axes"] = [sp, r, comm.axis_size("data"), comm.axis_rank("data")]
    with np.load(plan["qkvw"]) as z:
        q, k, v, w = (torch.from_numpy(z[n]) for n in "qkvw")
    Sl = q.shape[2] // sp
    cut = lambda t: t[:, :, r * Sl:(r + 1) * Sl].contiguous()
    for impl, fn in (("ring", tra.ring_attention),
                     ("ulysses", tra.ulysses_attention)):
        for causal in (True, False):
            qq, kk, vv = (cut(t).requires_grad_() for t in (q, k, v))
            o = fn(qq, kk, vv, causal=causal)
            (o * cut(w)).sum().backward()
            res[f"{impl}/{causal}"] = [t.tolist() for t in
                                       (o, qq.grad, kk.grad, vv.grad)]
    # the router reaches the same functions
    res["routed"] = attention(
        cut(q), cut(k), cut(v), impl="ring").tolist()
    x = torch.full((3,), float(rank + 1))
    res["p2p"] = {
        "listed": comm.ppermute(x, [(0, 1)], axis="seq").tolist(),
        "swap": comm.ppermute(x, [(0, 1), (1, 0)], axis="seq").tolist(),
        "async": comm.ppermute_async(x, [(1, 0)], axis="seq").wait()
        .tolist(),
        "next": comm.send_recv_next(x, axis="seq").tolist(),
        "prev": comm.send_recv_prev(x, axis="seq").tolist(),
        "data": comm.ppermute(x, [(0, 0)], axis="data").tolist()}
    raised = {}
    try:
        tra.ulysses_attention(cut(q)[:, :3], cut(k)[:, :3], cut(v)[:, :3])
    except ValueError as e:
        raised["ulysses_heads"] = str(e)
    mask = torch.ones(1, 1, Sl, Sl, dtype=torch.bool)
    for name, kw in (("mask", {"mask": mask}),
                     ("alibi", {"alibi_slopes": torch.ones(4)})):
        try:
            attention(cut(q), cut(k), cut(v), impl="ring", **kw)
        except NotImplementedError as e:
            raised[name] = str(e)
    # the engine refuses what a rank's chunk cannot compute
    for name, kw, lf in (
            ("dynamic_rope", {"rope_scaling_type": "dynamic",
                              "rope_scaling_factor": 2.0},
             ttr.causal_lm_loss),
            ("custom_loss", {}, lambda out, b: out.mean())):
        m, _ = ttr.build_model("gpt2-tiny", hidden_size=32, num_layers=1,
                               num_heads=4, vocab_size=64,
                               pos_embed="rotary", dtype=torch.float32, **kw)
        try:
            ds.initialize(model=m, loss_fn=lf, device="cpu", config={
                "train_batch_size": 2, "optimizer": {"type": "SGD"},
                "sequence_parallel": {"sp_size": world}})
        except (NotImplementedError, ValueError) as e:
            raised[name] = str(e)
    res["raised"] = raised
    res["counts"] = {"rotations": tra.ring_attention.rotations,
                     "returns": tra.ring_attention.returns,
                     "chunk_steps": tra.ring_attention.chunk_steps}

res["train"] = {}
for key, item in plan["train"].items():
    fields = dict(item["cfg"], dtype=torch.float32)
    tcfg = ttr.TransformerConfig(**fields)
    eng, *_ = ds.initialize(model=ttr.Transformer(tcfg), config=item["ds"],
                            model_parameters=load(item["params"]),
                            loss_fn=ttr.causal_lm_loss, device="cpu")
    traj = []
    for s in range(plan["steps"]):
        m = eng.train_batch(batch(100 + s % 3))
        traj.append([m["loss"], m["grad_norm"]])
    res["train"][key] = {"traj": traj, "impl": eng.module.cfg.attention_impl,
                         "seq": [eng.seq_world, eng.seq_rank],
                         "batch": [eng.batch_world, eng.batch_rank]}
res["ops"] = comm.op_counts()
print("RESULT " + json.dumps(res), flush=True)
torch.distributed.destroy_process_group()
"""


def _jax_engine(arch, stage, sp):
    """The JAX engine on 8 devices at ``sp``; its ring reads the global
    mesh, set to the engine's (the caller restores the old one)."""
    jcfg, _ = _cfgs(arch)
    mm = MeshManager(devices=jax.devices()[:8], sp_size=sp)
    jmesh.set_global_mesh(mm)
    eng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=_config(stage, sp),
        model_parameters=_params(arch), loss_fn=jtr.causal_lm_loss,
        mesh_manager=mm)
    return eng


def _port_engine(arch, stage):
    _, tcfg = _cfgs(arch)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config=_config(stage, 1),
        model_parameters=_params(arch), loss_fn=ttr.causal_lm_loss,
        device="cpu")
    return eng


def _traj(eng):
    out = []
    for s in range(STEPS):
        m = jax.device_get(eng.train_batch(_batch(TB, S, seed=100 + s % 3)))
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return np.array(out)


def _run(tmp, world, train, attention):
    plan = {"tb": TB, "seq": S, "steps": STEPS, "attention": attention,
            "qkvw": str(tmp / "qkvw.npz"), "train": train}
    np.savez(tmp / "qkvw.npz", **dict(zip("qkvw", _qkvw(0))))
    for arch in {item["arch"] for item in train.values()}:
        np.savez(tmp / f"{arch}.npz", **_flat(_params(arch)))
    (tmp / "plan.json").write_text(json.dumps(plan))
    outs = _spawn(WORKER, world, tmp, f"sp_worker{world}",
                  args=[tmp / "plan.json"])
    ranks = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    return ranks


def _train_plan(tmp, archs, stages):
    return {f"{a}/{s}": {"arch": a, "cfg": _fields(a), "ds": _config(s),
                         "params": str(tmp / f"{a}.npz")}
            for a in archs for s in stages}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_parallel")
    for a in ARCHS:
        _params(a)
    return _run(tmp, 2, _train_plan(tmp, ARCHS, STAGES), attention=True)


def _gathered(ranks, key):
    """Each of (o, dq, dk, dv) concatenated over the ranks' chunks."""
    parts = [np.array(r[key][i], np.float32) for r in ranks
             for i in range(4)]
    return [np.concatenate(parts[i::4], axis=2) for i in range(4)]


_JAX = {}


def _jax_attention(impl, causal):
    """JAX ring / Ulysses at sp 4 on 8 devices, and mha_reference: (o,
    dq, dk, dv) of sum(o * w)."""
    if (impl, causal) not in _JAX:
        q, k, v, w = (jnp.asarray(x) for x in _qkvw(0))
        old, jmesh._GLOBAL_MESH = jmesh._GLOBAL_MESH, None
        try:
            mm = MeshManager(devices=jax.devices()[:8], sp_size=4)
            sh = NamedSharding(mm.mesh, P(None, None, "seq"))
            fn = {"ring": jring, "ulysses": july}[impl]
            f = lambda q, k, v: fn(q, k, v, mesh=mm.mesh, causal=causal)
            args = tuple(jax.device_put(t, sh) for t in (q, k, v))
            o = jax.jit(f)(*args)
            g = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w),
                                 argnums=(0, 1, 2)))(*args)
        finally:
            jmesh._GLOBAL_MESH = old
        ref = lambda q, k, v: jmha(q, k, v, causal=causal)
        g_ref = jax.grad(lambda q, k, v: jnp.sum(ref(q, k, v) * w),
                         argnums=(0, 1, 2))(q, k, v)
        _JAX[impl, causal] = ([np.asarray(o)] + [np.asarray(x) for x in g],
                              [np.asarray(ref(q, k, v))]
                              + [np.asarray(x) for x in g_ref])
    return _JAX[impl, causal]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp2_attention_matches_jax(two_ranks, impl, causal):
    got = _gathered(two_ranks, f"{impl}/{causal}")
    jax_sp, jax_ref = _jax_attention(impl, causal)
    for name, g, a, b in zip(("o", "dq", "dk", "dv"), got, jax_sp, jax_ref):
        np.testing.assert_allclose(g, a, rtol=5e-5, atol=5e-5,
                                   err_msg=f"{name} vs JAX {impl} sp 4")
        np.testing.assert_allclose(g, b, rtol=5e-5, atol=5e-5,
                                   err_msg=f"{name} vs JAX mha_reference")


def test_ring_counts_and_router(two_ranks):
    """sp 2: one rotation a ring forward, one K/V rotation and one dK/dV
    hop home a backward; a causal rank 0 skips rank 1's chunk."""
    for r in two_ranks:
        # 2 differentiable forwards + 1 routed, 2 backwards
        assert r["counts"]["rotations"] == 3 + 2
        assert r["counts"]["returns"] == 2
        # causal: rank 0 one chunk, rank 1 two; full: two each; + routed
        assert r["counts"]["chunk_steps"] == 2 * (1 + r["rank"]) + 2
        np.testing.assert_array_equal(np.array(r["routed"]),
                                      np.array(r["ring/True"][0]))


def test_point_to_point_semantics(two_ranks):
    for r in two_ranks:
        # without a mesh "seq" is size 1: a ring model on a data-parallel
        # world keeps its own positions and sends nothing
        assert r["no_mesh"] == [1, 0, True, True, 0]
        me, other = r["rank"] + 1.0, 2.0 - r["rank"]
        p = r["p2p"]
        assert r["axes"] == [2, r["rank"], 1, 0]
        assert p["listed"] == ([0.0] * 3 if r["rank"] == 0 else [1.0] * 3)
        assert p["swap"] == p["next"] == p["prev"] == [other] * 3
        assert p["async"] == ([2.0] * 3 if r["rank"] == 0 else [0.0] * 3)
        assert p["data"] == [me] * 3
        assert r["ops"]["ppermute"] >= 5 and r["ops"]["ppermute_async"] >= 1


def test_ulysses_heads_and_queue3_raise(two_ranks):
    for r in two_ranks:
        assert "heads 3 divisible by sp 2" in r["raised"]["ulysses_heads"]
        for name in ("mask", "alibi", "dynamic_rope"):
            assert "Queue 3" in r["raised"][name], name
        assert "causal_lm_loss" in r["raised"]["custom_loss"]


_PORT = {}


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sp2_train_batch_matches_one_rank_port(two_ranks, arch, stage):
    if (arch, stage) not in _PORT:
        _PORT[arch, stage] = _traj(_port_engine(arch, stage))
    ref = _PORT[arch, stage]
    for r in two_ranks:
        t = r["train"][f"{arch}/{stage}"]
        assert t["impl"] == "ring" and t["seq"] == [2, r["rank"]]
        assert t["batch"] == [1, 0]
        np.testing.assert_allclose(np.array(t["traj"]), ref, rtol=1e-5)
    assert ref[-1, 0] < ref[0, 0]


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sp2_train_batch_matches_jax_engine(two_ranks, arch, stage):
    old, jmesh._GLOBAL_MESH = jmesh._GLOBAL_MESH, None
    try:
        ref = _traj(_jax_engine(arch, stage, 2))
    finally:
        jmesh._GLOBAL_MESH = old
    for r in two_ranks:
        np.testing.assert_allclose(
            np.array(r["train"][f"{arch}/{stage}"]["traj"]), ref, rtol=2e-4)


def test_four_ranks_data2_seq2_match_one_rank_port(tmp_path):
    """data 2 x seq 2: each seq pair takes its samples, the grads sum
    over seq and average over data."""
    ranks = _run(tmp_path, 4, _train_plan(tmp_path, ["llama"], [1]),
                 attention=False)
    if ("llama", 1) not in _PORT:
        _PORT["llama", 1] = _traj(_port_engine("llama", 1))
    for r in ranks:
        t = r["train"]["llama/1"]
        assert t["seq"] == [2, r["rank"] % 2]
        assert t["batch"] == [2, r["rank"] // 2]
        np.testing.assert_allclose(np.array(t["traj"]), _PORT["llama", 1],
                                   rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_emulated_ring_chunk_logic_matches_plain(causal):
    """The ring's chunk steps, merge and backward over 4 virtual ranks of
    one sample (the emulation chip_smoke.py runs on the card) against
    mha_reference."""
    q, k, v, w = (torch.from_numpy(x) for x in _qkvw(3))
    o, dq, dk, dv = tra.emulate_ring(q, k, v, 4, causal=causal, do=w)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = mha_reference(qq, kk, vv, causal=causal)
    (ref * w).sum().backward()
    for a, b in ((o, ref.detach()), (dq, qq.grad), (dk, kk.grad),
                 (dv, vv.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-5,
                                   atol=5e-5)
    assert tra.chunk_kind(2, 1, True) == "full"
    assert tra.chunk_kind(1, 2, True) == "skip"
    assert tra.chunk_kind(1, 2, False) == "full"


def test_sequence_parallel_needs_a_group_and_in_tree_losses():
    _, tcfg = _cfgs("gpt2")
    with pytest.raises(ValueError, match="process group"):
        deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg), config=_config(1),
            loss_fn=ttr.causal_lm_loss, device="cpu")
    # at seq-world 1 a ring model with extras routes as "auto"
    m, _ = ttr.build_model("gpt2-tiny", hidden_size=32, num_layers=1,
                           num_heads=4, vocab_size=64, pos_embed="alibi",
                           attention_impl="ring", dtype=torch.float32)
    ref, _ = ttr.build_model("gpt2-tiny", hidden_size=32, num_layers=1,
                             num_heads=4, vocab_size=64, pos_embed="alibi",
                             dtype=torch.float32)
    ids = torch.randint(0, 64, (2, 8))
    with torch.no_grad():
        np.testing.assert_array_equal(m(ids).numpy(), ref(ids).numpy())
