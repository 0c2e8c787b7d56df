"""Port parity: the int8 / overlap / compressed collectives and their
engine wiring across two gloo ranks on the CPU, against the JAX package
on a 2-device mesh (the int8 numbers depend on the group size, so JAX
runs at 2, not 8).

One spawn of two ranks (``test_torch_comm._spawn``) runs every port leg;
the JAX references run in this process on the same numpy-seeded inputs:

* ``grad_sync`` (``exact``, ``int8``) and ``overlap_grad_sync``
  (``overlap``, ``overlap_int8``, 3 chunks) on an odd-sized leaf, the
  ``quantized_all_to_all``, ``quantized_reduce_scatter``, the qwZ gather
  (``make_quantized_gather``) and the overlap gathers forward and
  backward, the benchmark pipelines (``chunked_ag_matmul``,
  ``chunked_rs``, ``chunked_matmul_rs``), three rounds of
  ``compressed_allreduce`` (outputs and both error buffers),
  ``quantized_allreduce`` and ``hierarchical_quantized_allreduce``: within
  1e-6 (the same int8 bytes; sums in another order), the error buffers
  (x - q * scale, a cancellation) within 1e-5. An inf on one rank comes
  out of the int8 sync non-finite;
* the engine, tiny gpt2 (2 layers, f32, SGD with momentum so the leaves
  after a step compare element for element), 3 steps at data 2: ZeRO-2
  with the grad sync forced to ``int8`` and ``overlap`` and ZeRO-3 with
  qwZ (``zero_quantized_weights``; the persistence threshold keeps the
  1-D leaves whole, whose ZeRO dim differs between the stacked and the
  per-block layouts) against the JAX engine: losses and grad norms rtol
  1e-5, leaves atol 1e-4 (an element on an int8 rounding boundary may
  round the other way in one package). qwZ's scale is one a rank and stacked leaf,
  over the rank's slabs of both blocks; the ZeRO-3 ``overlap`` gather
  against the port's exact ZeRO-3 engine at 1e-6;
* the MoE int8 exchange at ep 2 against the JAX engine's (rtol 1e-5);
* the comms logger's bytes: the int8 sync moves at most 0.28x the exact
  sync's;
* the compositions left out (compression under ZeRO-3, TP and EP, the
  eigenvalue across data ranks) raise naming ROADMAP.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import deepspeed_tpu as jds
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime.comm import compressed as jcomp
from deepspeed_tpu.runtime.comm import overlap as jov
from deepspeed_tpu.runtime.comm import quantized as jquant

from deepspeed_tpu_torch.parallel import mesh as tmesh

from test_torch_comm import _spawn

SHAPE = (37, 29)                 # 1073 elements: no block or chunk divides
KW = dict(hidden_size=32, num_layers=2, num_heads=4, vocab_size=64,
          max_seq_len=16)
MOE_KW = dict(KW, moe_experts=4, moe_capacity_factor=2.0)
SEEDS = [31, 32, 33]
BASE = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "SGD", "params": {"lr": 0.05,
                                                "momentum": 0.9}},
        "gradient_clipping": 1.0, "steps_per_print": 100}
ENGINES = {
    "z2_int8": {"zero_optimization": {"stage": 2},
                "comm_plan": {"enabled": True, "overrides": {
                    "grad_reduce_scatter": "int8"}}},
    "z2_overlap": {"zero_optimization": {"stage": 2},
                   "comm_plan": {"enabled": True, "overlap_chunks": 3,
                                 "overrides": {
                                     "grad_reduce_scatter": "overlap"}}},
    "z3_qwz": {"zero_optimization": {
        "stage": 3, "stage3_param_persistence_threshold": 1000,
        "zero_quantized_weights": True}},
    "moe_int8": {"zero_optimization": {"stage": 1},
                 "moe": {"enabled": True, "ep_size": 2},
                 "train_micro_batch_size_per_gpu": 4,
                 "gradient_accumulation_steps": 1,
                 "comm_plan": {"enabled": True, "overrides": {
                     "moe_all_to_all": "int8"}}},
}
# port-only: the chunked ZeRO-3 gather against the whole-tensor one
PORT_ONLY = {
    "z3_exact": {"zero_optimization": {
        "stage": 3, "stage3_param_persistence_threshold": 1000}},
    "z3_overlap": {"zero_optimization": {
        "stage": 3, "stage3_param_persistence_threshold": 1000},
        "comm_plan": {"enabled": True, "overlap_chunks": 3,
                      "overlap_min_leaf_elems": 0,
                      "overrides": {"param_all_gather": "overlap"}}},
}


@pytest.fixture(autouse=True)
def _no_session_mesh(monkeypatch):
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    monkeypatch.setattr(tmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _inputs():
    """Each rank's inputs, stacked [2, ...] (rank r's are row r)."""
    d = {"grad": _x((2,) + SHAPE, 1, 3.0),
         "a2a": _x((12, 40), 2),
         "gather": _x((10, 7), 3),
         "gather_w": _x((2, 10, 7), 4),      # each rank's cotangent share
         "ogather": _x((12, 40), 5),
         "ogather_w": _x((2, 12, 40), 6)}
    d.update(cag_x=_x((3, 12), 7), cag_w=_x((12, 5), 8),
             crs=_x((2, 700), 9), cmr_u=_x((2, 6), 20), cmr_v=_x((6, 700), 21))
    bad = d["grad"].copy()
    bad[1, 3, 4] = np.inf
    d["bad"] = bad
    for i in range(3):
        d[f"onebit{i}"] = _x((2,) + SHAPE, 10 + i)
    return d


def _mesh(shape=(2,), names=("data",)):
    return Mesh(np.asarray(jax.devices()[:2]).reshape(shape), names)


def _put(mesh, x, spec=P("data")):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _jax_collectives(d):
    """The JAX functions' results on the 2-device mesh."""
    mesh = _mesh()
    out = {}
    g = _put(mesh, d["grad"])
    for algo in ("exact", "int8"):
        out[f"sync_{algo}"] = jquant.grad_sync(g, mesh=mesh, algo=algo)
    for algo in ("overlap", "overlap_int8"):
        out[f"sync_{algo}"] = jov.overlap_grad_sync(g, mesh=mesh, chunks=3,
                                                    algo=algo)
    out["sync_bad"] = jquant.grad_sync(_put(mesh, d["bad"]), mesh=mesh,
                                       algo="int8")
    out["a2a"] = jquant.quantized_all_to_all(_put(mesh, d["a2a"]), mesh=mesh,
                                             axis="data")
    out["qrs"] = jquant.quantized_reduce_scatter(g, mesh=mesh, mean=True)
    for algo in ("overlap", "overlap_int8"):
        out[f"cag_{algo}"] = jov.chunked_ag_matmul(
            jnp.asarray(d["cag_x"]), _put(mesh, d["cag_w"]), mesh=mesh,
            axis="data", chunks=3, algo=algo)
        out[f"crs_{algo}"] = jov.chunked_rs(
            _put(mesh, d["crs"]), mesh=mesh, axis="data", chunks=3,
            algo=algo)
        out[f"cmr_{algo}"] = jov.chunked_matmul_rs(
            _put(mesh, d["cmr_u"]), jnp.asarray(d["cmr_v"]), mesh=mesh,
            axis="data", chunks=3, algo=algo)
    qg = jcomp.make_quantized_gather(mesh, "data", 0)
    w = d["gather_w"].sum(0)
    x = _put(mesh, d["gather"])
    out["qw_fwd"] = qg(x)
    out["qw_bwd"] = jax.grad(lambda v: jnp.sum(qg(v) * w))(x)
    ow = d["ogather_w"].sum(0)
    for algo in ("overlap", "overlap_int8"):
        og = jov.make_overlap_gather(mesh, "data", 0, chunks=3, algo=algo)
        xo = _put(mesh, d["ogather"])
        out[f"og_{algo}_fwd"] = jax.jit(og)(xo)
        out[f"og_{algo}_bwd"] = jax.grad(
            lambda v: jnp.sum(og(v) * ow))(xo)
    n = int(np.prod(SHAPE))
    we = _put(mesh, np.zeros((2, n), np.float32))
    se = _put(mesh, np.zeros((2, jcomp.chunk_elems(n, 2)), np.float32))
    for i in range(3):
        o, we, se = jcomp.compressed_allreduce(_put(mesh, d[f"onebit{i}"]),
                                               we, se, mesh=mesh)
        out[f"onebit{i}"], out[f"onebit{i}_w"], out[f"onebit{i}_s"] = \
            o, we, se
    o, e = jcomp.quantized_allreduce(g, _put(mesh, np.zeros((2, n),
                                                            np.float32)),
                                     mesh=mesh)
    out["qar"], out["qar_err"] = o, e
    hmesh = _mesh((2, 1), ("data", "expert"))
    o, e = jcomp.hierarchical_quantized_allreduce(
        _put(hmesh, d["grad"], P(("data", "expert"))),
        _put(hmesh, np.zeros((2, n), np.float32)), mesh=hmesh,
        intra_axis="expert", inter_axis="data")
    out["hqar"], out["hqar_err"] = o, e
    return {k: np.asarray(v) for k, v in out.items()}


def _jcfg(kw):
    return jtr.get_config("gpt2-tiny", **kw, dtype=jnp.float32,
                          attention_impl="reference")


_P = {}


def _params(kw):
    key = json.dumps(kw, sort_keys=True)
    if key not in _P:
        p = jax.jit(jtr.Transformer(_jcfg(kw)).init)(
            jax.random.PRNGKey(5),
            {"input_ids": np.zeros((1, 8), np.int32)})["params"]
        _P[key] = jax.tree.map(np.asarray, jax.device_get(p))
    return _P[key]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, 64, (8, 16))
    return {"input_ids": ids.astype(np.int32)}


def _jax_engine(mode):
    moe = mode.startswith("moe")
    kw = MOE_KW if moe else KW
    mm = jmesh.MeshManager(devices=jax.devices()[:2],
                           ep_size=2 if moe else 1)
    jmesh.set_global_mesh(mm)
    eng, *_ = jds.initialize(
        model=jtr.Transformer(_jcfg(kw)), config=dict(BASE, **ENGINES[mode]),
        model_parameters=_params(kw),
        loss_fn=jtr.make_moe_loss(0.01) if moe else jtr.causal_lm_loss,
        mesh_manager=mm)
    traj = []
    for s in SEEDS:
        m = jax.device_get(eng.train_batch(_batch(s)))
        traj.append([float(m["loss"]), float(m["grad_norm"])])
    state = {k: np.asarray(v, np.float32)
             for k, v in eng.module_state_dict().items()}
    jmesh.set_global_mesh(None)
    return traj, state, eng


WORKER = r"""
import json, sys
import numpy as np
import torch
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.runtime.comm import compressed, overlap, quantized

plan = json.load(open(sys.argv[1]))
comm.init_distributed(device="cpu")
r = comm.get_rank()
d = dict(np.load(plan["inputs"]))
tmesh.set_global_mesh(tmesh.MeshManager(devices=range(2)))
out = {}
t = lambda a: torch.from_numpy(np.array(a))
g = t(d["grad"][r])
for algo in ("exact", "int8"):
    out["sync_" + algo] = quantized.grad_sync(g, algo=algo)
for algo in ("overlap", "overlap_int8"):
    out["sync_" + algo] = overlap.overlap_grad_sync(g, chunks=3, algo=algo)
out["sync_bad"] = quantized.grad_sync(t(d["bad"][r]), algo="int8")
out["a2a"] = quantized.quantized_all_to_all(t(d["a2a"][6 * r:6 * r + 6]),
                                            axis="data")
out["qrs"] = quantized.quantized_reduce_scatter(g, mean=True)[None]
for algo in ("overlap", "overlap_int8"):
    out["cag_" + algo] = overlap.chunked_ag_matmul(
        t(d["cag_x"]), t(d["cag_w"][6 * r:6 * r + 6]), axis="data", chunks=3,
        algo=algo)
    out["crs_" + algo] = overlap.chunked_rs(t(d["crs"][r]), axis="data",
                                            chunks=3, algo=algo)[None]
    out["cmr_" + algo] = overlap.chunked_matmul_rs(
        t(d["cmr_u"][r]), t(d["cmr_v"]), axis="data", chunks=3,
        algo=algo)[None]
qg = compressed.make_quantized_gather("data", 0)
x = t(d["gather"][5 * r:5 * r + 5]).requires_grad_(True)
f = qg(x)
(f * t(d["gather_w"][r])).sum().backward()
out["qw_fwd"], out["qw_bwd"] = f, x.grad
for algo in ("overlap", "overlap_int8"):
    og = overlap.make_overlap_gather("data", 0, chunks=3, algo=algo)
    x = t(d["ogather"][6 * r:6 * r + 6]).requires_grad_(True)
    f = og(x)
    (f * t(d["ogather_w"][r])).sum().backward()
    out["og_%s_fwd" % algo], out["og_%s_bwd" % algo] = f, x.grad
n = int(np.prod(g.shape))
we = torch.zeros(n)
se = torch.zeros(compressed.chunk_elems(n, 2))
for i in range(3):
    o, we, se = compressed.compressed_allreduce(t(d["onebit%d" % i][r]),
                                                we, se)
    out["onebit%d" % i], out["onebit%d_w" % i], out["onebit%d_s" % i] = \
        o, we, se
out["qar"], out["qar_err"] = compressed.quantized_allreduce(g, torch.zeros(n))
out["hqar"], out["hqar_err"] = compressed.hierarchical_quantized_allreduce(
    g, torch.zeros(n), intra_axis="expert", inter_axis="data")
# the comms logger's bytes of the two syncs, by op
log = comm.get_comms_logger()
log.configure(enabled=True)
nbytes = {}
for algo in ("exact", "int8"):
    log.reset()
    quantized.grad_sync(torch.ones(65536), algo=algo)
    nbytes[algo] = {op: sum(b for b, _ in recs)
                    for op, recs in log.comms_dict.items()}
log.configure(enabled=False)
tmesh.set_global_mesh(None)
np.savez(plan["dir"] + "/coll%d.npz" % r,
         **{k: v.detach().numpy() for k, v in out.items()})

def tree(path):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    root = {}
    for k, v in flat.items():
        node = root
        for p in k.split("/")[:-1]:
            node = node.setdefault(p, {})
        node[k.split("/")[-1]] = v
    return root

res = {"bytes": nbytes, "engines": {}}
for mode, extra in plan["engines"].items():
    moe = mode.startswith("moe")
    kw = plan["moe_kw"] if moe else plan["kw"]
    cfg = ttr.get_config("gpt2-tiny", **kw, dtype=torch.float32)
    eng, *_ = ds.initialize(
        model=ttr.Transformer(cfg, params_from_jax(
            tree(plan["moe_params"] if moe else plan["params"]))),
        config=dict(plan["base"], **extra),
        loss_fn=ttr.make_moe_loss(0.01) if moe else ttr.causal_lm_loss,
        device="cpu")
    traj, algos = [], []
    comm.reset_op_counts()
    for s in plan["seeds"]:
        ids = np.random.default_rng(s).integers(0, 64, (8, 16))
        m = eng.train_batch({"input_ids": ids.astype(np.int32)})
        traj.append([m["loss"], m["grad_norm"]])
        algos.append([m.get("grad_sync_algo"), m.get("param_gather_algo")])
    sd = eng.module_state_dict()
    if r == 0:
        np.savez(plan["dir"] + "/state_%s.npz" % mode, **sd)
    res["engines"][mode] = {"traj": traj, "algos": algos,
                            "ops": comm.op_counts()}
# the compositions the port refuses (NotImplementedError naming ROADMAP)
wq = {"weight_quantization": {
    "shared_parameters": {"enabled": True},
    "different_groups": {"g": {"params": {"start_bits": 8},
                               "modules": ["kernel"]}}}}
refused = {}
for name, kw, extra in (
        ("zero3", plan["kw"], {"zero_optimization": {"stage": 3}}),
        ("tp", plan["kw"], {"tensor_parallel": {"tp_size": 2},
                            "train_micro_batch_size_per_gpu": 4}),
        ("ep", plan["moe_kw"], {"moe": {"enabled": True, "ep_size": 2}})):
    cfg = ttr.get_config("gpt2-tiny", **kw, dtype=torch.float32)
    model = ttr.Transformer(cfg)
    try:
        ds.initialize(model=model, config=dict(
            plan["base"], compression_training=wq, **extra),
            loss_fn=(ttr.make_moe_loss(0.01) if name == "ep"
                     else ttr.causal_lm_loss), device="cpu",
            sharding_rules=cfg.tp_rules() if name == "tp" else None)
        refused[name] = None
    except NotImplementedError as e:
        refused[name] = str(e)
cfg = ttr.get_config("gpt2-tiny", **plan["kw"], dtype=torch.float32,
                     attention_impl="reference")
eng, *_ = ds.initialize(model=ttr.Transformer(cfg), config=dict(
    plan["base"], eigenvalue={"enabled": True}), device="cpu",
    loss_fn=ttr.causal_lm_loss)
try:
    eng.compute_eigenvalue({"input_ids": np.zeros((4, 16), np.int32)})
    refused["eigenvalue"] = None
except NotImplementedError as e:
    refused["eigenvalue"] = str(e)
res["refused"] = refused
print("RESULT " + json.dumps(res), flush=True)
torch.distributed.destroy_process_group()
"""

_RUN = {}


def _run(tmp_path_factory):
    if _RUN:
        return _RUN
    tmp = tmp_path_factory.mktemp("qcomm")
    d = _inputs()
    np.savez(tmp / "inputs.npz", **d)
    np.savez(tmp / "params.npz", **_flat(_params(KW)))
    np.savez(tmp / "moe_params.npz", **_flat(_params(MOE_KW)))
    plan = {"inputs": str(tmp / "inputs.npz"), "dir": str(tmp),
            "params": str(tmp / "params.npz"),
            "moe_params": str(tmp / "moe_params.npz"),
            "kw": KW, "moe_kw": MOE_KW, "seeds": SEEDS, "base": BASE,
            "engines": dict(ENGINES, **PORT_ONLY)}
    (tmp / "plan.json").write_text(json.dumps(plan))
    outs = _spawn(WORKER, 2, tmp, "qcomm", args=[tmp / "plan.json"])
    ranks = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    _RUN.update(dir=tmp, inputs=d, ranks=ranks,
                coll=[dict(np.load(tmp / f"coll{r}.npz")) for r in (0, 1)])
    return _RUN


def test_collectives_match_jax(tmp_path_factory):
    run = _run(tmp_path_factory)
    want = _jax_collectives(run["inputs"])
    for r, got in enumerate(run["coll"]):
        for k, w in want.items():
            g = got[k]
            if k in ("a2a", "qrs") or k.startswith(("crs_", "cmr_")) or \
                    k.endswith("_bwd"):
                # each rank's rows of the dim-0 sharded result
                rows = w.shape[0] // 2
                w = w[rows * r:rows * (r + 1)]
            elif k.endswith(("_w", "_s", "_err")):
                w = w[r]                            # per-rank error buffers
            if k == "sync_bad":
                assert not np.isfinite(g).all()
                assert np.isfinite(g).sum() == np.isfinite(w).sum()
                continue
            # an error buffer is x - q * scale: the cancellation leaves an
            # f32 rounding of q * scale as it is
            atol = 1e-5 if k.endswith(("_w", "_s", "_err")) else 1e-6
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=atol,
                                       err_msg=f"{k} rank {r}")
    # the int8 sync is near the mean, per element within the bound of
    # docs/COMM.md (two int8 hops)
    grads = run["inputs"]["grad"]
    err = np.abs(run["coll"][0]["sync_int8"] - grads.mean(0)).max()
    assert err <= 2 * np.abs(grads).max() / 127
    b = run["ranks"][0]["bytes"]
    exact, int8 = sum(b["exact"].values()), sum(b["int8"].values())
    assert set(b["exact"]) == {"all_to_all", "all_gather"}
    assert int8 <= 0.28 * exact, (int8, exact)


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_quantized_engines_match_jax(mode, tmp_path_factory):
    run = _run(tmp_path_factory)
    jtraj, jstate, jeng = _jax_engine(mode)
    for r in run["ranks"]:
        got = r["engines"][mode]
        np.testing.assert_allclose(np.array(got["traj"]), np.array(jtraj),
                                   rtol=1e-5, err_msg=mode)
    with np.load(run["dir"] / f"state_{mode}.npz") as z:
        for k, v in jstate.items():
            np.testing.assert_allclose(z[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{mode} {k}")
    algos = run["ranks"][0]["engines"][mode]["algos"]
    ops = run["ranks"][0]["engines"][mode]["ops"]
    if mode == "z2_int8":
        assert algos[0][0] == "int8"
        assert jeng.comm_plan_ctx.resolved["grad_reduce_scatter"] == "int8"
        assert "reduce_scatter" not in ops     # one sync a step, no RS
    if mode == "z2_overlap":
        assert algos[0][0] == "overlap"
        assert ops["all_to_all_async"] > 0 and "reduce_scatter" not in ops
    if mode == "z3_qwz":
        assert algos[0] == [None, None]       # no comm plan
    if mode == "moe_int8":
        # the int8 pair: payload and scales, each direction, forward and
        # backward, two layers, one micro-batch a step
        assert ops["all_to_all"] >= 2 * 2 * 2 * 2 * len(SEEDS)


def test_left_out_compositions_raise_across_ranks(tmp_path_factory):
    """Compression under ZeRO-3, TP and EP in a process group, and the
    eigenvalue across data ranks, raise naming ROADMAP."""
    run = _run(tmp_path_factory)
    for r in run["ranks"]:
        got = r["refused"]
        for name, word in (("zero3", "ZeRO-3"), ("tp", "tensor"),
                           ("ep", "expert"), ("eigenvalue", "across ranks")):
            assert got[name] is not None and word in got[name] and \
                "ROADMAP" in got[name], (name, got[name])


def test_overlap_gather_engine_matches_exact(tmp_path_factory):
    run = _run(tmp_path_factory)
    for r in run["ranks"]:
        a = np.array(r["engines"]["z3_overlap"]["traj"])
        b = np.array(r["engines"]["z3_exact"]["traj"])
        np.testing.assert_allclose(a, b, rtol=1e-6)
        assert r["engines"]["z3_overlap"]["algos"][0][1] == "overlap"
        ops = r["engines"]["z3_overlap"]["ops"]
        assert ops["all_gather_async"] > 0
    with np.load(run["dir"] / "state_z3_overlap.npz") as za, \
            np.load(run["dir"] / "state_z3_exact.npz") as zb:
        for k in za.files:
            np.testing.assert_allclose(za[k], zb[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
