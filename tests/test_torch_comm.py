"""The port's comm facade (``deepspeed_tpu_torch.comm``) across two real
gloo ranks on the CPU, against numpy.

One spawn of two processes (a ``file://`` rendezvous under ``tmp_path``,
never a fixed port) runs every collective of the facade on numpy-seeded
inputs in f32 and bf16: ``all_reduce`` with each ``ReduceOp`` (AVG the
sum over the group size), ``all_gather`` tiled and stacked along dims 0
and 1, ``reduce_scatter`` SUM and AVG along dims 0 and 1, ``broadcast``
from either rank and ``all_to_all``; each parametrized case checks one
result on both ranks. Tolerances: f32 rtol 1e-6 (a sum of two values in
another order), bf16 exact against the same sum rounded to bf16 (two
addends), PRODUCT / MIN / MAX exact. The comms logger's counts and bytes
and the facade's always-on counts are checked too, and the
point-to-point ops without a mesh: along ``data`` over the world, along
an axis no mesh binds as size 1 (``tests/test_torch_sequence_parallel.py``
checks them along the ``seq`` axis of a mesh).

The spawn is bounded by its own clock: past ``JOIN_S`` seconds the
children are killed and the test fails.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = str(Path(__file__).resolve().parents[1])
JOIN_S = 120


def _spawn(script: str, world: int, tmp_path, name: str, args=(),
           timeout: float = JOIN_S):
    """Run ``script`` (source text) as ``world`` processes with RANK,
    WORLD_SIZE and a ``file://`` rendezvous (``DSTPU_COORDINATOR_
    ADDRESS``); kill them all and fail past ``timeout`` seconds. Returns
    the (rc, output) of each rank."""
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(script))
    rdv = tmp_path / f"{name}.rdv"
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank),
                   WORLD_SIZE=str(world),
                   DSTPU_COORDINATOR_ADDRESS=f"file://{rdv}",
                   OMP_NUM_THREADS="1")
        env.pop("DSTPU_CHAOS", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(path), *map(str, args)], env=env,
            cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{name}: the ranks did not finish in {timeout} s")
    return outs


WORKER = r"""
import json, sys
import numpy as np
import torch
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm import ReduceOp

comm.init_distributed(device="cpu")
rank, world = comm.get_rank(), comm.get_world_size()
comm.get_comms_logger().configure(enabled=True)
out = {"rank": rank, "world": world, "local": comm.get_local_rank()}

def arr(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)

def t(x, dt):
    return torch.tensor(x, dtype=dt)

def host(x):
    return x.to(torch.float32).tolist()

for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    x = arr(rank, (4, 6))
    for op in ("SUM", "AVG", "MAX", "MIN", "PRODUCT"):
        y = t(x, dt)
        got = comm.all_reduce(y, op=getattr(ReduceOp, op))
        assert got is y                         # in place, returned
        out[f"all_reduce/{op}/{dn}"] = host(got)
    for dim in (0, 1):
        out[f"all_gather/tiled{dim}/{dn}"] = host(
            comm.all_gather(t(x, dt), gather_dim=dim))
        out[f"all_gather/stacked{dim}/{dn}"] = host(
            comm.all_gather(t(x, dt), tiled=False, gather_dim=dim))
        for op in ("SUM", "AVG"):
            out[f"reduce_scatter/{op}{dim}/{dn}"] = host(comm.reduce_scatter(
                t(x, dt), scatter_dim=dim, op=getattr(ReduceOp, op)))
    for src in (0, 1):
        y = t(x, dt)
        assert comm.broadcast(y, src=src) is y
        out[f"broadcast/{src}/{dn}"] = host(y)
    out[f"all_to_all/{dn}"] = host(comm.all_to_all(t(x, dt), axis="data",
                                                   split_dim=0, concat_dim=1))
comm.barrier()
out["counts"] = comm.op_counts()
logger = comm.get_comms_logger()
out["logged"] = {op: [len(r), sum(b for b, _ in r)]
                 for op, r in logger.comms_dict.items()}
out["summary"] = comm.log_summary()
# point-to-point without a mesh: along "data" (the world) rank 1
# receives rank 0's, rank 0 zeros (no pair sends to it); "pipe" and
# "seq" are bound to no mesh, so they are size 1, nothing is sent, and a
# collective over one of them raises
mine = torch.full((1,), rank + 1.0)
try:
    comm.all_reduce(mine.clone(), axis="seq")
    unbound = "no raise"
except ValueError as e:
    unbound = str(e)
out["pipelines_raise"] = [
    comm.ppermute(mine, [(0, 1)], axis="data").tolist(),
    comm.send_recv_next(mine, axis="data").tolist(),
    comm.axis_rank("data"), comm.axis_size("data"),
    comm.send_recv_next(mine).tolist(),
    [comm.axis_rank(a) for a in ("pipe", "seq", ("data", "seq"))],
    [comm.axis_size(a) for a in ("pipe", "seq", ("data", "seq"))],
    "bound by no mesh" in unbound]
print("RESULT " + json.dumps(out), flush=True)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm")
    outs = _spawn(WORKER, 2, tmp, "comm_worker")
    res = []
    for rc, out in outs:
        assert rc == 0, out[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        res.append(json.loads(line[-1][len("RESULT "):]))
    return res


def _inputs(dt):
    xs = [np.random.default_rng(r).standard_normal((4, 6)).astype(np.float32)
          for r in range(2)]
    if dt == "bf16":        # what each rank held: its input rounded to bf16
        xs = [torch.tensor(x).to(torch.bfloat16).float().numpy() for x in xs]
    return xs


def _round(x, dt):
    return (torch.tensor(x).to(torch.bfloat16).float().numpy()
            if dt == "bf16" else x)


def _hold(got, want, dt, exact=False):
    got = np.asarray(got, np.float32)
    if exact or dt == "bf16":
        np.testing.assert_array_equal(got, _round(want, dt))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


DTS = ("f32", "bf16")


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX", "MIN", "PRODUCT"])
def test_all_reduce(two_ranks, op, dt):
    a, b = _inputs(dt)
    want = {"SUM": a + b, "AVG": _round(a + b, dt) / 2,
            "MAX": np.maximum(a, b), "MIN": np.minimum(a, b),
            "PRODUCT": a * b}[op]
    for r in two_ranks:
        _hold(r[f"all_reduce/{op}/{dt}"], want, dt,
              exact=op in ("MAX", "MIN"))


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("dim", [0, 1])
def test_all_gather(two_ranks, dim, dt):
    a, b = _inputs(dt)
    for r in two_ranks:
        _hold(r[f"all_gather/tiled{dim}/{dt}"],
              np.concatenate([a, b], axis=dim), dt, exact=True)
        _hold(r[f"all_gather/stacked{dim}/{dt}"],
              np.stack([a, b], axis=dim), dt, exact=True)


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("op", ["SUM", "AVG"])
@pytest.mark.parametrize("dim", [0, 1])
def test_reduce_scatter(two_ranks, dim, op, dt):
    a, b = _inputs(dt)
    total = _round(a + b, dt)
    for r in two_ranks:
        piece = np.split(total, 2, axis=dim)[r["rank"]]
        _hold(r[f"reduce_scatter/{op}{dim}/{dt}"],
              piece / 2 if op == "AVG" else piece, dt)


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("src", [0, 1])
def test_broadcast(two_ranks, src, dt):
    xs = _inputs(dt)
    for r in two_ranks:
        _hold(r[f"broadcast/{src}/{dt}"], xs[src], dt, exact=True)


@pytest.mark.parametrize("dt", DTS)
def test_all_to_all(two_ranks, dt):
    xs = _inputs(dt)
    for r in two_ranks:
        # chunk r of every rank's dim 0, concatenated along dim 1
        want = np.concatenate([np.split(x, 2, axis=0)[r["rank"]]
                               for x in xs], axis=1)
        _hold(r[f"all_to_all/{dt}"], want, dt, exact=True)


def test_logger_counts_and_bytes(two_ranks):
    """Per dtype: 5 all-reduces, 4 all-gathers, 4 reduce-scatters, 2
    broadcasts, 1 all-to-all; bytes are the input's (4 x 6 elements);
    the always-on counts agree and add the barrier."""
    want = {"all_reduce": 10, "all_gather": 8, "reduce_scatter": 8,
            "broadcast": 4, "all_to_all": 2}
    for r in two_ranks:
        assert r["world"] == 2 and r["local"] == 0
        assert r["counts"] == dict(want, barrier=1)
        per = 24 * 4 + 24 * 2                   # one f32 and one bf16 input
        assert r["logged"] == {op: [n, n // 2 * per]
                               for op, n in want.items()}
        assert "all_reduce" in r["summary"] and "Count" in r["summary"]
        # the point-to-point ops run (they raised until ring attention)
        me, other = r["rank"] + 1.0, 2.0 - r["rank"]
        assert r["pipelines_raise"] == [
            [0.0] if r["rank"] == 0 else [1.0], [other], r["rank"], 2,
            [me], [0, 0, r["rank"]], [1, 1, 2], True]
        assert me != other


def test_init_distributed_without_a_world_is_a_no_op(monkeypatch):
    from deepspeed_tpu_torch import comm
    for var in ("WORLD_SIZE", "DSTPU_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    comm.init_distributed()
    assert not comm.is_initialized()
    assert (comm.get_rank(), comm.get_world_size()) == (0, 1)
    with pytest.raises(RuntimeError, match="init_distributed"):
        comm.all_reduce(torch.ones(2))


def test_init_distributed_refuses_gloo_for_cuda_and_nccl_for_cpu():
    """The backend follows the device: no silent gloo for a CUDA run."""
    from deepspeed_tpu_torch import comm
    with pytest.raises(ValueError, match="NCCL"):
        comm.init_distributed(dist_backend="nccl", world_size=1,
                              device="cpu")
    assert not comm.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            comm.init_distributed(world_size=1)
