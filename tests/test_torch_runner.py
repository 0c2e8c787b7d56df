"""Port parity: the launcher's command building and the elastic batch math
(``deepspeed_tpu_torch/launcher/{runner,multinode_runner,launch,ds_ssh}.py``
and ``elasticity/``) against the JAX package, on the CPU.

* hostfile and --include / --exclude parsing, the world-info codec, the
  per-host launch command and the ssh command: equal to the JAX
  functions' output for the same arguments, the module name aside;
* every scheduler backend's ``get_cmd`` / ``get_kill_cmd`` /
  ``route_line`` (PDSH, OpenMPI, Slurm, MVAPICH): the same, commands only
  (nothing dials a host);
* ``compute_elastic_config`` on the same ds_configs, errors included;
* ``health`` over the same heartbeat records: the same table and rc;
* the per-node bootstrap's rank detection and worker layout, and the
  runner's refusals of what is not ported.
"""

import types

import pytest

from deepspeed_tpu.elasticity import elasticity as jel
from deepspeed_tpu.launcher import multinode_runner as jmr
from deepspeed_tpu.launcher import runner as jrun

from deepspeed_tpu_torch.elasticity import elasticity as tel
from deepspeed_tpu_torch.launcher import launch as tlaunch
from deepspeed_tpu_torch.launcher import multinode_runner as tmr
from deepspeed_tpu_torch.launcher import runner as trun

JMOD, TMOD = "deepspeed_tpu.launcher.launch", \
    "deepspeed_tpu_torch.launcher.launch"


def _unport(cmd):
    """A port command with the JAX module name in place of the port's."""
    if cmd is None:
        return None
    return [c.replace(TMOD, JMOD) for c in cmd]


def _args(**kw):
    ns = types.SimpleNamespace(user_script="train.py", user_args=["--x", "1"],
                               hostfile="/job/hostfile", include="")
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


HOSTFILES = [
    ["worker-1 slots=4", "worker-2 slots=4  # comment", "", "# only"],
    ["a slots=1", "b slots=2", "c slots=8"],
    ["localhost slots=1"],
    ["bad-line"],
    ["a slots=1", "a slots=2"],
    ["a gpus=2"],
]


def _both(fn_j, fn_t, *a, **k):
    """(JAX result or exception type, port result or exception type)."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(fn(*a, **k))
        except Exception as e:               # the same refusal on both
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("lines", HOSTFILES)
def test_hostfile_parsing_equals_jax(lines):
    j, t = _both(jrun.parse_hostfile, trun.parse_hostfile, lines)
    assert j == t


@pytest.mark.parametrize("inc,exc", [
    ("", ""), ("w1:0,2@w3", ""), ("w2", ""), ("", "w1"), ("", "w2:1,3"),
    ("", "w1@w2@w3"), ("w1", "w2"), ("w9", ""), ("", "w9"), ("w1:7", ""),
])
def test_include_exclude_and_world_info_equal_jax(inc, exc):
    pool = jrun.parse_hostfile(["w1 slots=4", "w2 slots=4", "w3 slots=2"])
    j, t = _both(jrun.parse_inclusion_exclusion,
                 trun.parse_inclusion_exclusion, pool, inc, exc)
    assert j == t
    if isinstance(j, dict):
        blob = trun.encode_world_info(t)
        assert blob == jrun.encode_world_info(j)
        assert trun.decode_world_info(blob) == jrun.decode_world_info(blob)


def test_launch_and_ssh_commands_equal_jax():
    info = jrun.encode_world_info({"a": [0, 1], "b": [0]})
    for idx in range(2):
        args = (idx, 2, "a", 29511, info, "train.py", ["--lr", "1e-3"])
        assert _unport(trun.build_launch_cmd(*args)) == \
            jrun.build_launch_cmd(*args)
    remote = jrun.build_launch_cmd(1, 2, "a", 29511, info, "t.py", [])
    exports = {"DSTPU_CHAOS": "run.kill:kill", "PYTHONPATH": "/x y"}
    assert trun.build_ssh_cmd("b", remote, exports, connect_timeout=7) == \
        jrun.build_ssh_cmd("b", remote, exports, connect_timeout=7)


@pytest.mark.parametrize("backend", ["pdsh", "openmpi", "slurm", "mvapich"])
def test_backend_commands_equal_jax(backend, monkeypatch):
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    pool = jrun.parse_hostfile(["w1 slots=4", "w2 slots=4", "w3 slots=4"])
    active = jrun.parse_inclusion_exclusion(pool, "w1:0,2@w3")
    info = jrun.encode_world_info(active)
    for env in ({"DSTPU_COORDINATOR": "w1", "E": "v"},
                {"MV2_SMP_USE_CMA": "1", "SLURM_JOB_ID": "1234"}):
        j = jmr.build_runner(backend, _args(hostfile="/tmp/hf"), info)
        t = tmr.build_runner(backend, _args(hostfile="/tmp/hf"), info)
        for r in (j, t):
            r.add_export("XLA_FLAGS", "--flag=1")
        assert _unport(t.get_cmd(env, active)) == j.get_cmd(env, active)
        assert _unport(t.get_kill_cmd(env, active)) == \
            j.get_kill_cmd(env, active)
        for line in ("w2: hello\n", "3: payload\n", "no prefix\n"):
            assert t.route_line(line) == j.route_line(line)
    with pytest.raises(ValueError, match="unknown launcher"):
        tmr.build_runner("nope", _args())


@pytest.mark.parametrize("elastic", [
    {"enabled": True, "max_train_batch_size": 2000,
     "micro_batch_sizes": [2, 4, 6], "min_gpus": 1, "max_gpus": 64},
    {"enabled": True, "max_train_batch_size": 256,
     "micro_batch_sizes": [8], "min_gpus": 2, "max_gpus": 16,
     "prefer_larger_batch": False},
    {"enabled": True, "max_train_batch_size": 3, "micro_batch_sizes": [4]},
    {"enabled": True, "version": 0.9},
    {"enabled": False},
])
@pytest.mark.parametrize("world", [0, 4, 7, 8])
def test_compute_elastic_config_equals_jax(elastic, world):
    cfg = {"elasticity": elastic}
    j, t = _both(jel.compute_elastic_config, tel.compute_elastic_config,
                 cfg, world_size=world)
    assert j == t


def test_health_reads_records_as_jax(tmp_path, capsys):
    from deepspeed_tpu_torch.runtime import heartbeat as hb
    d = str(tmp_path / "hb")
    w0 = hb.HeartbeatWriter(d, 0, host="h0", refresh_interval=0)
    w0.write(hb.PHASE_STEP, 7, force=True, extra={"step_ms": 41.5,
                                                  "stage": 1})
    w1 = hb.HeartbeatWriter(d, 1, host="h1", refresh_interval=0)
    w1.write(hb.PHASE_STEP, 7, force=True)
    w1.stamp_terminal(hb.PHASE_EXIT)
    outs = []
    for main in (jrun.health_main, trun.health_main):
        rc = main([d])
        outs.append((rc, [ln.split()[:6] for ln in
                          capsys.readouterr().out.splitlines()]))
    assert outs[0] == outs[1] and outs[1][0] == 0
    w0.add_flag("SDC")
    rcs = [main([d]) for main in (jrun.health_main, trun.health_main)]
    capsys.readouterr()
    assert rcs == [1, 1]
    assert trun.health_main([str(tmp_path / "none")]) == 1


def test_launch_layout_and_node_rank(monkeypatch):
    info = trun.encode_world_info({"a": [0, 1], "b": [0, 1, 2], "c": [0]})
    a = tlaunch.parse_args(["--node_rank", "1", "--nnodes", "3",
                            "--world_info", info, "--coordinator",
                            "a:29511", "t.py", "--y"])
    assert tlaunch._layout(a, 1) == (3, 6, 2, "b")
    assert a.user_args == ["--y"]
    a = tlaunch.parse_args(["--nproc_per_node", "2", "--nnodes", "2",
                            "--node_rank", "1", "t.py"])
    assert tlaunch._layout(a, 1) == (2, 4, 2, None)
    # -1: the scheduler's rank variable, else the host's place
    a = tlaunch.parse_args(["--node_rank=-1", "--nnodes=3",
                            f"--world_info={info}", "t.py"])
    monkeypatch.setenv("SLURM_PROCID", "2")
    assert tlaunch.resolve_node_rank(a) == 2
    monkeypatch.delenv("SLURM_PROCID")
    for var in ("OMPI_COMM_WORLD_RANK", "PMI_RANK", "PMIX_RANK",
                "MV2_COMM_WORLD_RANK", "MPIRUN_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr("socket.gethostname", lambda: "b.example.com")
    assert tlaunch.resolve_node_rank(a) == 1
    monkeypatch.setattr("socket.gethostname", lambda: "b1")
    with pytest.raises(RuntimeError, match="node_rank"):
        tlaunch.resolve_node_rank(a)


def test_runner_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trun.main(["comm-plan", "sweep"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trun.main(["--autotuning", "tune", "t.py"])


LAUNCHER_IMPORTS = r"""
import runpy, sys
sys.argv = ["runner", "--help"]
try:
    runpy.run_module("deepspeed_tpu_torch.launcher.runner",
                     run_name="__main__")
except SystemExit:
    pass
import deepspeed_tpu_torch.elasticity.elastic_agent
import deepspeed_tpu_torch.launcher.ds_ssh
import deepspeed_tpu_torch.launcher.launch
import deepspeed_tpu_torch.launcher.multinode_runner
import deepspeed_tpu_torch.launcher.supervisor
print("TORCH", "torch" in sys.modules)
"""


def test_launcher_processes_do_not_load_torch():
    """The runner, the per-node bootstrap, the supervisors and the elastic
    agent run in processes of their own that never touch a tensor: they
    import the package without torch (its exports load at first use)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", LAUNCHER_IMPORTS],
                         capture_output=True, text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=repo), cwd=repo)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "usage:" in out.stdout
    assert "TORCH False" in out.stdout
