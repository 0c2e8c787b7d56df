"""The port's per-node launcher (``python -m
deepspeed_tpu_torch.launcher.launch``) with two local gloo workers.

Each leg starts the launcher in its own process with ``--nproc_per_node
2`` and a ``file://`` rendezvous under ``tmp_path`` (never a fixed port),
bounded by its own clock (killed and failed past ``JOIN_S`` seconds):

* rc 0: both workers see RANK / LOCAL_RANK / WORLD_SIZE, start the
  process group through ``comm.init_distributed(device="cpu")`` and
  all-reduce their ranks; the script's own arguments reach it;
* a worker whose script raises an exception carrying ``exit_code=118``
  exits 118, and so does the launcher (the JAX launcher's rc contract);
* a worker that crashes (SIGKILL from inside) makes the launcher stop the
  other worker, which would otherwise run on for minutes, and exit
  128 + 9.

``--heartbeat_dir`` gives each worker a heartbeat record, attesting INIT
before the script runs and concluded with EXIT.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = str(Path(__file__).resolve().parents[1])
JOIN_S = 120

SCRIPT = r"""
import json, os, signal, sys, time
import torch
from deepspeed_tpu_torch import comm

mode = sys.argv[1]
env = {k: os.environ[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE")}
comm.init_distributed(device="cpu")
rank = comm.get_rank()
t = comm.all_reduce(torch.tensor([float(rank + 1)]))
with open(f"worker{rank}.json", "w") as f:   # the ranks share one pipe
    json.dump({"env": env, "sum": t.item(), "args": sys.argv[1:]}, f)
if mode == "coded" and rank == 1:
    class IntegrityAbort(RuntimeError):
        exit_code = 118
    raise IntegrityAbort("the run computes wrong numbers")
if mode == "crash" and rank == 1:
    os.kill(os.getpid(), signal.SIGKILL)
if mode == "crash":
    time.sleep(300)             # rank 0: only the launcher stops it
torch.distributed.destroy_process_group()
"""


def _launch(tmp_path, mode, *extra, nproc=2):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(SCRIPT))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "DSTPU_HEARTBEAT_DIR"):
        env.pop(var, None)
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
           "--nproc_per_node", str(nproc),
           "--init_method", f"file://{tmp_path / 'rdv'}",
           *extra, str(script), mode, "--flag"]
    p = subprocess.Popen(cmd, env=env, cwd=str(tmp_path),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    try:
        out, _ = p.communicate(timeout=JOIN_S)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        pytest.fail(f"launch {mode}: not done in {JOIN_S} s")
    return p.returncode, out


def _workers(tmp_path):
    import json
    return [json.loads((tmp_path / f"worker{r}.json").read_text())
            for r in range(2) if (tmp_path / f"worker{r}.json").exists()]


def test_two_workers_rc_0(tmp_path):
    rc, out = _launch(tmp_path, "ok")
    assert rc == 0, out[-3000:]
    ws = _workers(tmp_path)
    assert [w["env"] for w in ws] == [
        {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2"}
        for r in range(2)]
    assert all(w["sum"] == 3.0 and w["args"] == ["ok", "--flag"]
               for w in ws)


def test_worker_exit_code_passes_through(tmp_path):
    rc, out = _launch(tmp_path, "coded")
    assert rc == 118, out[-3000:]
    assert "IntegrityAbort" in out and len(_workers(tmp_path)) == 2


def test_worker_crash_stops_the_others(tmp_path):
    rc, out = _launch(tmp_path, "crash")
    assert rc == 128 + 9, out[-3000:]


def test_heartbeat_raises_naming_roadmap(tmp_path):
    # the heartbeat channel is ported: each worker's record ends EXIT (one
    # worker runs in the launcher's own process)
    rc, out = _launch(tmp_path, "ok", "--heartbeat_dir",
                      str(tmp_path / "hb"), nproc=1)
    assert rc == 0, out[-3000:]
    from deepspeed_tpu_torch.runtime import heartbeat as hb
    recs = hb.read_heartbeats(str(tmp_path / "hb"))
    assert sorted(recs) == [0]
    assert recs[0]["phase"] == hb.PHASE_EXIT
    from deepspeed_tpu_torch.launcher import launch
    with pytest.raises(ValueError, match="master_port"):
        launch.main(["--nnodes", "2", "script.py"])
