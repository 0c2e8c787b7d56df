"""The sharded save's agreement across the whole world, on two gloo ranks
of a pipe 2 mesh (a mesh whose ``data`` axis has one rank, as under pipe
2 x expert 2 or pipe 2 x model 2).

The save's two votes (every rank wrote its shard; rank 0 published) must
span the world, not the data group: with a one-rank data group, rank 0
digested another rank's shard while that rank was still writing it, and
the published marker recorded a digest the finished file no longer
matched. Rank 1's shard write is held up by the ``ckpt.write`` failpoint
in ``sleep`` mode, so the old code fails here every time.
"""

import json

import numpy as np

from test_torch_comm import _spawn

WORKER = r"""
import json, os, sys
import torch
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel import mesh
from deepspeed_tpu_torch.runtime import checkpointing as ck
from deepspeed_tpu_torch.testing import chaos

out_dir = sys.argv[1]
comm.init_distributed(device="cpu")
rank = comm.get_rank()
mesh.set_global_mesh(mesh.MeshManager(devices=range(2), pp_size=2))
res = {"rank": rank}
# one rank's veto reaches every rank
res["votes"] = [ck._all_ok(rank != 1), ck._all_ok(True)]
g = torch.Generator().manual_seed(rank)
params = {f"r{rank}/w": torch.randn(64, 64, generator=g)}
opt = {f"m/r{rank}/w": torch.zeros(64, 64)}
if rank == 1:
    chaos.arm("ckpt.write", "sleep", ms=600)
ck.save_checkpoint_sharded(out_dir, "global_step1",
                           ck.TrainState(params=params, opt_state=opt,
                                         step=1))
# the published tag is whole the moment the save returns, on every rank
res["intact"] = ck.verify_tag(os.path.join(out_dir, "global_step1"))
res["files"] = sorted(os.listdir(os.path.join(out_dir, "global_step1")))
print("RESULT " + json.dumps(res), flush=True)
torch.distributed.destroy_process_group()
"""


def test_sharded_save_votes_span_the_world(tmp_path):
    outs = _spawn(WORKER, 2, tmp_path, "save", args=[tmp_path / "ckpt"])
    ranks = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    assert [r["votes"] for r in ranks] == [[False, True]] * 2
    for r in ranks:
        assert r["intact"] is None, r
        assert [f for f in r["files"] if f.startswith("model_states")] == \
            [f"model_states-shard{k}.npz" for k in range(2)]
    from deepspeed_tpu_torch.runtime import checkpointing as ck
    assert ck.resolve_load_tag(str(tmp_path / "ckpt")) == "global_step1"
    meta = json.loads((tmp_path / "ckpt" / "global_step1" /
                       ck.CKPT_META_FILE).read_text())
    assert meta["num_shards"] == 2
    assert np.all([meta["files"][f"model_states-shard{k}.npz"]["size"] > 0
                   for k in range(2)])
