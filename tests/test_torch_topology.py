"""The port's process topology and mesh against the JAX package's.

``ProcessTopology``, ``PipeDataParallelTopology``,
``PipeModelDataParallelTopology`` and ``PipelineParallelGrid`` (a copy
in the port) are held output for output to the JAX classes over several
(pp, mp, dp) shapes: every rank's coordinate and rank string, every
axis's peer groups, filters, and every grid accessor. ``MeshManager``'s
group sizes are held to the JAX ``MeshManager`` on the 8-device mesh;
the axes the port does not split yet (pipe, model, seq, expert) raise
naming ROADMAP.md.
"""

import jax
import pytest

from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel import topology as jtopo

from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.parallel import topology as ttopo

SHAPES = [(1, 1, 1), (1, 1, 8), (2, 1, 4), (2, 2, 2), (4, 2, 1), (3, 2, 2)]


def _topos(mod, pp, mp, dp):
    return [mod.ProcessTopology(["pipe", "data", "model"], [pp, dp, mp]),
            mod.PipeDataParallelTopology(pp, dp),
            mod.PipeModelDataParallelTopology(pp, mp, dp),
            mod.ProcessTopology(["x", "y"], [pp * mp, dp])]


def _view(t):
    out = {"world": t.world_size(), "axes": t.get_axis_names(),
           "dims": [t.get_dim(a) for a in t.get_axis_names() + ["none"]],
           "str": str(t)}
    for r in range(t.world_size()):
        c = t.get_coord(r)
        out[f"coord{r}"] = tuple(c)
        out[f"repr{r}"] = t.get_rank_repr(r)
        out[f"repr_all{r}"] = t.get_rank_repr(r, omit_axes=())
        assert t.get_rank(**c._asdict()) == r
    for a in t.get_axis_names() + ["none"]:
        out[f"comm_{a}"] = t.get_axis_comm_lists(a)
    for a in t.get_axis_names():
        for v in range(t.get_dim(a)):
            out[f"filter_{a}{v}"] = t.filter_match(**{a: v})
    return out


@pytest.mark.parametrize("pp,mp,dp", SHAPES)
def test_topologies_match_jax(pp, mp, dp):
    for tt, jt in zip(_topos(ttopo, pp, mp, dp), _topos(jtopo, pp, mp, dp)):
        assert _view(tt) == _view(jt)


@pytest.mark.parametrize("pp,mp,dp", SHAPES)
def test_pipeline_grid_matches_jax(pp, mp, dp):
    getters = ["get_stage_id", "get_data_parallel_id",
               "get_pipe_parallel_rank", "get_data_parallel_rank",
               "get_model_parallel_rank", "get_pipe_parallel_world_size",
               "get_data_parallel_world_size",
               "get_model_parallel_world_size", "pipe_group", "dp_group",
               "is_first_stage", "is_last_stage"]
    for tt, jt in zip(_topos(ttopo, pp, mp, dp)[1:3],
                      _topos(jtopo, pp, mp, dp)[1:3]):
        for r in range(tt.world_size()):
            tg = ttopo.PipelineParallelGrid(tt, r)
            jg = jtopo.PipelineParallelGrid(jt, r)
            for g in getters:
                assert getattr(tg, g)() == getattr(jg, g)(), (g, r)
            for s in range(pp):
                assert tg.stage_to_global(s) == jg.stage_to_global(s)


def test_topology_errors_match_jax():
    for mod in (ttopo, jtopo):
        with pytest.raises(ValueError, match="equal length"):
            mod.ProcessTopology(["a"], [1, 2])
        with pytest.raises(ValueError, match="duplicate"):
            mod.ProcessTopology(["a", "a"], [1, 2])
        with pytest.raises(ValueError, match="expected axes"):
            mod.ProcessTopology(["a", "b"], [1, 2]).get_rank(a=0)


_GETTERS = ["world_size", "get_data_parallel_world_size",
            "get_model_parallel_world_size", "get_pipe_parallel_world_size",
            "get_expert_parallel_world_size",
            "get_sequence_parallel_world_size",
            "get_expert_data_parallel_world_size"]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_group_sizes_match_jax(n):
    devices = jax.devices()[:n]
    jm = jmesh.MeshManager(devices=devices)
    tm = tmesh.MeshManager(devices=list(range(n)))
    assert tm.shape == jm.shape
    for g in _GETTERS:
        tv, jv = getattr(tm, g), getattr(jm, g)
        assert (tv if g == "world_size" else tv()) == \
            (jv if g == "world_size" else jv())
    for b in (8, 16, 64):
        assert tm.local_batch_slice(b) == jm.local_batch_slice(b)
    assert tm.describe() == jm.describe()
    for axes in (tmesh.ZERO_AXES, tmesh.BATCH_AXES, "data", "model"):
        want = 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            want *= jm.shape[a]
        assert tm.axes_size(axes) == want
    assert (tmesh.MESH_AXES, tmesh.ZERO_AXES, tmesh.EXPERT_ZERO_AXES,
            tmesh.BATCH_AXES) == (jmesh.MESH_AXES, jmesh.ZERO_AXES,
                                  jmesh.EXPERT_ZERO_AXES, jmesh.BATCH_AXES)


@pytest.mark.parametrize("axis,kw", [("pipe", {"pp_size": 2}),
                                     ("model", {"tp_size": 2}),
                                     ("seq", {"sp_size": 2}),
                                     ("expert", {"ep_size": 2})])
def test_mesh_axes_other_than_data_raise_naming_roadmap(axis, kw):
    # the JAX mesh takes them
    assert jmesh.MeshManager(devices=jax.devices()[:8], **kw).shape[axis] == 2
    with pytest.raises(NotImplementedError, match=f"'{axis}'.*ROADMAP"):
        tmesh.MeshManager(devices=list(range(8)), **kw)


def test_mesh_errors_match_jax():
    for mod, devs in ((jmesh, jax.devices()[:8]), (tmesh, list(range(8)))):
        with pytest.raises(ValueError, match="not divisible"):
            mod.MeshManager(devices=devs[:6], pp_size=4)
        with pytest.raises(ValueError, match="inconsistent"):
            mod.MeshManager(devices=devs, dp_size=4)


def test_mesh_without_a_process_group():
    """One rank without torch.distributed: sizes answer, groups refuse,
    the global mesh round-trips."""
    mm = tmesh.MeshManager()
    assert mm.world_size == 1 and mm.get_data_parallel_world_size() == 1
    with pytest.raises(RuntimeError, match="no process group"):
        mm.group("data")
    old = tmesh.get_global_mesh()
    try:
        tmesh.set_global_mesh(mm)
        assert tmesh.get_global_mesh() is mm
    finally:
        tmesh.set_global_mesh(old)


def test_mesh_from_config_sizes():
    from deepspeed_tpu_torch.config.config import load_config
    old = tmesh.get_global_mesh()
    try:
        mm = tmesh.build_mesh_from_config(load_config({}),
                                          devices=list(range(4)))
        assert tmesh.get_global_mesh() is mm and mm.shape["data"] == 4
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmesh.build_mesh_from_config(
                load_config({"tensor_parallel": {"tp_size": 2}}),
                devices=list(range(4)))
    finally:
        tmesh.set_global_mesh(old)
