"""The port's ZeRO sharding policy and TiledLinear against the JAX
package's.

Every leaf of two small ``Transformer`` trees (flax shapes, the scan
layout) gets its compute-parameter, master and gradient spec from both
packages' ``ZeroShardingPolicy`` at ZeRO worlds 2 and 8, stages 0-3, with
and without a persistence threshold: the specs must be equal (the port
canonicalizes as the JAX package does). That covers the shard dim (the
largest one the world divides, the last dim skipped for compute
parameters), ``stage3_param_persistence_threshold`` and the grad floor
``GRAD_SHARD_MIN_ELEMS``. The dims the engine splits on agree with the
specs; at world 1 they name the dim any world would split. ``TiledLinear``
is held to ``nn.Linear`` with its assembled weight and to the JAX
``TiledLinear`` with the same tiles (f32, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import build_model as jbuild_model
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.parallel.mesh import MeshManager
from deepspeed_tpu.runtime.zero import stages as jstages
from deepspeed_tpu.runtime.zero.tiling import TiledLinear as JTiledLinear

from deepspeed_tpu_torch.runtime.zero import stages as tstages
from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear

ARCHS = {
    "gpt2": dict(hidden_size=64, num_layers=2, num_heads=4, vocab_size=256,
                 max_seq_len=64),
    "llama": dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                  vocab_size=250, max_seq_len=64, pos_embed="rotary",
                  norm="rmsnorm", gated_mlp=True, activation="silu",
                  tie_embeddings=False, use_bias=False,
                  mlp_dim_override=200),
}
_SHAPES = {}


def _shapes(arch):
    """{flax path: shape} of the architecture's parameter tree."""
    if arch not in _SHAPES:
        _, cfg = jbuild_model("gpt2-tiny", dtype=jnp.float32, **ARCHS[arch])
        tree = jax.eval_shape(jtr.Transformer(cfg).init,
                              jax.random.PRNGKey(0),
                              {"input_ids": np.zeros((1, 8), np.int32)})
        flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
        _SHAPES[arch] = {"/".join(str(getattr(k, "key", k)) for k in p):
                         tuple(leaf.shape) for p, leaf in flat}
    return _SHAPES[arch]


def _jax_specs(policy, shapes, fn):
    tree = {k: jax.ShapeDtypeStruct(s, jnp.float32)
            for k, s in shapes.items()}
    sh = policy.tree_shardings(tree, fn)
    return {k: tuple(v.spec) for k, v in sh.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("world", [2, 8])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("threshold", [0, 3000])
def test_specs_match_jax(arch, world, stage, threshold):
    shapes = _shapes(arch)
    jp = jstages.ZeroShardingPolicy(
        stage, MeshManager(devices=jax.devices()[:world]),
        param_persistence_threshold=threshold)
    tp = tstages.ZeroShardingPolicy(stage, world,
                                    param_persistence_threshold=threshold)
    for kind in ("param", "master", "grad"):
        want = _jax_specs(jp, shapes, getattr(jp, f"{kind}_spec"))
        got = getattr(tp, f"{kind}_specs")(shapes)
        assert got == want, kind
        for path, shape in shapes.items():
            dim = getattr(tp, f"{kind}_dim")(shape)
            spec = got[path] + (None,) * (len(shape) - len(got[path]))
            named = [i for i, e in enumerate(spec) if e is not None]
            assert named == ([] if dim is None else [dim]), (kind, path)
    # something of every kind is sharded at the stages that shard it
    sharded = {k: any(getattr(tp, f"{k}_spec")(s) for s in shapes.values())
               for k in ("param", "master", "grad")}
    assert sharded == {"param": stage == 3, "master": stage >= 1,
                       "grad": stage >= 2}


def test_policy_rules_match_jax_on_edge_shapes():
    """insert_zero_axes / canonicalize_spec / the persistence and grad
    floors on shapes that probe each rule, at world 4 and a mesh whose
    data axis is 4 (ZERO_AXES canonicalize to "data")."""
    mm = MeshManager(devices=jax.devices()[:4])
    shapes = [(), (3,), (8,), (6, 4), (4, 6), (4, 4), (12, 5), (5, 12),
              (2, 8, 16), (4096, 3), (3, 8192), (2, 4096), (7, 9)]
    for thr in (0, 32, 10 ** 5):
        for stage in range(4):
            jp = jstages.ZeroShardingPolicy(stage, mm,
                                            param_persistence_threshold=thr)
            tp = tstages.ZeroShardingPolicy(stage, 4,
                                            param_persistence_threshold=thr)
            for s in shapes:
                for kind in ("param", "master", "grad"):
                    want = tuple(jstages.canonicalize_spec(
                        getattr(jp, f"{kind}_spec")(s), mm.shape))
                    assert getattr(tp, f"{kind}_spec")(s) == want, (kind, s)
    for s in shapes:
        for last in (False, True):
            want = tuple(jstages.insert_zero_axes(s, None, ("data",), 4,
                                                  avoid_last=last))
            assert tstages.insert_zero_axes(s, None, ("data",), 4,
                                            avoid_last=last) == want
    assert tstages.ZeroShardingPolicy.GRAD_SHARD_MIN_ELEMS == \
        jstages.ZeroShardingPolicy.GRAD_SHARD_MIN_ELEMS


def test_world_one_specs_are_whole_and_dims_name_the_split():
    """At a ZeRO world of one the specs shard nothing (as the JAX package
    says), while the dims give the 1-way split the engine's sharded path
    runs over: the largest dim, the last one skipped for compute
    parameters of >= 2 dims."""
    tp = tstages.ZeroShardingPolicy(3, 1)
    assert tp.param_spec((64, 192)) == () == tp.master_spec((64, 192))
    assert tp.param_dim((64, 192)) == 0 and tp.master_dim((64, 192)) == 1
    assert tp.param_dim((192,)) == 0 and tp.grad_dim((10, 10)) is None
    assert tp.grad_dim((128, 128)) == 0
    assert tstages.ZeroShardingPolicy(2, 1).param_dim((64, 192)) is None
    assert tstages.ZeroShardingPolicy(0, 1).master_dim((64, 192)) is None
    with pytest.raises(ValueError, match="invalid ZeRO stage"):
        tstages.ZeroShardingPolicy(4, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstages.insert_zero_axes((4, 4), (None, "model"), ("data",), 2)


@pytest.mark.parametrize("splits", [(1, 1), (2, 3), (4, 1), (1, 2)])
@pytest.mark.parametrize("bias", [True, False])
def test_tiled_linear_matches_linear_and_jax(splits, bias):
    ins, outs = splits
    g = torch.Generator().manual_seed(ins * 10 + outs)
    tl = TiledLinear(16, 24, in_splits=ins, out_splits=outs, bias=bias,
                     generator=g)
    if bias:
        with torch.no_grad():
            tl.bias.normal_(generator=g)
    x = torch.randn(3, 5, 16, generator=g)
    w = tl.assembled_weight()
    assert tuple(w.shape) == (16, 24)
    lin = torch.nn.Linear(16, 24, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(w.t())
        if bias:
            lin.bias.copy_(tl.bias)
    y = tl(x)
    torch.testing.assert_close(y, lin(x), atol=1e-5, rtol=0)
    # tile kernel_{i}_{j} holds the JAX package's leaf kernel_{i}_{j}
    params = {name.split(".")[0]: p.detach().numpy()
              for name, p in tl.named_parameters()}
    jy = JTiledLinear(features=24, in_splits=ins, out_splits=outs,
                      use_bias=bias).apply({"params": params}, x.numpy())
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5,
                               rtol=0)
    assert sorted(params) == sorted(
        [f"kernel_{i}_{j}" for i in range(ins) for j in range(outs)]
        + (["bias"] if bias else []))
    with pytest.raises(ValueError, match="not divisible"):
        TiledLinear(16, 24, in_splits=3)
