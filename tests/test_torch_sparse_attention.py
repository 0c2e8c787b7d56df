"""Port parity: deepspeed_tpu_torch.ops.sparse_attention and the window
route of ops.attention vs the JAX package, on the CPU.

The same numpy-seeded f32 inputs go through both packages. On the CPU the
port's block-sparse wrappers run their plain versions; the JAX side runs
its Pallas kernel in interpret mode (``use_kernel=True, interpret=True``)
or its dense-mask oracle. Tolerances:

* layouts and dense masks: exactly equal (the same numpy code and seeds);
* outputs 2e-5 (the JAX kernel file's forward tolerance: the online
  softmax sums in another order than the dense softmax);
* sliding-window outputs 1e-5 and gradients 5e-4 (the JAX file's
  gradient tolerance for this route: the kernel's backward and autograd
  through the dense softmax sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import attention as jatt
from deepspeed_tpu.ops import sparse_attention as jsa

from deepspeed_tpu_torch.ops import attention as tatt
from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops import sparse_attention as tsa


@pytest.fixture(autouse=True)
def _precise_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


# (mode, kwargs): every family, BigBird both shared and per head
LAYOUTS = [
    ("dense", dict(block=16)),
    ("fixed", dict(block=16, num_local_blocks=4, num_global_blocks=1)),
    ("fixed", dict(block=32, num_local_blocks=2, num_global_blocks=1,
                   attention="unidirectional")),
    ("variable", dict(block=16, local_window_blocks=(2, 4),
                      global_block_indices=(0, 5), num_random_blocks=2,
                      seed=3)),
    ("variable", dict(block=16, attention="unidirectional")),
    ("bigbird", dict(block=16, num_random_blocks=2, seed=7)),
    ("bigbird", dict(block=16, num_random_blocks=2,
                     different_layout_per_head=True, seed=1)),
    ("bslongformer", dict(block=16, num_sliding_window_blocks=3,
                          global_block_indices=(0, 9))),
    ("local_sliding_window", dict(block=16, num_sliding_window_blocks=4)),
    ("local_sliding_window", dict(block=32, num_sliding_window_blocks=3,
                                  attention="bidirectional")),
]
_IDS = [f"{m}-{i}" for i, (m, _) in enumerate(LAYOUTS)]


def _qkv(B=1, H=2, S=256, D=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, H, S, D)) * 0.5).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("mode,kw", LAYOUTS, ids=_IDS)
def test_make_layout_and_dense_mask_match_jax(mode, kw):
    jl = jsa.build_sparsity_config(mode, 3, **kw).make_layout(256)
    tl = tsa.build_sparsity_config(mode, 3, **kw).make_layout(256)
    assert tl.dtype == jl.dtype == bool
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(
        tsa.layout_to_dense_mask(tl, kw["block"]).numpy(),
        np.asarray(jsa.layout_to_dense_mask(jl, kw["block"])))


def test_registry_and_cached_read_only_layout():
    assert sorted(tsa.SPARSITY_CONFIGS) == sorted(jsa.SPARSITY_CONFIGS)
    with pytest.raises(ValueError, match="unknown sparse attention mode"):
        tsa.build_sparsity_config("nope", num_heads=1)
    with pytest.raises(ValueError, match="not divisible"):
        tsa.FixedSparsityConfig(num_heads=1, block=16).make_layout(100)
    cfg = tsa.FixedSparsityConfig(num_heads=2, block=16)
    lay = tsa.config_layout(cfg, 128)
    assert lay is tsa.config_layout(
        tsa.FixedSparsityConfig(num_heads=2, block=16), 128)
    assert not lay.flags.writeable
    np.testing.assert_array_equal(lay, cfg.make_layout(128))


@pytest.mark.parametrize("mode,kw,causal", [
    ("fixed", dict(block=16, attention="unidirectional"), True),
    ("fixed", dict(block=16), False),
    ("bigbird", dict(block=16, num_random_blocks=2,
                     different_layout_per_head=True), False),
    ("bslongformer", dict(block=16), False),
    ("variable", dict(block=32, local_window_blocks=(2, 3)), True),
])
def test_sparse_attention_matches_both_jax_paths(mode, kw, causal):
    q, k, v = _qkv()
    jcfg = jsa.build_sparsity_config(mode, 2, **kw)
    tcfg = tsa.build_sparsity_config(mode, 2, **kw)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    j_kernel = jsa.sparse_attention(jq, jk, jv, jcfg, causal=causal,
                                    use_kernel=True, interpret=True)
    j_mask = jsa.sparse_attention(jq, jk, jv, jcfg, causal=causal,
                                  use_kernel=False)
    before = tbs.block_sparse_attention_fwd.launches
    out = tsa.sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               tcfg, causal=causal)
    assert tbs.block_sparse_attention_fwd.launches == before   # CPU: plain
    for ref in (j_kernel, j_mask):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
    dense = tsa.sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 tcfg, causal=causal, use_kernel=False)
    np.testing.assert_allclose(dense.numpy(), np.asarray(j_mask), rtol=2e-5,
                               atol=2e-5)
    mod = tsa.SparseSelfAttention(tcfg, causal=causal)
    torch.testing.assert_close(
        mod(*(torch.from_numpy(x) for x in (q, k, v))), out)


@pytest.mark.parametrize("W", [1, 37, 64, 100, 256])
def test_sliding_window_attention_matches_jax_with_grads(W):
    q, k, v = _qkv(B=2, H=2, S=256, D=32, seed=5)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))

    def jf(a, b, c):
        return jnp.sum(jatt.sliding_window_attention(a, b, c, W,
                                                     interpret=True) * w)

    jl, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tatt.sliding_window_attention(tq, tk, tv, W)
    jout = jatt.sliding_window_attention(jq, jk, jv, W, interpret=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=5e-4, atol=5e-4)
    # the router sends a pure causal window on the CPU to the same route
    routed = tatt.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=True, window=W)
    np.testing.assert_allclose(routed.numpy(), out.detach().numpy(),
                               rtol=0, atol=0)


def test_untileable_shapes_raise_or_fall_back():
    q, k, v = (torch.from_numpy(x) for x in _qkv(D=12))   # D % 8 != 0
    cfg = tsa.FixedSparsityConfig(num_heads=2, block=16)
    layout = cfg.make_layout(256)
    with pytest.raises(ValueError, match="tile"):
        tbs.block_sparse_flash_attention(q, k, v, layout, 16)
    with pytest.raises(ValueError, match="tile"):
        tsa.sparse_attention(q, k, v, cfg, use_kernel=True)
    assert tbs.tileable(q, k, v, 16, layout) is not None
    # the auto path takes the dense-mask route, as the JAX package's does
    auto = tsa.sparse_attention(q, k, v, cfg)
    ref = jsa.sparse_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                               jsa.FixedSparsityConfig(num_heads=2, block=16),
                               use_kernel=False)
    np.testing.assert_allclose(auto.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    # a window the block-sparse kernels cannot take rides the flash route
    assert not tatt.sliding_window_tileable(q, k, v)
    x = torch.from_numpy(_qkv(S=40)[0])
    assert not tatt.sliding_window_tileable(x, x, x)      # S % 16 != 0
    with pytest.raises(ValueError, match="tile"):
        tatt.sliding_window_attention(q, k, v, 8)
    out = tatt.attention(q, k, v, causal=True, window=8)
    mask = (np.arange(256)[:, None] - np.arange(256)[None, :] < 8)
    jref = jatt.mha_reference(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                              causal=True, mask=jnp.asarray(mask)[None, None])
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), rtol=2e-5,
                               atol=2e-5)


def test_sparse_impl_reaching_the_router_runs_the_reference():
    """The JAX router has no "sparse" branch: such a call runs its
    reference (the model's Block applies the layout before the router)."""
    q, k, v = _qkv(S=64)
    out = tatt.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                         impl="sparse")
    ref = jatt.attention(*(jnp.asarray(x) for x in (q, k, v)), impl="sparse")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
