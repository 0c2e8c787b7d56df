"""Port parity: the quantized formats and compression transforms of
deepspeed_tpu_torch against the JAX package, on the CPU.

The same numpy-seeded inputs go through both packages:

* ``ops/quantizer.py`` (symmetric / asymmetric group quant and dequant,
  ``fake_quantize``, ``onebit_compress``, ``pack_signs``), and
  ``quant_format``'s ``block_quant`` / ``block_dequant`` /
  ``fake_quant_act`` (int8 and fp8): bitwise (fp8 within 1e-6); the
  straight-through gradients are the identity on both sides;
* stochastic rounding: unbiased by a statistical check (the generators
  of the two packages differ, so no elementwise comparison);
* every ``compression`` kind on a stacked 2-layer tree at steps before,
  at and after its offset, the bit schedule, ``quantize_groups`` 1 (one
  scale over both layers) and 4 (groups that split the layers), and
  the STE gradients: bitwise, gradients within rtol 1e-5 (the
  loss sums in another order);
* ``apply_layer_reduction``, ``export_int8`` and ``build_moq_spec``;
* ``Eigenvalue`` on the quadratic of ``tests/test_engine_hooks.py``
  (5.0 within 0.05), and its refusal of the flash kernels' graph.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import quant_format as jqf
from deepspeed_tpu.compression import compress as jcomp
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.runtime import quantize as jmoq

from deepspeed_tpu_torch import quant_format as tqf
from deepspeed_tpu_torch.compression import compress as tcomp
from deepspeed_tpu_torch.ops import quantizer as tq
from deepspeed_tpu_torch.runtime import quantize as tmoq
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    if kw:
        np.testing.assert_allclose(got, np.asarray(want), **kw)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------- quantizer

@pytest.mark.parametrize("bits,groups", [(8, 1), (8, 4), (4, 2)])
def test_symmetric_quant_matches_jax(bits, groups):
    x = _x((16, 12), 1)
    x[3] = 0.0                                     # a zero group row
    jqv, js = jq.quantize_symmetric(jnp.asarray(x), bits, groups)
    tqv, ts = tq.quantize_symmetric(_t(x), bits, groups)
    _eq(tqv, jqv)
    _eq(ts, js)
    _eq(tq.dequantize_symmetric(tqv, ts, groups),
        jq.dequantize_symmetric(jqv, js, groups))
    _eq(tq.fake_quantize(_t(x), bits, groups),
        jq.fake_quantize(jnp.asarray(x), bits, groups))


def test_asymmetric_quant_matches_jax():
    x = _x((8, 24), 2)
    jqv, js, jz = jq.quantize_asymmetric(jnp.asarray(x), 8, 4)
    tqv, ts, tz = tq.quantize_asymmetric(_t(x), 8, 4)
    _eq(tqv, jqv)
    _eq(ts, js)
    _eq(tz, jz)
    _eq(tq.dequantize_asymmetric(tqv, ts, tz, 4),
        jq.dequantize_asymmetric(jqv, js, jz, 4))
    _eq(tq.fake_quantize(_t(x), 8, 4, symmetric=False),
        jq.fake_quantize(jnp.asarray(x), 8, 4, symmetric=False))


def test_fake_quantize_straight_through_grad():
    x = _t(_x((6, 8), 3)).requires_grad_(True)
    (tq.fake_quantize(x, 4) * 3.0).sum().backward()
    _eq(x.grad, np.full((6, 8), 3.0, np.float32))
    jg = jax.grad(lambda v: jnp.sum(jq.fake_quantize(v, 4) * 3.0))(
        jnp.asarray(x.detach().numpy()))
    _eq(x.grad, jg)


def test_stochastic_rounding_unbiased():
    """E[q * scale] = x inside the range: the mean of 4096 draws sits
    within 4 standard errors of x (|q - y| <= 1, so a draw's deviation
    is at most one step)."""
    x = _t(_x((64,), 4))
    gen = torch.Generator().manual_seed(7)
    draws = []
    for _ in range(4096):
        q, s = tq.quantize_symmetric(x, 4, stochastic=True, generator=gen)
        draws.append(tq.dequantize_symmetric(q, s))
    d = torch.stack(draws)
    step = float(s[0])
    err = (d.mean(0) - x).abs()
    assert float(err.max()) < 4 * step / np.sqrt(4096)
    # and it rounds: some draws differ from round-to-nearest
    q0, _ = tq.quantize_symmetric(x, 4)
    assert (torch.stack([tq.quantize_symmetric(x, 4, stochastic=True,
                                               generator=gen)[0]
                         for _ in range(8)]) != q0).any()


def test_onebit_and_pack_signs_match_jax_bytes():
    x = _x((64,), 5)
    x[:8] = [0.0, -0.0, 1.0, -1.0, 2.0, -3.0, 0.5, -0.5]
    js, jsc = jq.onebit_compress(jnp.asarray(x))
    ts, tsc = tq.onebit_compress(_t(x))
    _eq(ts, js)
    _eq(tsc, jsc)
    _eq(tq.onebit_decompress(ts, tsc), jq.onebit_decompress(js, jsc))
    jp = jq.pack_signs(jnp.asarray(x))
    tp = tq.pack_signs(_t(x))
    assert tp.dtype == torch.uint8 and tuple(tp.shape) == (8,)
    _eq(tp, jp)                                   # bit j of byte i: 8i + j
    _eq(tq.unpack_signs(tp), jq.unpack_signs(jp))
    _eq(tq.unpack_signs(tp), np.where(x >= 0, 1.0, -1.0))


# -------------------------------------------------------------- quant_format

@pytest.mark.parametrize("L,block", [(512, 256), (300, 256), (40, 16)])
def test_block_quant_and_dequant_match_jax(L, block):
    x = _x((3, L), 6, scale=4.0)
    x[1, :block] = 0.0                             # a zero block: scale 1
    jq_, js, jpad = jqf.block_quant(jnp.asarray(x), 8, block)
    tq_, ts, tpad = tqf.block_quant(_t(x), 8, block)
    assert tpad == jpad
    _eq(tq_, jq_)
    _eq(ts, js)
    _eq(tqf.block_dequant(tq_, ts, tpad), jqf.block_dequant(jq_, js, jpad))
    deq = tqf.block_dequant(tq_, ts, tpad).numpy()
    bound = np.repeat(np.asarray(js), block, axis=-1)[:, :L] / 2 + 1e-7
    assert (np.abs(deq - x) <= bound).all()     # half a step of the block


def test_block_quant_carries_non_finite_in_the_scale():
    x = _x((2, 512), 7)
    x[0, 3], x[1, 300] = np.inf, np.nan
    q, s, pad = tqf.block_quant(_t(x), 8, 256)
    out = tqf.block_dequant(q, s, pad).numpy()
    assert not np.isfinite(out[0, :256]).all()
    assert not np.isfinite(out[1, 256:]).all()
    assert np.isfinite(out[0, 256:]).all() and np.isfinite(out[1, :256]).all()
    assert (q.numpy()[1, 256:] == 0).all()       # NaN cast to int8: zeros


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("L", [256, 200])
def test_fake_quant_act_matches_jax(fmt, L):
    x = _x((2, 5, L), 8, scale=3.0)
    x[0, 0, :] = 0.0
    want = jqf.fake_quant_act(jnp.asarray(x), fmt)
    xt = _t(x).requires_grad_(True)
    got = tqf.fake_quant_act(xt, fmt)
    if fmt == "int8":
        _eq(got, want)
    else:
        _eq(got, want, rtol=1e-6, atol=1e-6)
        assert not np.array_equal(got.detach().numpy(), x)
    (got * 2.0).sum().backward()
    _eq(xt.grad, np.full(x.shape, 2.0, np.float32))
    with pytest.raises(ValueError, match="int8|fp8"):
        tqf.fake_quant_act(xt, "int4")


def test_fake_quant_act_bf16_matches_jax():
    x = _x((4, 256), 9)
    want = np.asarray(jqf.fake_quant_act(jnp.asarray(x, jnp.bfloat16),
                                         "int8").astype(jnp.float32))
    got = tqf.fake_quant_act(_t(x).to(torch.bfloat16), "int8")
    assert got.dtype == torch.bfloat16
    _eq(got.to(torch.float32), want)


# --------------------------------------------------------------- compression

def _group_cfg(kind, offset, **params):
    return {kind: {"shared_parameters": {"enabled": True,
                                         "schedule_offset": offset},
                   "different_groups": {"g": {
                       "params": params,
                       "modules": params.pop("modules", ["kernel"])}}}}


CASES = {
    # one scale over both layers of each stacked kernel (quantize_groups 1)
    "wq8": _group_cfg("weight_quantization", 2, start_bits=8, target_bits=8),
    # groups that split the stacked leaf across its layers, asymmetric,
    # and the 16 -> 8 -> 4 schedule
    "wq_sched": {"weight_quantization": {
        "shared_parameters": {"enabled": True, "schedule_offset": 2,
                              "quantization_type": "asymmetric"},
        "different_groups": {"g": {
            "params": {"start_bits": 16, "target_bits": 4,
                       "quantization_period": 2, "quantize_groups": 4},
            "modules": ["kernel", "embedding"]}}}},
    "sparse": _group_cfg("sparse_pruning", 2, dense_ratio=0.3),
    "row": _group_cfg("row_pruning", 2, dense_ratio=0.5),
    "channel": _group_cfg("channel_pruning", 2, dense_ratio=0.5),
    "head": _group_cfg("head_pruning", 2, dense_ratio=0.5, num_heads=2,
                       modules=["attn_proj/kernel"]),
}


def _tree(seed=10):
    """A 2-layer stacked tree in the JAX layout."""
    return {"blocks": {"attn_proj": {"kernel": _x((2, 16, 8), seed),
                                     "bias": _x((2, 8), seed + 1)},
                       "mlp_fc": {"kernel": _x((2, 8, 32), seed + 2,
                                               scale=2.0)},
                       "ln1": {"scale": _x((2, 8), seed + 3)}},
            "wte": {"embedding": _x((12, 8), seed + 4)}}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("step", [1, 2, 3, 6])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compression_kinds_on_stacked_tree_match_jax(case, step):
    tree = _tree()
    jspec = jcomp.init_compression({"compression_training": CASES[case]})
    tspec = tcomp.init_compression({"compression_training": CASES[case]})
    assert [dataclasses.astuple(g) for g in tspec.groups] == \
        [dataclasses.astuple(g) for g in jspec.groups]
    want = jcomp.apply_compression(_map(jnp.asarray, tree), jspec,
                                   jnp.asarray(step))
    got = tcomp.apply_compression(_map(_t, tree), tspec, step)
    wl, gl = dict(_leaves(want)), dict(_leaves(got))
    changed = 0
    for path, w in wl.items():
        _eq(gl[path], w)
        changed += not np.array_equal(np.asarray(w), dict(_leaves(tree))[path])
    assert (changed > 0) == (step >= 2)           # the offset gates it


def test_quantize_groups_one_spans_the_layers():
    """At quantize_groups=1 one scale spans both layers of the stacked
    leaf: quantizing each layer on its own gives other numbers."""
    spec = tcomp.init_compression({"compression_training": CASES["wq8"]})
    k = _x((2, 16, 8), 11)
    k[1] *= 10.0                           # layer 1 sets the shared absmax
    whole = tcomp.apply_compression({"blocks": {"p": {"kernel": _t(k)}}},
                                    spec, 2)["blocks"]["p"]["kernel"]
    per = torch.stack([tcomp.apply_compression(
        {"p": {"kernel": _t(k[i])}}, spec, 2)["p"]["kernel"]
        for i in range(2)])
    assert not torch.equal(whole[0], per[0])
    _eq(whole, jcomp.apply_compression(
        {"blocks": {"p": {"kernel": jnp.asarray(k)}}},
        jcomp.init_compression({"compression_training": CASES["wq8"]}),
        jnp.asarray(2))["blocks"]["p"]["kernel"])


@pytest.mark.parametrize("case", ["wq_sched", "sparse", "head"])
def test_compression_grads_match_jax(case):
    """STE gradients through the quantizer, the mask's through pruning."""
    tree = _tree(20)
    w = _map(lambda a: _x(a.shape, 30), tree)
    jspec = jcomp.init_compression({"compression_training": CASES[case]})
    tspec = tcomp.init_compression({"compression_training": CASES[case]})

    def jloss(p):
        c = jcomp.apply_compression(p, jspec, jnp.asarray(4))
        return sum(jnp.sum(a * b) ** 2 / 100 for a, b in
                   zip(jax.tree.leaves(c), jax.tree.leaves(
                       _map(jnp.asarray, w))))

    jg = jax.grad(jloss)(_map(jnp.asarray, tree))
    tt = _map(lambda a: _t(a).requires_grad_(True), tree)
    c = tcomp.apply_compression(tt, tspec, 4)
    wt = _map(_t, w)
    cl = [v for _, v in sorted(_leaves(c))]
    wl = [v for _, v in sorted(_leaves(wt))]
    sum((a * b).sum() ** 2 / 100 for a, b in zip(cl, wl)).backward()
    jgl = dict(_leaves(jg))
    for path, leaf in _leaves(tt):
        _eq(leaf.grad, jgl[path], rtol=1e-5, atol=1e-6)


def test_layer_reduction_export_int8_and_moq_spec_match_jax():
    tree = _tree(40)
    got = tcomp.apply_layer_reduction(_map(_t, tree), [1])
    want = jcomp.apply_layer_reduction(_map(jnp.asarray, tree), [1])
    for path, w in _leaves(want):
        _eq(dict(_leaves(got))[path], w)
    spec_cfg = {"compression_training": CASES["wq8"]}
    got = tcomp.export_int8(_map(_t, tree),
                            tcomp.init_compression(spec_cfg))
    want = jcomp.export_int8(_map(jnp.asarray, tree),
                             jcomp.init_compression(spec_cfg))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        _eq(got[k], want[k])
    qt = {"enabled": True,
          "quantize_bits": {"start_bits": 16, "target_bits": 8},
          "quantize_schedule": {"quantize_period": 50, "schedule_offset": 2},
          "quantize_groups": 2, "quantize_algo": {"q_type": "asymmetric"}}
    t, j = tmoq.build_moq_spec(qt), jmoq.build_moq_spec(qt)
    assert [dataclasses.astuple(g) for g in t.groups] == \
        [dataclasses.astuple(g) for g in j.groups]
    assert tmoq.build_moq_spec({"enabled": False}) is None
    with pytest.raises(ValueError, match="layer_reduction"):
        tcomp.apply_layer_reduction({"wte": {}}, [0])


# ---------------------------------------------------------------- eigenvalue

def test_eigenvalue_quadratic():
    """loss = 0.5 x^T A x: the largest |eigenvalue| is 5 (the JAX
    package's ``test_eigenvalue_quadratic_exact``)."""
    rng = np.random.RandomState(0)
    Q, _ = np.linalg.qr(rng.randn(8, 8))
    eigs = np.array([5.0, 3.0, 1.0, 0.5, 0.2, 0.1, 0.05, 0.01])
    A = torch.from_numpy((Q @ np.diag(eigs) @ Q.T).astype(np.float32))

    def loss(ps):
        x = ps[0]
        return 0.5 * x @ A @ x

    got = Eigenvalue(max_iter=200, tol=1e-5).compute_eigenvalue(
        loss, {"x": torch.ones(8)})
    assert abs(got - 5.0) < 0.05, got


def test_eigenvalue_refuses_the_flash_kernels():
    """The flash wrappers' Function is differentiable once: the product
    raises, naming it, on the CPU as on the card (the plain version runs
    inside the same Function here)."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention
    q = torch.randn(1, 2, 8, 8)

    def loss(ps):
        return flash_attention(ps[0], q, q).square().sum()

    with pytest.raises(NotImplementedError, match="flash_attention"):
        Eigenvalue(max_iter=2).compute_eigenvalue(loss, [q.clone()])
