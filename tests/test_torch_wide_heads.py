"""Port parity at head dims above 256, which the CUDA attention kernels take
since their wide forms (``ops/csrc/attention_wide.cuh``,
``ops/csrc/decode_row.cuh``), and the routing of the decode and the
block-sparse dK/dV kernels.

The plain versions (which the wrappers run for CPU tensors) against the
JAX package at D 264 and 512, the JAX side run as its own CPU tests run
it: the Pallas kernels in interpret mode (flash forward and backward by
``jax.vjp``, decode at T 1 and 17, paged, block-sparse forward and
backward), the paged gather reference beside its kernel. f32 throughout,
with JAX matmuls at "highest" precision; tolerances as in the files of
each kernel (atol 1e-5 on outputs, 2e-4 on gradients: f32 sums of D
products in another order). The CUDA kernels at these widths are held
against the same plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes
from deepspeed_tpu.ops.pallas import block_sparse_attention as jbs
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu.ops.pallas.decode_attention import \
    decode_attention as jax_decode_attention
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import paged_attention as tpa

WIDE = [264, 512]


@pytest.fixture(autouse=True)
def _precise_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _rand(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("D", WIDE)
@pytest.mark.parametrize("case", ["causal", "alibi_window_softcap"])
def test_flash_forward_and_backward(D, case):
    """The plain forward and backward against ``jax.vjp`` of the JAX flash
    kernel (interpret mode, blocks of 64 over S 128, so causal tiles are
    skipped): o to 1e-5, dq / dk / dv to 2e-4."""
    rng = np.random.default_rng(D + len(case))
    q, k, v, g = (_rand(rng, 1, 2, 128, D) for _ in range(4))
    kw = {} if case == "causal" else dict(window=40, softcap=20.0)
    slopes = None if case == "causal" else np.asarray(alibi_slopes(2),
                                                      np.float32)

    def jfn(q, k, v):
        return jfa.flash_attention(
            q, k, v, causal=True, block_q=64, block_k=64, block_q_bwd=64,
            block_k_bwd=64, interpret=True,
            alibi_slopes=None if slopes is None else jnp.asarray(slopes),
            **kw)

    jo, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True, alibi_slopes=slopes,
                              **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               atol=1e-5, rtol=0)
    out.backward(torch.from_numpy(g))
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=2e-4, rtol=0)


@pytest.mark.parametrize("D", WIDE)
@pytest.mark.parametrize("T", [1, 17])
def test_decode(D, T):
    """One query (the decode step) and 17 against the JAX decode kernel
    (interpret mode) in a cache of 384 with 250 live rows, with ALiBi and a
    window: to 1e-5."""
    rng = np.random.default_rng(D + T)
    cur, max_len = 250, 384
    q = _rand(rng, 2, 4, T, D, scale=1.0)
    kc = np.zeros((2, 4, max_len, D), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :cur] = _rand(rng, 2, 4, cur, D, scale=1.0)
    vc[:, :, :cur] = _rand(rng, 2, 4, cur, D, scale=1.0)
    slopes = np.asarray(alibi_slopes(4), np.float32)
    port = tda.decode_attention(*(torch.from_numpy(x) for x in (q, kc, vc)),
                                cur, window=100, alibi_slopes=slopes)
    ker = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(cur, jnp.int32), window=jnp.asarray(100, jnp.int32),
        alibi_slopes=jnp.asarray(slopes), interpret=True)
    np.testing.assert_allclose(port.numpy(), np.asarray(ker), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("D", WIDE)
def test_paged(D):
    """One decode query a lane against a block-table pool: the plain version
    against the JAX gather reference and the JAX kernel (interpret mode),
    with a softcap and a window: to 1e-5."""
    rng = np.random.default_rng(D)
    B, nh, nblk, bs, nbk = 3, 2, 16, 16, 5
    kp = _rand(rng, 2, nh, nblk, bs, D, scale=1.0)
    vp = _rand(rng, 2, nh, nblk, bs, D, scale=1.0)
    bt = (rng.permutation(nblk - 1)[:B * nbk] + 1).reshape(B, nbk).astype(
        np.int32)
    lens = np.asarray([1, 37, nbk * bs], np.int32)
    q = _rand(rng, B, nh, 1, D, scale=1.0)
    kw = dict(layer_idx=1, softcap=6.0, window=30)
    port = tpa.paged_attention_reference(
        *(torch.from_numpy(x) for x in (q, kp, vp, bt, lens)), **kw)
    args = [jnp.asarray(x) for x in (q, kp, vp, bt, lens)]
    ref = jpa.paged_attention_reference(*args, **kw)
    ker = jpa.paged_attention(*args, interpret=True, **kw)
    for other in (ref, ker):
        np.testing.assert_allclose(port.numpy(), np.asarray(other),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("D", WIDE)
@pytest.mark.parametrize("causal", [True, False])
def test_block_sparse_forward_and_backward(D, causal):
    """The plain block-sparse forward and backward against ``jax.vjp`` of
    the JAX kernels (interpret mode, blocks of 64, DeepSpeed's fixed
    layout of 16) at S 128: o to 2e-5, gradients to 2e-4 (the file's)."""
    S, H = 128, 2
    layout = jsa.FixedSparsityConfig(
        num_heads=H, block=16, attention="unidirectional").make_layout(S)
    rng = np.random.default_rng(D + causal)
    q, k, v, g = (_rand(rng, 1, H, S, D) for _ in range(4))
    jfn = lambda q, k, v: jbs.block_sparse_flash_attention(
        q, k, v, layout, 16, causal=causal, block_q=64, block_k=64,
        interpret=True)
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tbs.block_sparse_flash_attention(tq, tk, tv, layout, 16,
                                           causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    out.backward(torch.from_numpy(g))
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("T,hd,dtype,want", [
    (1, 64, torch.bfloat16, "row"), (1, 80, torch.float16, "row"),
    (1, 256, torch.float32, "row"), (1, 264, torch.bfloat16, "wide"),
    (2, 64, torch.bfloat16, "mma"), (64, 96, torch.float16, "mma"),
    (17, 256, torch.bfloat16, "mma"), (64, 64, torch.float32, "f32"),
    (17, 512, torch.float32, "wide"), (64, 1024, torch.bfloat16, "wide")])
def test_decode_route(T, hd, dtype, want):
    """Which form of the decode kernel a call takes: a pure function of T,
    the head dim and the dtype."""
    assert tda.route(T, hd, dtype) == want


@pytest.mark.parametrize("B,nh,T,hd,live,expect", [
    (8, 32, 1, 64, 1056, 1),      # the generate step: 256 (b, h) on 132 SMs
    (8, 16, 1, 96, 1056, 2),      # gpt2-760m: 128 (b, h)
    (8, 16, 1, 256, 1056, 2),     # Gemma-7b's heads
    (2, 8, 1, 64, 2048, 8),       # 16 (b, h): the most a cluster holds
    (8, 8, 1, 64, 200, 1),        # short: at least 128 positions a split
    (8, 16, 64, 96, 1056, 1),     # T > 1 is not split
    (2, 4, 1, 512, 2048, 1),      # the wide form splits columns instead
])
def test_decode_split_plan(B, nh, T, hd, live, expect):
    assert tda.split_plan(B, nh, T, hd, live, 132) == expect


@pytest.mark.parametrize("D,dtype,want", [
    (64, torch.bfloat16, "wgmma"), (64, torch.float16, "wgmma"),
    (64, torch.float32, "f32"), (32, torch.bfloat16, "mma"),
    (128, torch.float16, "mma"), (256, torch.bfloat16, "mma"),
    (256, torch.float32, "f32"), (264, torch.bfloat16, "wide"),
    (1024, torch.float32, "wide")])
def test_block_sparse_dkv_route(D, dtype, want):
    """Which form of the block-sparse dK/dV kernel a call takes: the long
    leg's 16-bit D 64 call the persistent wgmma kernel, a pure function of
    the head dim and the dtype."""
    assert tbs.dkv_route(D, dtype) == want
