"""Port parity: deepspeed_tpu_torch flash attention forward vs the JAX package.

The port's wrapper on CPU tensors runs its plain version
(``flash_attention_reference``). Each case mirrors a forward case of
``tests/test_flash_attention.py`` and holds, on the same numpy-seeded f32
inputs, at atol 1e-5 (f32 sums in another order):

* o against JAX ``flash_attention(interpret=True)`` on live rows (rows
  with at least one key to attend);
* lse against the JAX kernel's own ``_fwd`` (interpret mode) on live rows;
* o against the JAX ``mha_reference`` everywhere: a row with no live key is
  zeros from the kernels and a uniform average from both references, so
  the JAX kernel's zeros are asserted where such rows exist.

The CUDA kernel is held against the same plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes
from deepspeed_tpu.ops.attention import alibi_bias_from_slopes, mha_reference
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _precise_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _qkv(rng, shape, sk=None):
    B, H, S, D = shape
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, H, sk or S, D)).astype(np.float32)
    v = rng.standard_normal((B, H, sk or S, D)).astype(np.float32)
    return q, k, v


def _padding_mask(rng, B, S, min_len):
    lens = rng.integers(min_len, S + 1, size=(B,))
    return (np.arange(S)[None, :] < lens[:, None])[:, None, None, :]


def _block(S, Sk):
    g = math.gcd(S, Sk)
    return max(d for d in range(1, 65) if g % d == 0)


def _jax_fwd(q, k, v, causal, mask, slopes, window, softcap):
    """The JAX forward kernel itself (``_fwd``, interpret mode): o, lse."""
    B, H, S, D = q.shape
    Sk = k.shape[2]
    kvm = qkm = None
    per_head = False
    if mask is not None:
        kvm, qkm, per_head = jfa._normalize_mask(jnp.asarray(mask), B, H, S,
                                                 Sk)
    sl3 = None
    if slopes is not None:
        sl3 = jnp.broadcast_to(jnp.tile(jnp.asarray(slopes, jnp.float32),
                                        B)[:, None, None], (B * H, 1, 128))
    blk = _block(S, Sk)
    o, lse = jfa._fwd(jnp.asarray(q).reshape(B * H, S, D),
                      jnp.asarray(k).reshape(B * H, Sk, D),
                      jnp.asarray(v).reshape(B * H, Sk, D), kvm, qkm, sl3, H,
                      causal, 1.0 / math.sqrt(D), blk, blk, window, softcap,
                      per_head, True)
    return (np.asarray(o).reshape(B, H, S, D),
            np.asarray(lse).reshape(B, H, S))


def _check(q, k, v, *, causal=True, mask=None, slopes=None, window=0,
           softcap=0.0, expect_dead=False):
    S, Sk = q.shape[2], k.shape[2]
    t = torch.from_numpy
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(
        t(q), t(k), t(v), causal=causal,
        mask=None if mask is None else t(mask), alibi_slopes=slopes,
        window=window, softcap=softcap)
    assert tfa.flash_attention_fwd.launches == before   # CPU: plain version
    o, lse = o.numpy(), lse.numpy()
    blk = _block(S, Sk)
    jo = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        mask=None if mask is None else jnp.asarray(mask),
        alibi_slopes=slopes, window=window, softcap=softcap, block_q=blk,
        block_k=blk, interpret=True))
    ko, klse = _jax_fwd(q, k, v, causal, mask, slopes, window, softcap)
    live = klse > -1e29                           # rows with a live key
    assert live.any() and (expect_dead == (not live.all()))
    np.testing.assert_allclose(o[live], jo[live], atol=ATOL, rtol=0)
    np.testing.assert_allclose(o[live], ko[live], atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse[live], klse[live], atol=ATOL, rtol=0)
    assert np.all(ko[~live] == 0.0)               # the kernel's zero rows
    # the plain version is the JAX reference everywhere, dead rows included
    bias = (None if slopes is None
            else alibi_bias_from_slopes(slopes, S, Sk))
    rmask = None if mask is None else jnp.asarray(mask)
    if window:
        wm = jnp.asarray((np.arange(S)[:, None] + Sk - S
                          - np.arange(Sk)[None, :]) < window)[None, None]
        rmask = wm if rmask is None else rmask & wm
    ref = np.asarray(mha_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, bias=bias,
                                   mask=rmask, softcap=softcap))
    np.testing.assert_allclose(o, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (2, 2, 128, 32)])
def test_forward_matches_jax(causal, shape):
    _check(*_qkv(np.random.default_rng(0), shape), causal=causal)


def test_cross_length_causal_offset():
    """Sk > S: query i sits at i + Sk - S, the last row sees every key."""
    rng = np.random.default_rng(7)
    _check(*_qkv(rng, (1, 2, 64, 32), sk=192), causal=True)


@pytest.mark.parametrize("causal", [True, False])
def test_padding_mask(causal):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, (3, 2, 128, 32))
    _check(q, k, v, causal=causal, mask=_padding_mask(rng, 3, 128, 23))


def test_full_qk_mask():
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, (2, 2, 128, 32))
    m = (rng.random((2, 1, 128, 128)) > 0.3) | np.eye(128, dtype=bool)
    _check(q, k, v, causal=False, mask=m)


def test_per_head_mask():
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, (1, 4, 64, 32))
    m = (rng.random((1, 4, 64, 64)) > 0.4) | np.eye(64, dtype=bool)
    _check(q, k, v, causal=True, mask=m)


def test_fully_masked_rows():
    """A batch row with every key masked (key mask) and padded query rows
    inside live tiles ((q, k) mask): zeros from the JAX kernel, uniform
    rows from both references; live rows agree."""
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, (2, 2, 64, 32))
    m = np.ones((2, 1, 1, 64), bool)
    m[1] = False
    _check(q, k, v, causal=False, mask=m, expect_dead=True)
    valid = np.arange(64) < 50
    _check(q, k, v, causal=False, mask=(valid[:, None] & valid[None, :])
           [None, None], expect_dead=True)


@pytest.mark.parametrize("causal", [True, False])
def test_alibi(causal):
    rng = np.random.default_rng(7)
    _check(*_qkv(rng, (2, 4, 128, 32)), causal=causal,
           slopes=alibi_slopes(4))


@pytest.mark.parametrize("window", [16, 48])
def test_sliding_window(window):
    _check(*_qkv(np.random.default_rng(8), (1, 2, 128, 32)), causal=True,
           window=window)


def test_softcap():
    _check(*_qkv(np.random.default_rng(9), (2, 2, 128, 32)), causal=True,
           softcap=5.0)


def test_mask_alibi_softcap_window_combined():
    rng = np.random.default_rng(10)
    q, k, v = _qkv(rng, (2, 4, 128, 32))
    _check(q, k, v, causal=True, mask=_padding_mask(rng, 2, 128, 32),
           slopes=alibi_slopes(4), window=96, softcap=20.0)


def test_masked_cross_length_offset():
    rng = np.random.default_rng(11)
    q, _, _ = _qkv(rng, (1, 2, 64, 32))
    _, k, v = _qkv(rng, (1, 2, 192, 32))
    _check(q, k, v, causal=True, mask=_padding_mask(rng, 1, 192, 100),
           slopes=alibi_slopes(2))


@pytest.mark.parametrize("shape", [(1, 2, 100, 24), (2, 1, 144, 32)])
def test_nondivisible_shapes(shape):
    """Sequences that no 16-multiple block tiles: the JAX wrapper sends
    S = 100 to its reference, and the port's kernel masks the edge."""
    rng = np.random.default_rng(12)
    q, k, v = _qkv(rng, shape)
    _check(q, k, v, causal=True,
           mask=_padding_mask(rng, shape[0], shape[2], shape[2] // 2),
           slopes=alibi_slopes(shape[1]), softcap=15.0)


def test_bf16_close_to_jax_kernel():
    """bf16 at the JAX test's tolerance: the JAX kernel keeps f32 scores,
    the plain version rounds q k^T to bf16 first."""
    rng = np.random.default_rng(13)
    q, k, v = _qkv(rng, (2, 2, 128, 64))
    m = _padding_mask(rng, 2, 128, 48)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    o = tfa.flash_attention(bf(q), bf(k), bf(v), causal=False,
                            mask=torch.from_numpy(m), softcap=8.0)
    jo = jfa.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                             causal=False, mask=jnp.asarray(m), softcap=8.0,
                             block_q=64, block_k=64, interpret=True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32),
                               atol=5e-2, rtol=0)


def test_forward_only_and_argument_guards():
    """Inputs that require grad run the forward alone under no_grad
    (outside it the autograd Function: tests/test_torch_flash_attention_bwd.py)."""
    q = torch.randn(1, 2, 16, 32, requires_grad=True)
    k, v = torch.randn(1, 2, 16, 32), torch.randn(1, 2, 16, 32)
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).shape == q.shape
    with pytest.raises(ValueError, match="impl"):
        tfa.flash_attention(q.detach(), k, v, impl="flash")
    with pytest.raises(ValueError, match="broadcast"):
        tfa._normalize_mask(torch.ones(3, 1, 1, 16, dtype=torch.bool), 1, 2,
                            16, 16, "cpu")


@pytest.mark.parametrize("case", ["causal", "mask_alibi_window_softcap"])
@pytest.mark.parametrize("D", [80, 96])
def test_head_dims_80_96(D, case):
    """gpt2-2.7b's head dim (80) and gpt2-760m's (96), which the CUDA
    kernels take at a padded width of 96 and 128."""
    rng = np.random.default_rng(D)
    q, k, v = _qkv(rng, (2, 2, 64, D))
    kw = {} if case == "causal" else dict(
        mask=_padding_mask(rng, 2, 64, 40), slopes=alibi_slopes(2),
        window=40, softcap=20.0)
    _check(q, k, v, causal=True, **kw)


@pytest.mark.parametrize("D", [64, 80])
def test_fp16_close_to_jax_kernel(D):
    """float16 on both sides, to 1e-2: a few fp16 ulps of |o| < 4 (the JAX
    kernel keeps f32 scores, the plain version rounds q k^T to fp16
    first)."""
    rng = np.random.default_rng(14 + D)
    q, k, v = _qkv(rng, (2, 2, 128, D))
    m = _padding_mask(rng, 2, 128, 48)
    h = lambda a: torch.from_numpy(a).to(torch.float16)
    o = tfa.flash_attention(h(q), h(k), h(v), causal=True,
                            mask=torch.from_numpy(m), softcap=8.0)
    jo = jfa.flash_attention(*(jnp.asarray(a, jnp.float16) for a in (q, k, v)),
                             causal=True, mask=jnp.asarray(m), softcap=8.0,
                             block_q=64, block_k=64, interpret=True)
    assert o.dtype == torch.float16 and jo.dtype == jnp.float16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32),
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("case", ["causal", "mask_alibi_window_softcap"])
def test_head_dim_256(case):
    """Gemma's head dim: the CUDA forward takes it in its wgmma kernel
    (no extras) and in its mma.sync kernel with Q in shared memory."""
    rng = np.random.default_rng(256)
    q, k, v = _qkv(rng, (1, 2, 64, 256))
    kw = {} if case == "causal" else dict(
        mask=_padding_mask(rng, 1, 64, 40), slopes=alibi_slopes(2),
        window=40, softcap=20.0)
    _check(q, k, v, causal=True, **kw)
