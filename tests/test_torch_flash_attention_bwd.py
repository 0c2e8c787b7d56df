"""Port parity: deepspeed_tpu_torch flash attention backward vs the JAX
package.

On CPU tensors the port's backward runs its plain version,
``flash_attention_bwd_reference``. Each case mirrors a case of
``tests/test_flash_attention.py`` and holds, on the same numpy-seeded f32
inputs and cotangent dO, at atol 2e-5 (f32 sums of up to a few hundred
terms in another order):

* (dq, dk, dv) of the plain backward, fed the port's own forward (o, lse),
  against ``jax.vjp`` of the JAX ``flash_attention(interpret=True)`` (its
  custom VJP runs the two backward Pallas kernels) on every row, the
  zero-gradient rows of a query with no live key included;
* the port's differentiable ``flash_attention`` (autograd through
  ``_FlashAttention``) against ``jax.vjp`` of the JAX ``mha_reference`` on
  live rows: dq on rows with a live key; dk and dv wherever no dead query
  row exists (the reference's uniform dead rows add to dk and dv).

Shapes no 16-multiple block tiles send the JAX wrapper to its reference;
those cases carry no dead row. The CUDA kernels are held against the same
plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py``.
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

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _precise_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _qkv(rng, shape, sk=None):
    B, H, S, D = shape
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, H, sk or S, D)).astype(np.float32)
    v = rng.standard_normal((B, H, sk or S, D)).astype(np.float32)
    do = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v, do


def _padding_mask(rng, B, S, min_len):
    lens = rng.integers(min_len, S + 1, size=(B,))
    return (np.arange(S)[None, :] < lens[:, None])[:, None, None, :]


def _block(S, Sk):
    g = math.gcd(S, Sk)
    return max(d for d in range(1, 65) if g % d == 0)


def _check(q, k, v, do, *, causal=True, mask=None, slopes=None, window=0,
           softcap=0.0, expect_dead=False):
    S, Sk = q.shape[2], k.shape[2]
    t = torch.from_numpy
    kw = dict(causal=causal, mask=None if mask is None else t(mask),
              alibi_slopes=slopes, window=window, softcap=softcap)
    before = (tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    o, lse = tfa.flash_attention_fwd(t(q), t(k), t(v), **kw)
    grads = tfa.flash_attention_bwd(t(q), t(k), t(v), o, lse, t(do), **kw)
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == before  # plain version
    dq, dk, dv = (g.numpy() for g in grads)
    blk = _block(S, Sk)

    def jflash(q, k, v):
        return jfa.flash_attention(
            q, k, v, causal=causal,
            mask=None if mask is None else jnp.asarray(mask),
            alibi_slopes=slopes, window=window, softcap=softcap, block_q=blk,
            block_k=blk, block_q_bwd=blk, block_k_bwd=blk, interpret=True)

    _, vjp = jax.vjp(jflash, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    dead = lse.numpy() <= -1e29                      # query rows, no live key
    assert expect_dead == bool(dead.any())
    for name, a, b in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)
    assert np.all(dq[dead] == 0.0) and np.all(jdq[dead] == 0.0)
    return dead


def _check_autograd(q, k, v, do, *, causal=True, mask=None, slopes=None,
                    window=0, softcap=0.0, dead=None):
    """The port's autograd flash_attention vs jax.vjp of mha_reference."""
    S, Sk = q.shape[2], k.shape[2]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal,
                            mask=None if mask is None
                            else torch.from_numpy(mask),
                            alibi_slopes=slopes, window=window,
                            softcap=softcap)
    o.backward(torch.from_numpy(do))
    bias = None if slopes is None else alibi_bias_from_slopes(slopes, S, Sk)
    rmask = None if mask is None else jnp.asarray(mask)
    if window:
        wm = jnp.asarray((np.arange(S)[:, None] + Sk - S
                          - np.arange(Sk)[None, :]) < window)[None, None]
        rmask = wm if rmask is None else rmask & wm

    def ref(q, k, v):
        return mha_reference(q, k, v, causal=causal, bias=bias, mask=rmask,
                             softcap=softcap)

    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    live = ~dead
    np.testing.assert_allclose(tq.grad.numpy()[live], jdq[live], atol=ATOL,
                               rtol=0)
    if not dead.any():
        np.testing.assert_allclose(tk.grad.numpy(), jdk, atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.grad.numpy(), jdv, atol=ATOL, rtol=0)


def _both(args, **kw):
    dead = _check(*args, **kw)
    kw.pop("expect_dead", None)
    _check_autograd(*args, dead=dead, **kw)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 2, 128, 64), (2, 2, 64, 32)])
def test_backward_matches_jax(causal, shape):
    _both(_qkv(np.random.default_rng(0), shape), causal=causal)


def test_cross_length_causal_offset():
    """Sk > S: query i sits at i + Sk - S, the last row sees every key."""
    _both(_qkv(np.random.default_rng(7), (1, 2, 32, 32), sk=96), causal=True)


@pytest.mark.parametrize("causal", [True, False])
def test_padding_mask(causal):
    rng = np.random.default_rng(1)
    args = _qkv(rng, (3, 2, 64, 32))
    _both(args, causal=causal, mask=_padding_mask(rng, 3, 64, 13))


def test_full_qk_mask():
    rng = np.random.default_rng(4)
    args = _qkv(rng, (2, 2, 64, 32))
    m = (rng.random((2, 1, 64, 64)) > 0.3) | np.eye(64, dtype=bool)
    _both(args, causal=False, mask=m)


def test_per_head_mask():
    rng = np.random.default_rng(5)
    args = _qkv(rng, (1, 4, 32, 32))
    m = (rng.random((1, 4, 32, 32)) > 0.4) | np.eye(32, dtype=bool)
    _both(args, causal=True, mask=m)


def test_dead_rows_get_zero_gradients():
    """A batch row with every key masked (key mask), and masked query rows
    inside live tiles ((q, k) mask): zero dq rows on both sides, and the
    dead batch row's keys get zero dk and dv."""
    rng = np.random.default_rng(6)
    args = _qkv(rng, (2, 2, 32, 32))
    m = np.ones((2, 1, 1, 32), bool)
    m[1] = False
    dead = _check(*args, causal=False, mask=m, expect_dead=True)
    assert dead[1].all() and not dead[0].any()
    _check_autograd(*args, causal=False, mask=m, dead=dead)
    valid = np.arange(32) < 25
    qk = (valid[:, None] & valid[None, :])[None, None]
    dead = _check(*args, causal=False, mask=qk, expect_dead=True)
    _check_autograd(*args, causal=False, mask=qk, dead=dead)
    o, lse = tfa.flash_attention_fwd(*(torch.from_numpy(a) for a in args[:3]),
                                     causal=False, mask=torch.from_numpy(m))
    _, dk, dv = tfa.flash_attention_bwd(
        *(torch.from_numpy(a) for a in args[:3]), o, lse,
        torch.from_numpy(args[3]), causal=False, mask=torch.from_numpy(m))
    assert torch.all(dk[1] == 0) and torch.all(dv[1] == 0)


@pytest.mark.parametrize("causal", [True, False])
def test_alibi(causal):
    _both(_qkv(np.random.default_rng(7), (2, 4, 64, 32)), causal=causal,
          slopes=alibi_slopes(4))


@pytest.mark.parametrize("window", [16, 40])
def test_sliding_window(window):
    _both(_qkv(np.random.default_rng(8), (1, 2, 64, 32)), causal=True,
          window=window)


def test_softcap():
    _both(_qkv(np.random.default_rng(9), (2, 2, 64, 32)), causal=True,
          softcap=5.0)


def test_mask_alibi_softcap_window_combined():
    rng = np.random.default_rng(10)
    args = _qkv(rng, (2, 4, 64, 32))
    _both(args, causal=True, mask=_padding_mask(rng, 2, 64, 16),
          slopes=alibi_slopes(4), window=48, softcap=20.0)


def test_masked_cross_length_offset():
    rng = np.random.default_rng(11)
    q, _, _, do = _qkv(rng, (1, 2, 32, 32))
    _, k, v, _ = _qkv(rng, (1, 2, 96, 32))
    _both((q, k, v, do), causal=True, mask=_padding_mask(rng, 1, 96, 50),
          slopes=alibi_slopes(2))


@pytest.mark.parametrize("shape", [(1, 2, 50, 24), (2, 1, 72, 32)])
def test_nondivisible_shapes(shape):
    """Sequences no 16-multiple block tiles: the JAX wrapper differentiates
    its reference; no row is dead (causal, key 0 always live)."""
    rng = np.random.default_rng(12)
    args = _qkv(rng, shape)
    _both(args, causal=True,
          mask=_padding_mask(rng, shape[0], shape[2], shape[2] // 2),
          slopes=alibi_slopes(shape[1]), softcap=15.0)


def test_kernel_wrappers_raise_on_cpu_tensors():
    """The dq and dk/dv kernel wrappers take CUDA tensors only; nothing
    launches."""
    x = torch.randn(1, 2, 16, 64)
    rows = torch.zeros(1, 2, 16)
    before = (tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dq(x, x, x, x, rows, rows)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dkv(x, x, x, x, rows, rows)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention_bwd_dq(*(x.double(),) * 4, rows, rows)
    with pytest.raises(ValueError, match="impl"):
        tfa.flash_attention_bwd(x, x, x, x, rows, x, impl="flash")
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == before


@pytest.mark.parametrize("case", ["causal", "mask_alibi_softcap"])
@pytest.mark.parametrize("D", [80, 96])
def test_head_dims_80_96(D, case):
    """The head dims the CUDA kernels take at a padded width: 80
    (gpt2-2.7b) and 96 (gpt2-760m)."""
    rng = np.random.default_rng(D)
    args = _qkv(rng, (1, 2, 64, D))
    kw = {} if case == "causal" else dict(
        mask=_padding_mask(rng, 1, 64, 20), slopes=alibi_slopes(2),
        softcap=15.0)
    _both(args, causal=True, **kw)


@pytest.mark.parametrize("D", [64, 96])
def test_fp16_close_to_jax_kernel(D):
    """float16 on both sides: the autograd flash_attention (plain forward
    and backward) against jax.vjp of the JAX kernels, each gradient to
    2^-6 of its largest |value| (the 16-bit tolerance of the card's
    checks; the two round scores, P and dS to fp16 at other points)."""
    rng = np.random.default_rng(20 + D)
    q, k, v, do = _qkv(rng, (1, 2, 128, D))
    h = lambda a: torch.from_numpy(a).to(torch.float16)
    tq, tk, tv = (h(a).requires_grad_() for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=True, softcap=10.0)
    o.backward(h(do))

    def jflash(q, k, v):
        return jfa.flash_attention(q, k, v, causal=True, softcap=10.0,
                                   block_q=64, block_k=64, block_q_bwd=64,
                                   block_k_bwd=64, interpret=True)

    _, vjp = jax.vjp(jflash, *(jnp.asarray(a, jnp.float16) for a in (q, k, v)))
    for name, t, jg in zip(("dq", "dk", "dv"), (tq, tk, tv),
                           vjp(jnp.asarray(do, jnp.float16))):
        assert t.grad.dtype == torch.float16 and jg.dtype == jnp.float16
        jg = np.asarray(jg, np.float32)
        np.testing.assert_allclose(t.grad.float().numpy(), jg,
                                   atol=2.0 ** -6 * np.abs(jg).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["causal", "mask_alibi_softcap"])
def test_head_dim_256(case):
    """Gemma's head dim: the CUDA backward takes it with the own rows in
    shared memory and dk/dv split over two column halves."""
    rng = np.random.default_rng(256)
    args = _qkv(rng, (1, 2, 64, 256))
    kw = {} if case == "causal" else dict(
        mask=_padding_mask(rng, 1, 64, 20), slopes=alibi_slopes(2),
        softcap=15.0)
    _both(args, causal=True, **kw)
