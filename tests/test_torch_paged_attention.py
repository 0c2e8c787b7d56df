"""Port parity: deepspeed_tpu_torch paged attention vs the JAX package.

The port's plain version (``paged_attention_reference``, which the port's
wrapper runs for CPU tensors) is held against the JAX gather reference
AND the JAX Pallas kernel in interpret mode, on the same numpy-seeded
inputs in f32, at atol 1e-5 (f32 sums in a different order). The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu.quant_format import kv_quantize as jax_kv_quantize
from deepspeed_tpu_torch.ops import paged_attention as tpa
from deepspeed_tpu_torch.ops.attention import paged_attention as dispatch
from deepspeed_tpu_torch.quant_format import kv_quantize

ATOL = 1e-5


def _data(B=3, nh=4, hd=32, bs=16, num_blocks=24, nbk=6, L=None, T=1,
          seed=0, zero_lane=False):
    rng = np.random.default_rng(seed)
    lead = () if L is None else (L,)
    kp = rng.standard_normal(lead + (nh, num_blocks, bs, hd)).astype(np.float32)
    vp = rng.standard_normal(lead + (nh, num_blocks, bs, hd)).astype(np.float32)
    perm = rng.permutation(num_blocks - 1)[:B * nbk] + 1
    bt = perm.reshape(B, nbk).astype(np.int32)
    lens = rng.integers(T, nbk * bs + 1, size=B).astype(np.int32)
    if zero_lane:
        lens[-1] = 0
    q = rng.standard_normal((B, nh, T, hd)).astype(np.float32)
    return q, kp, vp, bt, lens


def _both(q, kp, vp, bt, lens, kernel=True, q_start=None, **kw):
    """(port plain version, JAX reference, JAX interpret kernel or None)."""
    tkw = {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
               else v) for k, v in kw.items()}
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    t = lambda a: torch.from_numpy(np.array(a))
    port = tpa.paged_attention_reference(
        t(q), t(kp), t(vp), t(bt), t(lens),
        q_start=None if q_start is None else t(q_start), **tkw)
    ref = jpa.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens),
        q_start=None if q_start is None else jnp.asarray(q_start), **jkw)
    ker = None
    if kernel:
        ker = jpa.paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(lens), interpret=True, **jkw)
    return port.numpy(), np.asarray(ref), (None if ker is None
                                           else np.asarray(ker))


def _check(port, ref, ker):
    np.testing.assert_allclose(port, ref, atol=ATOL, rtol=0)
    if ker is not None:
        np.testing.assert_allclose(port, ker, atol=ATOL, rtol=0)


CASES = {
    "ragged": dict(),
    "alibi": dict(alibi_slopes=np.asarray([2.0 ** -(i + 1) for i in range(4)],
                                          np.float32)),
    "softcap": dict(softcap=5.0),
    "window": dict(window=20),
    "alibi_softcap_window": dict(
        alibi_slopes=np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32),
        softcap=8.0, window=37),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_decode_matches_jax_reference_and_kernel(case):
    q, kp, vp, bt, lens = _data(seed=len(case))
    _check(*_both(q, kp, vp, bt, lens, **CASES[case]))


def test_paged_decode_zero_length_lane():
    """A lane with ctx == 0 has no live key: the kernels (TPU and CUDA)
    write zeros, while both gather references softmax over all-masked
    scores (a uniform average). Live lanes agree everywhere."""
    q, kp, vp, bt, lens = _data(zero_lane=True, seed=3)
    port, ref, ker = _both(q, kp, vp, bt, lens)
    _check(port, ref, None)
    _check(port[:-1], ref[:-1], ker[:-1])
    assert np.all(ker[-1] == 0.0) and np.all(np.isfinite(port))


def test_paged_decode_stacked_layer_idx():
    q, kp, vp, bt, lens = _data(L=3, seed=5)
    for li in range(3):
        _check(*_both(q, kp, vp, bt, lens, layer_idx=li, window=0))


def test_paged_decode_int8_pool_with_scales():
    q, kp, vp, bt, lens = _data(L=2, seed=7)
    kq_j, ks_j = jax_kv_quantize(jnp.asarray(kp))
    vq_j, vs_j = jax_kv_quantize(jnp.asarray(vp))
    kq_t, ks_t = kv_quantize(torch.from_numpy(kp))
    # the port's KV format is byte-for-byte the JAX package's
    np.testing.assert_array_equal(kq_t.numpy(), np.asarray(kq_j))
    np.testing.assert_allclose(ks_t.numpy(), np.asarray(ks_j), rtol=1e-6)
    _check(*_both(q, np.asarray(kq_j), np.asarray(vq_j), bt, lens,
                  layer_idx=1, k_scale=np.asarray(ks_j),
                  v_scale=np.asarray(vs_j), softcap=4.0))


def test_paged_prefill_q_start_matches_jax_reference():
    """T > 1 (the prefill form, with padded trailing queries) exists only
    in the gather reference on both sides."""
    q, kp, vp, bt, lens = _data(T=5, seed=11)
    q_start = np.maximum(lens - 3, 0).astype(np.int32)   # 2 padded queries
    _check(*_both(q, kp, vp, bt, lens, kernel=False, q_start=q_start,
                  layer_idx=None, window=9))
    _check(*_both(q, kp, vp, bt, lens, kernel=False))


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    q, kp, vp, bt, lens = _data(seed=13)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, lens)]
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*args, softcap=3.0)
    via_dispatch = dispatch(*args, softcap=3.0)
    ref = tpa.paged_attention_reference(*args, softcap=3.0)
    assert tpa.paged_attention.launches == before
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    torch.testing.assert_close(via_dispatch, ref, atol=0, rtol=0)


@pytest.mark.parametrize("hd", [80, 96])
def test_paged_decode_head_dims_80_96(hd):
    """gpt2-2.7b's (80) and gpt2-760m's (96) head dims, which the CUDA
    kernel takes with padded thread slices: f32 pools and an int8 pool
    with its per-slot scales, ALiBi and a window."""
    q, kp, vp, bt, lens = _data(hd=hd, L=2, seed=hd)
    slopes = np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32)
    _check(*_both(q, kp, vp, bt, lens, layer_idx=1, alibi_slopes=slopes,
                  window=37))
    kq, ks = jax_kv_quantize(jnp.asarray(kp))
    vq, vs = jax_kv_quantize(jnp.asarray(vp))
    _check(*_both(q, np.asarray(kq), np.asarray(vq), bt, lens, layer_idx=0,
                  k_scale=np.asarray(ks), v_scale=np.asarray(vs)))


@pytest.mark.parametrize("hd", [64, 80])
def test_paged_decode_fp16(hd):
    """float16 q and pool on both sides, plain version vs the JAX gather
    reference and the JAX kernel, to 1e-2 (a few fp16 ulps of |o| < 4)."""
    q, kp, vp, bt, lens = _data(hd=hd, seed=40 + hd)
    h = lambda a: np.asarray(a, np.float16)
    port, ref, ker = _both(h(q), h(kp), h(vp), bt, lens, softcap=5.0)
    assert port.dtype == np.float16
    for other in (ref, ker):
        np.testing.assert_allclose(port.astype(np.float32),
                                   np.asarray(other, np.float32), atol=1e-2,
                                   rtol=0)


def test_paged_decode_head_dim_256_bf16():
    """Gemma's head dim with a bf16 query and pool on both sides: the plain
    version against the JAX gather reference and the JAX kernel, to 2e-2
    (a few bf16 ulps of |o| < 2; the two round q k^T and p at other
    points)."""
    q, kp, vp, bt, lens = _data(hd=256, L=2, seed=256)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    slopes = np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32)
    kw = dict(layer_idx=1, window=37)
    port = tpa.paged_attention_reference(
        bf(q), bf(kp), bf(vp), torch.from_numpy(bt), torch.from_numpy(lens),
        alibi_slopes=slopes, **kw)
    assert port.dtype == torch.bfloat16
    jkw = dict(alibi_slopes=jnp.asarray(slopes), **kw)
    ref = jpa.paged_attention_reference(jb(q), jb(kp), jb(vp),
                                        jnp.asarray(bt), jnp.asarray(lens),
                                        **jkw)
    ker = jpa.paged_attention(jb(q), jb(kp), jb(vp), jnp.asarray(bt),
                              jnp.asarray(lens), interpret=True, **jkw)
    for other in (ref, ker):
        np.testing.assert_allclose(port.float().numpy(),
                                   np.asarray(other, np.float32), atol=2e-2,
                                   rtol=0)


def test_paged_decode_head_dim_256_int8_pool():
    """Gemma's head dim over an int8 pool with its per-slot scales."""
    q, kp, vp, bt, lens = _data(hd=256, L=2, seed=257)
    kq, ks = jax_kv_quantize(jnp.asarray(kp))
    vq, vs = jax_kv_quantize(jnp.asarray(vp))
    _check(*_both(q, np.asarray(kq), np.asarray(vq), bt, lens, layer_idx=1,
                  k_scale=np.asarray(ks), v_scale=np.asarray(vs),
                  softcap=6.0))


@pytest.mark.parametrize("B,nh,max_ctx,expect", [
    (8, 32, 1024, 1),       # the serve leg's step: 256 (b, h) on 132 SMs
    (8, 16, 1024, 2),       # 128 (b, h), D 96 x 16 heads
    (8, 4, 2048, 7),        # 32 (b, h)
    (2, 8, 2048, 8),        # 16 (b, h): the most a cluster holds
    (8, 8, 256, 2),         # short contexts: at least 128 positions a split
    (64, 32, 4096, 1),      # 2048 (b, h) fill the card alone
    (1, 8, 64, 1),          # a context shorter than one split's minimum
])
def test_split_plan(B, nh, max_ctx, expect):
    """The kernel's context split, a pure function of the shapes."""
    assert tpa.split_plan(B, nh, max_ctx, 132) == expect
