"""Port parity: deepspeed_tpu_torch decode attention vs the JAX package.

The port's wrapper on CPU tensors runs its plain version
(``decode_attention_reference``); each case holds it against the JAX
Pallas kernel in interpret mode on the same numpy-seeded inputs. f32
cases agree to atol 1e-5 (f32 sums in another order). The bf16 case
compares at the JAX test's own 5e-2: the JAX kernel keeps f32 scores,
while both plain versions round q k^T to bf16 first; the port's plain
version also matches the JAX jnp decode math there to 1e-5. The CUDA
kernel is held against the same plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes
from deepspeed_tpu.ops.pallas.decode_attention import \
    decode_attention as jax_decode_attention
from deepspeed_tpu_torch.ops import decode_attention as tda

ATOL = 1e-5
SLOPES = np.asarray(alibi_slopes(4), np.float32)


def _data(B=2, nh=4, T=1, hd=64, max_len=512, cur=200, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, nh, T, hd)).astype(np.float32)
    kc = np.zeros((B, nh, max_len, hd), np.float32)
    vc = np.zeros((B, nh, max_len, hd), np.float32)
    kc[:, :, :cur] = rng.standard_normal((B, nh, cur, hd))
    vc[:, :, :cur] = rng.standard_normal((B, nh, cur, hd))
    return q, kc, vc


def _both(q, kc, vc, cur, dtype=torch.float32, layer_idx=None, window=0,
          slopes=None, softcap=0.0):
    """(port on CPU tensors, JAX kernel in interpret mode), as f32 numpy."""
    port = tda.decode_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(kc).to(dtype),
        torch.from_numpy(vc).to(dtype), cur, window=window,
        layer_idx=layer_idx, alibi_slopes=slopes, softcap=softcap)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ker = jax_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
        jnp.asarray(cur, jnp.int32), window=jnp.asarray(window, jnp.int32),
        layer_idx=None if layer_idx is None else jnp.asarray(layer_idx),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        softcap=softcap, interpret=True)
    return port.float().numpy(), np.asarray(ker, np.float32)


CASES = {
    "T1_cur200": dict(T=1, cur=200),
    "T4_cur300": dict(T=4, cur=300),
    "T8_full": dict(T=8, cur=512),
    "window64": dict(cur=400, window=64),
    "alibi_T4": dict(T=4, cur=300, slopes=SLOPES),
    "softcap": dict(cur=300, softcap=20.0),
    "alibi_softcap_window": dict(cur=400, window=64, slopes=SLOPES,
                                 softcap=15.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_attention_matches_jax_kernel(case):
    kw = dict(CASES[case])
    T, cur = kw.pop("T", 1), kw.pop("cur")
    q, kc, vc = _data(T=T, cur=cur, seed=len(case))
    port, ker = _both(q, kc, vc, cur, **kw)
    np.testing.assert_allclose(port, ker, atol=ATOL, rtol=0)


def test_decode_attention_stacked_layer_idx():
    """The stacked [L, B, nh, max_len, hd] cache read at ``layer_idx``."""
    L, cur = 3, 256
    q, kc, vc = _data(cur=cur, seed=21)
    kcl = np.stack([kc * (li + 1) for li in range(L)])
    vcl = np.stack([vc * 0.5 * (li + 1) for li in range(L)])
    for li in range(L):
        port, ker = _both(q, kcl, vcl, cur, layer_idx=li)
        np.testing.assert_allclose(port, ker, atol=ATOL, rtol=0)


def test_decode_attention_bf16():
    q, kc, vc = _data(cur=300, seed=22)
    port, ker = _both(q, kc, vc, 300, dtype=torch.bfloat16)
    np.testing.assert_allclose(port, ker, atol=5e-2, rtol=0)
    # the plain version is the JAX jnp decode math, bf16 roundings included
    to_bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    k_pos = np.arange(kc.shape[2])
    s = jnp.einsum("bhqd,bhkd->bhqk", to_bf(q), to_bf(kc)).astype(
        jnp.float32) / np.sqrt(64)
    s = jnp.where(jnp.asarray(k_pos < 300)[None, None, None], s, -1e30)
    p = jax.nn.softmax(s, axis=-1).astype(jnp.bfloat16)
    ref = np.asarray(jnp.einsum("bhqk,bhkd->bhqd", p, to_bf(vc)), np.float32)
    np.testing.assert_allclose(port, ref, atol=ATOL, rtol=0)


def test_decode_attention_any_max_len():
    """No tiling constraint on max_len (1000 here, untileable for the TPU
    wrapper); CPU runs never launch."""
    q, kc, vc = _data(max_len=1000, cur=777, seed=23)
    before = tda.decode_attention.launches
    out = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), 777)
    ref = tda.decode_attention_reference(torch.from_numpy(q),
                                         torch.from_numpy(kc),
                                         torch.from_numpy(vc), 777)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert tda.decode_attention.launches == before
    # the live slice alone gives the same answer: dead rows carry nothing
    short = tda.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(kc[:, :, :777].copy()),
        torch.from_numpy(vc[:, :, :777].copy()), 777)
    torch.testing.assert_close(out, short, atol=ATOL, rtol=0)


@pytest.mark.parametrize("T,hd", [(1, 80), (4, 80), (1, 96), (8, 96)])
def test_decode_attention_head_dims_80_96(T, hd):
    """gpt2-2.7b's (80) and gpt2-760m's (96) head dims, which the CUDA
    kernel takes at a padded width, with ALiBi and a window."""
    q, kc, vc = _data(T=T, hd=hd, cur=300, seed=hd + T)
    port, ker = _both(q, kc, vc, 300, window=100, slopes=SLOPES)
    np.testing.assert_allclose(port, ker, atol=ATOL, rtol=0)


@pytest.mark.parametrize("T,hd", [(1, 64), (4, 96)])
def test_decode_attention_fp16(T, hd):
    """float16 on both sides, to 1e-2 (a few fp16 ulps of |o| < 4): the
    JAX kernel keeps f32 scores, the plain version rounds q k^T to fp16
    first."""
    q, kc, vc = _data(T=T, hd=hd, cur=300, seed=30 + T)
    port = tda.decode_attention(*(torch.from_numpy(a).half()
                                  for a in (q, kc, vc)), 300)
    ker = jax_decode_attention(*(jnp.asarray(a, jnp.float16)
                                 for a in (q, kc, vc)),
                               jnp.asarray(300, jnp.int32), interpret=True)
    assert port.dtype == torch.float16 and ker.dtype == jnp.float16
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ker, np.float32),
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("T", [1, 64])
def test_decode_attention_head_dim_256(T):
    """Gemma's head dim at one query (the decode step: 32 threads of 16
    bytes a bf16 row, of 32 bytes an f32 row) and at the most queries a
    call takes (64: queries and rows in shared memory past 48 KB), with
    ALiBi and a window."""
    q, kc, vc = _data(T=T, hd=256, cur=300, seed=256 + T)
    port, ker = _both(q, kc, vc, 300, window=100, slopes=SLOPES)
    np.testing.assert_allclose(port, ker, atol=ATOL, rtol=0)
