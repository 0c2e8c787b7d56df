"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import). On the card run
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``. This file
imports no JAX; on a GPU host without JAX pass ``--noconftest`` (the
suite's conftest sets JAX up). Tolerances: in bf16 the plain version
rounds the scores to bf16 before the softmax (as the JAX reference does)
and the kernel keeps them f32, so O(1) outputs may differ by ~3e-2; f32
agrees to rounding (atol 1e-4).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import paged_attention as tpa
from deepspeed_tpu_torch.ops import quant_matmul as tqm
from deepspeed_tpu_torch.quant_format import kv_quantize

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pa(dev, dtype, seed=0, B=5, nh=8, hd=64, bs=32, nblk=48, nbk=8, L=2):
    g = torch.Generator().manual_seed(seed)
    k = torch.randn(L, nh, nblk, bs, hd, generator=g)
    v = torch.randn(L, nh, nblk, bs, hd, generator=g)
    q = torch.randn(B, nh, 1, hd, generator=g)
    bt = (torch.randperm(nblk - 1, generator=g)[:B * nbk] + 1).reshape(B, nbk)
    lens = torch.tensor([1, 33, 100, nbk * bs, 0][:B], dtype=torch.int32)
    cast = lambda t: t.to(dev, dtype)
    return (cast(q), cast(k), cast(v), bt.to(dev, torch.int32), lens.to(dev))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("opts", [{}, {"alibi_slopes": np.linspace(1, .1, 8),
                                       "softcap": 10.0, "window": 40}])
def test_paged_attention_kernel(dev, dtype, atol, opts):
    q, k, v, bt, lens = _pa(dev, dtype)
    out = tpa.paged_attention(q, k, v, bt, lens, layer_idx=1, **opts)
    ref = tpa.paged_attention_reference(q, k, v, bt, lens, layer_idx=1,
                                        **opts)
    torch.cuda.synchronize()
    live = lens > 0
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=atol, rtol=0)
    assert torch.all(out[~live] == 0)


def test_paged_attention_kernel_int8(dev):
    q, k, v, bt, lens = _pa(dev, torch.bfloat16, seed=1)
    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    out = tpa.paged_attention(q, kq, vq, bt, lens, k_scale=ks, v_scale=vs,
                              layer_idx=0)
    ref = tpa.paged_attention_reference(q, kq, vq, bt, lens, k_scale=ks,
                                        v_scale=vs, layer_idx=0)
    torch.cuda.synchronize()
    live = lens > 0
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=3e-2, rtol=0)


@pytest.mark.parametrize("M,K,N", [(8, 2048, 2560), (8, 5632, 2048),
                                   (3, 300, 200), (130, 512, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_kernel(dev, M, K, N, dtype):
    g = torch.Generator().manual_seed(M + K + N)
    w = torch.randn(K, N, generator=g).to(dev)
    x = torch.randn(M, K, generator=g).to(dev, dtype)
    q, s = tqm.pack_kernel(w)
    out = tqm.quant_matmul(x, q, s)
    ref = tqm.quant_matmul_reference(x, q, s)
    torch.cuda.synchronize()
    # f32 sums of K products of O(1) terms: relative to sqrt(K)
    tol = (2e-4 if dtype == torch.float32 else 2e-2) * K ** 0.5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=1e-2)
