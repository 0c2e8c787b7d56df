"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import). On the card run
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``. This file
imports no JAX; on a GPU host without JAX pass ``--noconftest`` (the
suite's conftest sets JAX up). Tolerances: f32 kernels agree with their
plain versions to rounding (atol 1e-4). A 16-bit (bf16 or fp16) attention
kernel is held against its plain version run on the same values cast to
f32, so both take f32 scores of the same numbers; what is left is the
kernel's rounding of p to the 16-bit type before P V and of its output,
each at most 2^-8 relative (bf16; fp16 2^-11), so every output lies within
2^-6 of its row's largest |o| (the worst seen in simulation at these
shapes is 0.8 x 2^-7). Every attention kernel runs at head dims 80 and 96
(padded widths) and 192 and 256 (Gemma's) beside 32/64/128, and in fp16
beside f32 and bf16. The flash kernel's lse is
f32 statistics of the same f32 scores: atol 1e-4. Rows with no live key
are zeros from the kernel. The flash backward kernels are held the same
way, gradient rows along D; a row whose gradient is zero in exact
arithmetic (the first causal query row) is rounding noise on both sides,
so each row's limit is taken against max(its largest |grad|, 2^-10 x the
tensor's largest). The block-sparse kernels are held the same way; their
gradients' floor is taken against the largest |grad| of dq, dk and dv
together (a window of one key has dq = dk = 0 in exact arithmetic).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import paged_attention as tpa
from deepspeed_tpu_torch.ops import quant_matmul as tqm
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.parallel import ring_attention as tra
from deepspeed_tpu_torch.quant_format import kv_quantize

pytestmark = pytest.mark.cuda

F32_TOL = 1e-4
BF16_ROW_TOL = 2.0 ** -6
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _hold(out, ref, f32, floor=0.0, scale=0.0):
    """f32: |out - ref| <= F32_TOL. 16-bit (ref on the inputs cast to f32):
    |out - ref| <= BF16_ROW_TOL x the largest |ref| of its row (the last
    dim), or x ``floor`` times the tensor's largest |ref| where that is
    more (gradient rows that are zero in exact arithmetic)."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    if f32:
        assert err.max().item() <= F32_TOL, err.max().item()
        return
    row = ref.abs().amax(-1, keepdim=True)
    lo = max(floor * max(row.max().item(), scale), 1e-30)
    ratio = (err / row.clamp_min(lo)).max().item()
    assert ratio <= BF16_ROW_TOL, (ratio, err.max().item())


def _f32(*ts):
    return tuple(t.float() for t in ts)


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [64, 80, 96, 192, 256])
@pytest.mark.parametrize("opts", [{}, {"alibi_slopes": np.linspace(1, .1, 8),
                                       "softcap": 10.0, "window": 40}])
def test_paged_attention_kernel(dev, dtype, hd, opts):
    q, k, v, bt, lens = _pa(dev, dtype, hd=hd)
    out = tpa.paged_attention(q, k, v, bt, lens, layer_idx=1, **opts)
    ref = tpa.paged_attention_reference(*_f32(q, k, v), bt, lens,
                                        layer_idx=1, **opts)
    torch.cuda.synchronize()
    live = lens > 0
    _hold(out[live], ref[live], dtype == torch.float32)
    assert torch.all(out[~live] == 0)


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 80),
                                      (torch.bfloat16, 72),
                                      (torch.float16, 96),
                                      (torch.bfloat16, 256),
                                      (torch.float16, 192)])
def test_paged_attention_kernel_int8(dev, dtype, hd):
    """int8 pools with their per-slot scales at every width (72: rows of
    8-byte slices)."""
    q, k, v, bt, lens = _pa(dev, dtype, seed=1, hd=hd)
    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    out = tpa.paged_attention(q, kq, vq, bt, lens, k_scale=ks, v_scale=vs,
                              layer_idx=0)
    # the kernel's dequantized rows: x * scale rounded to q's dtype
    kd, vd = ((x.float() * s.reshape(x.shape[:-1])[..., None]).to(q.dtype)
              for x, s in ((kq, ks), (vq, vs)))
    ref = tpa.paged_attention_reference(*_f32(q, kd, vd), bt, lens,
                                        layer_idx=0)
    torch.cuda.synchronize()
    live = lens > 0
    _hold(out[live], ref[live], False)


@pytest.mark.parametrize("B,nh,hd,nbk,bs", [
    (8, 32, 64, 32, 32),        # the serve step: unsplit
    (8, 16, 96, 32, 32),        # 128 (b, h): two splits
    (2, 8, 64, 64, 32),         # 16 (b, h): the most splits
    (8, 8, 64, 16, 16),         # short contexts: two splits
    (64, 32, 64, 8, 32),        # a large batch: unsplit
    (4, 8, 128, 3, 32),         # one split's worth of context: unsplit
    (8, 8, 256, 64, 32)])       # Gemma's head dim, four splits
@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_kernel_split_context(dev, B, nh, hd, nbk, bs, int8):
    """The context split against the plain version at split and unsplit
    shapes (split_plan's count), ragged lengths with one lane at 1 and one
    at the table's end; two calls bit-identical."""
    g = torch.Generator().manual_seed(B * nh + hd)
    nblk = B * nbk + 1
    k, v = (torch.randn(1, nh, nblk, bs, hd, generator=g) for _ in range(2))
    q = torch.randn(B, nh, 1, hd, generator=g).to(dev, torch.bfloat16)
    bt = (torch.randperm(nblk - 1, generator=g) + 1).reshape(B, nbk)
    lens = torch.randint(1, nbk * bs + 1, (B,), generator=g)
    lens[0], lens[-1] = 1, nbk * bs
    bt, lens = bt.to(dev, torch.int32), lens.to(dev, torch.int32)
    kw = {}
    if int8:
        (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
        kd, vd = ((x.float() * s.reshape(x.shape[:-1])[..., None]).to(
            torch.bfloat16) for x, s in ((kq, ks), (vq, vs)))
        k, v = kq.to(dev), vq.to(dev)
        kw = {"k_scale": ks.to(dev), "v_scale": vs.to(dev)}
        kd, vd = kd.to(dev), vd.to(dev)
    else:
        k, v = k.to(dev, torch.bfloat16), v.to(dev, torch.bfloat16)
        kd, vd = k, v
    out = tpa.paged_attention(q, k, v, bt, lens, layer_idx=0, **kw)
    again = tpa.paged_attention(q, k, v, bt, lens, layer_idx=0, **kw)
    ref = tpa.paged_attention_reference(*_f32(q, kd, vd), bt, lens,
                                        layer_idx=0)
    torch.cuda.synchronize()
    _hold(out, ref, False)
    assert torch.equal(out, again)


def _qm_inputs(dev, M, K, N, dtype, block=256):
    g = torch.Generator().manual_seed(M + K + N)
    w = torch.randn(K, N, generator=g).to(dev)
    x = torch.randn(M, K, generator=g).to(dev, dtype)
    return (x, *tqm.pack_kernel(w, block))


# the GEMV (M <= 16) and GEMM (M > 16) regimes at their edges, the serving
# leg's decode and prefill shapes, the LM head, a ragged K and N
@pytest.mark.parametrize("M,K,N", [
    (8, 2048, 2560), (8, 5632, 2048), (3, 300, 200), (130, 512, 1000),
    (1, 2048, 2560), (16, 2048, 2560), (17, 2048, 2560), (32, 2048, 2560),
    (96, 2048, 2048), (352, 2048, 5632), (512, 5632, 2048),
    (8, 2048, 32000), (512, 2048, 32000), (8, 300, 1000), (96, 300, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_kernel(dev, M, K, N, dtype):
    x, q, s = _qm_inputs(dev, M, K, N, dtype)
    out = tqm.quant_matmul(x, q, s)
    ref = tqm.quant_matmul_reference(x, q, s)
    torch.cuda.synchronize()
    # f32 sums of K products of O(1) terms: relative to sqrt(K)
    tol = (2e-4 if dtype == torch.float32 else 2e-2) * K ** 0.5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=1e-2)


@pytest.mark.parametrize("M,K,N", [(8, 2048, 2048), (96, 2048, 2048),
                                   (512, 5632, 2048)])
def test_quant_matmul_kernel_split_k_is_bit_identical(dev, M, K, N):
    # split K (a ticketed reduction in split order): two calls agree bit
    # for bit, whichever CTA of a tile arrives last
    x, q, s = _qm_inputs(dev, M, K, N, torch.bfloat16)
    assert tqm._plan(M, N, s.shape[0], build.sm_count(x.device),
                     x.dtype).splits > 1
    a = tqm.quant_matmul(x, q, s)
    b = tqm.quant_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("block", [64, 128, 48, 512, 8, 40, 100])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 2048), (16, 5632, 2048),
                                   (96, 2048, 2560), (512, 2048, 2048),
                                   (3, 300, 200), (130, 512, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_kernel_scale_blocks(dev, block, M, K, N, dtype):
    """Scale blocks other than 256 rows (any block; 8, 40 and 100 cross
    the GEMM's 16-row k steps): each K-block's partial scaled once, K
    split in whole blocks; split calls repeat bit for bit."""
    x, q, s = _qm_inputs(dev, M, K, N, dtype, block)
    out = tqm.quant_matmul(x, q, s)
    again = tqm.quant_matmul(x, q, s)
    ref = tqm.quant_matmul_reference(x, q, s)
    torch.cuda.synchronize()
    tol = (2 ** -7 if dtype == torch.bfloat16 else 2 ** -14) * \
        ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(out, again)


@pytest.mark.parametrize("M", [8, 96])
def test_quant_matmul_kernel_unaligned_rows(dev, M):
    # x and q one element off their 16-byte alignment: plain loads
    x, q, s = _qm_inputs(dev, M, 2048, 2560, torch.bfloat16)

    def offset(t):
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:]
        return o.view_as(t).copy_(t)

    x, q = offset(x), offset(q)
    out = tqm.quant_matmul(x, q, s)
    ref = tqm.quant_matmul_reference(x, q, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=2e-2 * 2048 ** 0.5, rtol=1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,cur", [(1, 1), (1, 700), (5, 300), (64, 1000)])
@pytest.mark.parametrize("opts", [{}, {"alibi_slopes": np.linspace(1, .1, 8),
                                       "softcap": 10.0, "window": 40}])
def test_decode_attention_kernel(dev, dtype, T, cur, opts):
    g = torch.Generator().manual_seed(T + cur)
    k = torch.randn(2, 3, 8, 1000, 64, generator=g).to(dev, dtype)
    v = torch.randn(2, 3, 8, 1000, 64, generator=g).to(dev, dtype)
    q = torch.randn(3, 8, T, 64, generator=g).to(dev, dtype)
    out = tda.decode_attention(q, k, v, cur, layer_idx=1, **opts)
    ref = tda.decode_attention_reference(*_f32(q, k[1], v[1]), cur, **opts)
    torch.cuda.synchronize()
    _hold(out, ref, dtype == torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [8, 32, 80, 96, 128, 192, 256])
@pytest.mark.parametrize("T,cur", [(1, 500), (7, 500), (64, 333)])
def test_decode_attention_kernel_head_dims(dev, dtype, hd, T, cur):
    g = torch.Generator().manual_seed(hd + T)
    k = torch.randn(2, 4, 500, hd, generator=g).to(dev, dtype)
    v = torch.randn(2, 4, 500, hd, generator=g).to(dev, dtype)
    q = torch.randn(2, 4, T, hd, generator=g).to(dev, dtype)
    out = tda.decode_attention(q, k, v, cur)
    ref = tda.decode_attention_reference(*_f32(q, k, v), cur)
    torch.cuda.synchronize()
    _hold(out, ref, dtype == torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [64, 80, 96, 256, 264])
@pytest.mark.parametrize("T", [1, 2, 17, 64])
def test_decode_attention_kernel_routes(dev, dtype, hd, T):
    """Every form of the decode kernel (route: the T = 1 row kernel, the
    mma.sync and f32 forms at T > 1, the wide form above 256), with ALiBi,
    a softcap and a window, in a cache of 700 at cur_len 650; 2 sequences x
    4 heads, so the T = 1 context splits over a cluster."""
    g = torch.Generator().manual_seed(hd * 100 + T)
    k = torch.randn(2, 4, 700, hd, generator=g).to(dev, dtype)
    v = torch.randn(2, 4, 700, hd, generator=g).to(dev, dtype)
    q = torch.randn(2, 4, T, hd, generator=g).to(dev, dtype)
    kw = {"alibi_slopes": np.linspace(1, .1, 4), "softcap": 10.0,
          "window": 300}
    out = tda.decode_attention(q, k, v, 650, **kw)
    ref = tda.decode_attention_reference(*_f32(q, k, v), 650, **kw)
    torch.cuda.synchronize()
    _hold(out, ref, dtype == torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [264, 320, 512, 1024])
def test_attention_kernels_wide_heads(dev, dtype, D):
    """Head dims above 256 (the wide forms): the flash forward and backward,
    decode at T 1 and 17, paged, and the three block-sparse kernels, each
    against its plain version."""
    g = torch.Generator().manual_seed(D)
    q, k, v, do = (torch.randn(1, 2, 200, D, generator=g).mul(.5)
                   .to(dev, dtype) for _ in range(4))
    o, lse = tfa.flash_attention_fwd(q, k, v)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    ro, rlse = tfa.flash_attention_reference(*_f32(q, k, v))
    refs = tfa.flash_attention_bwd_reference(*_f32(q, k, v, o), lse,
                                             do.float())
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    _hold(o, ro, f32)
    torch.testing.assert_close(lse, rlse, atol=F32_TOL, rtol=0)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, f32, floor=2.0 ** -10)
    kc, vc = (torch.randn(2, 3, 400, D, generator=g).to(dev, dtype)
              for _ in range(2))
    for T in (1, 17):
        qd = torch.randn(2, 3, T, D, generator=g).to(dev, dtype)
        out = tda.decode_attention(qd, kc, vc, 333, window=100)
        ref = tda.decode_attention_reference(*_f32(qd, kc, vc), 333,
                                             window=100)
        torch.cuda.synchronize()
        _hold(out, ref, f32)
    qp, kp, vp, bt, lens = _pa(dev, dtype, seed=D, B=4, nh=2, hd=D, L=1)
    out = tpa.paged_attention(qp, kp, vp, bt, lens, layer_idx=0)
    ref = tpa.paged_attention_reference(*_f32(qp, kp, vp), bt, lens,
                                        layer_idx=0)
    torch.cuda.synchronize()
    live = lens > 0
    _hold(out[live], ref[live], f32)
    assert torch.all(out[~live] == 0)
    layout, fine, kw = _bs_layout("fixed16", 2, 256)
    q, k, v, do = (torch.randn(1, 2, 256, D, generator=g).mul(.5)
                   .to(dev, dtype) for _ in range(4))
    o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, fine, **kw)
    delta = (do.float() * o.float()).sum(-1)
    grads = (tbs.block_sparse_attention_bwd_dq(q, k, v, do, lse, delta,
                                               layout, fine, **kw),
             *tbs.block_sparse_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 layout, fine, **kw))
    ro, _ = tbs.block_sparse_attention_reference(*_f32(q, k, v), layout,
                                                 fine, **kw)
    refs = tbs.block_sparse_attention_bwd_reference(
        *_f32(q, k, v, do), lse, delta, layout, fine, **kw)
    torch.cuda.synchronize()
    _hold(o, ro, f32)
    scale = max(r.abs().max().item() for r in refs)
    for out, ref in zip(grads, refs):
        _hold(out, ref, f32, floor=2.0 ** -10, scale=scale)


def test_decode_attention_kernel_generate_shape(dev):
    """The generate leg's call: T 1 at cur_len 1056 in the stacked
    22-layer bf16 cache of 1280 (8 sequences, 32 heads of 64)."""
    g = torch.Generator(device=dev).manual_seed(0)
    k, v = (torch.randn(22, 8, 32, 1280, 64, device=dev,
                        generator=g).to(torch.bfloat16) for _ in range(2))
    q = torch.randn(8, 32, 1, 64, device=dev, generator=g).to(torch.bfloat16)
    out = tda.decode_attention(q, k, v, 1056, layer_idx=21)
    ref = tda.decode_attention_reference(*_f32(q, k[21], v[21]), 1056)
    torch.cuda.synchronize()
    _hold(out, ref, False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 80, 96, 128, 192, 256])
@pytest.mark.parametrize("S,Sk,opts", [
    (256, 256, {}), (200, 200, {"causal": False}), (100, 300, {}),
    (256, 256, {"alibi_slopes": [0.5, 0.25], "window": 64, "softcap": 20.0}),
    (128, 128, {"mask": "key"}), (192, 192, {"mask": "per_head"})])
def test_flash_attention_fwd_kernel(dev, dtype, D, S, Sk, opts):
    g = torch.Generator().manual_seed(S + Sk + D)
    q = torch.randn(2, 2, S, D, generator=g).to(dev, dtype)
    k = torch.randn(2, 2, Sk, D, generator=g).to(dev, dtype)
    v = torch.randn(2, 2, Sk, D, generator=g).to(dev, dtype)
    opts = dict(opts)
    if opts.get("mask") == "key":          # batch row 1: every key masked
        opts["mask"] = torch.zeros(2, 1, 1, Sk, dtype=torch.bool, device=dev)
        opts["mask"][0, ..., :Sk // 2] = True
    elif opts.get("mask") == "per_head":
        opts["mask"] = torch.rand(2, 2, S, Sk, generator=g).to(dev) > 0.4
    o, lse = tfa.flash_attention_fwd(q, k, v, **opts)
    ro, rlse = tfa.flash_attention_reference(*_f32(q, k, v), **opts)
    torch.cuda.synchronize()
    live = rlse > -1e29
    _hold(o[live], ro[live], dtype == torch.float32)
    torch.testing.assert_close(lse[live], rlse[live], atol=F32_TOL, rtol=0)
    assert torch.all(o[~live] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128, 192, 256])
@pytest.mark.parametrize("S,Sk,opts", [
    (256, 256, {}), (200, 200, {"causal": False}), (100, 300, {}),
    (200, 200, {}), (20, 20, {}), (300, 100, {}),
    (256, 256, {"alibi_slopes": [0.5, 0.25], "window": 64, "softcap": 20.0}),
    (128, 128, {"mask": "key"}), (192, 192, {"mask": "per_head"})])
def test_flash_attention_bwd_kernels(dev, dtype, D, S, Sk, opts):
    g = torch.Generator().manual_seed(S + Sk + D + 1)
    q = torch.randn(2, 2, S, D, generator=g).to(dev, dtype)
    k = torch.randn(2, 2, Sk, D, generator=g).to(dev, dtype)
    v = torch.randn(2, 2, Sk, D, generator=g).to(dev, dtype)
    do = torch.randn(2, 2, S, D, generator=g).to(dev, dtype)
    opts = dict(opts)
    if opts.get("mask") == "key":          # batch row 1: every key masked
        opts["mask"] = torch.zeros(2, 1, 1, Sk, dtype=torch.bool, device=dev)
        opts["mask"][0, ..., :Sk // 2] = True
    elif opts.get("mask") == "per_head":
        opts["mask"] = torch.rand(2, 2, S, Sk, generator=g).to(dev) > 0.4
    o, lse = tfa.flash_attention_fwd(q, k, v, **opts)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    refs = tfa.flash_attention_bwd_reference(*_f32(q, k, v, o), lse,
                                             do.float(), **opts)
    torch.cuda.synchronize()
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, dtype == torch.float32, floor=2.0 ** -10)
    dead = lse <= -1e29
    assert torch.all(dq[dead] == 0)
    if opts.get("mask") is not None and opts["mask"].shape[1] == 1 \
            and opts["mask"].shape[2] == 1:
        assert torch.all(dk[1] == 0) and torch.all(dv[1] == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_kernels_bert_large_shape(dev, dtype):
    """The BERT-large legs' calls: [8, 16, 512, 64], non-causal, a ragged
    key-padding mask (live 128..512; the padded query rows still see live
    keys): the forward and both backward kernels."""
    g = torch.Generator().manual_seed(8)
    q, k, v, do = (torch.randn(8, 16, 512, 64, generator=g).to(dev, dtype)
                   for _ in range(4))
    lens = torch.tensor([512, 128, 200, 333, 450, 129, 511, 256])
    mask = (torch.arange(512)[None] < lens[:, None])[:, None, None].to(dev)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=False, mask=mask)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=False,
                                         mask=mask)
    ro, rlse = tfa.flash_attention_reference(*_f32(q, k, v), causal=False,
                                             mask=mask)
    refs = tfa.flash_attention_bwd_reference(*_f32(q, k, v, o), lse,
                                             do.float(), causal=False,
                                             mask=mask)
    torch.cuda.synchronize()
    _hold(o, ro, False)
    torch.testing.assert_close(lse, rlse, atol=F32_TOL, rtol=0)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, False, floor=2.0 ** -10)
    dead = ~mask[:, 0, 0]                  # masked keys get no gradient
    assert torch.all(dk.transpose(1, 2)[dead] == 0)
    assert torch.all(dv.transpose(1, 2)[dead] == 0)


def test_flash_attention_kernels_gpt2_1_3b_zero_shape(dev):
    """The zero leg's calls (gpt2-1.3b under ZeRO-3): [2, 16, 1024, 128],
    causal, bf16: the forward and both backward kernels."""
    g = torch.Generator().manual_seed(128)
    q, k, v, do = (torch.randn(2, 16, 1024, 128, generator=g).to(
        dev, torch.bfloat16) for _ in range(4))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    ro, rlse = tfa.flash_attention_reference(*_f32(q, k, v), causal=True)
    refs = tfa.flash_attention_bwd_reference(*_f32(q, k, v, o), lse,
                                             do.float(), causal=True)
    torch.cuda.synchronize()
    _hold(o, ro, False)
    torch.testing.assert_close(lse, rlse, atol=F32_TOL, rtol=0)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, False, floor=2.0 ** -10)


@pytest.mark.parametrize("nh,dtype", [(16, torch.bfloat16),
                                      (16, torch.float32),
                                      (32, torch.bfloat16)])
def test_flash_attention_kernels_pipeline_stage_shape(dev, nh, dtype):
    """The pp legs' calls, one micro-batch of 1 x 1024 a stage's layer:
    gpt2-1.3b's [1, 16, 1024, 128] in bf16 and in f32 (the pp phase's f32
    parity run), gpt2-6.7b's [1, 32, 1024, 128] in bf16 (``--pp-ranks``);
    causal, the forward and both backward kernels."""
    g = torch.Generator().manual_seed(nh)
    q, k, v, do = (torch.randn(1, nh, 1024, 128, generator=g).to(dev, dtype)
                   for _ in range(4))
    f32 = dtype == torch.float32
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    ro, rlse = tfa.flash_attention_reference(*_f32(q, k, v), causal=True)
    refs = tfa.flash_attention_bwd_reference(*_f32(q, k, v, o), lse,
                                             do.float(), causal=True)
    torch.cuda.synchronize()
    _hold(o, ro, f32)
    torch.testing.assert_close(lse, rlse, atol=F32_TOL, rtol=0)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, f32, floor=2.0 ** -10)


def test_flash_attention_kernels_mpmd_stage_shape(dev):
    """The run leg's MPMD stage workers' call: llama-1.1b's one micro-batch
    of 1 x 1024 a stage's layer, [1, 32, 1024, 64] bf16 causal (the 16-bit
    D 64 train path's ``wgmma`` kernels at one sample), the forward and
    both backward kernels against their plain versions."""
    g = torch.Generator().manual_seed(64)
    q, k, v, do = (torch.randn(1, 32, 1024, 64, generator=g).to(
        dev, torch.bfloat16) for _ in range(4))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    ro, rlse = tfa.flash_attention_reference(*_f32(q, k, v), causal=True)
    refs = tfa.flash_attention_bwd_reference(*_f32(q, k, v, o), lse,
                                             do.float(), causal=True)
    torch.cuda.synchronize()
    _hold(o, ro, False)
    torch.testing.assert_close(lse, rlse, atol=F32_TOL, rtol=0)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, False, floor=2.0 ** -10)


@pytest.mark.parametrize("leg,H,kv,dtype", [
    ("pp2_tp2_llama70b", 32, 4, torch.bfloat16),
    ("pp2_ep2_mixtral", 32, 8, torch.bfloat16),
    ("pp2_data2_gpt2_1_3b", 16, 16, torch.bfloat16),
    ("pp2_mixtral_f32", 32, 8, torch.float32)])
def test_flash_attention_kernels_pipeline_compose_shapes(dev, leg, H, kv,
                                                         dtype):
    """The composed pp legs' calls, one micro-batch of 1 x 1024 a stage's
    layer at D 128: ``--pp-compose tp`` (a tp-2 rank of Llama-2-70B: 32
    query heads over 4 KV heads, each repeated to its 8 query heads
    before the kernel), ``ep`` (Mixtral-8x7B: 32 over 8), ``zero3``
    (gpt2-1.3b: 16 heads) in bf16, and the pp phase's Mixtral piece in
    f32; causal, the forward and both backward kernels."""
    g = torch.Generator().manual_seed(H * kv)
    q, do = (torch.randn(1, H, 1024, 128, generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(1, kv, 1024, 128, generator=g).to(dev, dtype)
            .repeat_interleave(H // kv, dim=1).contiguous() for _ in range(2))
    f32 = dtype == torch.float32
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    ro, rlse = tfa.flash_attention_reference(*_f32(q, k, v), causal=True)
    refs = tfa.flash_attention_bwd_reference(*_f32(q, k, v, o), lse,
                                             do.float(), causal=True)
    torch.cuda.synchronize()
    _hold(o, ro, f32)
    torch.testing.assert_close(lse, rlse, atol=F32_TOL, rtol=0)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, f32, floor=2.0 ** -10)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ring_chunk_step_sp_shape(dev, dtype, causal):
    """The ring's chunk step at an sp = 4 ring's chunk of the sp leg
    ([1, 32, 4096, 64]: the causal diagonal or a full earlier chunk), its
    backward through the flash kernels with the chunk's o and lse, and
    the lse merge of two key halves against the whole call."""
    g = torch.Generator().manual_seed(64)
    q, k, v, do = (torch.randn(1, 32, 4096, 64, generator=g).to(dev, dtype)
                   for _ in range(4))
    kind = "causal" if causal else "full"
    o, lse = tra.chunk_step(q, k, v, kind, 0.125)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    ro, rlse = tfa.flash_attention_reference(*_f32(q, k, v), causal=causal)
    refs = tfa.flash_attention_bwd_reference(*_f32(q, k, v, o), lse,
                                             do.float(), causal=causal)
    torch.cuda.synchronize()
    _hold(o, ro, False)
    torch.testing.assert_close(lse, rlse, atol=F32_TOL, rtol=0)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, False, floor=2.0 ** -10)
    if not causal:          # two halves of the keys, merged by their lse
        parts = [tra.chunk_step(q, k[:, :, h], v[:, :, h], "full", 0.125)
                 for h in (slice(0, 2048), slice(2048, 4096))]
        mo, mlse = tra.merge(parts[0][0].float(), parts[0][1], *parts[1])
        _hold(mo.to(dtype), ro, False)
        torch.testing.assert_close(mlse, rlse, atol=F32_TOL, rtol=0)


def test_ring_chunk_step_one_card_sp_shape(dev):
    """The 1-card sp leg's call, the ring's one chunk step at seq-world 1
    ([1, 32, 16384, 64], causal, bf16), and its backward through the flash
    kernels. The plain version runs 4 heads at a time: the f32 scores of
    all 32 heads would take 34 GB."""
    g = torch.Generator().manual_seed(66)
    q, k, v, do = (torch.randn(1, 32, 16384, 64, generator=g).to(
        dev, torch.bfloat16) for _ in range(4))
    o, lse = tra.chunk_step(q, k, v, "causal", 0.125)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for h in range(0, 32, 4):
        p = slice(h, h + 4)
        ro, rlse = tfa.flash_attention_reference(
            *_f32(q[:, p], k[:, p], v[:, p]), causal=True)
        refs = tfa.flash_attention_bwd_reference(
            *_f32(q[:, p], k[:, p], v[:, p], o[:, p]), lse[:, p],
            do[:, p].float(), causal=True)
        torch.cuda.synchronize()
        _hold(o[:, p], ro, False)
        torch.testing.assert_close(lse[:, p], rlse, atol=F32_TOL, rtol=0)
        for out, ref in zip((dq, dk, dv), refs):
            _hold(out[:, p], ref, False, floor=2.0 ** -10)
        del ro, rlse, refs


@pytest.mark.parametrize("causal", [True, False])
def test_ring_emulation_four_chunks(dev, causal):
    """Four virtual ranks of one [1, 8, 4096, 64] bf16 sample through the
    ring's forward and backward (chunk steps, skips, merge, dK/dV
    accumulation) against the whole call's plain version."""
    g = torch.Generator().manual_seed(65)
    q, k, v, do = (torch.randn(1, 8, 4096, 64, generator=g).to(
        dev, torch.bfloat16) for _ in range(4))
    before = tfa.flash_attention_fwd.launches
    o, dq, dk, dv = tra.emulate_ring(q, k, v, 4, causal=causal, do=do)
    assert tfa.flash_attention_fwd.launches - before == (10 if causal
                                                         else 16)
    ro, lse = tfa.flash_attention_reference(*_f32(q, k, v), causal=causal)
    refs = tfa.flash_attention_bwd_reference(*_f32(q, k, v, o), lse,
                                             do.float(), causal=causal)
    torch.cuda.synchronize()
    _hold(o, ro, False)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, False, floor=2.0 ** -10)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_decode_and_paged_kernels_phi2_shape(dev, dtype):
    """The Phi-2 legs' decode calls, 32 heads of 80: the generate step (4
    sequences at cur_len 1050 in a cache of 1280) and the serve step (8
    lanes of ragged contexts up to 1056 in a pool of 32-token blocks)."""
    g = torch.Generator().manual_seed(80)
    k, v = (torch.randn(2, 4, 32, 1280, 80, generator=g).to(dev, dtype)
            for _ in range(2))
    q = torch.randn(4, 32, 1, 80, generator=g).to(dev, dtype)
    out = tda.decode_attention(q, k, v, 1050, layer_idx=1)
    ref = tda.decode_attention_reference(*_f32(q, k[1], v[1]), 1050)
    torch.cuda.synchronize()
    _hold(out, ref, False)
    B, nbk, bs = 8, 33, 32
    nblk = B * nbk + 1
    kp, vp = (torch.randn(2, 32, nblk, bs, 80, generator=g).to(dev, dtype)
              for _ in range(2))
    q = torch.randn(B, 32, 1, 80, generator=g).to(dev, dtype)
    bt = (torch.randperm(nblk - 1, generator=g) + 1).reshape(B, nbk)
    bt = bt.to(dev, torch.int32)
    lens = torch.tensor([1056, 65, 1, 700, 1024, 300, 999, 128],
                        dtype=torch.int32, device=dev)
    out = tpa.paged_attention(q, kp, vp, bt, lens, layer_idx=1)
    ref = tpa.paged_attention_reference(*_f32(q, kp, vp), bt, lens,
                                        layer_idx=1)
    torch.cuda.synchronize()
    _hold(out, ref, False)


def test_flash_attention_kernels_mixtral_shape(dev):
    """The moe leg's training calls (Mixtral-8x7B: 32 query heads of 128
    over 8 KV heads, each repeated to its 4 query heads before the
    kernel, as the Block does): [2, 32, 1024, 128], causal, bf16."""
    g = torch.Generator().manual_seed(8)
    q, do = (torch.randn(2, 32, 1024, 128, generator=g).to(
        dev, torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(2, 8, 1024, 128, generator=g).to(dev, torch.bfloat16)
            .repeat_interleave(4, dim=1).contiguous() for _ in range(2))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    ro, rlse = tfa.flash_attention_reference(*_f32(q, k, v), causal=True)
    refs = tfa.flash_attention_bwd_reference(*_f32(q, k, v, o), lse,
                                             do.float(), causal=True)
    torch.cuda.synchronize()
    _hold(o, ro, False)
    torch.testing.assert_close(lse, rlse, atol=F32_TOL, rtol=0)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, False, floor=2.0 ** -10)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_and_paged_kernels_mixtral_shape(dev, int8):
    """The moe leg's decode calls, 32 heads of 128 over 8 KV heads
    (repeated in the cache and the pool): the generate step (4 sequences
    at cur_len 1050 in a cache of 1280) and the serve step (8 lanes of
    ragged contexts up to 1056 in a pool of 32-token blocks, bf16 or the
    int8 serve leg's int8 pool)."""
    g = torch.Generator().manual_seed(128)
    rep = lambda t: t.repeat_interleave(4, dim=-3).contiguous()
    if not int8:
        k, v = (rep(torch.randn(2, 4, 8, 1280, 128, generator=g)).to(
            dev, torch.bfloat16) for _ in range(2))
        q = torch.randn(4, 32, 1, 128, generator=g).to(dev, torch.bfloat16)
        out = tda.decode_attention(q, k, v, 1050, layer_idx=1)
        ref = tda.decode_attention_reference(*_f32(q, k[1], v[1]), 1050)
        torch.cuda.synchronize()
        _hold(out, ref, False)
    B, nbk, bs = 8, 33, 32
    nblk = B * nbk + 1
    kp, vp = (torch.randn(2, 8, nblk, bs, 128, generator=g)
              .repeat_interleave(4, dim=1).to(dev, torch.bfloat16)
              for _ in range(2))
    q = torch.randn(B, 32, 1, 128, generator=g).to(dev, torch.bfloat16)
    bt = (torch.randperm(nblk - 1, generator=g) + 1).reshape(B, nbk)
    bt = bt.to(dev, torch.int32)
    lens = torch.tensor([1056, 65, 1, 700, 1024, 300, 999, 128],
                        dtype=torch.int32, device=dev)
    if int8:
        (kq, ks), (vq, vs) = kv_quantize(kp), kv_quantize(vp)
        out = tpa.paged_attention(q, kq, vq, bt, lens, k_scale=ks,
                                  v_scale=vs, layer_idx=1)
        # the kernel's dequantized rows: x * scale rounded to q's dtype
        kp, vp = ((x.float() * sc.reshape(x.shape[:-1])[..., None]).to(
            q.dtype) for x, sc in ((kq, ks), (vq, vs)))
    else:
        out = tpa.paged_attention(q, kp, vp, bt, lens, layer_idx=1)
    ref = tpa.paged_attention_reference(*_f32(q, kp, vp), bt, lens,
                                        layer_idx=1)
    torch.cuda.synchronize()
    _hold(out, ref, False)


# Llama-2-70B under tensor parallelism (the tp leg): a rank's local shapes
# at tp 4 (16 query heads of 128 over 2 KV heads, each repeated to its 8
# query heads before the kernel) and at tp 2 (32 over 4)
@pytest.mark.parametrize("B,H,kv,S", [(4, 16, 2, 1024), (1, 32, 4, 4096),
                                      (2, 64, 8, 1024)])
def test_flash_attention_kernels_llama70b_tp_shapes(dev, B, H, kv, S):
    """The tp leg's prefill at tp 4 ([4, 16, 1024, 128]), its train calls
    at tp 2 ([1, 32, 4096, 128]) and the 1-rank world's ([2, 64, 1024,
    128]); causal bf16, forward and backward."""
    g = torch.Generator().manual_seed(70 + H)
    q, do = (torch.randn(B, H, S, 128, generator=g).to(dev, torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, kv, S, 128, generator=g).to(dev, torch.bfloat16)
            .repeat_interleave(H // kv, dim=1).contiguous() for _ in range(2))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    ro, rlse = tfa.flash_attention_reference(*_f32(q, k, v), causal=True)
    refs = tfa.flash_attention_bwd_reference(*_f32(q, k, v, o), lse,
                                             do.float(), causal=True)
    torch.cuda.synchronize()
    _hold(o, ro, False)
    torch.testing.assert_close(lse, rlse, atol=F32_TOL, rtol=0)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, False, floor=2.0 ** -10)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_and_paged_kernels_llama70b_tp4_shape(dev, int8):
    """The tp leg's decode calls at tp 4: 16 heads of 128 a rank over 2
    KV heads (repeated in the cache and the pool): the generate step (4
    sequences at cur_len 1050 in a cache of 1280) and the serve step (8
    lanes of ragged contexts in a bf16 or int8 pool)."""
    g = torch.Generator().manual_seed(704)
    rep = lambda t: t.repeat_interleave(8, dim=-3).contiguous()
    if not int8:
        k, v = (rep(torch.randn(2, 4, 2, 1280, 128, generator=g)).to(
            dev, torch.bfloat16) for _ in range(2))
        q = torch.randn(4, 16, 1, 128, generator=g).to(dev, torch.bfloat16)
        out = tda.decode_attention(q, k, v, 1050, layer_idx=1)
        ref = tda.decode_attention_reference(*_f32(q, k[1], v[1]), 1050)
        torch.cuda.synchronize()
        _hold(out, ref, False)
    B, nbk, bs = 8, 33, 32
    nblk = B * nbk + 1
    kp, vp = (torch.randn(2, 2, nblk, bs, 128, generator=g)
              .repeat_interleave(8, dim=1).to(dev, torch.bfloat16)
              for _ in range(2))
    q = torch.randn(B, 16, 1, 128, generator=g).to(dev, torch.bfloat16)
    bt = (torch.randperm(nblk - 1, generator=g) + 1).reshape(B, nbk)
    bt = bt.to(dev, torch.int32)
    lens = torch.tensor([1056, 65, 1, 700, 1024, 300, 999, 128],
                        dtype=torch.int32, device=dev)
    if int8:
        (kq, ks), (vq, vs) = kv_quantize(kp), kv_quantize(vp)
        out = tpa.paged_attention(q, kq, vq, bt, lens, k_scale=ks,
                                  v_scale=vs, layer_idx=1)
        kp, vp = ((x.float() * sc.reshape(x.shape[:-1])[..., None]).to(
            q.dtype) for x, sc in ((kq, ks), (vq, vs)))
    else:
        out = tpa.paged_attention(q, kp, vp, bt, lens, layer_idx=1)
    ref = tpa.paged_attention_reference(*_f32(q, kp, vp), bt, lens,
                                        layer_idx=1)
    torch.cuda.synchronize()
    _hold(out, ref, False)


# a tp-4 rank's int8 matmuls of Llama-2-70B: qkv (N 2560), the attention
# projection (K 2048), gate / fc (N 7168), the MLP projection (K 7168) and
# the head (N 8000), at a decode step's and a prefill's rows
@pytest.mark.parametrize("K,N", [(8192, 2560), (2048, 8192), (8192, 7168),
                                 (7168, 8192), (8192, 8000)])
@pytest.mark.parametrize("M", [8, 512])
def test_quant_matmul_kernel_llama70b_tp4_shapes(dev, M, K, N):
    x, q, s = _qm_inputs(dev, M, K, N, torch.bfloat16)
    out = tqm.quant_matmul(x, q, s)
    ref = tqm.quant_matmul_reference(x, q, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2 * K ** 0.5,
                               rtol=1e-2)


def test_flash_attention_autograd_on_the_card(dev):
    """The autograd Function launches the forward and both backward
    kernels once each; its grads match the plain backward."""
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, 4, 256, 64, device=dev, generator=g)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    o = tfa.flash_attention(q, k, v)
    do = torch.randn_like(o)
    o.backward(do)
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == tuple(
                b + 1 for b in before)
    _, lse = tfa.flash_attention_fwd(*(t.detach() for t in (q, k, v)))
    refs = tfa.flash_attention_bwd_reference(
        *_f32(q.detach(), k.detach(), v.detach(), o.detach()), lse,
        do.float())
    torch.cuda.synchronize()
    for t, ref in zip((q, k, v), refs):
        _hold(t.grad, ref, False, floor=2.0 ** -10)


def _bs_layout(name, H, S):
    """(layout, fine block, options) of a block-sparse kernel case."""
    uni = dict(attention="unidirectional")
    if name == "fixed16":
        cfg = tsa.FixedSparsityConfig(num_heads=H, block=16, **uni)
        return tsa.config_layout(cfg, S), 16, {"causal": True}
    if name == "fixed64-causal":            # the long leg's layout
        cfg = tsa.FixedSparsityConfig(num_heads=H, block=64, **uni)
        return tsa.config_layout(cfg, S), 64, {"causal": True}
    if name == "fixed64-bi":
        cfg = tsa.FixedSparsityConfig(num_heads=H, block=64,
                                      num_local_blocks=2)
        return tsa.config_layout(cfg, S), 64, {}
    if name == "bigbird":
        cfg = tsa.BigBirdSparsityConfig(num_heads=H, block=16,
                                        num_random_blocks=2,
                                        different_layout_per_head=True)
        return tsa.config_layout(cfg, S), 16, {}
    if name == "longformer":
        cfg = tsa.BSLongformerSparsityConfig(num_heads=H, block=32)
        return tsa.config_layout(cfg, S), 32, {"causal": True}
    if name == "variable":
        cfg = tsa.VariableSparsityConfig(num_heads=H, block=16,
                                         local_window_blocks=(2, 4),
                                         num_random_blocks=1, **uni)
        return tsa.config_layout(cfg, S), 16, {"causal": True}
    if name.startswith("window"):
        W = int(name[6:])
        fine = 64 if S % 64 == 0 else 16
        blocks = -(-(W - 1) // fine) + 1 if W > 1 else 1
        cfg = tsa.LocalSlidingWindowSparsityConfig(
            num_heads=H, block=fine, num_sliding_window_blocks=blocks)
        return (tsa.config_layout(cfg, S), fine,
                {"causal": True, "window": W, "layout_exact": False})
    assert name == "dead"
    lay = np.ones((H, S // 16, S // 16), dtype=bool)
    lay[:, 3, :] = False                    # query block 3 sees no key
    lay[0, :, 6] = False                    # key block 6 of head 0: nobody
    return lay, 16, {}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128, 192, 256])
@pytest.mark.parametrize("name,S", [
    ("fixed16", 512), ("fixed64-bi", 512), ("bigbird", 400),
    ("longformer", 512), ("variable", 496), ("window1", 512),
    ("window100", 400), ("dead", 512)])
def test_block_sparse_attention_kernels(dev, dtype, D, name, S):
    H = 4
    layout, fine, kw = _bs_layout(name, H, S)
    g = torch.Generator().manual_seed(S + D)
    q, k, v, do = (torch.randn(2, H, S, D, generator=g).to(dev, dtype)
                   for _ in range(4))
    o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, fine, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dq = tbs.block_sparse_attention_bwd_dq(q, k, v, do, lse, delta, layout,
                                           fine, **kw)
    dk, dv = tbs.block_sparse_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                layout, fine, **kw)
    qf, kf, vf, dof = _f32(q, k, v, do)
    ro, rlse = tbs.block_sparse_attention_reference(qf, kf, vf, layout, fine,
                                                    **kw)
    refs = tbs.block_sparse_attention_bwd_reference(qf, kf, vf, dof, lse,
                                                    delta, layout, fine, **kw)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    _hold(o, ro, f32)
    live = rlse > -1e29
    torch.testing.assert_close(lse[live], rlse[live], atol=F32_TOL, rtol=0)
    scale = max(r.abs().max().item() for r in refs)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, f32, floor=2.0 ** -10, scale=scale)
    assert torch.all(o[~live] == 0) and torch.all(dq[~live] == 0)
    if name == "dead":
        assert not live[:, :, 48:64].any()
        assert torch.all(dk[:, 0, 96:112] == 0)
        assert torch.all(dv[:, 0, 96:112] == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H", [(1, 32), (2, 16)])
def test_block_sparse_attention_kernels_many_items(dev, dtype, B, H):
    """The persistent wgmma kernels (the 16-bit D 64 routes) where the
    items outnumber the CTAs several times (B x H x 32 query or key tiles
    over 2 CTAs an SM), so that each CTA walks many items and its ring of
    K / V (or Q / dO) tiles runs on across them: fixed-64 causal at S 2048,
    all three kernels against their plain versions with the file's
    tolerances, and a repeat of each bit-identical (each item owns its
    rows: no atomics)."""
    S, D = 2048, 64
    layout, fine, kw = _bs_layout("fixed64-causal", H, S)
    sched = tbs.schedule(layout, fine, S, device=dev, **kw)
    assert B * H * sched.visited.shape[1] >= 3 * tbs.CTAS_PER_SM * \
        build.sm_count(dev)
    assert {tbs.fwd_route(D, dtype), tbs.dq_route(D, dtype),
            tbs.dkv_route(D, dtype)} == {"wgmma"}
    g = torch.Generator().manual_seed(B * H)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g).to(dev, dtype)
                   for _ in range(4))

    def run():
        o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, fine, **kw)
        delta = (do.float() * o.float()).sum(-1)
        dq = tbs.block_sparse_attention_bwd_dq(q, k, v, do, lse, delta,
                                               layout, fine, **kw)
        dk, dv = tbs.block_sparse_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                    layout, fine, **kw)
        return o, lse, delta, dq, dk, dv

    o, lse, delta, dq, dk, dv = run()
    qf, kf, vf, dof = _f32(q, k, v, do)
    ro, rlse = tbs.block_sparse_attention_reference(qf, kf, vf, layout, fine,
                                                    **kw)
    refs = tbs.block_sparse_attention_bwd_reference(qf, kf, vf, dof, lse,
                                                    delta, layout, fine, **kw)
    torch.cuda.synchronize()
    _hold(o, ro, False)
    torch.testing.assert_close(lse, rlse, atol=F32_TOL, rtol=0)
    scale = max(r.abs().max().item() for r in refs)
    for out, ref in zip((dq, dk, dv), refs):
        _hold(out, ref, False, floor=2.0 ** -10, scale=scale)
    for a, b in zip((o, lse, delta, dq, dk, dv), run()):
        assert torch.equal(a, b)


def test_block_sparse_routes_launch_on_the_card(dev):
    """sparse_attention and the window route through the autograd Function
    launch each kernel once per call, the 16-bit D 64 calls by the wgmma
    routes; grads match the plain backward; a CUDA tensor the kernels
    cannot take raises."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(1, 4, 512, 64, device=dev, generator=g)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    assert {tbs.fwd_route(64, q.dtype), tbs.dq_route(64, q.dtype),
            tbs.dkv_route(64, q.dtype)} == {"wgmma"}
    names = ("block_sparse_attention_fwd", "block_sparse_attention_bwd_dq",
             "block_sparse_attention_bwd_dkv")
    cfg = tsa.FixedSparsityConfig(num_heads=4, block=64,
                                  attention="unidirectional")
    from deepspeed_tpu_torch.ops.attention import attention
    for run in (lambda: tsa.sparse_attention(q, k, v, cfg, causal=True),
                lambda: attention(q, k, v, causal=True, window=100)):
        before = [getattr(tbs, n).launches for n in names]
        o = run()
        do = torch.randn_like(o)
        grads = torch.autograd.grad(o, (q, k, v), do)
        assert [getattr(tbs, n).launches for n in names] == \
            [b + 1 for b in before]
        assert all(torch.isfinite(t.float()).all() for t in grads)
    layout = tsa.config_layout(cfg, 512)
    q2 = torch.randn(1, 4, 512, 12, device=dev)
    with pytest.raises(ValueError, match="tile.*ROADMAP.md"):
        tbs.block_sparse_attention_fwd(q2, q2, q2, layout, 64)
    q2 = torch.randn(1, 4, 512, 64, device=dev).double()
    with pytest.raises(ValueError, match="tile"):
        tbs.block_sparse_attention_fwd(q2, q2, q2, layout, 64)


# ------------------------- the rest of TP: uneven heads, off-grid int8 rows


@pytest.mark.parametrize("nh", [17, 18])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_uneven_head_shards(dev, nh, dtype):
    """A Falcon-7B rank at tp 4 (18 or 17 query heads of 64 over its one
    KV head, repeated before the kernels): paged, decode and the flash
    forward and backward against their plain versions."""
    g = torch.Generator().manual_seed(nh)
    rep = lambda t, d: t.expand(*t.shape[:d], nh, *t.shape[d + 1:]).contiguous()
    q, k, v, bt, lens = _pa(dev, dtype, nh=1, hd=64)
    q = torch.randn(q.shape[0], nh, 1, 64, generator=g).to(dev, dtype)
    k, v = rep(k, 1), rep(v, 1)
    out = tpa.paged_attention(q, k, v, bt, lens, layer_idx=1)
    ref = tpa.paged_attention_reference(*_f32(q, k, v), bt, lens, layer_idx=1)
    live = lens > 0
    _hold(out[live], ref[live], dtype == torch.float32)
    kc = rep(torch.randn(2, 3, 1, 600, 64, generator=g).to(dev, dtype), 2)
    vc = rep(torch.randn(2, 3, 1, 600, 64, generator=g).to(dev, dtype), 2)
    qd = torch.randn(3, nh, 1, 64, generator=g).to(dev, dtype)
    _hold(tda.decode_attention(qd, kc, vc, 500, layer_idx=1),
          tda.decode_attention_reference(*_f32(qd, kc[1], vc[1]), 500),
          dtype == torch.float32)
    S = 256
    qf = torch.randn(2, nh, S, 64, generator=g).to(dev, dtype)
    kf = rep(torch.randn(2, 1, S, 64, generator=g).to(dev, dtype), 1)
    vf = rep(torch.randn(2, 1, S, 64, generator=g).to(dev, dtype), 1)
    do = torch.randn(2, nh, S, 64, generator=g).to(dev, dtype)
    o, lse = tfa.flash_attention_fwd(qf, kf, vf, causal=True)
    ro, rlse = tfa.flash_attention_reference(*_f32(qf, kf, vf), causal=True)
    _hold(o, ro, dtype == torch.float32)
    torch.testing.assert_close(lse, rlse, atol=F32_TOL, rtol=0)
    grads = tfa.flash_attention_bwd(qf, kf, vf, o, lse, do, causal=True)
    refs = tfa.flash_attention_bwd_reference(*_f32(qf, kf, vf, o), lse,
                                             do.float(), causal=True)
    torch.cuda.synchronize()
    for out, ref in zip(grads, refs):
        _hold(out, ref, dtype == torch.float32, floor=2.0 ** -10)


@pytest.mark.parametrize("K,N,block", [(1408, 2048, 128), (1152, 4544, 128),
                                       (1088, 4544, 64), (4544, 4544, 64)])
@pytest.mark.parametrize("M", [8, 96])
def test_quant_matmul_kernel_off_grid_row_shards(dev, K, N, block, M):
    """A tensor-parallel rank's row shard off the 256-row grid, packed at
    the finer block (llama-1.1b's mlp_proj at tp 4; Falcon-7B's attn_proj
    and mlp_proj at tp 4): the kernel against its plain version, and two
    calls bit for bit."""
    x, q, s = _qm_inputs(dev, M, K, N, torch.bfloat16, block)
    out = tqm.quant_matmul(x, q, s)
    again = tqm.quant_matmul(x, q, s)
    ref = tqm.quant_matmul_reference(x, q, s)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= \
        2 ** -7 * ref.float().abs().max().item()
    assert torch.equal(out, again)
