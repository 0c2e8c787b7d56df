"""Port parity: deepspeed_tpu_torch blockwise-int8 matmul vs the JAX package.

``pack_kernel`` must produce the JAX package's bytes exactly (and its
scales to rtol 1e-6); the port's plain matmul (which its wrapper runs for
CPU tensors) must match JAX ``quant_matmul_reference`` and the JAX Pallas
kernel in interpret mode to rtol 1e-5 in f32 (the same per-block sums,
reduced in another order). The CUDA kernel is held against the plain
version on the card by ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import quant_matmul as jqm
from deepspeed_tpu_torch.ops import quant_matmul as tqm


@pytest.mark.parametrize("K,N,lead", [(300, 128, (5,)), (512, 256, (2, 3)),
                                      (256, 96, (4,))])
def test_pack_and_matmul_match_jax(K, N, lead):
    rng = np.random.default_rng(K + N)
    w = rng.standard_normal((K, N)).astype(np.float32)
    w[:, 3] = 0.0                                  # an all-zero column: scale 1
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    qj, sj = jqm.pack_kernel(jnp.asarray(w))
    qt, st = tqm.pack_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=0)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert qt.shape == (-(-K // 256) * 256, N)

    port = tqm.quant_matmul(torch.from_numpy(x), qt, st).numpy()
    ref = np.asarray(jqm.quant_matmul_reference(jnp.asarray(x), qj, sj))
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)
    if N % 128 == 0:                 # the JAX kernel's own tiling condition
        ker = np.asarray(jqm.quant_matmul(jnp.asarray(x), qj, sj,
                                          interpret=True))
        np.testing.assert_allclose(port, ker, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,N", [(300, 128), (512, 96)])
def test_plain_matmul_takes_any_scale_block(K, N):
    """Scale blocks of 128 rows: the plain version (CPU tensors) matches
    the JAX reference, which takes any block (as the CUDA kernel does)."""
    rng = np.random.default_rng(K * N)
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = rng.standard_normal((3, K)).astype(np.float32)
    qj, sj = jqm.pack_kernel(jnp.asarray(w), block=128)
    qt, st = tqm.pack_kernel(torch.from_numpy(w), block=128)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt.shape == (-(-K // 128) * 128, N)
    assert st.shape == (qt.shape[0] // 128, N)
    port = tqm.quant_matmul(torch.from_numpy(x), qt, st).numpy()
    ref = np.asarray(jqm.quant_matmul_reference(jnp.asarray(x), qj, sj))
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)


def test_pack_decode_weights_packs_matmul_leaves_only():
    rng = np.random.default_rng(1)
    L, H = 2, 64
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    params = {"wte": {"embedding": mk(32, H)},
              "blocks": {"ln1": {"scale": mk(L, H)},
                         "attn_qkv": {"kernel": mk(L, H, 3 * H),
                                      "bias": mk(L, 3 * H)},
                         "attn_proj": {"kernel": mk(L, H, H)}},
              "lm_head": {"kernel": mk(H, 32)}}
    jparams = {k: {kk: ({kkk: jnp.asarray(v.numpy()) for kkk, v in vv.items()}
                        if isinstance(vv, dict) else jnp.asarray(vv.numpy()))
                   for kk, vv in sub.items()} for k, sub in params.items()}
    tp = tqm.pack_decode_weights(params)
    jp = jqm.pack_decode_weights(jparams)
    for name in ("attn_qkv", "attn_proj"):
        np.testing.assert_array_equal(tp["blocks"][name]["kernel"].numpy(),
                                      np.asarray(jp["blocks"][name]["kernel"]))
        np.testing.assert_allclose(
            tp["blocks"][name]["kernel_qscale"].numpy(),
            np.asarray(jp["blocks"][name]["kernel_qscale"]), rtol=1e-6)
    assert "kernel_qscale" not in tp["blocks"]["ln1"]
    assert tp["blocks"]["attn_qkv"]["bias"] is params["blocks"]["attn_qkv"]["bias"]
    assert tp["lm_head"]["kernel"].dtype == torch.int8
    assert tp["wte"] is params["wte"]


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((512, 200)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((8, 512)).astype(np.float32))
    q, s = tqm.pack_kernel(w)
    before = tqm.quant_matmul.launches
    out = tqm.quant_matmul(x, q, s)
    assert tqm.quant_matmul.launches == before
    torch.testing.assert_close(out, tqm.quant_matmul_reference(x, q, s),
                               atol=0, rtol=0)
    # blockwise int8 stays within the analytic bound of the dense product:
    # per element |w - deq(w)| <= absmax_block / 254
    err = (out - x @ w).abs().max().item()
    bound = (x.abs() @ (s.repeat_interleave(256, 0) / 2.0)).max().item()
    assert err <= bound


# the serving int8 leg's matmuls (llama-1.1b: qkv, attn proj, gate/fc,
# mlp proj, LM head) at decode (8 lanes) and prefill (prompts padded to a
# multiple of 32), the regime edges, a ragged K and N, and f32 x
_PLAN_SHAPES = ([(M, K, N) for M in (1, 3, 8, 16, 17, 32, 96, 224, 352, 512)
                 for K, N in ((2048, 2560), (2048, 2048), (2048, 5632),
                              (5632, 2048), (2048, 32000))]
                + [(M, 300, N) for M in (8, 96) for N in (200, 1000)])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", _PLAN_SHAPES)
def test_plan_regime_and_splits(M, K, N, dtype):
    nkb, sms = -(-K // 256), 132
    plan = tqm._plan(M, N, nkb, sms, dtype)
    expect = ("simt" if dtype == torch.float32 else
              "gemv" if M <= 16 else "gemm")
    assert plan.regime == expect
    _, bm, bn, _ = tqm._REGIMES[plan.regime]
    assert plan.tiles == -(-M // bm) * -(-N // bn)
    # the splits take whole K-blocks, each exactly once, none empty
    covered = []
    for s in range(plan.splits):
        blocks = range(s * plan.kb_per, min(nkb, (s + 1) * plan.kb_per))
        assert len(blocks) > 0
        covered.extend(blocks)
    assert covered == list(range(nkb))
    # split K only where the tiles alone do not fill the card, and then in
    # at most one wave of CTAs and one cluster (<= 8 CTAs) a tile
    slots = (2 if plan.regime == "gemv" and M <= 8 else 1) * sms
    assert 1 <= plan.splits <= tqm.MAX_SPLITS
    if plan.splits > 1:
        assert plan.tiles * plan.splits <= slots


def test_plan_splits_decode_matrices_to_fill_the_card():
    # a 2048 x 2048 decode matrix is 16 column tiles: one K-block a CTA
    plan = tqm._plan(8, 2048, 8, 132, torch.bfloat16)
    assert (plan.regime, plan.splits, plan.kb_per) == ("gemv", 8, 1)
    # the LM head's 250 column tiles fill the card unsplit
    assert tqm._plan(8, 32000, 8, 132, torch.bfloat16).splits == 1
    assert tqm._plan(512, 32000, 8, 132, torch.bfloat16).splits == 1


def test_launch_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 256)
    q, s = tqm.pack_kernel(torch.zeros(256, 128))
    with pytest.raises(TypeError):
        tqm._launch(x.to(torch.float16), q, s)
    with pytest.raises(TypeError):
        tqm._launch(x, q.to(torch.int16), s)
    with pytest.raises(ValueError, match="CUDA"):
        tqm._launch(x, q, s)
    with pytest.raises(ValueError, match="impl"):
        tqm.quant_matmul(x, q, s, impl="triton")


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 2048), (96, 2048, 5632),
                                   (512, 5632, 2048), (3, 300, 200)])
def test_plan_splits_whole_blocks_of_any_size(M, K, N, block):
    """_plan takes the scale block: the splits cover the K-blocks of
    ``block`` rows exactly once, each split a whole number of them, and
    with at least as many splits as the plan of 256-row blocks no CTA
    walks more rows of K than there (finer blocks balance better)."""
    nkb = -(-K // block)
    plan = tqm._plan(M, N, nkb, 132, torch.bfloat16, block)
    covered = []
    for s in range(plan.splits):
        blocks = range(s * plan.kb_per, min(nkb, (s + 1) * plan.kb_per))
        assert len(blocks) > 0
        covered.extend(blocks)
    assert covered == list(range(nkb))
    assert 1 <= plan.splits <= tqm.MAX_SPLITS
    if K % 256 == 0:
        p256 = tqm._plan(M, N, K // 256, 132, torch.bfloat16)
        if plan.splits >= p256.splits:
            assert plan.kb_per * block <= p256.kb_per * 256


@pytest.mark.parametrize("block", [64, 128, 48, 16])
def test_gate_takes_blocks_that_are_multiples_of_16(block):
    """Meta tensors: the launch gets past the block gate to the device
    check (what a CUDA tensor would launch), for every block that is a
    multiple of 16."""
    x = torch.empty(4, 512, device="meta")
    q = torch.empty(-(-512 // block) * block, 256, dtype=torch.int8,
                    device="meta")
    s = torch.empty(q.shape[0] // block, 256, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tqm._launch(x, q, s)
    assert tqm.block_reason(block) is None


@pytest.mark.parametrize("block", [40, 100, 8])
def test_gate_refuses_other_blocks_naming_roadmap(block):
    """Blocks that are not a multiple of 16 rows, once refused with a
    message naming ROADMAP.md, are taken now: the gate passes them, the
    launch gets to the device check, and ``_plan`` splits K in whole
    blocks of them. Only a block below one row is refused."""
    x = torch.empty(4, 400, device="meta")
    q = torch.empty(-(-400 // block) * block, 256, dtype=torch.int8,
                    device="meta")
    s = torch.empty(q.shape[0] // block, 256, device="meta")
    assert tqm.block_reason(block) is None
    with pytest.raises(ValueError, match="CUDA tensors"):
        tqm._launch(x, q, s)
    nkb = q.shape[0] // block
    for M, dt in ((8, torch.bfloat16), (512, torch.bfloat16),
                  (8, torch.float32)):
        plan = tqm._plan(M, 256, nkb, 132, dt, block)
        assert plan.splits * plan.kb_per >= nkb
        assert (plan.splits - 1) * plan.kb_per < nkb
    for bad in (0, -16):
        assert "at least one row" in tqm.block_reason(bad)
        with pytest.raises(ValueError, match=f"scale block {bad}"):
            tqm._plan(8, 256, 4, 132, torch.bfloat16, bad)


@pytest.mark.parametrize("block", [8, 40, 100])
@pytest.mark.parametrize("K,N", [(300, 128), (520, 96)])
def test_plain_matmul_matches_jax_at_odd_blocks(K, N, block):
    """Scale blocks that are not a multiple of 16 rows (the CUDA kernel's
    GEMM masks a k step on each side of a block's end): packing and the
    plain version against the JAX reference and, where its tiling takes
    the shape, the JAX kernel in interpret mode; rtol / atol 1e-5 in f32
    (the same per-block sums, reduced in another order)."""
    rng = np.random.default_rng(K + N + block)
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = rng.standard_normal((3, K)).astype(np.float32)
    qj, sj = jqm.pack_kernel(jnp.asarray(w), block=block)
    qt, st = tqm.pack_kernel(torch.from_numpy(w), block=block)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=0)
    assert st.shape == (-(-K // block), N)
    port = tqm.quant_matmul(torch.from_numpy(x), qt, st).numpy()
    ref = np.asarray(jqm.quant_matmul_reference(jnp.asarray(x), qj, sj))
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)
    if N % 128 == 0:                 # the JAX kernel's own tiling condition
        ker = np.asarray(jqm.quant_matmul(jnp.asarray(x), qj, sj,
                                          interpret=True))
        np.testing.assert_allclose(port, ker, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,N", [(300, 128), (640, 96)])
def test_plain_matmul_matches_jax_at_block_64(K, N):
    """Scale blocks of 64 rows (a block the CUDA kernel takes since the
    scale block became a parameter of its K loops): packing and the plain
    version against the JAX reference and the JAX kernel."""
    rng = np.random.default_rng(K + 64)
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = rng.standard_normal((5, K)).astype(np.float32)
    qj, sj = jqm.pack_kernel(jnp.asarray(w), block=64)
    qt, st = tqm.pack_kernel(torch.from_numpy(w), block=64)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.shape == (-(-K // 64), N)
    port = tqm.quant_matmul(torch.from_numpy(x), qt, st).numpy()
    ref = np.asarray(jqm.quant_matmul_reference(jnp.asarray(x), qj, sj))
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)
    if N % 128 == 0:                 # the JAX kernel's own tiling condition
        ker = np.asarray(jqm.quant_matmul(jnp.asarray(x), qj, sj,
                                          interpret=True))
        np.testing.assert_allclose(port, ker, rtol=1e-5, atol=1e-5)
