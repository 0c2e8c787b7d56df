"""Port parity: deepspeed_tpu_torch.ops.block_sparse_attention (the plain
versions the CPU runs, the tile schedule, the autograd wiring) vs the JAX
package's Pallas kernels run in interpret mode, on the CPU.

The same numpy-seeded f32 inputs go through ``block_sparse_flash_attention``
of both packages; the JAX kernels run with ``interpret=True`` at kernel
blocks of 128 (two tiles a side, so skipping and the per-tile layout
matter) and the port's wrappers run their plain versions. Tolerances are
the JAX kernel file's (tests/test_sparse_attention.py):

* the forward 2e-5 in f32 (the kernel's online softmax and the plain
  dense softmax sum in different orders);
* gradients 2e-4, and 5e-4 for the sliding-window route (the JAX file's:
  the kernel's backward and the plain backward accumulate the (q, k)
  products in different orders).

Query rows with no live key differ by design: the port gives zeros and
zero gradients, the TPU kernel the mean of V over the keys its tiles
visited. Those rows are compared as such and the rest as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import block_sparse_attention as jbs

from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops import sparse_attention as tsa


@pytest.fixture(autouse=True)
def _precise_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


S, H, D = 256, 2, 32
# (name, layout maker, fine block, causal, window, layout_exact)
_UNI = dict(attention="unidirectional")
CASES = [
    ("fixed16-uni-causal", lambda: jsa.FixedSparsityConfig(
        num_heads=H, block=16, **_UNI).make_layout(S), 16, True, 0, True),
    ("fixed16-bi", lambda: jsa.FixedSparsityConfig(
        num_heads=H, block=16).make_layout(S), 16, False, 0, True),
    ("fixed64-uni-causal", lambda: jsa.FixedSparsityConfig(
        num_heads=H, block=64, num_local_blocks=2, **_UNI).make_layout(S),
     64, True, 0, True),
    ("fixed64-bi-causal", lambda: jsa.FixedSparsityConfig(
        num_heads=H, block=64, num_local_blocks=2).make_layout(S),
     64, True, 0, True),
    ("bigbird-per-head", lambda: jsa.BigBirdSparsityConfig(
        num_heads=H, block=16, num_random_blocks=2,
        different_layout_per_head=True, seed=4).make_layout(S),
     16, False, 0, True),
    ("bslongformer-causal", lambda: jsa.BSLongformerSparsityConfig(
        num_heads=H, block=16, global_block_indices=(0, 7)).make_layout(S),
     16, True, 0, True),
    ("variable", lambda: jsa.VariableSparsityConfig(
        num_heads=H, block=16, local_window_blocks=(2, 4),
        global_block_indices=(3,), num_random_blocks=1).make_layout(S),
     16, False, 0, True),
    ("sliding-window-causal", lambda: jsa.LocalSlidingWindowSparsityConfig(
        num_heads=H, block=16, num_sliding_window_blocks=5).make_layout(S),
     16, True, 0, True),
    ("window-route-W70", lambda: jsa.LocalSlidingWindowSparsityConfig(
        num_heads=H, block=64, num_sliding_window_blocks=3).make_layout(S),
     64, True, 70, False),
]
_IDS = [c[0] for c in CASES]


def _inputs(seed=0, B=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, H, S, D)) * 0.5).astype(np.float32)
            for _ in range(4)]


def _jax_kernel(layout, fine, causal, window, exact):
    return lambda q, k, v: jbs.block_sparse_flash_attention(
        q, k, v, layout, fine, causal=causal, block_q=128, block_k=128,
        window=window, layout_exact=exact, interpret=True)


@pytest.mark.parametrize("name,make,fine,causal,window,exact", CASES,
                         ids=_IDS)
def test_plain_forward_matches_jax_kernel(name, make, fine, causal, window,
                                          exact):
    layout = make()
    q, k, v, _ = _inputs()
    jout = _jax_kernel(layout, fine, causal, window, exact)(
        *(jnp.asarray(x) for x in (q, k, v)))
    kw = dict(causal=causal, window=window, layout_exact=exact)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = tbs.block_sparse_flash_attention(tq, tk, tv, layout, fine, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)
    o, lse = tbs.block_sparse_attention_fwd(tq, tk, tv, layout, fine, **kw)
    torch.testing.assert_close(o, out, rtol=0, atol=0)
    assert lse.shape == (1, H, S) and bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("name,make,fine,causal,window,exact",
                         [CASES[i] for i in (0, 3, 4, 8)],
                         ids=[_IDS[i] for i in (0, 3, 4, 8)])
def test_plain_backward_matches_jax_vjp(name, make, fine, causal, window,
                                        exact):
    layout = make()
    q, k, v, g = _inputs(seed=1)
    jout, vjp = jax.vjp(_jax_kernel(layout, fine, causal, window, exact),
                        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tbs.block_sparse_flash_attention(tq, tk, tv, layout, fine,
                                           causal=causal, window=window,
                                           layout_exact=exact)
    out.backward(torch.from_numpy(g))
    tol = 5e-4 if window else 2e-4
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=tol,
                                   atol=tol)
    # the dq and dk/dv wrappers on the CPU run the same plain backward
    o, lse = tbs.block_sparse_attention_fwd(tq.detach(), tk.detach(),
                                            tv.detach(), layout, fine,
                                            causal=causal, window=window,
                                            layout_exact=exact)
    do = torch.from_numpy(g)
    delta = (do * o).sum(-1)
    args = (tq.detach(), tk.detach(), tv.detach(), do, lse, delta, layout,
            fine)
    kw = dict(causal=causal, window=window, layout_exact=exact)
    dq = tbs.block_sparse_attention_bwd_dq(*args, **kw)
    dk, dv = tbs.block_sparse_attention_bwd_dkv(*args, **kw)
    for got, t in ((dq, tq), (dk, tk), (dv, tv)):
        torch.testing.assert_close(got, t.grad, rtol=0, atol=0)


@pytest.mark.parametrize("mode,kw,tq,tk", [
    ("fixed", dict(block=16), 64, 64),
    ("fixed", dict(block=16, attention="unidirectional"), 128, 64),
    ("bigbird", dict(block=16, num_random_blocks=3,
                     different_layout_per_head=True), 64, 128),
    ("bslongformer", dict(block=32), 128, 128),
    ("variable", dict(block=16, local_window_blocks=(1, 3)), 32, 32),
])
def test_tile_lists_match_jax_active_lists(mode, kw, tq, tk):
    layout = jsa.build_sparsity_config(mode, 3, **kw).make_layout(512)
    fine = kw["block"]
    lay = layout.astype(np.int32)
    for lists, (cnt, idx, maxk) in (
            (tbs.active_lists(tbs.coarse_layout(layout, fine, 512, tq, tk)),
             jbs._active_lists(lay, fine, tq, tk)),
            (tbs.active_lists(tbs.coarse_layout(
                layout.transpose(0, 2, 1), fine, 512, tk, tq)),
             jbs._active_lists(lay.transpose(0, 2, 1), fine, tk, tq))):
        ptr, ours = lists
        np.testing.assert_array_equal(np.diff(ptr), cnt)
        for r, c in enumerate(cnt):
            np.testing.assert_array_equal(ours[ptr[r]:ptr[r + 1]],
                                          idx[r * maxk:r * maxk + c])


def test_schedule_flags_cache_and_skipping():
    """The train leg's layout (fixed, block 64, unidirectional) at 64-row
    tiles: only the diagonal tiles carry a mask; the schedule is built
    once; a causal bidirectional layout drops the tiles above the
    diagonal; a window drops the tiles it leaves empty."""
    cfg = tsa.FixedSparsityConfig(num_heads=2, block=64, **_UNI)
    lay = tsa.config_layout(cfg, 1024)
    sched = tbs.schedule(lay, 64, 1024, causal=True)
    assert tbs.schedule(lay, 64, 1024, causal=True) is sched
    # keyed by the layout's bytes: an equal copy hits, a changed one misses
    assert tbs.schedule(lay.copy(), 64, 1024, causal=True) is sched
    changed = lay.copy()
    changed[0, 3, 0] = not changed[0, 3, 0]
    assert tbs.schedule(changed, 64, 1024, causal=True) is not sched
    nT = 1024 // 64
    flagged = np.argwhere(sched.flags[0] != 0)
    assert (flagged[:, 0] == flagged[:, 1]).all() and len(flagged) == nT
    assert (sched.flags[sched.visited] & tbs.LAYOUT_BIT).sum() == 0
    ptr, idx = tbs.active_lists(sched.visited)
    assert ptr[-1] == sched.n_tiles == len(idx)
    np.testing.assert_array_equal(sched.dev["q_ptr"].numpy(), ptr)
    # the launch order: each head's tiles by descending list length
    order = sched.dev["k_order"].numpy().reshape(2, nT)
    lengths = sched.visited.sum(1)              # dk/dv lists: per key tile
    assert (np.diff(lengths[0][order[0]]) <= 0).all()
    assert sorted(order[0]) == list(range(nT))
    bi = tsa.FixedSparsityConfig(num_heads=2, block=16).make_layout(1024)
    s_bi = tbs.schedule(bi, 16, 1024, causal=True)
    assert not np.triu(s_bi.visited[0], 1).any()
    assert (s_bi.flags[s_bi.visited] & tbs.LAYOUT_BIT).any()
    dense = np.ones((2, 16, 16), dtype=bool)
    win = tbs.schedule(dense, 64, 1024, causal=True, window=100,
                       layout_exact=False)
    i, j = np.indices((nT, nT))
    np.testing.assert_array_equal(win.visited[0], (j <= i) & (i - j <= 2))
    # a ragged S flags the edge tiles
    rag = tbs.schedule(np.ones((1, 63, 63), dtype=bool), 16, 1008)
    assert (rag.flags[0, -1, :] & tbs.POS_BIT).all()
    assert (rag.flags[0, :-1, :-1] == 0).all()


@pytest.mark.parametrize("W,fine,S", [(1, 64, 1024), (100, 16, 1008),
                                      (1024, 64, 2048)])
def test_window_route_plain_mask_is_causal_and_window_alone(W, fine, S):
    """With layout_exact=False the plain version's mask is the layout,
    causal and the window, built without the tile lists; on the window
    route's layout that is exactly q - W < k <= q. A layout short of the
    band raises."""
    blocks = -(-(W - 1) // fine) + 1 if W > 1 else 1
    lay = tsa.LocalSlidingWindowSparsityConfig(
        num_heads=1, block=fine,
        num_sliding_window_blocks=blocks).make_layout(S)
    sched = tbs.schedule(lay, fine, S, causal=True, window=W,
                         layout_exact=False)
    qp, kp = np.arange(S)[:, None], np.arange(S)[None]
    np.testing.assert_array_equal(sched.keep("cpu")[0].numpy(),
                                  (kp <= qp) & (qp - kp < W))
    # every live pair lies in a listed tile
    T = tbs.TILE
    vis = np.repeat(np.repeat(sched.visited[0], T, 0), T, 1)[:S, :S]
    assert not ((kp <= qp) & (qp - kp < W) & ~vis).any()
    if blocks > 1:
        short = tsa.LocalSlidingWindowSparsityConfig(
            num_heads=1, block=fine,
            num_sliding_window_blocks=blocks - 1).make_layout(S)
        with pytest.raises(ValueError, match="layout_exact=False"):
            tbs.schedule(short, fine, S, causal=True, window=W,
                         layout_exact=False)


def test_dead_rows_give_zeros_where_the_tpu_kernel_averages():
    """A layout whose query block 2 (of 16) attends nothing and whose key
    block 5 of head 1 nobody attends. Live rows match the JAX kernel; the
    dead rows are zero here with zero gradients, while the JAX kernel
    (which visits the 128-row tiles of the other queries) gives them the
    mean of V over the keys of the tiles it visited."""
    nf = S // 16
    layout = np.random.default_rng(3).random((H, nf, nf)) < 0.4
    layout |= np.eye(nf, dtype=bool)[None]
    layout[:, 2, :] = False
    layout[1, :, 5] = False
    q, k, v, g = _inputs(seed=2)
    jfn = _jax_kernel(layout, 16, False, 0, True)
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jout = np.asarray(jout)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tbs.block_sparse_flash_attention(tq, tk, tv, layout, 16)
    dead = np.zeros(S, dtype=bool)
    dead[32:48] = True
    np.testing.assert_allclose(out.detach().numpy()[:, :, ~dead],
                               jout[:, :, ~dead], rtol=2e-5, atol=2e-5)
    assert (out.detach().numpy()[:, :, dead] == 0).all()
    # the TPU kernel's dead rows: the mean of V over the visited keys (the
    # k tiles of 128 that query tile 0 lists, per head)
    coarse = layout.reshape(H, 2, 8, 2, 8).any(axis=(2, 4))
    for h in range(H):
        keys = np.concatenate([np.arange(128 * t, 128 * t + 128)
                               for t in np.nonzero(coarse[h, 0])[0]])
        np.testing.assert_allclose(jout[0, h, dead],
                                   np.broadcast_to(v[0, h, keys].mean(0),
                                                   (16, D)),
                                   rtol=1e-5, atol=1e-5)
    out.backward(torch.from_numpy(g))
    assert (tq.grad.numpy()[:, :, dead] == 0).all()
    assert (tk.grad.numpy()[:, 1, 80:96] == 0).all()
    assert (tv.grad.numpy()[:, 1, 80:96] == 0).all()
    # live rows' gradients: the JAX kernel's, with the dead rows' cotangent
    # zeroed so that its averaged rows contribute nothing either
    g_live = g.copy()
    g_live[:, :, dead] = 0
    jg = vjp(jnp.asarray(g_live))
    tq2, tk2, tv2 = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tbs.block_sparse_flash_attention(tq2, tk2, tv2, layout, 16).backward(
        torch.from_numpy(g_live))
    for t, j in zip((tq2, tk2, tv2), jg):
        got, ref = t.grad.numpy(), np.asarray(j)
        np.testing.assert_allclose(got[:, :, ~dead], ref[:, :, ~dead],
                                   rtol=2e-4, atol=2e-4)


def test_wrappers_on_cpu_launch_nothing():
    layout = tsa.FixedSparsityConfig(num_heads=H, block=16).make_layout(S)
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(seed=4))
    before = [getattr(tbs, n).launches for n in (
        "block_sparse_attention_fwd", "block_sparse_attention_bwd_dq",
        "block_sparse_attention_bwd_dkv")]
    o, lse = tbs.block_sparse_attention_fwd(q, k, v, layout, 16)
    ro, rlse = tbs.block_sparse_attention_reference(q, k, v, layout, 16)
    torch.testing.assert_close(o, ro, rtol=0, atol=0)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=0)
    delta = (g * o).sum(-1)
    dq = tbs.block_sparse_attention_bwd_dq(q, k, v, g, lse, delta, layout, 16)
    rq, _, _ = tbs.block_sparse_attention_bwd_reference(q, k, v, g, lse,
                                                        delta, layout, 16)
    torch.testing.assert_close(dq, rq, rtol=0, atol=0)
    after = [getattr(tbs, n).launches for n in (
        "block_sparse_attention_fwd", "block_sparse_attention_bwd_dq",
        "block_sparse_attention_bwd_dkv")]
    assert after == before
    with pytest.raises(ValueError, match="CUDA"):
        tbs._cuda_operands(tbs.schedule(layout, 16, S), q, k, v)


@pytest.mark.parametrize("dtype,Dh", [(np.float32, 80), (np.float32, 96),
                                      (np.float16, 64)])
def test_head_dims_80_96_and_fp16(dtype, Dh):
    """Head dims 80 and 96 (which the CUDA kernels take at a padded width)
    in f32 at the forward's and gradients' tolerances above, and float16
    on both sides to 2^-6 of each output's largest |value| (the 16-bit
    tolerance of the card's checks): the forward and jax.vjp of the JAX
    kernels against the plain versions through autograd."""
    _, make, fine, causal, window, exact = CASES[0]
    layout = make()
    rng = np.random.default_rng(Dh)
    q, k, v, g = [(rng.standard_normal((1, H, S, Dh)) * 0.5).astype(dtype)
                  for _ in range(4)]
    jout, vjp = jax.vjp(_jax_kernel(layout, fine, causal, window, exact),
                        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tbs.block_sparse_flash_attention(tq, tk, tv, layout, fine,
                                           causal=causal)
    out.backward(torch.from_numpy(g))
    pairs = [(out.detach(), jout, 2e-5)] + [
        (t.grad, jg, 2e-4) for t, jg in zip((tq, tk, tv), jgrads)]
    for got, want, tol in pairs:
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.from_numpy(q).dtype
        if dtype == np.float16:
            tol = 2.0 ** -6 * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_256_forward_and_backward(causal):
    """Gemma's head dim, which the CUDA kernels take with the own rows in
    shared memory (and dk/dv split over two column halves): the plain
    forward and backward against the JAX kernels (blocks of 64, so tiles
    are skipped), to the file's tolerances."""
    S2, D2 = 128, 256
    layout = jsa.FixedSparsityConfig(num_heads=H, block=16,
                                     **_UNI).make_layout(S2)
    rng = np.random.default_rng(256)
    q, k, v, g = [(rng.standard_normal((1, H, S2, D2)) * 0.5).astype(
        np.float32) for _ in range(4)]
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


# the k side's cases keep their first ids; the query side's are new
@pytest.mark.parametrize("side,slots", [
    pytest.param("k", 264, id="264"), pytest.param("k", 100, id="100"),
    pytest.param("k", 7, id="7"),
    *(pytest.param("q", slots, id=f"q-{slots}") for slots in (264, 100, 7))])
def test_dkv_slots_balance_the_long_leg(side, slots):
    """The persistent kernels' per-CTA item lists (``balance``, a pure
    function), on both sides: the (head, key tile) items of dK/dV and the
    (head, query tile) items of the forward and dQ. Every item once, each
    list costliest first, and at the long leg's layout (DeepSpeed's fixed,
    blocks of 64, unidirectional, S 4096, 32 heads: dK/dV lists of 1 to 61
    tiles, query-side lists of 1 to 19) no list costs more than the mean
    plus the costliest item, within the 4/3 of the best that LPT
    guarantees; ``Schedule.cta_slots`` gives the same lists for a card of
    slots / 2 SMs."""
    cfg = tsa.FixedSparsityConfig(num_heads=32, block=64, num_local_blocks=4,
                                  num_global_blocks=1, **_UNI)
    sched = tbs.schedule(tsa.config_layout(cfg, 4096), 64, 4096, causal=True)
    costs = sched.item_costs(side)
    lengths = sched.visited.sum(1 if side == "k" else 2).reshape(-1)
    assert np.array_equal(costs, lengths + tbs.ITEM_COST[side])
    assert lengths.max() == (61 if side == "k" else 19)
    ptr, items = tbs.balance(costs, slots)
    assert ptr[0] == 0 and ptr[-1] == costs.size and len(ptr) == slots + 1
    assert sorted(items.tolist()) == list(range(costs.size))
    loads = np.add.reduceat(costs[items], ptr[:-1]) * (np.diff(ptr) > 0)
    best = max(costs.sum() / slots, costs.max())
    assert loads.max() <= costs.sum() / slots + costs.max()
    assert loads.max() <= 4 / 3 * best + 1
    for w in range(slots):
        c = costs[items[ptr[w]:ptr[w + 1]]]
        assert np.all(np.diff(c) <= 0)
    if slots % tbs.CTAS_PER_SM == 0:
        tptr, titems = sched.cta_slots(side, slots // tbs.CTAS_PER_SM)
        assert np.array_equal(tptr.numpy(), ptr)
        assert np.array_equal(titems.numpy(), items)
    # dealt round-robin in longest-first order instead, the costliest CTA
    # takes much more than the mean (what the host balancing removes): the
    # long dK/dV lists 1.3x, the query side's 1.1x
    order = np.argsort(-costs, kind="stable")
    rr = np.bincount(np.arange(costs.size) % slots, weights=costs[order],
                     minlength=slots)
    if slots == 264:
        skew, tight = (1.3, 1.1) if side == "k" else (1.1, 1.05)
        assert rr.max() > skew * costs.sum() / slots
        assert loads.max() < tight * costs.sum() / slots


@pytest.mark.parametrize("D,dtype,want", [
    (64, torch.float32, "f32"), (64, torch.bfloat16, "wgmma"),
    (64, torch.float16, "wgmma"), (80, torch.float32, "f32"),
    (80, torch.bfloat16, "mma"), (80, torch.float16, "mma"),
    (264, torch.float32, "wide"), (264, torch.bfloat16, "wide"),
    (264, torch.float16, "wide")])
def test_routes_on_meta_tensors(D, dtype, want):
    """Which form of each block-sparse kernel a call takes, from the shapes
    and dtype alone (meta tensors: no data, no device): the 16-bit D 64
    call (the long and window legs') the persistent wgmma kernels
    (bs_fwd_wg, bs_dq_wg, bs_dkv_wg), the other 16-bit widths mma.sync, f32
    the CUDA-core kernels and D above 256 the wide forms; each a call the
    kernels take."""
    q = torch.empty(1, 4, 512, D, dtype=dtype, device="meta")
    layout = tsa.config_layout(tsa.FixedSparsityConfig(
        num_heads=4, block=64, **_UNI), 512)
    assert tbs.tileable(q, q, q, 64, layout) is None
    for route in (tbs.fwd_route, tbs.dq_route, tbs.dkv_route):
        assert route(q.shape[-1], q.dtype) == want


@pytest.mark.parametrize("S,fine", [(1008, 16), (512, 8), (960, 24),
                                    (1024, 32)])
def test_fine_bits_hold_the_layout(S, fine):
    """The wgmma forward's and dq's mask word (``fine_bits``, ``q_bits`` of
    the schedule): for every listed tile with LAYOUT_BIT, bit 8 rg + kg is
    the dense layout mask on the whole 8 x 8 group of rows 8 rg.. and keys
    8 kg.. of the tile (a fine block is a multiple of 8, so the group is
    uniform; past S the last position counts); tiles without LAYOUT_BIT
    carry all ones."""
    cfg = tsa.BigBirdSparsityConfig(num_heads=2, block=fine,
                                    num_random_blocks=2,
                                    different_layout_per_head=True)
    layout = tsa.config_layout(cfg, S)
    sched = tbs.schedule(layout, fine, S, causal=True)
    h, qt, kt = np.nonzero(sched.visited)
    flags = sched.flags[sched.visited]
    words = sched.dev["q_bits"].numpy().reshape(-1, 2).view("<u8")[:, 0]
    assert (flags & tbs.LAYOUT_BIT).any()
    dense = tsa.layout_to_dense_mask(layout, fine, device="cpu").numpy()
    g = np.minimum(np.arange(0, 64, 8), S - 1)
    for n in range(len(h)):
        if not flags[n] & tbs.LAYOUT_BIT:
            assert words[n] == ~np.uint64(0)
            continue
        rows = np.minimum(qt[n] * 64 + g, S - 1)
        cols = np.minimum(kt[n] * 64 + g, S - 1)
        want = dense[h[n]][np.ix_(rows, cols)]
        got = (words[n] >> np.arange(64, dtype=np.uint64)).reshape(8, 8) & 1
        assert np.array_equal(got, want.astype(int))
        blocks = dense[h[n]][np.ix_(np.minimum(rows + 7, S - 1),
                                    np.minimum(cols + 7, S - 1))]
        assert np.array_equal(blocks, want)
