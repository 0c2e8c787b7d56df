"""Port parity: activation checkpointing (``runtime/act_checkpoint.py`` and
the ``Transformer``'s ``remat`` / ``remat_policy``), on the CPU.

* loss and every grad under each block policy ("full", "attn", "dots")
  equal remat off (atol 1e-6) and the JAX ``Transformer`` with the same
  policy (the tolerances of test_torch_training.py: loss rtol 1e-5, grads
  atol 2e-5 + rtol 1e-4), on a gpt2-style, a llama-style GQA and a
  pure-window model (whose attention runs the block-sparse wrappers);
* the attention forward runs twice a layer under "full" (the backward's
  recomputation) and once under "attn" and "dots"; the backward once;
* a kept call comes back only to a recomputation on inputs of the same
  shapes;
* the bytes saved for backward, counted by
  ``torch.autograd.graph.saved_tensors_hooks`` (unique storages, the
  parameters left out), order full < attn < dots < off;
* the engine's ``activation_checkpointing`` section remats a user
  ``nn.Module`` (its forward runs again in the backward) with the same
  loss and grads; ``cpu_checkpointing`` and the "offload" policy raise
  naming ROADMAP.md.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import module_from_jax
from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.runtime import act_checkpoint

from test_torch_training import (_batch, _cfgs, _flat, _grad_tree,
                                 _numpy_tree, _params)

POLICIES = ("full", "attn", "dots")
# a pure causal window of 32 at seq 64: the block-sparse wrappers' route
ARCHS = {"gpt2": {}, "llama": {},
         "llama_wide": dict(layer_windows=(32, 32))}


@pytest.fixture(autouse=True)
def _precise_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _spy(monkeypatch):
    """Count the attention forwards (flash and block-sparse plain
    versions) and backwards."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_attention_fwd, tfa.flash_attention_bwd
    bs_fwd, bs_bwd = tbs._reference, tbs._bwd_reference

    def count(kind, fn):
        def spy(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return spy
    monkeypatch.setattr(tfa, "flash_attention_fwd", count("fwd", fwd))
    monkeypatch.setattr(tfa, "flash_attention_bwd", count("bwd", bwd))
    monkeypatch.setattr(tbs, "_reference", count("fwd", bs_fwd))
    monkeypatch.setattr(tbs, "_bwd_reference", count("bwd", bs_bwd))
    return calls


def _port_loss_and_grads(arch, policy, batch, count_saved=False):
    jp = _params(arch)
    kw = dict(ARCHS[arch], remat=policy is not None,
              remat_policy=policy or "dots")
    _, tcfg = _cfgs(arch, **kw)
    module = module_from_jax(jp, tcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = {p.untyped_storage().data_ptr() for p in module.parameters()}
    seen = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in params:
            seen[ptr] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = ttr.causal_lm_loss(module(tb, train=True), tb)
    loss.backward()
    return loss.item(), _grad_tree(module), sum(seen.values())


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_policies_match_remat_off_and_flax(arch, policy, monkeypatch):
    S = 64 if arch == "llama_wide" else 24
    batch = _batch(2, S, seed=4)
    calls = _spy(monkeypatch)
    off_loss, off_grads, _ = _port_loss_and_grads(arch, None, batch)
    assert calls == {"fwd": 2, "bwd": 2}
    calls.update(fwd=0, bwd=0)
    loss, grads, _ = _port_loss_and_grads(arch, policy, batch)
    assert calls == {"fwd": 4 if policy == "full" else 2, "bwd": 2}
    np.testing.assert_allclose(loss, off_loss, rtol=0, atol=1e-6)
    assert sorted(grads) == sorted(off_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, off_grads[name], rtol=0, atol=1e-6,
                                   err_msg=name)
    # the JAX Transformer with the same policy
    jcfg, _ = _cfgs(arch, **ARCHS[arch], remat=True, remat_policy=policy)
    jmodel = jtr.Transformer(jcfg)
    jl, jg = jax.value_and_grad(
        lambda p: jtr.causal_lm_loss(jmodel.apply({"params": p}, batch),
                                     batch))(
        jax.tree.map(jnp.asarray, _params(arch)))
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    for name, g in _flat(_numpy_tree(jg)).items():
        np.testing.assert_allclose(grads[name], g, atol=2e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_saved_bytes_order_full_attn_dots_off(arch):
    batch = _batch(2, 24, seed=5)
    saved = {p: _port_loss_and_grads(arch, p, batch)[2]
             for p in (None, "dots", "attn", "full")}
    assert saved["full"] < saved["attn"] < saved["dots"] < saved[None], saved


def test_kept_call_comes_back_only_for_the_same_inputs():
    """A region keeping "attn" computes a kept call once; a recomputation
    that makes it on inputs of another shape raises instead of handing
    back the forward's value."""
    from deepspeed_tpu_torch.ops.checkpoint_name import keep_region, reuse
    computed = []

    class Kept(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            def compute():
                computed.append(tuple(x.shape))
                return x * 2
            y = reuse("attn", compute, x)
            ctx.save_for_backward(x)     # the recomputation reaches here
            return y

        @staticmethod
        def backward(ctx, g):
            return g * 2

    w = torch.randn(4, 4, requires_grad=True)
    x = torch.randn(3, 4)
    runs = []

    def region(x, shrink):
        runs.append(1)
        h = torch.tanh(x @ w)
        if shrink and len(runs) > 1:
            h = h[:2]                    # the recomputation diverges
        return Kept.apply(h).sum()

    y = keep_region(region, ("attn",), (x, False), {})
    (g,) = torch.autograd.grad(y, w)
    (gref,) = torch.autograd.grad(region(x, False), w)
    assert computed == [(3, 4), (3, 4)] and len(runs) == 3
    torch.testing.assert_close(g, gref, rtol=0, atol=0)
    computed.clear()
    runs.clear()
    y = keep_region(region, ("attn",), (x, True), {})
    with pytest.raises(RuntimeError, match="diverged"):
        y.backward()
    assert computed == [(3, 4)]


def test_remat_off_in_eval_and_without_grad():
    """No grad, no region: eval under remat is the plain forward."""
    _, tcfg = _cfgs("gpt2", remat=True, remat_policy="attn")
    module = module_from_jax(_params("gpt2"), tcfg)
    ref = module_from_jax(_params("gpt2"), _cfgs("gpt2")[1])
    ids = torch.from_numpy(_batch(2, 12, seed=6)["input_ids"])
    with torch.no_grad():
        assert torch.equal(module(ids), ref(ids))


def test_unknown_and_offload_policies_raise():
    for policy, err in (("offload", NotImplementedError),
                        ("bogus", ValueError)):
        with pytest.raises(err, match="5.2" if policy == "offload"
                           else "remat_policy"):
            ttr.Transformer(_cfgs("gpt2", remat=True,
                                  remat_policy=policy)[1])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        act_checkpoint.make_remat_policy("offload")
    with pytest.raises(ValueError, match="remat policy"):
        act_checkpoint.make_remat_policy("most")
    with pytest.raises(NotImplementedError, match="5.2"):
        act_checkpoint.configure(checkpoint_in_cpu=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.initialize(
            model=_Mlp(), device="cpu",
            config={"train_batch_size": 4,
                    "activation_checkpointing": {"cpu_checkpointing": True}})


# ------------------------------------------------------------ user modules

class _Mlp(nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.fc = nn.Linear(8, 16)
        self.out = nn.Linear(16, 1)
        for p in self.parameters():
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        self.calls = 0

    def forward(self, batch):
        self.calls += 1
        h = torch.tanh(self.fc(batch["x"]))
        return ((self.out(h)[:, 0] - batch["y"]) ** 2).mean()


def test_engine_section_remats_a_user_module():
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((4, 8)).astype(np.float32),
             "y": rng.standard_normal(4).astype(np.float32)}
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 1,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    out = {}
    for name, extra in (("off", {}), ("on", {"activation_checkpointing": {
            "partition_activations": True, "number_checkpoints": 1}})):
        act_checkpoint.reset()
        model = _Mlp()
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=model, config={**cfg, **extra}, device="cpu")
        metrics = [eng.train_batch(batch) for _ in range(3)]
        out[name] = (metrics, model.calls,
                     [p.detach().clone() for p in model.parameters()])
    assert act_checkpoint.is_configured()
    act_checkpoint.reset()
    assert not act_checkpoint.is_configured()
    assert out["off"][1] == 3 and out["on"][1] == 6  # recomputed per step
    for a, b in zip(out["off"][0], out["on"][0]):
        assert abs(a["loss"] - b["loss"]) <= 1e-6
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-6
    for a, b in zip(out["off"][2], out["on"][2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_checkpoint_api_on_a_function(policy):
    """``checkpoint`` / ``checkpointable`` / ``remat`` under the configured
    or given policy: the same value and grad, the function run again in
    the backward."""
    calls = []
    w = torch.randn(6, 6, requires_grad=True)

    def f(x):
        calls.append(1)
        return torch.sin(x @ w).sum()

    x = torch.randn(3, 6)
    ref = f(x)
    (gref,) = torch.autograd.grad(ref, w)
    calls.clear()
    fn = act_checkpoint.remat(f, policy_name=policy)
    y = fn(x)
    (g,) = torch.autograd.grad(y, w)
    assert len(calls) == 2 and torch.equal(y, ref)
    torch.testing.assert_close(g, gref, rtol=0, atol=1e-6)
    act_checkpoint.configure(num_checkpoints=2)
    calls.clear()
    y = act_checkpoint.checkpointable(f)(x)
    y.backward()
    assert len(calls) == 2 and act_checkpoint.remat(f, "none") is f
    act_checkpoint.reset()
