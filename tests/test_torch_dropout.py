"""Dropout in the port: statistics, seeding and remat, on the CPU.

The two packages draw from different random streams, so masks cannot
match; the tests hold the port's dropout to what it must compute:

* the keep fraction of ``ops.attention.dropout`` within a 5-sigma
  binomial bound at rates 0.1 and 0.5, the kept entries scaled by
  exactly 1 / (1 - rate), the dropped ones exactly 0;
* identity at rate 0 and without a generator, bitwise, as flax's
  ``nn.Dropout`` is at rate 0 (both return the input's bits); a model
  with ``dropout`` 0.1 in eval mode, and one with dropout 0 in training,
  give the logits of the dropout-free model bitwise, and those logits
  match the JAX model's (atol 1e-5, f32);
* the same seed draws the same mask; another layer, site, micro-batch or
  step draws another;
* the mean over 200 seeds of an attention output with dropped
  probabilities against the undropped output, in both packages: at most
  2% of the entries past 3 sigma of their sample mean (0.3% expected);
* with dropout on, remat "full" grads equal remat off's bitwise (each
  site's generator is made from its seed inside the checkpointed region,
  so the recomputation draws the same masks);
* ``train_batch`` with dropout: two engines with one config seed give
  bitwise-equal losses, another seed other losses, and the loss falls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn

from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.ops.attention import mha_reference as jmha

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import module_from_jax
from deepspeed_tpu_torch.ops.attention import (attention, dropout,
                                               mha_reference)

from test_torch_training import _batch, _cfgs, _params


@pytest.fixture(autouse=True)
def _precise():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_fraction_and_scale(rate):
    n = 200_000
    x = torch.full((n,), 3.0)
    y = dropout(x, rate, torch.Generator().manual_seed(1))
    kept = (y != 0).sum().item()
    sigma = np.sqrt(n * rate * (1 - rate))
    assert abs(kept - n * (1 - rate)) < 5 * sigma
    # x / (1 - rate) in x's dtype, as flax divides by keep_prob
    assert torch.equal(y[y != 0], torch.full((kept,), 3.0) / (1 - rate))


def test_identity_at_rate_zero_matches_flax_bitwise():
    x = np.random.default_rng(0).standard_normal((4, 7)).astype(np.float32)
    jy = np.asarray(jnn.Dropout(0.0).apply({}, jnp.asarray(x),
                                           deterministic=False))
    ty = dropout(torch.from_numpy(x), 0.0, torch.Generator()).numpy()
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(ty, x)
    t = torch.from_numpy(x)
    assert dropout(t, 0.5, None) is t


def test_eval_and_rate_zero_models_are_the_dropout_free_model():
    jcfg, tcfg = _cfgs("gpt2")
    base = module_from_jax(_params("gpt2"), tcfg)
    drop = module_from_jax(_params("gpt2"),
                           dataclasses.replace(tcfg, dropout=0.1))
    ids = torch.from_numpy(_batch(2, 16, seed=3)["input_ids"]).long()
    with torch.no_grad():
        ref = base(ids)
        np.testing.assert_array_equal(drop(ids, train=False).numpy(),
                                      ref.numpy())
        np.testing.assert_array_equal(
            base(ids, train=True, dropout_seed=5).numpy(), ref.numpy())
        assert not torch.equal(drop(ids, train=True, dropout_seed=5), ref)
    jlogits = jtr.Transformer(dataclasses.replace(jcfg, dropout=0.1)).apply(
        {"params": _params("gpt2")}, ids.numpy(), train=False)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jlogits), atol=1e-5)


def test_seeds_pick_the_masks():
    g = lambda seed, site: ttr.site_generator(seed, site, "cpu")
    x = torch.ones(4096)
    a = dropout(x, 0.3, g(7, "mlp"))
    assert torch.equal(a, dropout(x, 0.3, g(7, "mlp")))
    for other in (g(8, "mlp"), g(7, "attn_out")):
        assert not torch.equal(a, dropout(x, 0.3, other))
    # layers: the model derives one seed a layer from the call's seed
    assert ttr.mix_seed(5, 1) != ttr.mix_seed(5, 2)
    # micro-batches and steps: the engine's seed of each
    _, tcfg = _cfgs("gpt2", dropout=0.1)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config={
            "train_batch_size": 4, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "SGD"}},
        loss_fn=ttr.causal_lm_loss, device="cpu")
    seeds = {eng._dropout_seed(0), eng._dropout_seed(1)}
    eng.global_steps += 1
    seeds |= {eng._dropout_seed(0)}
    assert len(seeds) == 3


def test_attention_dropout_mean_over_seeds_is_the_undropped_output():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 2, 8, 4)).astype(np.float32)
               for _ in range(3))
    rate, n = 0.2, 200

    def check(samples, ref):
        mean = samples.mean(0)
        sem = samples.std(0, ddof=1) / np.sqrt(n)
        z = np.abs(mean - ref) / np.maximum(sem, 1e-12)
        assert (z > 3).mean() <= 0.02, (z > 3).mean()

    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ref = mha_reference(tq, tk, tv).numpy()
    before = attention.plain_calls
    port = np.stack([attention(tq, tk, tv, dropout_rate=rate,
                               dropout_rng=torch.Generator().manual_seed(s))
                     .numpy() for s in range(n)])
    assert attention.plain_calls == before + n
    check(port, ref)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jout = jax.vmap(lambda key: jmha(q, k, v, dropout_rate=rate,
                                     dropout_rng=key))(keys)
    check(np.asarray(jout), np.asarray(jmha(q, k, v)))


@pytest.mark.parametrize("arch,extra", [
    ("gpt2", {}), ("llama", {}),
    ("gpt2", dict(post_ln=True, causal=False)),
    ("gpt2", dict(parallel_residual=True))])
def test_remat_full_grads_equal_remat_off_with_dropout(arch, extra):
    grads = []
    for remat in (False, True):
        _, tcfg = _cfgs(arch, dropout=0.2, remat=remat,
                        remat_policy="full", **extra)
        m = ttr.Transformer(tcfg, seed=3)
        ids = torch.from_numpy(_batch(2, 16, seed=9)["input_ids"]).long()
        loss = ttr.causal_lm_loss(m(ids, train=True, dropout_seed=11), ids)
        loss.backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_train_batch_with_dropout_is_seeded():
    def losses(seed):
        _, tcfg = _cfgs("llama", dropout=0.1)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg), config={
                "train_batch_size": 8, "gradient_accumulation_steps": 2,
                "seed": seed, "optimizer": {"type": "AdamW",
                                            "params": {"lr": 3e-3}}},
            model_parameters=_params("llama"), loss_fn=ttr.causal_lm_loss,
            device="cpu")
        return [eng.train_batch(_batch(8, 16, seed=s))["loss"]
                for s in (1, 1, 1, 1)]
    a, b, c = losses(1), losses(1), losses(2)
    assert a == b and a != c
    assert a[-1] < a[0]
