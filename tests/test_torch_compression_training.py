"""Port parity: the engine's compression training, low-precision
activations, MoQ and eigenvalue sections against the JAX engine, on the
CPU.

The tiny llama of ``tests/test_torch_training.py`` (f32, the same
flax-initialized weights and numpy-seeded batches) trains 12 steps in
both engines:

* ``qat``: ``compression_training`` weight quantization (symmetric 8
  bits on every kernel, ``schedule_offset`` 2, so steps 0-1 are exact)
  and ``activation_quantization`` int8, which the engine wires into the
  model's ``activation_quant`` (sentinel-gated, as in JAX). A value on a
  rounding boundary may round the other way in one package, so the loss
  is held within rtol 3e-3 and the grad norm within 3e-2 (the JAX
  package's own quantized-twin bound is 0.05 on the loss);
* ``moq``: ``quantize_training`` 16 -> 8 bits, period 2: loss rtol 1e-3,
  grad norm 1e-2.

``compute_eigenvalue`` and ``moq_rescale`` run on an MLP with the JAX
test model's parameter names (``Dense_<i>/kernel``), whose largest
Hessian eigenvalue both engines estimate within 2% of each other (their
start vectors differ). The compositions the port leaves out raise.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.parallel import mesh as tmesh

import test_torch_training as T
from util import SimpleModel, random_batch

QAT = {
    "compression_training": {
        "weight_quantization": {
            "shared_parameters": {"enabled": True, "schedule_offset": 2,
                                  "quantization_type": "symmetric"},
            "different_groups": {"wq": {
                "params": {"start_bits": 8, "target_bits": 8},
                "modules": ["kernel"]}}},
        "activation_quantization": {
            "shared_parameters": {"enabled": True},
            "different_groups": {"aq": {"params": {"bits": 8}}}}},
    "integrity": {"enabled": True},
}
MOQ = {"quantize_training": {
    "enabled": True, "quantize_bits": {"start_bits": 16, "target_bits": 8},
    "quantize_schedule": {"quantize_period": 2, "schedule_offset": 1}}}
MODES = {"qat": (QAT, 3e-3, 3e-2), "moq": (MOQ, 1e-3, 1e-2)}


@pytest.fixture(autouse=True)
def _precise_matmuls(monkeypatch):
    # one device each: a global mesh another test left set would shard
    # the JAX engine's step over it
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    monkeypatch.setattr(tmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("mode", sorted(MODES))
def test_compressed_trajectory_matches_jax_engine(mode, tmp_path):
    extra, loss_tol, norm_tol = MODES[mode]
    jeng, teng = T._engines("llama", tmp_path, cfg=dict(T._TRAIN_CFG,
                                                          **extra))
    if mode == "qat":
        assert teng.module.cfg.activation_quant == "int8"
        assert jeng.module.cfg.activation_quant == "int8"
    assert [g.name for g in teng.compression_spec.groups] == \
        [g.name for g in jeng.compression_spec.groups]
    losses = []
    for step in range(12):
        batch = T._batch(8, 16, seed=100 + step % 3)
        jm = jax.device_get(jeng.train_batch(batch))
        tm = teng.train_batch(batch)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]),
                                   rtol=loss_tol)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=norm_tol)
        losses.append(tm["loss"])
    assert losses[-1] < losses[0]
    # the forward's compressed leaves are gone between steps
    assert not teng._compressed
    assert all("kernel" not in vars(m) for m in teng.module.modules())


class MLP(nn.Module):
    """The JAX test suite's ``SimpleModel`` (``tests/util.py``): relu
    Dense layers, a classification loss returned by the forward, under
    flax's parameter names."""

    def __init__(self, params):
        super().__init__()
        self.names = sorted(params)
        for name in self.names:
            layer = nn.Module()
            for k, v in params[name].items():
                layer.register_parameter(
                    k, nn.Parameter(torch.from_numpy(np.array(v))))
            self.add_module(name, layer)

    def forward(self, batch, train=False):
        h = torch.as_tensor(batch["x"])
        for i, name in enumerate(self.names):
            layer = getattr(self, name)
            h = h @ layer.kernel + layer.bias
            if i < len(self.names) - 1:
                h = torch.relu(h)
        logp = torch.log_softmax(h, -1)
        y = torch.as_tensor(batch["y"]).long()
        return -logp.gather(1, y[:, None]).mean()


def _mlp_engines(cfg):
    model = SimpleModel()
    params = jax.device_get(model.init(jax.random.PRNGKey(0), random_batch(8))
                            ["params"])
    jeng, *_ = deepspeed_tpu.initialize(model=model, config=cfg,
                                        model_parameters=params)
    teng, *_ = deepspeed_tpu_torch.initialize(model=MLP(params), config=cfg,
                                              device="cpu")
    return jeng, teng


def test_compute_eigenvalue_and_moq_rescale_match_jax():
    cfg = {"train_batch_size": 8,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "eigenvalue": {"enabled": True, "max_iter": 200, "tol": 1e-6},
           "quantize_training": {
               "enabled": True,
               "quantize_bits": {"start_bits": 16, "target_bits": 8},
               "quantize_schedule": {"quantize_period": 40,
                                     "schedule_offset": 0}}}
    jeng, teng = _mlp_engines(cfg)
    b = random_batch(8)
    np.testing.assert_allclose(teng.compute_eigenvalue(b),
                               jeng.compute_eigenvalue(b), rtol=2e-2)
    spec1 = teng.moq_rescale(b)                   # the baseline
    assert [g.quantization_period for g in spec1.groups] == [40]
    spec2 = teng.moq_rescale(random_batch(8, seed=5))
    assert all(g.quantization_period >= 40 for g in spec2.groups)
    m = teng.train_batch(b)                       # still trains
    assert np.isfinite(m["loss"])
    with pytest.raises(RuntimeError, match="eigenvalue"):
        _mlp_engines({"train_batch_size": 8,
                      "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
                     )[1].compute_eigenvalue(b)


def test_engine_eigenvalue_refuses_the_flash_path(tmp_path):
    """The in-tree model's attention kernels are differentiable once:
    the engine names them; the plain attention (``attention_impl=
    "reference"``) measures."""
    cfg = dict(T._TRAIN_CFG, eigenvalue={"enabled": True, "max_iter": 3})
    _, tcfg = T._cfgs("llama")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config=cfg,
        model_parameters=T._params("llama"), loss_fn=ttr.causal_lm_loss,
        device="cpu")
    with pytest.raises(NotImplementedError, match="flash_attention"):
        eng.compute_eigenvalue(T._batch(4, 16, 1))
    import dataclasses
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(dataclasses.replace(
            tcfg, attention_impl="reference")), config=cfg,
        model_parameters=T._params("llama"), loss_fn=ttr.causal_lm_loss,
        device="cpu")
    assert np.isfinite(eng.compute_eigenvalue(T._batch(4, 16, 1)))


def test_left_out_compositions_raise(tmp_path):
    """Activation quant needs the sentinel (JAX's words); a model knob of
    fp8 trains; activation quant under TP, in a pipelined model, and
    compression with a pipeline raise naming ROADMAP."""
    _, tcfg = T._cfgs("llama")
    with pytest.raises(ValueError, match="sentinel"):
        deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg), config=dict(
                T._TRAIN_CFG, compression_training=QAT[
                    "compression_training"]),
            model_parameters=T._params("llama"), device="cpu",
            loss_fn=ttr.causal_lm_loss)
    import dataclasses
    fp8 = dataclasses.replace(tcfg, activation_quant="fp8")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(fp8), config=dict(
            T._TRAIN_CFG, integrity={"enabled": True}),
        model_parameters=T._params("llama"), device="cpu",
        loss_fn=ttr.causal_lm_loss)
    assert np.isfinite(eng.train_batch(T._batch(8, 16, 2))["loss"])
    from deepspeed_tpu_torch.utils.partitioning import TPContext
    with pytest.raises(NotImplementedError, match="tensor parallelism.*"
                       "ROADMAP"):
        ttr.Transformer(fp8).set_tp(TPContext(0, 2, fp8.vocab_size))
    from deepspeed_tpu_torch.models.pipeline import PipelinedTransformer
    with pytest.raises(NotImplementedError, match="pipelined model.*"
                       "ROADMAP"):
        PipelinedTransformer(fp8, 2, 2)
    with pytest.raises(NotImplementedError, match="under a pipeline.*"
                       "ROADMAP"):
        deepspeed_tpu_torch.initialize(
            model=PipelinedTransformer(tcfg, 2, 2), config=dict(
                T._TRAIN_CFG, pipeline={"schedule": "1f1b"}, **MOQ),
            model_parameters=T._params("llama"), device="cpu",
            loss_fn=ttr.causal_lm_loss)
