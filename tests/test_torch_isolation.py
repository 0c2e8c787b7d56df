"""The port stands alone and never hides the device or the kernel.

* ``deepspeed_tpu_torch`` (every module) and ``chip_smoke.py`` import
  neither JAX nor ``deepspeed_tpu``, in a fresh interpreter and by source;
* the kernel modules import without ``nvcc`` or a GPU (nothing builds at
  import time);
* entry points run on CUDA by default and raise, naming ``device="cpu"``,
  when there is none;
* a kernel call given a CPU tensor or an unsupported dtype raises instead
  of falling back to the plain version.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.transformer import (Transformer, get_config,
                                                    init_params)
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import paged_attention as tpa
from deepspeed_tpu_torch.ops import quant_matmul as tqm
from deepspeed_tpu_torch.serving.engine import ServingEngine

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "deepspeed_tpu_torch"


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_fresh_interpreter_imports_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import deepspeed_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'deepspeed_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'flax')) or k == 'deepspeed_tpu' "
        "or k.startswith('deepspeed_tpu.'))\n"
        "print(json.dumps({'mods': len(mods), 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["mods"] >= 15


def test_hf_import_runs_without_transformers():
    """models/hf.py and chip_smoke.py import no ``transformers`` (the GPU
    host has none): with the package blocked, a GPT-2 state dict under
    HF's names and its config as a plain object still map."""
    code = (
        "import json, sys\n"
        "sys.modules['transformers'] = None\n"
        "from types import SimpleNamespace\n"
        "import torch\n"
        "import chip_smoke\n"
        "from deepspeed_tpu_torch.models.hf import load_hf\n"
        "H, L, V, S = 16, 2, 32, 8\n"
        "shapes = {'transformer.wte.weight': (V, H),\n"
        "          'transformer.wpe.weight': (S, H),\n"
        "          'transformer.ln_f.weight': (H,),\n"
        "          'transformer.ln_f.bias': (H,)}\n"
        "for i in range(L):\n"
        "    for n, shp in (('ln_1', (H,)), ('ln_2', (H,)),\n"
        "                   ('attn.c_attn', (H, 3 * H)),\n"
        "                   ('attn.c_proj', (H, H)),\n"
        "                   ('mlp.c_fc', (H, 4 * H)),\n"
        "                   ('mlp.c_proj', (4 * H, H))):\n"
        "        shapes[f'transformer.h.{i}.{n}.weight'] = shp\n"
        "        shapes[f'transformer.h.{i}.{n}.bias'] = (shp[-1],)\n"
        "sd = {k: torch.randn(v) for k, v in shapes.items()}\n"
        "cfg = SimpleNamespace(n_layer=L, vocab_size=V, n_positions=S,\n"
        "                      n_embd=H, n_head=2, layer_norm_epsilon=1e-5)\n"
        "params, tcfg = load_hf(sd, arch='gpt2', config=cfg)\n"
        "print(json.dumps({'layers': tcfg.num_layers, 'qkv': list(\n"
        "    params['blocks']['attn_qkv']['kernel'].shape)}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"layers": 2, "qkv": [2, 16, 48]}


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "deepspeed_tpu"), \
                f"{path.name} imports {n}"


# the distributed slice: comm facade, topology and mesh, the ZeRO policy
# and partition, zero.Init / GatheredParameters, the launcher
DIST_MODULES = ["comm", "comm.comm", "comm.logging", "parallel.topology",
                "parallel.mesh", "runtime.zero.stages", "runtime.zero.tiling",
                "runtime.zero.partition", "zero", "launcher",
                "launcher.launch", "moe", "moe.sharded_moe", "moe.layer"]


@pytest.fixture(scope="module")
def dist_imports():
    """Each distributed module imported in order in one fresh interpreter:
    the JAX modules each import added, and whether any started a process
    group."""
    code = (
        "import importlib, json, sys\n"
        "bad = lambda: {k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deepspeed_tpu')}\n"
        "out = {}\n"
        f"for m in {DIST_MODULES!r}:\n"
        "    before = bad()\n"
        "    importlib.import_module('deepspeed_tpu_torch.' + m)\n"
        "    out[m] = sorted(bad() - before)\n"
        "import torch.distributed as dist\n"
        "print(json.dumps({'added': out, 'group': dist.is_initialized()}))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mod", DIST_MODULES)
def test_distributed_modules_import_no_jax_and_start_no_group(dist_imports,
                                                              mod):
    assert dist_imports["added"][mod] == []
    assert dist_imports["group"] is False


def test_import_builds_nothing_and_library_names_track_sources():
    # importing the kernel modules (done above) starts no compiler: the
    # build directory holds no library for the current sources here
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").exists()
        lib = build.library_path(name)
        assert lib.parent == build.BUILD_DIR and name in lib.name
    assert build.build([]) == 0.0


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gpt2-tiny", hidden_size=32, num_layers=1, num_heads=2,
                     vocab_size=64, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        deepspeed_tpu_torch.init_inference(cfg, {}, model_parameters=params)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServingEngine(cfg, params, device="cuda")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        deepspeed_tpu_torch.initialize(model=Transformer(cfg),
                                       config={"train_batch_size": 2})
    eng, *_ = deepspeed_tpu_torch.initialize(model=Transformer(cfg),
                                             config={"train_batch_size": 2},
                                             device="cpu")
    assert eng.device.type == "cpu"
    srv = deepspeed_tpu_torch.init_inference(
        cfg, {"dtype": "float32"}, model_parameters=params,
        device="cpu").serve({"block_size": 16, "pool_blocks": 8,
                             "max_batch": 2, "max_blocks_per_seq": 4})
    assert srv.generate_batch([[1, 2, 3]], 2)[0].__len__() == 2


def _pa_args(dtype=torch.float32):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 32)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((4, 6, 16, 32)).astype(np.float32))
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([20, 7], dtype=torch.int32)
    return q.to(dtype), kp.to(dtype), kp.clone().to(dtype), bt, lens


def test_kernel_calls_raise_instead_of_falling_back():
    kw = dict(sm_scale=None, alibi_slopes=None, softcap=0.0, window=None,
              layer_idx=None, k_scale=None, v_scale=None)
    before = (tpa.paged_attention.launches, tqm.quant_matmul.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tpa._launch(*_pa_args(), **kw)                 # CPU tensors
    with pytest.raises(TypeError, match="dtype"):
        tpa._launch(*_pa_args(torch.float64), **kw)    # no f64 kernel
    q, kp, vp, bt, lens = _pa_args()
    with pytest.raises(TypeError, match="int8"):
        tpa._launch(q, kp.to(torch.int8), vp.to(torch.int8), bt, lens, **kw)
    with pytest.raises(ValueError, match="impl"):
        tpa.paged_attention(q, kp, vp, bt, lens, impl="flash")
    w = torch.randn(256, 128)
    qw, s = tqm.pack_kernel(w)
    with pytest.raises(ValueError, match="CUDA"):
        tqm._launch(torch.randn(8, 256), qw, s)
    with pytest.raises(TypeError, match="dtype"):
        tqm._launch(torch.randn(8, 256, dtype=torch.float16), qw, s)
    with pytest.raises(TypeError, match="int8"):
        tqm._launch(torch.randn(8, 256), qw.float(), s)
    assert (tpa.paged_attention.launches,
            tqm.quant_matmul.launches) == before


def test_attention_kernel_calls_raise_instead_of_falling_back():
    """decode_attention and the flash kernels: CPU tensors in the launch
    path, f64, T > 64, a head dim that is not a multiple of 8 and a
    non-causal window raise (a head dim past 256 gets to the device check);
    inputs on the CPU
    that require grad take the plain forward and backward; nothing
    launches."""
    before = (tda.decode_attention.launches,
              tfa.flash_attention_fwd.launches)
    before_bwd = (tfa.flash_attention_bwd_dq.launches,
                  tfa.flash_attention_bwd_dkv.launches)
    dkw = dict(window=None, sm_scale=None, layer_idx=None, alibi_slopes=None,
               softcap=0.0)
    q, kc = torch.randn(2, 4, 1, 64), torch.randn(2, 4, 100, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tda._launch(q, kc, kc.clone(), 50, **dkw)
    with pytest.raises(TypeError, match="dtype"):
        tda._launch(q.double(), kc.double(), kc.double(), 50, **dkw)
    with pytest.raises(ValueError, match="T <= 64"):
        tda._launch(torch.randn(2, 4, 65, 64), kc, kc.clone(), 80, **dkw)
    with pytest.raises(ValueError, match="impl"):
        tda.decode_attention(q, kc, kc.clone(), 50, impl="flash")
    fkw = dict(causal=True, sm_scale=None, mask=None, alibi_slopes=None,
               window=0, softcap=0.0)
    x = torch.randn(1, 2, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._launch(x, x, x, **fkw)
    with pytest.raises(TypeError, match="dtype"):
        tfa._launch(x.double(), x.double(), x.double(), **fkw)
    with pytest.raises(ValueError, match="causal"):
        tfa._launch(x, x, x, **dict(fkw, causal=False, window=8))
    with pytest.raises(ValueError, match="head_dim 260.*ROADMAP.md"):
        tfa._launch(*(torch.randn(1, 2, 16, 260),) * 3, **fkw)
    with pytest.raises(ValueError, match="CUDA"):   # wide heads: taken
        tfa._launch(*(torch.randn(1, 2, 16, 264),) * 3, **fkw)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dq(x, x, x, x, x[..., 0], x[..., 0])
    # CPU tensors that require grad: the autograd path runs both plain
    # versions and launches nothing
    xg = x.clone().requires_grad_()
    tfa.flash_attention(xg, x, x).sum().backward()
    assert xg.grad.shape == x.shape
    assert (tda.decode_attention.launches,
            tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == before + before_bwd


def test_unported_options_raise():
    cfg = get_config("gpt2-tiny", hidden_size=32, num_layers=1, num_heads=2,
                     vocab_size=64, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    serve = {"block_size": 16, "pool_blocks": 8, "max_batch": 2,
             "max_blocks_per_seq": 4}
    with pytest.raises(NotImplementedError):
        ServingEngine(cfg, params, serving=serve, heartbeat=object(),
                      device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(cfg, params, serving=dict(serve, weight_dtype="int4"),
                      device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(cfg, params, serving=dict(serve, kv_cache_dtype="fp8"),
                      device="cpu")
    eng = deepspeed_tpu_torch.init_inference(
        cfg, {"dtype": "float32", "watchdog": {"serve_timeout": 5.0}},
        model_parameters=params, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.serve()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.serve(dict(serve, fleet={"replicas": 2}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.initialize(
            model=Transformer(cfg), device="cpu",
            config={"train_batch_size": 2, "zero_optimization": {
                "stage": 3, "offload_param": {"device": "cpu"},
                "offload_optimizer": {"device": "cpu"}}})
    with pytest.raises(FileNotFoundError):    # ported: a missing file
        eng.load_checkpoint("ckpt")
    # tensor parallelism is ported (tests/test_torch_tensor_parallel.py);
    # a rule table other than the model's own cfg.tp_rules() is not
    from deepspeed_tpu_torch.utils.partitioning import PartitionSpec
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.init_inference(
            cfg, {"tp": {"tp_size": 2}}, model_parameters=params,
            device="cpu",
            sharding_rules={r"wte/embedding": PartitionSpec("model", None)})
    # MoE serves on the CPU: serve() and generate() agree
    moe = get_config("gpt2-tiny", hidden_size=32, num_layers=1, num_heads=2,
                     vocab_size=64, dtype=torch.float32, moe_experts=2)
    mparams = init_params(moe, torch.Generator().manual_seed(0))
    srv = ServingEngine(moe, mparams, serving=serve, device="cpu")
    eng = deepspeed_tpu_torch.init_inference(
        moe, {"dtype": "float32"}, model_parameters=mparams, device="cpu")
    assert srv.generate_batch([[1, 2, 3]], 2)[0] == \
        eng.generate([[1, 2, 3]], max_new_tokens=2)[0, 3:].tolist()
