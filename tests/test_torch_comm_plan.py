"""Port parity: the comm plan's policy side (``comm_plan/``) against the
JAX package's, pure Python on the CPU.

* a plan from the same sweep records is the same JSON in both packages,
  and each loads the other's;
* the selector, the heuristic and the resolution ladder (override, then
  plan entry, then heuristic) give JAX's answers on a grid of queries;
  an unexecutable forced algorithm raises in both;
* the accuracy guard's latch;
* the grad-sync envelope: the JAX degrade matrix's cases
  (``tests/test_comm_overlap.py::test_envelope_degrade_matrix``): ZeRO-3,
  an expert, seq or pipe axis above 1, compression and a single data
  rank degrade; data parallelism with TP stays inside. An engine forced
  outside it warns with the JAX words and runs exact;
* ``comm-plan show --query``, through the CLI and the launcher runner;
  ``sweep`` raises naming ROADMAP.
"""

import json
import logging
import random

import numpy as np
import pytest

from deepspeed_tpu import comm_plan as jcp
from deepspeed_tpu.comm_plan import runtime as jrt
from deepspeed_tpu.comm_plan import selector as jsel

from deepspeed_tpu_torch import comm_plan as tcp
from deepspeed_tpu_torch.comm_plan import runtime as trt
from deepspeed_tpu_torch.comm_plan import selector as tsel


def _rows(shuffle_seed=None):
    """The JAX suite's sweep records, plus an overlap row that wins."""
    rows = [
        {"op": "reduce_scatter", "algo": "exact", "axis": "all",
         "size_mb": 8.0, "size_bytes": 8 * 2 ** 20, "latency_us": 900.0},
        {"op": "reduce_scatter", "algo": "int8", "axis": "all",
         "size_mb": 8.0, "size_bytes": 8 * 2 ** 20, "latency_us": 400.0},
        {"op": "all_to_all", "algo": "exact", "axis": "all",
         "size_mb": 8.0, "size_bytes": 8 * 2 ** 20, "latency_us": 500.0},
        {"op": "all_to_all", "algo": "int8", "axis": "all",
         "size_mb": 8.0, "size_bytes": 8 * 2 ** 20, "latency_us": 700.0},
        {"op": "all_reduce", "algo": "exact", "axis": "all",
         "size_mb": 1.0, "size_bytes": 2 ** 20, "latency_us": 120.0},
        {"op": "all_reduce", "algo": "int8", "axis": "all",
         "size_mb": 1.0, "size_bytes": 2 ** 20, "latency_us": 120.0},
        {"op": "all_gather", "algo": "overlap", "axis": "data",
         "size_mb": 32.0, "latency_us": 80.0},
        {"op": "all_gather", "algo": "exact", "axis": "data",
         "size_mb": 32.0, "latency_us": 95.0},
        {"op": "reduce_scatter", "algo": "hierarchical", "axis": "data",
         "size_mb": 64.0, "latency_us": 10.0},
    ]
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(rows)
    return rows


def test_plan_json_round_trip_crosses_packages(tmp_path):
    tplan = tcp.select_plan(_rows(), meta={"n_devices": 2})
    jplan = jcp.select_plan(_rows(), meta={"n_devices": 2})
    assert tplan.to_json() == jplan.to_json()
    path = str(tmp_path / "plan.json")
    tplan.save(path)
    assert jcp.CommPlan.load(path).to_json() == tplan.to_json()
    jplan.save(path)
    loaded = tcp.CommPlan.load(path)
    assert loaded.to_json() == tplan.to_json()
    e = loaded.entry_for("reduce_scatter", "all", 8 * 2 ** 20)
    assert e.algo == "int8" and e.source == "sweep" and e.est_us == 400.0
    for seed in range(3):
        assert tcp.select_plan(_rows(seed), meta={"n_devices": 2}
                               ).to_json() == tplan.to_json()
    with pytest.raises(ValueError, match="unknown algo"):
        tcp.CommPlan.from_json(json.dumps({"version": 1, "entries": [
            {"kind": "all_reduce", "axis": "all", "bucket": 20,
             "algo": "fp4"}]}))
    with pytest.raises(ValueError, match="newer"):
        tcp.CommPlan.from_json(json.dumps({"version": 99, "entries": []}))
    assert tcp.ALGOS == jcp.ALGOS and tcp.SITE_ALGOS == jcp.SITE_ALGOS
    from deepspeed_tpu.comm_plan.plan import QUANTIZED_ALGOS as JQ
    from deepspeed_tpu_torch.comm_plan.plan import QUANTIZED_ALGOS as TQ
    assert JQ == TQ


def test_selector_heuristic_and_ladder_match_jax():
    text = "\n".join(["noise", "comm_bench: {bad json"] +
                     [f"comm_bench: {json.dumps(r)}" for r in _rows()])
    assert tsel.parse_bench_lines(text) == jsel.parse_bench_lines(text)
    sizes = [100, 2 ** 12, 2 ** 20, 3 * 2 ** 20, 4 * 2 ** 20,
             8 * 2 ** 20, 32 * 2 ** 20, 64 * 2 ** 20, 2 ** 30]
    kinds = ["reduce_scatter", "all_to_all", "all_reduce", "all_gather"]
    for kind in kinds:
        for n in sizes:
            for ax in (1, 2, 8):
                assert tsel.heuristic_algo(kind, n, ax) == \
                    jsel.heuristic_algo(kind, n, ax)
    for overrides in ({}, {"grad_reduce_scatter": "overlap_int8"},
                      {"reduce_scatter": "exact"}, {"all_to_all": "int8"},
                      {"all_gather": "overlap"}):
        for plan in (None, "rows"):
            tctx = trt.PlanContext(
                plan=tcp.select_plan(_rows()) if plan else None,
                overrides=dict(overrides))
            jctx = jrt.PlanContext(
                plan=jcp.select_plan(_rows()) if plan else None,
                overrides=dict(overrides))
            for site, axis in (("grad_reduce_scatter", "data"),
                               ("moe_all_to_all", "expert"),
                               ("param_all_gather", "data")):
                for n in sizes:
                    assert trt.resolve_algo(tctx, site, axis, n, 2) == \
                        jrt.resolve_algo(jctx, site, axis, n, 2), \
                        (overrides, plan, site, n)
            assert tctx.resolved == jctx.resolved
    for mod in (trt, jrt):
        with pytest.raises(ValueError, match="not executable"):
            mod.resolve_algo(mod.PlanContext(
                overrides={"grad_reduce_scatter": "onebit"}),
                "grad_reduce_scatter", "data", 1024, axis_size=8)
        with pytest.raises(ValueError, match="unknown comm-plan site"):
            mod.resolve_algo(mod.PlanContext(), "nope", "data", 1, 2)


def test_use_context_is_a_thread_local_stack():
    import threading
    a, b = trt.PlanContext(bits=8), trt.PlanContext(bits=4)
    assert trt.active_context() is None
    seen = []
    with trt.use_context(a):
        with trt.use_context(None):
            assert trt.active_context() is a
        with trt.use_context(b):
            assert trt.active_context() is b
            t = threading.Thread(target=lambda: seen.append(
                trt.active_context()))
            t.start()
            t.join()
        assert trt.active_context() is a
    assert trt.active_context() is None and seen == [None]


def test_accuracy_guard_latches_on_small_norms():
    for mod in (trt, jrt):
        g = mod.AccuracyGuard(0.5)
        states = [g.use_exact]
        for norm in (2.0, 0.1, float("nan"), 3.0):
            g.observe(norm)
            states.append(g.use_exact)
        assert states == [False, False, True, True, False]


SHAPE = {"pipe": 1, "data": 2, "expert": 1, "seq": 1, "model": 1}


@pytest.mark.parametrize("case,compression,stage,shape,inside", [
    ("data", False, 2, {}, True),
    ("stage0", False, 0, {}, True),
    ("tp", False, 2, {"model": 2}, True),
    ("zero3", False, 3, {}, False),
    ("expert", False, 1, {"expert": 2}, False),
    ("seq", False, 2, {"seq": 2}, False),
    ("pipe", False, 1, {"pipe": 2}, False),
    ("one_rank", False, 2, {"data": 1}, False),
    ("compression", True, 2, {}, False),
])
def test_envelope_degrade_matrix(case, compression, stage, shape, inside):
    from deepspeed_tpu_torch.runtime.engine import grad_sync_envelope
    ok, why = grad_sync_envelope(compression, stage, dict(SHAPE, **shape))
    assert ok is inside, (case, why)
    assert (why == "") is inside


def test_engine_forced_sync_outside_envelope_degrades(caplog):
    """One process is a single data rank: a forced int8 sync warns with
    the JAX engine's words and runs exact; an unexecutable forced
    algorithm raises."""
    import torch
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.utils.logging import logger

    model = torch.nn.Linear(4, 4)

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = model

        def forward(self, batch):
            return self.lin(torch.as_tensor(batch["x"])).square().mean()

    cfg = {"train_batch_size": 2,
           "optimizer": {"type": "SGD", "params": {"lr": 0.1}},
           "comm_plan": {"enabled": True,
                         "overrides": {"grad_reduce_scatter": "int8"}}}
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger.addHandler(handler)
    try:
        eng, *_ = ds.initialize(model=Wrap(), config=cfg, device="cpu")
    finally:
        logger.removeHandler(handler)
    assert eng.comm_plan_ctx.resolved["grad_reduce_scatter"] == "exact"
    assert any("running exact" in m and "single DP rank" in m
               for m in records), records
    m = eng.train_batch({"x": np.ones((2, 4), np.float32)})
    assert m["grad_sync_algo"] == "exact" and np.isfinite(m["loss"])
    with pytest.raises(ValueError, match="not executable"):
        ds.initialize(model=Wrap(), config=dict(cfg, comm_plan={
            "enabled": True, "overrides": {"grad_reduce_scatter": "onebit"}}),
            device="cpu")


def test_comm_plan_cli_show_and_runner(tmp_path, capsys):
    from deepspeed_tpu.comm_plan.cli import main as jmain
    from deepspeed_tpu_torch.comm_plan.cli import main as tmain
    from deepspeed_tpu_torch.launcher import runner
    path = str(tmp_path / "plan.json")
    tcp.select_plan(_rows()).save(path)
    outs = []
    for main in (tmain, jmain):
        for q in (f"reduce_scatter:data:{8 * 2 ** 20}",
                  f"reduce_scatter:data:{512 * 2 ** 20}"):
            assert main(["show", path, "--query", q]) == 0
            outs.append(capsys.readouterr().out)
    assert outs[:2] == outs[2:]
    assert "-> int8 (plan entry)" in outs[0]
    assert "(heuristic: no plan entry covers this bucket)" in outs[1]
    with pytest.raises(SystemExit) as ex:
        runner.main(["comm-plan", "show", path])
    assert ex.value.code == 0
    assert "reduce_scatter" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 5.3"):
        tmain(["sweep", "--out", str(tmp_path / "x.json")])
