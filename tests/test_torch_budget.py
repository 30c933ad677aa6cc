"""The port's budget ledger (``repro_torch.analysis.budget``) against the
JAX package's (``repro.analysis.budget``), and the port's writers.

The ledger is a stdlib copy, so the same sequence of bumps, resets and
``expect`` blocks must leave the same counters and raise the same errors
in both.  The reference's process-global ``LEDGER`` is never touched: each
side's ``expect`` reads a fresh ledger put in its place.  The port writes
the reference's sections: ``"trace"`` (every MAP-iteration workspace
built, by kind; ``kernels.ops.WORKSPACE_BUILDS`` is its total),
``"compile"`` (``lower_compile`` on a session's cache miss, ``warm_hit``
on a hit) and ``"serve"`` (the engine's ``ticks`` and ``lane_steps``); the
reference's declared budgets hold on a cold compile, a warm execute and a
warm engine tick, on the CPU at 44x44 with a 6x6 grid.
"""

import numpy as np
import pytest

from repro.analysis import budget as ref_budget

from repro_torch import api
from repro_torch.analysis import budget
from repro_torch.core import synthetic
from repro_torch.kernels import ops
from repro_torch.serving import SegmentationEngine


def _script(mod):
    """One sequence of ledger operations; returns what it observed."""
    led = mod.LEDGER
    seen = []
    sec = led.section("trace", keys=("a", "b"))
    seen.append(led.snapshot())
    sec["a"] += 2                       # a live alias writes through
    seen.append((led.bump("trace", "b"), led.bump("compile", "lower_compile"),
                 led.bump("serve", "lane_steps", 7), led.total("trace"), led.total("nope")))
    with mod.expect("warm_execute"):
        led.bump("compile", "warm_hit")  # another section: no trace event
    with mod.expect("cold_compile"):
        led.bump("trace", "a")
    for phase, n in (("warm_tick", 1), ("cold_compile", 2)):
        try:
            with mod.expect(phase):
                led.bump("trace", "b", n)
        except mod.BudgetExceeded as e:
            seen.append((e.phase, e.section, e.delta, e.max_delta, str(e)))
    seen.append(led.snapshot())
    led.reset("serve")
    led.reset("nope")
    seen.append(led.snapshot())
    assert led.section("trace") is sec   # resets zero in place
    led.reset()
    seen.append((led.snapshot(), sec))
    return seen


def test_ledger_semantics_equal_the_reference(monkeypatch):
    monkeypatch.setattr(budget, "LEDGER", budget.Ledger())
    monkeypatch.setattr(ref_budget, "LEDGER", ref_budget.Ledger())
    assert _script(budget) == _script(ref_budget)
    assert [(b.phase, b.section, b.max_delta) for b in budget.BUDGETS] == \
        [(b.phase, b.section, b.max_delta) for b in ref_budget.BUDGETS]
    assert budget.budget_for("warm_tick").max_delta == 0
    with pytest.raises(KeyError):
        budget.budget_for("nope")
    assert issubclass(budget.BudgetExceeded, AssertionError)


def test_workspace_builds_are_the_trace_section():
    assert ops.BUILDS is budget.LEDGER.section("trace")
    before, kinds = ops.WORKSPACE_BUILDS, dict(ops.BUILDS)
    ops.tick_workspace((64, 8, 9, 2), device="cpu", batch=2)
    assert ops.WORKSPACE_BUILDS == before + 1 == budget.LEDGER.total("trace")
    assert ops.BUILDS["batch_tick"] == kinds["batch_tick"] + 1
    with pytest.raises(AttributeError):
        ops.NO_SUCH_COUNT


def test_port_writers_stay_within_the_declared_budgets():
    vol = synthetic.make_synthetic_volume(seed=3, n_slices=3, shape=(44, 44), device="cpu")
    seg = api.Segmenter(api.ExecutionConfig(overseg_grid=(6, 6)), device="cpu")
    plans = [seg.plan(img) for img in vol.images]
    compiles = dict(budget.LEDGER.section("compile"))
    with budget.expect("cold_compile"):
        seg.compile(plans[0])
    with budget.expect("warm_execute"):
        seg.execute(plans[0])
    sec = budget.LEDGER.section("compile")
    assert sec["lower_compile"] == compiles.get("lower_compile", 0) + 1
    assert sec["warm_hit"] == compiles.get("warm_hit", 0) + 1

    engine = SegmentationEngine(seg, max_batch=2, tick_iters=2)
    serve = dict(budget.LEDGER.section("serve"))
    for rid, p in enumerate(plans):
        engine.submit(p, rid=rid)
    engine.step()   # the pool's bring-up
    while engine.pending() or engine.active():
        with budget.expect("warm_tick"):
            engine.step()
    st = engine.stats()
    sec = budget.LEDGER.section("serve")
    assert sec["ticks"] - serve.get("ticks", 0) == st["ticks"] > 1
    assert sec["lane_steps"] - serve.get("lane_steps", 0) == st["lane_steps"] > 0
    assert np.isfinite(st["tick_cost"]["model_per_step_s"])
