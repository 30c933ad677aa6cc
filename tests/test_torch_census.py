"""The op and host-read census of the EM drivers
(``repro_torch.analysis.census``) on the CPU.

* Known-bad loops, each caught exactly once: a float64 value (PT001), an
  extra ``.tolist()`` (PT002) and a ``torch.tensor(list)`` onto the device
  (PT003) inside a MAP scope, and a scatter over budget (PT005).
* Kernel entries are opaque: a ``kernels.ops`` call is one launch and no
  device op, the plain version behind it runs unseen; the census leaves
  ``kernels.ops`` and the workspaces as it found them.
* Every (driver, mode) at K = 2 and 3 with two EM and two MAP iterations
  stays within the registry's budget (the float64 of the EM boundary
  suppressed).
* The counts do not depend on the plan's size: a 48x48 plan over a 6x6
  grid gives, scope by scope, the counts the committed baseline holds for
  the 32x32 plan.
* Exactly one host read per MAP iteration in every driver and mode, and
  one launch per MAP iteration for ``static-pallas`` under ``run_em``.
* The compiled EM program (``static-pallas`` ``run_em`` and
  ``run_em_batched``): on the CPU its plain version's rows (one launch and
  one read of a condition word per MAP iteration and per EM boundary, no
  device op there; per solve two launches, the neighbourhood sizes and the
  start, and one read of the counters); its card rows
  (``registry.PROGRAM_CARD``: no MAP or EM scope, the solve's counts the
  CPU's but for the labels' gather by the device's parity words) and the
  graph's kernels per iteration (``registry.PROGRAM_GRAPH``).
"""

import json
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import census, cli, findings, registry
from repro_torch.kernels import ops
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

BASELINE = json.loads((Path(__file__).resolve().parents[1]
                       / "src/repro_torch/analysis/ANALYSIS.json").read_text())
PAIRS = [(d, m) for d in registry.DRIVERS for m in registry.MODES]
_GENEROUS = {c: 1000 for c in census.COUNTERS}


def _budget(**map_iteration):
    return {census.MAP_ITERATION: {**_GENEROUS, **map_iteration},
            census.EM_BOUNDARY: dict(_GENEROUS)}


def _loop(body, n=3):
    """``n`` MAP-scope instances of ``body`` under a census."""
    with census.take() as cen:
        for _ in range(n):
            cen.enter(census.MAP_ITERATION)
            body()
        cen.leave(census.MAP_ITERATION)
    return cen.summary()


def _clean():
    x = torch.arange(8, dtype=torch.float32)
    (x * 2 + 1).sum()
    torch.stack([x.min() > 0, x.max() < 10]).tolist()


def _float64():
    _clean()
    torch.arange(8, dtype=torch.float32).double().sum()


def _extra_read():
    _clean()
    torch.ones(2).tolist()


def _host_copy():
    _clean()
    torch.tensor([1.0, 2.0], device="cpu")


def _scatter():
    _clean()
    torch.zeros(4).index_add_(0, torch.tensor([0, 1]), torch.ones(2))


@pytest.mark.parametrize("body,code,budget", [
    (_clean, None, _budget(host_reads=1)),
    (_float64, "PT001", _budget(host_reads=1)),
    (_extra_read, "PT002", _budget(host_reads=1)),
    (_host_copy, "PT003", _budget(host_reads=1)),
    (_scatter, "PT005", _budget(host_reads=1, scatters=0)),
], ids=["clean", "PT001", "PT002", "PT003", "PT005"])
def test_fixture_loop_caught_exactly_once(body, code, budget):
    summary = _loop(body)
    found = census.check(summary, "fixture", budget)
    assert [f.code for f in found] == ([code] if code else [])
    assert summary[census.MAP_ITERATION]["instances"] == 3


def test_kernel_entries_are_opaque_and_restored():
    before = (ops.segment_reduce, ops.fused_em_tick, type(None))
    v = torch.rand(64)
    ids = torch.randint(0, 8, (64,), dtype=torch.int32)
    summary = _loop(lambda: ops.segment_reduce(v, ids, 8), n=2)
    mx = summary[census.MAP_ITERATION]["max"]
    assert mx["launches"] == 1 and mx["device_ops"] == 0 and mx["scatters"] == 0
    assert (ops.segment_reduce, ops.fused_em_tick, type(None)) == before
    assert census.ACTIVE is None
    for cls in census.kernel_workspaces():
        assert not hasattr(cls.step, "__wrapped__")


def test_marker_outside_a_scope_counts_nothing():
    with census.take() as cen:
        torch.ones(3).sum().item()
    assert cen.summary()[census.MAP_ITERATION]["instances"] == 0
    assert all(not c for c in cen.by_op.values())


@pytest.mark.parametrize("driver,mode", PAIRS)
def test_driver_within_budget_at_k2_k3(driver, mode):
    for k in (2, 3):
        summary = cli.run_census(driver, mode, k, max_em_iters=2, max_map_iters=2)
        found, _ = findings.apply_suppressions(
            census.check(summary, f"{driver}[{mode}/K={k}]", registry.census_budget(driver, mode)),
            registry.SUPPRESSIONS)
        assert [f for f in found if not f.suppressed] == []
        assert summary[census.MAP_ITERATION]["instances"] > 0


_SIZE_48 = {}


def _census_48(driver, mode):
    if (driver, mode) not in _SIZE_48:
        _SIZE_48[driver, mode] = cli.run_census(driver, mode, 2, size=48, grid=6)
    return _SIZE_48[driver, mode]


def _baseline(driver, mode, k=2):
    (entry,) = [e for e in BASELINE["census"]
                if (e["driver"], e["mode"], e["k"]) == (driver, mode, k)]
    return entry["census"]


@pytest.mark.parametrize("driver,mode", PAIRS)
def test_counts_do_not_depend_on_plan_size(driver, mode):
    big, small = _census_48(driver, mode), _baseline(driver, mode)
    for scope in census.SCOPES:
        assert big[scope]["max"] == small[scope]["max"], scope
        assert big[scope]["min"] == small[scope]["min"], scope


@pytest.mark.parametrize("driver,mode", PAIRS)
def test_one_host_read_per_map_iteration(driver, mode):
    runs = [_census_48(driver, mode)] + [_baseline(driver, mode, k) for k in registry.KS]
    for s in runs:
        m = s[census.MAP_ITERATION]
        assert m["max"]["h2d_copies"] == 0
        if driver == "run_em_ticked":
            # A tick's plain program runs its micro-steps with the loop's
            # condition as a mask: the step, the stop test and the tail, the
            # mask's device ops, and no read; its one read is the tick's own
            # (the solve scope's), of every word at once.
            assert m["min"]["host_reads"] == m["max"]["host_reads"] == 0
            assert m["min"]["launches"] == m["max"]["launches"] == 3
            assert s[census.EM_BOUNDARY]["max"]["host_reads"] == 0
            tick = s[census.SOLVE]
            assert tick["min"]["host_reads"] == tick["max"]["host_reads"] == 1
            assert tick["max"]["h2d_copies"] == 0
            continue
        # Every other driver runs its program (here the plain version): a
        # MAP iteration is the step (one launch) and one read of the loop's
        # condition word; no device op outside them.
        assert m["min"]["host_reads"] == m["max"]["host_reads"] == 1
        assert (m["min"]["launches"], m["max"]["launches"]) == (1, 1)
        assert m["max"]["device_ops"] == 0


PROGRAM = [("run_em", "static-pallas"), ("run_em_batched", "static-pallas")]


@pytest.mark.parametrize("driver,mode", PROGRAM)
def test_plain_program_rows(driver, mode):
    for k in registry.KS:
        s = _baseline(driver, mode, k)
        for scope in (census.MAP_ITERATION, census.EM_BOUNDARY):
            mx, mn = s[scope]["max"], s[scope]["min"]
            assert mx == mn and (mx["launches"], mx["host_reads"], mx["device_ops"]) == (1, 1, 0)
        solve = s[census.SOLVE]
        assert solve["instances"] == 1
        assert (solve["max"]["launches"], solve["max"]["host_reads"], solve["max"]["h2d_copies"]) \
            == (2, 1, 0)
        # The audit's solve runs to its EM cap: one boundary per EM iteration.
        assert s[census.EM_BOUNDARY]["instances"] == registry.AUDIT_MAX_EM_ITERS


@pytest.mark.parametrize("driver,mode", PROGRAM)
def test_program_card_rows(driver, mode):
    card = registry.PROGRAM_CARD[(driver, mode)]
    assert card[census.MAP_ITERATION] is None and card[census.EM_BOUNDARY] is None
    cpu = _baseline(driver, mode)[census.SOLVE]["max"]
    want = dict(cpu, device_ops=cpu["device_ops"] + 2, gathers=cpu["gathers"] + 1)
    assert card[census.SOLVE] == want
    assert registry.PROGRAM_GRAPH == {"tick_per_map_iteration": 1, "boundary_per_em_iteration": 1,
                                      "init_per_solve": 1, "host_reads": 0}
