"""The ticked form of the modes ``static`` and ``faithful`` on the CPU:
``em.run_em_ticked`` on a ``DppPoolWorkspace`` (one flat MAP iteration of
every live lane per micro-step, each lane at its own iteration) and the
``SegmentationEngine`` on it.

* Against the JAX package's ``run_em_ticked`` (``backend="xla"``) in each
  mode: the static pool form (``_pool_tick_micro`` with its vote plan)
  and the vmapped faithful form, on the K = 2 stack of
  ``tests/test_torch_modes_batched.py`` (three lanes at different
  iteration counts).  Labels, counts and status exact; mu, sigma and
  energies within rtol/atol 1e-5.  Each mode's JAX run is made once, in a
  module-scoped fixture.
* Every lane of a two-slot pool fed three requests bit for bit its serial
  ``run_em`` at K = 2, 3 and 9; admission, retirement and a hold write one
  slot's rows alone.
* The engine against serial ``execute`` bit for bit: a stream at a fixed
  tick and ``"auto"``, a mixed-K pool (K = 2 requests in a K = 3 pool
  equal their own K's solve), a chaos stream (``bad_init`` and
  ``nan_data`` diverged, ``never_converge`` evicted, the healthy lanes bit
  for bit), and a tick replayed under ``FallbackPolicy`` after a transient
  execute failure.  No workspace is built after the pool's setup.
* A live pool's switch to the plain route (``FallbackPolicy(backend=
  "torch")``, the session's route labelled ``"cuda"`` and failed by the
  chaos harness or by a micro-step that raises after the tick's first):
  the engine's completions bit for bit serial ``execute``; a pool carried
  onto another pool workspace after its first tick (``em.carry_tick_state``)
  finishes bit for bit as the JAX ``run_em_ticked`` fixture's lanes and
  serial ``run_em``.
* ``launch.serve --mode static|faithful --check`` exits 0, and the
  reference's flags: ``--backend``, ``--deadline-spread``, ``--chaos-seed``
  and ``--latency-gate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pmrf import em as jax_em

from repro_torch import api
from repro_torch.core import synthetic
from repro_torch.core.pmrf import em as torch_em
from repro_torch.core.pmrf import energy as E
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TickShape
from repro_torch.serving import SegmentationEngine
from repro_torch.testing import chaos

from test_torch_modes_batched import (MAX_EM, MAX_MAP, MODES, TOL, _assert_same, _config,
                                      _jax_stack, _lane_hoods, _stack)
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()


def _lanes(n_labels):
    _, _, _, (hoods, model, lab0, mu0, sig0) = _stack(n_labels)
    return [(_lane_hoods(hoods, b), E.EnergyModel(*(t[b] for t in model)), lab0[b], mu0[b],
             sig0[b]) for b in range(3)]


def _serve(lanes, mode, batch=2, tick_iters=3):
    """Every lane through a pool of ``batch`` slots; returns (results by
    lane, micro-steps, pool workspace)."""
    cfg = _config(mode)
    ws = torch_em.make_workspace(TickShape.of(lanes[0][0], lanes[0][1]), cfg, device="cpu",
                                 batch=batch, pool=True)
    state = torch_em.blank_tick_state(ws)
    queue, slots, results, steps = list(range(len(lanes))), [None] * batch, {}, 0
    while queue or any(s is not None for s in slots):
        for b in range(batch):
            if slots[b] is None and queue:
                slots[b] = queue.pop(0)
                torch_em.init_tick_lane(state, b, *lanes[slots[b]])
        state, n = torch_em.run_em_ticked(state, cfg, tick_iters)
        steps += n
        for b in range(batch):
            if slots[b] is not None and state.done[b]:
                results[slots[b]] = torch_em.tick_result(state, b)
                slots[b] = None
    return results, steps, ws


@pytest.fixture(scope="module", params=MODES)
def jax_ticked(request):
    """One mode's JAX ``run_em_ticked`` of the K = 2 stack, every lane in
    its own slot, ticked to the end (run once)."""
    mode = request.param
    _, _, _, inputs = _stack(2)
    hoods, model, lab0, mu0, sig0 = _jax_stack(inputs)
    state = jax.vmap(lambda l, m, s: jax_em.init_tick_lane(l, m, s, hoods.n_hoods))(lab0, mu0, sig0)
    vplan = jax.vmap(lambda v: jax_em.make_vote_plan(v, hoods.n_regions))(hoods.vertex)
    cfg = jax_em.EMConfig(mode=mode, backend="xla", max_em_iters=MAX_EM, max_map_iters=MAX_MAP)
    while not bool(np.all(np.asarray(state.done))):
        state, _ = jax_em.run_em_ticked(hoods, model, state, vplan, cfg, 8)
    return mode, jax_em.tick_result(state)


def test_run_em_ticked_matches_jax(jax_ticked):
    mode, want = jax_ticked
    got, _, _ = _serve(_lanes(2), mode)
    for b in range(3):
        what = f"{mode} lane {b}"
        np.testing.assert_array_equal(got[b].labels.numpy(), np.asarray(want.labels[b]), what)
        assert (got[b].em_iters, got[b].map_iters, got[b].status) == (
            int(want.em_iters[b]), int(want.map_iters[b]), int(want.status[b])), what
        for f in ("mu", "sigma", "hood_energy", "total_energy"):
            np.testing.assert_allclose(getattr(got[b], f).numpy(), np.asarray(getattr(want, f)[b]),
                                       err_msg=f"{what} {f}", **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_labels", [2, 3, 9])
def test_every_lane_equals_its_serial_run_em(n_labels, mode):
    lanes = _lanes(n_labels)
    ops.reset_launch_counts()
    got, steps, _ = _serve(lanes, mode)
    assert ops.LANE_STEPS == steps
    for i, lane in enumerate(lanes):
        _assert_same(got[i], torch_em.run_em(*lane, _config(mode)), f"K={n_labels} {mode} {i}")


@pytest.mark.parametrize("mode", MODES)
def test_admission_retirement_and_hold_touch_one_slot(mode):
    lanes = _lanes(2)
    cfg = _config(mode)
    ws = torch_em.make_workspace(TickShape.of(lanes[0][0], lanes[0][1]), cfg, device="cpu",
                                 batch=3, pool=True)
    state = torch_em.blank_tick_state(ws)
    for b in range(2):
        torch_em.init_tick_lane(state, b, *lanes[b])
    torch_em.run_em_ticked(state, cfg, 2)
    names = ("labels", "ring", "hood_e", "stats", "active", "map_i", "mu", "sigma", "vertex",
             "hood_id", "valid", "rep_old_index", "region_mean", "region_weight", "beta")
    before = {n: getattr(ws, n).clone() for n in names}
    torch_em.init_tick_lane(state, 2, *lanes[2])
    state.retire(2)
    state.hold(2, np.ones(2, np.float32))
    for n in names:
        for b in range(2):
            assert torch.equal(getattr(ws, n)[b], before[n][b]), f"lane {b} {n}"
    assert state.done[:2] == [False, False] and not state.done[2]
    with pytest.raises(ValueError, match="slot 3"):
        ws.retire(3)


def _same(a, b):
    for f in ("region_labels", "segmentation", "mu", "sigma"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.em_iters, a.map_iters, a.status, a.total_energy) == (
        b.em_iters, b.map_iters, b.status, b.total_energy)


def _engine_session(mode, n_labels=2, **kw):
    return api.Segmenter(api.ExecutionConfig(mode=mode, n_labels=n_labels, overseg_grid=(5, 5),
                                             init="quantile", capacity_bucket=1024, **kw),
                         device="cpu")


def _stream(sess, n=5, seed=3):
    vol = synthetic.make_synthetic_volume(seed=seed, n_slices=n, shape=(40, 40), device="cpu")
    return [sess.plan(im) for im in vol.images]


def _run(engine, plans, faults=None):
    with chaos.inject(chaos.ChaosConfig(seed=7, **(faults or {}))) as monkey:
        for rid, p in enumerate(plans):
            engine.submit(p, rid=rid, seed=0)
        comps = engine.run()
    return {c.rid: c for c in comps}, monkey


@pytest.mark.parametrize("mode", MODES)
def test_engine_equals_serial_execute(mode):
    sess = _engine_session(mode)
    plans = _stream(sess)
    serial = [sess.execute(p, seed=0) for p in plans]
    for tick in (3, "auto"):
        engine = SegmentationEngine(sess, max_batch=2, tick_iters=tick)
        engine.submit(plans[0], rid=99)
        engine.step()  # the pool's setup: its compile and workspace
        builds = ops.WORKSPACE_BUILDS
        comps, _ = _run(engine, plans)
        assert ops.WORKSPACE_BUILDS == builds, "a workspace built after the pool's setup"
        for rid, want in enumerate(serial):
            assert comps[rid].status in ("converged", "max_iters")
            _same(comps[rid].result, want)


@pytest.mark.parametrize("mode", MODES)
def test_engine_mixed_k_pool(mode):
    """Two K = 2 and two K = 3 requests in a K = 3 pool: the K = 3 requests
    equal their serial execute, the K = 2 ones their own K's solve (their
    padded label at the inert mu)."""
    sess2, sess3 = _engine_session(mode), _engine_session(mode, n_labels=3)
    plans2 = _stream(sess2, n=2)
    vol3 = synthetic.make_kary_volume(seed=3, n_slices=2, shape=(40, 40), n_phases=3, device="cpu")
    plans = plans2 + [sess3.plan(im) for im in vol3.images]
    comps, _ = _run(SegmentationEngine(sess3, max_batch=2, tick_iters=4), plans)
    for rid, p in enumerate(plans):
        got = comps[rid].result
        if rid < 2:
            want = sess2.execute(p, seed=0)
            np.testing.assert_array_equal(got.region_labels, want.region_labels)
            np.testing.assert_array_equal(got.mu[:2], want.mu)
            np.testing.assert_array_equal(got.sigma[:2], want.sigma)
            assert got.mu[2] == torch_em.INERT_MU
            assert (got.em_iters, got.map_iters, got.status) == (want.em_iters, want.map_iters,
                                                               want.status)
        else:
            _same(got, sess3.execute(p, seed=0))


@pytest.mark.parametrize("mode", MODES)
def test_engine_chaos_stream(mode):
    sess = _engine_session(mode)
    plans = _stream(sess, n=6)
    engine = SegmentationEngine(sess, max_batch=3, tick_iters=4, max_ticks_resident=12)
    comps, monkey = _run(engine, plans, dict(bad_init_rids=(1,), nan_data_rids=(2,),
                                            never_converge_rids=(4,)))
    assert {r: comps[r].status for r in (1, 2, 4)} == {1: "diverged", 2: "diverged",
                                                       4: "evicted"}
    assert {e["kind"] for e in monkey.events} == {"bad_init", "nan_data", "never_converge"}
    for rid in (0, 3, 5):
        _same(comps[rid].result, sess.execute(plans[rid], seed=0))


@pytest.mark.parametrize("mode", MODES)
def test_engine_tick_replayed_under_fallback_policy(mode):
    sess = _engine_session(mode)
    plans = _stream(sess, n=3)
    engine = SegmentationEngine(sess, max_batch=2, tick_iters=3)
    comps, monkey = _run(engine, plans, dict(transient_exec_failures=1))
    assert [e["kind"] for e in monkey.events] == ["transient_exec_fail"]
    assert engine.stats()["tick_retries"] == 1 and not sess.fallback_events
    for rid, p in enumerate(plans):
        _same(comps[rid].result, sess.execute(p, seed=0))


def test_carried_pool_matches_jax(jax_ticked):
    """The K = 2 lanes through a two-slot pool that is carried onto a fresh
    pool workspace after its first tick, at the tick's snapshot and as it
    stands: every lane bit for bit its serial ``run_em`` and within the
    JAX fixture's tolerance of its ``run_em_ticked``."""
    mode, want = jax_ticked
    lanes, cfg = _lanes(2), _config(mode)
    shape = TickShape.of(lanes[0][0], lanes[0][1])
    for at_snapshot in (True, False):
        ws = torch_em.make_workspace(shape, cfg, device="cpu", batch=2, pool=True)
        state = torch_em.blank_tick_state(ws)
        for b in range(2):
            torch_em.init_tick_lane(state, b, *lanes[b])
        snap = torch_em.tick_snapshot(state) if at_snapshot else None
        state, _ = torch_em.run_em_ticked(state, cfg, 3)
        if at_snapshot:  # replay the first tick on the new pool
            assert state.micro_steps == 3
        other = torch_em.make_workspace(shape, cfg._replace(backend="torch"), device="cpu",
                                        batch=2, pool=True)
        state = torch_em.carry_tick_state(state, other, snap)
        assert state.workspace is other and other.owner() is state
        assert state.micro_steps == (0 if at_snapshot else 3)
        queue, slots, got = [2], [0, 1], {}
        while any(s is not None for s in slots):
            state, _ = torch_em.run_em_ticked(state, cfg, 3)
            for b in range(2):
                if slots[b] is not None and state.done[b]:
                    got[slots[b]] = torch_em.tick_result(state, b)
                    slots[b] = queue.pop(0) if queue else None
                    if slots[b] is not None:
                        torch_em.init_tick_lane(state, b, *lanes[slots[b]])
        for b in range(3):
            what = f"{mode} lane {b} (snapshot: {at_snapshot})"
            _assert_same(got[b], torch_em.run_em(*lanes[b], cfg), what)
            np.testing.assert_array_equal(got[b].labels.numpy(), np.asarray(want.labels[b]), what)
            assert (got[b].em_iters, got[b].map_iters, got[b].status) == (
                int(want.em_iters[b]), int(want.map_iters[b]), int(want.status[b])), what
            for f in ("mu", "sigma", "hood_energy", "total_energy"):
                np.testing.assert_allclose(getattr(got[b], f).numpy(),
                                           np.asarray(getattr(want, f)[b]), err_msg=f"{what} {f}",
                                           **TOL)
    with pytest.raises(ValueError, match="carried onto"):
        torch_em.carry_tick_state(state, torch_em.make_workspace(
            shape, cfg, device="cpu", batch=3, pool=True))


@pytest.mark.parametrize("fault", ["before_first_micro_step", "after_first_micro_step"])
@pytest.mark.parametrize("mode", MODES)
def test_engine_switches_routes_mid_stream(mode, fault, monkeypatch):
    """A mode's pool whose kernel route fails from its second tick on
    switches once to the plain route (one event, one warning, the plain
    pool built once); every completion equals its serial ``execute`` bit
    for bit."""
    monkeypatch.setattr(api.ExecutionConfig, "resolved_backend",
                        lambda self, device: "torch" if self.backend == "torch" else "cuda")
    sess = _engine_session(mode, fallback=api.FallbackPolicy(backend="torch", backoff_s=0.0))
    plans = _stream(sess, n=4)
    serial = [sess.execute(p, seed=0) for p in plans]
    engine = SegmentationEngine(sess, max_batch=2, tick_iters=3)
    for rid, p in enumerate(plans):
        engine.submit(p, rid=rid, seed=0)
    engine.step()
    builds = ops.WORKSPACE_BUILDS
    faults = dict(exec_fail_backends=("cuda",))
    if fault == "after_first_micro_step":
        real, kernel_pool, seen = torch_em._tick_micro, engine._state.workspace, []

        def micro(state, config):
            if state.workspace is kernel_pool:
                seen.append(1)
                if len(seen) == 2:
                    raise RuntimeError("allocator pressure")
            return real(state, config)

        monkeypatch.setattr(torch_em, "_tick_micro", micro)
        faults = {}
    with pytest.warns(RuntimeWarning, match="switches to 'torch'") as caught:
        comps, _ = _run(engine, [], faults)
    assert sum(w.category is RuntimeWarning for w in caught) == 1
    [event] = engine.fallback_events
    assert (event["stage"], event["from"], event["to"]) == ("tick", "cuda", "torch")
    assert engine.stats()["fallbacks"] == 1 and engine._exe.key.backend == "torch"
    assert ops.WORKSPACE_BUILDS == builds + 1
    assert isinstance(engine._state.workspace, torch_em.DppPoolWorkspace)
    assert engine._state.workspace.backend == "torch"
    for rid, want in enumerate(serial):
        _same(comps[rid].result, want)


@pytest.mark.parametrize("mode", MODES)
def test_launch_serve_mode_flag_checks(mode, capsys):
    """``launch.serve --mode`` serves a stream in the mode and ``--check``
    holds every completion to serial ``execute`` bit for bit."""
    from repro_torch.launch import serve as launch_serve

    args = ["--requests", "3", "--shape", "40", "--grid", "5", "--max-batch", "2",
            "--tick-iters", "3", "--device", "cpu", "--check", "--mode", mode]
    assert launch_serve.main(args) == 0
    assert '"check": "ok"' in capsys.readouterr().out


SERVE_ARGS = ["--requests", "4", "--shape", "40", "--grid", "5", "--max-batch", "2",
              "--tick-iters", "3", "--device", "cpu"]


def _serve_main(args, capsys):
    """``launch.serve.main(args)``: its exit code, its completion lines in
    print order and its report."""
    import json

    from repro_torch.launch import serve as launch_serve

    code = launch_serve.main(SERVE_ARGS + args)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    return code, lines[:-1], lines[-1]


def test_launch_serve_deadline_spread_orders_admission(monkeypatch, capsys):
    """``--deadline-spread S``: request ``rid`` is submitted with the
    deadline ``S * rid / (n - 1)`` seconds (the reference's), and one slot
    admits the stream in deadline order."""
    submitted = {}
    real_submit = SegmentationEngine.submit

    def submit(self, image_or_plan, *, rid=None, deadline_s=None, **kw):
        submitted[rid] = deadline_s
        return real_submit(self, image_or_plan, rid=rid, deadline_s=deadline_s, **kw)

    monkeypatch.setattr(SegmentationEngine, "submit", submit)
    code, comps, report = _serve_main(["--max-batch", "1", "--deadline-spread", "6"], capsys)
    assert code == 0 and submitted == {rid: 6.0 * rid / 3 for rid in range(4)}
    assert [c["rid"] for c in comps] == sorted(submitted, key=submitted.get)
    assert report["requests"] == 4


def test_launch_serve_chaos_seed_draws_the_references_faults(capsys):
    """``--chaos --chaos-seed N``: the fault map is the reference's
    ``assign_faults`` draw for N (not ``--seed``'s, whose draw differs),
    and ``--check`` holds every faulted request to its disposition."""
    from repro.launch import serve as jax_serve

    from repro_torch.launch import serve as launch_serve

    code, _, report = _serve_main(["--requests", "8", "--chaos", "--poison-rate", "0.5",
                                   "--chaos-seed", "3", "--check", "--max-batch", "3"], capsys)
    want = jax_serve.assign_faults(8, 0.5, 3)
    assert want != jax_serve.assign_faults(8, 0.5, 0), "test premise: the seeds draw apart"
    assert launch_serve.assign_faults(8, 0.5, 3) == want
    assert code == 0 and report["check"] == "ok" and report["chaos"]["seed"] == 3
    assert report["chaos"]["faults"] == {str(r): f for r, f in sorted(want.items())}


def test_launch_serve_latency_gate(capsys):
    """``--latency-gate``: refused without ``--check`` and below 0 (the
    reference's checks); a gate wide enough passes and reports
    ``serial_p50_s`` and ``latency_gate_x``."""
    from repro_torch.launch import serve as launch_serve

    for bad in (["--latency-gate", "5"], ["--latency-gate", "-1", "--check"]):
        with pytest.raises(SystemExit) as err:
            launch_serve.main(SERVE_ARGS + bad)
        assert err.value.code == 2
    assert "--latency-gate" in capsys.readouterr().err
    code, comps, report = _serve_main(["--check", "--latency-gate", "1000"], capsys)
    assert code == 0 and report["check"] == "ok" and len(comps) == 4
    assert report["serial_p50_s"] > 0.0 and 0.0 < report["latency_gate_x"] < 1000


def test_launch_serve_backend_torch_serves_the_plain_route(monkeypatch, capsys):
    """``--backend torch``: the session's config asks for the plain route
    and every executable it builds is keyed ``"torch"`` (with the route
    labelled ``"cuda"`` otherwise, as on the card)."""
    from repro_torch.launch import serve as launch_serve

    monkeypatch.setattr(api.ExecutionConfig, "resolved_backend",
                        lambda self, device: "torch" if self.backend == "torch" else "cuda")
    sessions = []
    real = launch_serve.api.Segmenter

    def segmenter(*args, **kw):
        sessions.append(real(*args, **kw))
        return sessions[-1]

    monkeypatch.setattr(launch_serve.api, "Segmenter", segmenter)
    for backend, route in (("torch", "torch"), ("auto", "cuda")):
        sessions.clear()
        code, _, report = _serve_main(["--check", "--backend", backend, "--requests", "2"],
                                      capsys)
        assert code == 0 and report["backend"] == backend
        [sess] = sessions
        assert sess.config.backend == backend
        assert {k.backend for k in sess.cache_keys} == {route}
