"""The compiled EM program of mode static-pallas on the CPU: its plain
version (``kernels.ref.run_program``, the control structure of the card's
CUDA graph) and the EM boundary's plain version
(``kernels.ref.em_boundary``/``em_boundary_lanes``, the contract of the
boundary kernel).

* Boundary: over stacks whose lanes reach every branch
  (``testing.boundary_cases``: a dead label, a degenerate one, NaN sums,
  the MAP loop's diverged flag, a loop of no iteration, a converging
  ring, an inert label, a finished lane) at EM iterations around the
  window and the cap, at K = 2, 3, 9: the lane form bit for bit the host
  boundary the port ran before the program (``energy.params_from_stats``,
  ``em._degenerate_components``, ``em._total_energy``,
  ``em._window_converged``, ``em._boundary_status``); the single form bit
  for bit the lane form's lane; the parameters, degeneracy and status
  against the reference's ``params_from_stats``, ``_degenerate_components``
  and ``_boundary_status`` (parameters within rtol 1e-6: the reference
  forms ``E[y^2] - mu^2`` in float32).
* Program: ``run_em`` against the JAX ``run_em`` at K = 2 and 3 (labels,
  counts and status exact; mu, sigma and hood energies within rtol/atol
  1e-5) and bit for bit the host-stepped driver (``testing.host_loop``,
  the port's ``run_em`` before the program) at K = 2, 3, 9 in f32 and bf16
  and with ``max_map_iters = 1``, ``max_map_iters = 0`` and
  ``max_em_iters = 0``; ``run_em_batched`` at B = 3 against the JAX
  ``run_em_batched`` and every lane bit for bit its serial solve and the
  host-stepped stack.
* The plain program's words: one plain MAP iteration and one read of the
  MAP loop's condition per MAP iteration, one boundary and one read per EM
  iteration, steered by nothing else.
* Session: a compile miss builds one workspace and one program, a warm hit
  neither; a failing program raises under ``FallbackPolicy``'s rules.

The problems are planned by the port on the CPU (48x48 slices) and carried
into the reference's types field by field (``core.pmrf.convert``'s field
lists); each JAX reference is computed once per module.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pmrf import em as jax_em
from repro.core.pmrf import energy as jax_energy
from repro.core.pmrf import hoods as jax_hoods

from repro_torch import api
from repro_torch.api.errors import FallbackError
from repro_torch.core import synthetic
from repro_torch.core.pmrf import convert
from repro_torch.core.pmrf import em as torch_em
from repro_torch.core.pmrf import energy as E
from repro_torch.core.pmrf import pipeline
from repro_torch.core.pmrf.hoods import pad_hoods, stack_hoods
from repro_torch.kernels import ops, ref
from repro_torch.testing import boundary_cases, host_loop
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = boundary_cases.cases()
# (phases, seed, grid) of the 48x48 problems; K = 9 on three phases is the
# card's runtime-K tick.
PROBLEMS = {2: (2, 0, 6), 3: (3, 0, 6), 9: (3, 0, 7)}
N_LANES = 3
_cache = {}


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


def _same_result(a, b):
    return all(_same(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# The boundary
# ---------------------------------------------------------------------------


def _host_boundary(st, max_em_iters, max_map_iters):
    """The port's EM boundary as the host ran it before the program, over
    every lane of ``st`` (a copy), selected into the lanes that ran."""
    st = boundary_cases.clone(st)
    lane, ctl = st.lane, st.ctl
    run, i = lane[ref.RUNNING] != 0, lane[ref.MAP_I].clone()
    model = SimpleNamespace(sigma_min=st.sigma_min, reseed_mu=st.reseed_mu,
                            reseed_sigma=st.reseed_sigma)
    msums = torch.where((i > 0)[:, None, None], st.stats, torch.zeros_like(st.stats))
    mu, sigma, sum_w = E.params_from_stats(model, msums[:, 0], msums[:, 1], msums[:, 2])
    div = (~torch.all(torch.isfinite(mu), dim=-1)) | (~torch.all(torch.isfinite(sigma), dim=-1))
    deg = torch_em._degenerate_components(model, sigma, sum_w)
    hist = torch.cat([torch_em._total_energy(st.hood_e)[:, None], st.total_hist[:, :-1]], dim=1)
    em_i = int(ctl[ref.EM_I]) + 1
    conv = torch_em._window_converged(hist.T) if em_i > boundary_cases.WINDOW else torch.zeros_like(div)
    go = []
    for b in range(lane.shape[1]):
        if not run[b]:
            go.append(False)
            continue
        d = bool(div[b]) or bool(int(lane[ref.FLAG, b]) & ref.FLAG_DIVERGED)
        c = bool(conv[b])
        finished = d or not (em_i < max_em_iters and not c)
        lane[ref.STATUS, b] = torch_em._boundary_status(d, bool(deg[b]), finished, c, em_i,
                                                        max_em_iters)
        lane[ref.EM_ITERS, b] = em_i
        lane[ref.MAP_ITERS, b] += int(i[b])
        lane[ref.RUNNING, b] = int(not (c or d))
        st.em_mu[b], st.em_sigma[b], st.total_hist[b] = mu[b], sigma[b], hist[b]
        go.append(not finished)
        if not finished:
            st.mu[b] = mu[b]
            st.sigma[b] = torch.maximum(sigma[b], st.sigma_min[b])
            st.ring[b] = 0.0
            lane[ref.MAP_I, b] = lane[ref.FLAG, b] = 0
            lane[ref.ACTIVE, b] = int(max_map_iters > 0)
    ctl[ref.STEPS] += int(max([int(i[b]) for b in range(len(go)) if run[b]], default=0))
    ctl[ref.EM_I] = em_i
    ctl[ref.BOUNDARY_LAUNCHES] += 1
    ctl[ref.MAP_LIVE] = sum(go)
    ctl[ref.EM_COND] = int(any(go))
    ctl[ref.MAP_COND] = int(max_map_iters > 0)
    return st


@pytest.mark.parametrize("max_map_iters", [boundary_cases.MAX_MAP_ITERS, 0])
@pytest.mark.parametrize("name,state", CASES, ids=[n for n, _ in CASES])
def test_boundary_lanes_equal_the_host_boundary(name, state, max_map_iters):
    want = _host_boundary(state, boundary_cases.MAX_EM_ITERS, max_map_iters)
    got = boundary_cases.clone(state)
    ref.em_boundary_lanes(got, max_em_iters=boundary_cases.MAX_EM_ITERS,
                          max_map_iters=max_map_iters)
    assert boundary_cases.unequal(got, want) == [], name
    # Every branch is reached somewhere: a lane that diverges, one that is
    # degenerate at a finishing boundary, a stopped lane untouched.
    kinds = {k: j for j, k in enumerate(boundary_cases.LANE_KINDS)}
    assert int(got.lane[ref.STATUS, kinds["nan_sums"]]) == torch_em.STATUS_DIVERGED
    assert int(got.lane[ref.STATUS, kinds["flag_diverged"]]) == torch_em.STATUS_DIVERGED
    assert boundary_cases.unequal(boundary_cases.lane_state(got, kinds["stopped"]),
                                  boundary_cases.lane_state(state, kinds["stopped"])) == ["ctl"]


@pytest.mark.parametrize("name,state", CASES, ids=[n for n, _ in CASES])
def test_single_form_equals_its_lane(name, state):
    stack = boundary_cases.clone(state)
    ref.em_boundary_lanes(stack, max_em_iters=boundary_cases.MAX_EM_ITERS,
                          max_map_iters=boundary_cases.MAX_MAP_ITERS)
    for b in range(state.lane.shape[1]):
        one = boundary_cases.lane_state(state, b)
        ref.em_boundary(one, max_em_iters=boundary_cases.MAX_EM_ITERS,
                        max_map_iters=boundary_cases.MAX_MAP_ITERS)
        lane_b = boundary_cases.lane_state(stack, b)
        assert boundary_cases.unequal(one, lane_b) in ([], ["ctl"]), (name, b)
        assert int(one.ctl[ref.EM_I]) == int(stack.ctl[ref.EM_I])


def test_boundary_statuses_cover_the_lattice():
    seen = set()
    for _, state in CASES:
        got = boundary_cases.clone(state)
        ref.em_boundary_lanes(got, max_em_iters=boundary_cases.MAX_EM_ITERS,
                              max_map_iters=boundary_cases.MAX_MAP_ITERS)
        seen |= set(got.lane[ref.STATUS].tolist())
    assert seen == {torch_em.STATUS_OK, torch_em.STATUS_CONVERGED, torch_em.STATUS_MAX_ITERS,
                    torch_em.STATUS_DIVERGED, torch_em.STATUS_DEGENERATE}


@pytest.mark.parametrize("name,state", CASES, ids=[n for n, _ in CASES])
def test_boundary_against_the_reference(name, state):
    """The boundary's parameters, degeneracy and status against the JAX
    package's ``params_from_stats``, ``_degenerate_components`` and
    ``_boundary_status``, lane by lane."""
    got = boundary_cases.clone(state)
    ref.em_boundary_lanes(got, max_em_iters=boundary_cases.MAX_EM_ITERS,
                          max_map_iters=boundary_cases.MAX_MAP_ITERS)
    em_i = int(state.ctl[ref.EM_I]) + 1
    for b in range(state.lane.shape[1]):
        if not int(state.lane[ref.RUNNING, b]):
            continue
        n = lambda t: jnp.asarray(t[b].numpy())  # noqa: E731
        model = SimpleNamespace(sigma_min=n(state.sigma_min), reseed_mu=n(state.reseed_mu),
                                reseed_sigma=n(state.reseed_sigma))
        sums = state.stats[b] if int(state.lane[ref.MAP_I, b]) else torch.zeros_like(state.stats[b])
        s = jnp.asarray(sums.numpy())
        mu, sigma, sum_w = jax_energy.params_from_stats(model, s[0], s[1], s[2])
        np.testing.assert_allclose(got.em_mu[b].numpy(), np.asarray(mu), rtol=1e-6, err_msg=name)
        # The reference's float32 E[y^2] - mu^2 may lose a few ulps of
        # E[y^2]; sigma = sqrt(var) moves by that over 2 sigma.
        ey2 = np.abs(sums[2].numpy() / np.maximum(sums[0].numpy(), 1e-6))
        slack = 8 * 2.0 ** -24 * ey2 / np.maximum(2 * np.abs(np.asarray(sigma)), 1e-6)
        g, w = got.em_sigma[b].numpy(), np.asarray(sigma)
        assert np.all((np.abs(g - w) <= slack + 1e-6 * np.abs(w)) | (np.isnan(g) & np.isnan(w))), (
            name, b)
        deg = bool(jax_em._degenerate_components(model, sigma, sum_w))
        div = bool(~jnp.all(jnp.isfinite(mu)) | ~jnp.all(jnp.isfinite(sigma))) or bool(
            int(state.lane[ref.FLAG, b]) & ref.FLAG_DIVERGED)
        conv = bool(jax_em._window_converged(jnp.asarray(got.total_hist[b].numpy()), em_i))
        finished = div or not (em_i < boundary_cases.MAX_EM_ITERS and not conv)
        want = int(jax_em._boundary_status(div, deg, finished, conv, em_i,
                                           boundary_cases.MAX_EM_ITERS))
        assert int(got.lane[ref.STATUS, b]) == want, (name, b)


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


def _torch_lanes(n_labels):
    """A stack of ``N_LANES`` 48x48 slices planned by the port on the CPU,
    padded to their joint bucket, each quantile-initialised:
    ``(hoods, model, labels0, mu0, sigma0)`` per lane."""
    key = ("torch", n_labels)
    if key not in _cache:
        phases, seed, grid = PROBLEMS[n_labels]
        if phases == 2:
            vol = synthetic.make_synthetic_volume(seed=seed, n_slices=N_LANES, shape=(48, 48),
                                                  device="cpu")
        else:
            vol = synthetic.make_kary_volume(seed=seed, n_slices=N_LANES, shape=(48, 48),
                                             n_phases=phases, device="cpu")
        probs = [pipeline.initialize(im, overseg_grid=(grid, grid), n_labels=n_labels,
                                     device="cpu") for im in vol.images]
        cap = max(p.hoods.capacity for p in probs)
        nh = max(p.hoods.n_hoods for p in probs)
        nr = max(p.hoods.n_regions for p in probs)
        lanes = []
        for b, p in enumerate(probs):
            labels0, mu0, sigma0 = pipeline.initial_params(p, b, "quantile")
            lab = torch.zeros((nr + 1,), dtype=torch.int32)
            lab[: p.graph.n_regions] = labels0[: p.graph.n_regions]
            lanes.append((pad_hoods(p.hoods, capacity=cap, n_hoods=nh, n_regions=nr,
                                    n_elements=-1), E.pad_model(p.model, nr), lab, mu0, sigma0))
        _cache[key] = lanes
    return _cache[key]


def _to_jax(hoods, model, labels0, mu0, sigma0):
    """One lane's problem carried into the reference's types."""
    arrays = {f: jnp.asarray(getattr(hoods, f).numpy()) for f in convert.HOODS_ARRAYS}
    sizes = {f: int(getattr(hoods, f)) for f in convert.HOODS_SIZES}
    model_j = jax_energy.EnergyModel(**{f: jnp.asarray(getattr(model, f).numpy())
                                        for f in convert.MODEL_FIELDS})
    return (jax_hoods.Hoods(**arrays, **sizes), model_j,
            *(jnp.asarray(t.numpy()) for t in (labels0, mu0, sigma0)))


def _stacked(lanes):
    hoods = stack_hoods([p[0] for p in lanes])
    model = E.EnergyModel(*(torch.stack(f) for f in zip(*(p[1] for p in lanes))))
    return (hoods, model, *(torch.stack([p[j] for p in lanes]) for j in (2, 3, 4)))


_JAX_CONFIG = jax_em.EMConfig(mode="static-pallas", backend="xla")


def _jax_run_em(n_labels):
    key = ("run_em", n_labels)
    if key not in _cache:
        _cache[key] = jax_em.run_em(*_to_jax(*_torch_lanes(n_labels)[0]), _JAX_CONFIG)
    return _cache[key]


def _jax_run_em_batched(n_labels):
    key = ("batched", n_labels)
    if key not in _cache:
        import jax

        lanes = [_to_jax(*lane) for lane in _torch_lanes(n_labels)]
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *lanes)
        _cache[key] = jax_em.run_em_batched(*stacked, _JAX_CONFIG)
    return _cache[key]


def _check_against_jax(got, want, lane=None):
    pick = (lambda v: np.asarray(v)) if lane is None else (lambda v: np.asarray(v)[lane])
    assert (got.em_iters, got.map_iters, got.status) == tuple(
        int(pick(getattr(want, f))) for f in ("em_iters", "map_iters", "status"))
    np.testing.assert_array_equal(got.labels.numpy(), pick(want.labels))
    for f in ("mu", "sigma", "hood_energy"):
        np.testing.assert_allclose(getattr(got, f).numpy(), pick(getattr(want, f)), **TOL, err_msg=f)


@pytest.mark.parametrize("n_labels", [2, 3])
def test_program_equals_jax_run_em(n_labels):
    got = torch_em.run_em(*_torch_lanes(n_labels)[0])
    _check_against_jax(got, _jax_run_em(n_labels))


@pytest.mark.parametrize("config", [
    torch_em.EMConfig(), torch_em.EMConfig(precision="bf16"), torch_em.EMConfig(max_map_iters=1),
    torch_em.EMConfig(max_map_iters=0, max_em_iters=2), torch_em.EMConfig(max_em_iters=0),
], ids=["f32", "bf16", "map1", "map0", "em0"])
@pytest.mark.parametrize("n_labels", sorted(PROBLEMS))
def test_program_equals_the_host_stepped_driver(n_labels, config):
    """Bit for bit the port's ``run_em`` before the program: labels, mu,
    sigma, hood and total energies, counts and status."""
    problem = _torch_lanes(n_labels)[0]
    got = torch_em.run_em(*problem, config)
    want = host_loop.run_em(*problem, config)
    assert _same_result(got, want)
    if config.max_em_iters == 0:
        assert (got.em_iters, got.map_iters, got.status) == (0, 0, torch_em.STATUS_OK)
        assert torch.equal(got.labels, problem[2]) and not got.hood_energy.any()


@pytest.mark.parametrize("config", [
    torch_em.EMConfig(), torch_em.EMConfig(max_map_iters=1), torch_em.EMConfig(max_em_iters=0),
], ids=["default", "map1", "em0"])
@pytest.mark.parametrize("n_labels", [2, 3])
def test_batched_program_lanes_equal_serial_and_host(n_labels, config):
    lanes = _torch_lanes(n_labels)
    inputs = _stacked(lanes)
    got = torch_em.run_em_batched(*inputs, config)
    want = host_loop.run_em_batched(*inputs, config)
    assert _same_result(got, want) and got.steps == want.steps
    for b, problem in enumerate(lanes):
        assert _same_result(got.lane(b), torch_em.run_em(*problem, config)), b
    assert max(got.map_iters) <= got.steps <= sum(got.map_iters)
    if config.max_em_iters == 0:
        assert got.steps == 0


@pytest.mark.parametrize("n_labels", [2, 3])
def test_batched_program_equals_jax_run_em_batched(n_labels):
    got = torch_em.run_em_batched(*_stacked(_torch_lanes(n_labels)))
    want = _jax_run_em_batched(n_labels)
    for b in range(N_LANES):
        _check_against_jax(got.lane(b), want, lane=b)


class _Words(ref.PlainTickWorkspace):
    """The plain single workspace, recording what the program reads."""

    def program_step(self):
        super().program_step()
        self.trace.append(("map", int(self.ctl[ref.MAP_COND]), int(self.lane[ref.MAP_I])))

    def program_boundary(self):
        super().program_boundary()
        self.trace.append(("em", int(self.ctl[ref.EM_COND]), int(self.ctl[ref.EM_I])))


def test_plain_program_is_steered_by_its_words():
    """Each MAP loop runs until the step that stops it writes its condition
    word 0, each EM loop until a boundary writes its word 0: the counts
    the words carry are the result's."""
    problem = _torch_lanes(3)[0]
    config = torch_em.EMConfig()
    ws = _Words(ref.TickShape.of(problem[0], problem[1]), device="cpu",
                conv_tol=torch_em.CONV_TOL, window=torch_em.WINDOW,
                max_em_iters=config.max_em_iters, max_map_iters=config.max_map_iters)
    ws.trace = []
    res = torch_em.run_em(*problem, config, workspace=ws)
    maps = [t for t in ws.trace if t[0] == "map"]
    ems = [t for t in ws.trace if t[0] == "em"]
    assert len(maps) == res.map_iters and len(ems) == res.em_iters
    assert (int(ws.ctl[ref.TICK_LAUNCHES]), int(ws.ctl[ref.BOUNDARY_LAUNCHES])) == (
        res.map_iters, res.em_iters)
    assert [t[1] for t in ems] == [1] * (res.em_iters - 1) + [0]
    # Within a MAP loop the condition holds until its last step.
    loops, run = [], []
    for kind, cond, _ in ws.trace:
        if kind == "map":
            run.append(cond)
        else:
            loops.append(run)
            run = []
    assert all(r == [1] * (len(r) - 1) + [0] for r in loops)
    assert sum(len(r) for r in loops) == res.map_iters


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------


def _session_plan(**kw):
    vol = synthetic.make_synthetic_volume(seed=2, n_slices=1, shape=(40, 40), device="cpu")
    seg = api.Segmenter(api.ExecutionConfig(overseg_grid=(5, 5), **kw), device="cpu")
    return seg, seg.plan(vol.images[0])


def test_compile_builds_one_program_and_a_hit_none():
    seg, plan = _session_plan()
    builds, programs = ops.WORKSPACE_BUILDS, ops.PROGRAM_BUILDS
    first = seg.execute(plan)
    assert (ops.WORKSPACE_BUILDS - builds, ops.PROGRAM_BUILDS - programs) == (1, 1)
    exe = seg.compile(plan)
    again = seg.execute(plan)
    assert seg.compile(plan) is exe
    assert (ops.WORKSPACE_BUILDS - builds, ops.PROGRAM_BUILDS - programs) == (1, 1)
    np.testing.assert_array_equal(first.region_labels, again.region_labels)
    # A stack compiles the program of its batch size once.
    seg.submit(plan)
    seg.submit(plan, seed=1)
    seg.drain()
    seg.submit(plan)
    seg.submit(plan, seed=1)
    seg.drain()
    assert (ops.WORKSPACE_BUILDS - builds, ops.PROGRAM_BUILDS - programs) == (2, 2)


def test_failing_program_raises_under_the_policy(monkeypatch):
    """A program that fails is retried on its route, then raises
    ``FallbackError``; nothing runs the host loop or another device."""
    seg, plan = _session_plan()
    calls = []

    def broken(self, marks=None):
        calls.append(1)
        raise RuntimeError("graph launch failed")

    monkeypatch.setattr(ref._PlainProgram, "run_program", broken)
    monkeypatch.setattr(host_loop, "run_em", lambda *a, **k: pytest.fail("host loop ran"))
    with pytest.raises(FallbackError):
        seg.execute(plan)
    assert len(calls) == 1 + seg.config.fallback.max_retries
    with pytest.raises(RuntimeError, match="graph launch failed"):
        api.Segmenter(seg.config.with_(fallback=api.FallbackPolicy(enabled=False)),
                      device="cpu").execute(plan)


def test_workspace_of_other_limits_is_refused():
    problem = _torch_lanes(2)[0]
    ws = torch_em.make_workspace(ref.TickShape.of(problem[0], problem[1]), torch_em.EMConfig(),
                                 device="cpu")
    with pytest.raises(ValueError, match="EM program"):
        torch_em.run_em(*problem, torch_em.EMConfig(max_em_iters=5), workspace=ws)
    with pytest.raises(ValueError, match="compiled EM program"):
        torch_em._em_driver(*problem, torch_em.EMConfig(), torch_em.collectives.LOCAL)
