"""The single-device MAP iteration of the port: ``ref.fused_map_iteration``
(the plain version of the CUDA ``TickWorkspace``) and the EM driver that
runs it on a plan-owned workspace.

* Over whole solves at K = 2, 3 and 9, f32 and bf16, the ring-and-head
  iteration gives the same bits at every MAP iteration as the composition
  it replaces (label gather, ``ref.fused_em_tick`` on a ``torch.cat``-rolled
  history, ``isfinite``, the gate): labels, votes, ``hood_e``, the M-step
  sums and the flag word.
* A NaN in one hood, or a NaN sigma, sets the diverged bit and ends the
  solve as the driver always did: diverged after one EM and one MAP
  iteration.
* Solves in one bucket share its workspace (the session's executable) and
  each equals a solve on a fresh plan, so no state leaks from one solve to
  the next.

The problems are small synthetic slices planned by the port on the CPU;
``tests/test_torch_em.py`` holds the same driver to the JAX ``run_em``
and the live oracle.  A test marked ``cuda`` holds the kernel's workspace
to the plain one on the card and skips without one.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import synthetic
from repro_torch.core.pmrf import convert
from repro_torch.core.pmrf import em as em_mod
from repro_torch.core.pmrf import energy as E
from repro_torch.core.pmrf import pipeline
from repro_torch.kernels import _build, em_tick, ops, ref

# (K, phases, seed, size, grid): K = 9 on a three-phase image is the
# CUDA tick's runtime-K variant.
PROBLEMS = {2: (2, 0, 48, 6), 3: (3, 0, 48, 6), 9: (3, 0, 48, 7)}
_plans = {}


def _problem(n_labels):
    if n_labels not in _plans:
        phases, seed, size, grid = PROBLEMS[n_labels]
        if phases == 2:
            vol = synthetic.make_synthetic_volume(seed=seed, n_slices=1, shape=(size, size), device="cpu")
        else:
            vol = synthetic.make_kary_volume(seed=seed, n_slices=1, shape=(size, size),
                                             n_phases=phases, device="cpu")
        _plans[n_labels] = pipeline.initialize(
            vol.images[0], overseg_grid=(grid, grid), n_labels=n_labels, device="cpu"
        )
    return _plans[n_labels]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


class _Lockstep(ref.PlainTickWorkspace):
    """The plain workspace, checked at every step against the composition
    the driver ran before it had a workspace, which keeps its own labels
    and its own history (rolled with ``torch.cat``)."""

    def start(self, hoods, model, y, w, nall_e, valid, labels0):
        super().start(hoods, model, y, w, nall_e, valid, labels0)
        self.old_labels = labels0.clone()
        self.steps = 0

    def begin_em(self, mu, sigma):
        super().begin_em(mu, sigma)
        self.old_hist = torch.zeros_like(self.ring)
        self.old_i = 0

    def step(self, gate, cap=False):
        h, m = self._hoods, self._model
        y, w, nall_e, valid = self._elements
        xf = self.old_labels[h.vertex.long()].to(torch.float32) * valid
        labels, hood_e, votes, conv, *sums = ref.fused_em_tick(
            y, w, nall_e, xf, valid, h.hood_id, h.vertex, m.region_mean, m.region_weight,
            self.old_hist, *self._params, m.beta, n_hoods=h.n_hoods,
            n_vertices=h.n_regions + 1, precision=self.precision, conv_tol=em_mod.CONV_TOL,
        )
        self.old_hist = torch.cat([hood_e[None], self.old_hist[:-1]])
        self.old_i += 1
        assert gate == (self.old_i > em_mod.WINDOW)
        flag = int(bool(conv) and gate) | 2 * int(not bool(torch.all(torch.isfinite(hood_e))))
        super().step(gate, cap)
        what = f"step {self.steps}"
        assert _same(self.labels, labels), what
        assert _same(self.votes, votes), what
        assert _same(self.hood_e, hood_e), what
        assert _same(self.stats, torch.stack(sums)), what
        assert self.flag() == flag, what
        # The ring read newest first from head is the rolled history.
        rows = self.ring.shape[0]
        ring = self.ring[[(self.head + r) % rows for r in range(rows)]]
        assert _same(ring, self.old_hist), what
        self.old_labels = labels
        self.steps += 1


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n_labels", sorted(PROBLEMS))
def test_map_iteration_equals_old_composition_over_a_solve(n_labels, precision):
    prob = _problem(n_labels)
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    config = em_mod.EMConfig(precision=precision)
    ws = _Lockstep(ref.TickShape.of(prob.hoods, prob.model), device="cpu", precision=precision,
                   conv_tol=em_mod.CONV_TOL, window=em_mod.WINDOW)
    res = em_mod.run_em(prob.hoods, prob.model, labels0, mu0, sigma0, config, workspace=ws)
    assert ws.steps == res.map_iters > em_mod.WINDOW
    assert res.status in (em_mod.STATUS_CONVERGED, em_mod.STATUS_MAX_ITERS)
    # The result owns its tensors: the workspace's buffers stay the plan's.
    assert res.labels.data_ptr() != ws.labels.data_ptr()
    assert torch.equal(res.labels, ws.labels)


def test_map_iteration_ring_and_flag_bits():
    """One iteration by hand: the ring row written, the head's rotation and
    both flag bits."""
    prob = _problem(2)
    hoods, model = prob.hoods, prob.model
    sctx = E.make_static_context(hoods, model)
    labels0, mu, sigma = pipeline.initial_params(prob, 0, "quantile")
    sig = torch.maximum(sigma, model.sigma_min)
    kw = dict(n_hoods=hoods.n_hoods, n_vertices=hoods.n_regions + 1)
    args = (sctx.y, sctx.w, sctx.nall_e, sctx.validf, hoods.hood_id, hoods.vertex,
            model.region_mean, model.region_weight)
    rows = em_mod.WINDOW + 1
    ring = torch.zeros((rows, hoods.n_hoods))
    labels = labels0
    for i in range(6):
        head = (-i) % rows
        before = ring.clone()
        labels, hood_e, _, flag, *_ = ref.fused_map_iteration(
            *args, ring, head, labels, mu, sig, model.beta, gate=True, **kw)
        oldest = (head + rows - 1) % rows
        assert _same(ring[oldest], hood_e)
        others = [r for r in range(rows) if r != oldest]
        assert _same(ring[others], before[others])
        assert int(flag) & ref.FLAG_DIVERGED == 0
    # With every row of the ring holding the energies this iteration gives
    # (they do not depend on the ring), the window holds; the flag says so
    # once the gate is open, and only then.
    probe = ref.fused_map_iteration(*args, ring.clone(), 0, labels, mu, sig, model.beta,
                                    gate=True, **kw)[1]
    for gate in (False, True):
        out = ref.fused_map_iteration(*args, probe.expand(rows, -1).clone(), 0, labels, mu, sig,
                                      model.beta, gate=gate, **kw)
        assert int(out[3]) == (ref.FLAG_CONVERGED if gate else 0)
    bad = sctx.y.clone()
    bad[int(hoods.offsets[3])] = float("nan")
    out = ref.fused_map_iteration(bad, *args[1:], ring.clone(), 0, labels, mu, sig, model.beta,
                                  gate=True, **kw)
    assert int(out[3]) == ref.FLAG_DIVERGED
    assert torch.isnan(out[1][3]) and int(torch.isnan(out[1]).sum()) == 1


@pytest.mark.parametrize("where", ["region_mean", "sigma"])
def test_nan_ends_the_solve_as_diverged(where):
    """A NaN in one hood (one region's mean) or in a sigma sets the diverged
    bit at the first MAP iteration; the solve ends there as diverged, as
    it did before the workspace (the loop stopped on ``~isfinite``)."""
    prob = _problem(3)
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    model = prob.model
    if where == "region_mean":
        mean = model.region_mean.clone()
        mean[int(prob.hoods.vertex[int(prob.hoods.offsets[5])])] = float("nan")
        model = model._replace(region_mean=mean)
    else:
        sigma0 = sigma0.clone()
        sigma0[1] = float("nan")
    seen = []

    class Watch(ref.PlainTickWorkspace):
        def flag(self):
            seen.append(super().flag())
            return seen[-1]

    ws = Watch(ref.TickShape.of(prob.hoods, model), device="cpu", conv_tol=em_mod.CONV_TOL,
               window=em_mod.WINDOW)
    res = em_mod.run_em(prob.hoods, model, labels0, mu0, sigma0, em_mod.EMConfig(), workspace=ws)
    assert seen == [ref.FLAG_DIVERGED]
    assert (res.status, res.em_iters, res.map_iters) == (em_mod.STATUS_DIVERGED, 1, 1)


def test_solves_on_one_plan_share_the_workspace_without_leaks():
    vol = synthetic.make_kary_volume(seed=1, n_slices=1, shape=(48, 48), n_phases=3, device="cpu")
    seg = api.Segmenter(api.ExecutionConfig(n_labels=3, overseg_grid=(6, 6), init="random"),
                        device="cpu")
    plan = seg.plan(vol.images[0])
    builds = ops.WORKSPACE_BUILDS
    first = seg.execute(plan, seed=1)
    ws = seg.compile(plan).workspace
    second = seg.execute(plan, seed=2)
    assert seg.compile(plan).workspace is ws and ops.WORKSPACE_BUILDS == builds + 1
    for seed, got in ((1, first), (2, second)):
        fresh = seg.execute(seg.plan(vol.images[0]), seed=seed)
        np.testing.assert_array_equal(got.region_labels, fresh.region_labels)
        np.testing.assert_array_equal(got.mu, fresh.mu)
        np.testing.assert_array_equal(got.sigma, fresh.sigma)
        assert (got.em_iters, got.map_iters, got.status, got.total_energy) == (
            fresh.em_iters, fresh.map_iters, fresh.status, fresh.total_energy)
    assert first.map_iters != second.map_iters or not np.array_equal(
        first.region_labels, second.region_labels)
    assert seg.compile(plan).workspace is ws and ops.WORKSPACE_BUILDS == builds + 1
    # Another precision on the same plan gets a workspace of its own.
    bf16 = api.Segmenter(seg.config.with_(precision="bf16"), device="cpu")
    bf16.execute(plan, seed=1)
    assert bf16.compile(plan).workspace.precision == "bf16" and ws.precision == "f32"
    assert ops.WORKSPACE_BUILDS == builds + 2


def test_workspace_routes_and_refusals():
    """CPU tensors get the plain workspace and launch nothing; the CUDA
    workspace refuses CPU tensors before it builds anything; a workspace
    for another precision or K is refused by the driver."""
    prob = _problem(2)
    ops.reset_launch_counts()
    shape = ref.TickShape.of(prob.hoods, prob.model)
    ws = ops.tick_workspace(shape, device="cpu")
    assert isinstance(ws, ref.PlainTickWorkspace)
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    em_mod.run_em(prob.hoods, prob.model, labels0, mu0, sigma0, workspace=ws)
    assert ops.launch_counts()["fused_em_tick"] == 0
    for cls in (em_tick.TickWorkspace, functools.partial(em_tick.BatchTickWorkspace, batch=2)):
        with pytest.raises(ValueError, match="CUDA"):
            cls(shape, device="cpu")
        with pytest.raises(ValueError, match="227 KB"):
            cls(shape._replace(n_labels=em_tick.MAX_LABELS + 1), device="cpu")
    assert _build._libs == {}
    with pytest.raises(ValueError, match="precision"):
        em_mod.run_em(prob.hoods, prob.model, labels0, mu0, sigma0,
                      em_mod.EMConfig(precision="bf16"), workspace=ws)


@pytest.mark.cuda
@pytest.mark.parametrize("n_labels", sorted(PROBLEMS))
def test_kernel_workspace_equals_plain_on_the_card(n_labels):
    """The card's ``TickWorkspace`` against the plain workspace over a
    whole solve: iteration counts and status equal, labels equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (a CUDA kernel has no CPU mode)")
    prob = _problem(n_labels)
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    d = {f: getattr(prob.hoods, f) for f in convert.HOODS_ARRAYS + convert.HOODS_SIZES}
    d.update({f: getattr(prob.model, f) for f in convert.MODEL_FIELDS})
    d.update(labels0=labels0, mu0=mu0, sigma0=sigma0)
    ops.reset_launch_counts()
    got = em_mod.run_em(*convert.problem_from_numpy(d, device="cuda"))
    assert ops.launch_counts()["fused_em_tick"] == got.map_iters
    want = em_mod.run_em(prob.hoods, prob.model, labels0, mu0, sigma0)
    assert (got.status, got.em_iters, got.map_iters) == (want.status, want.em_iters, want.map_iters)
    assert torch.equal(got.labels.cpu(), want.labels)
