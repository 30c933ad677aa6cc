"""The batched form of the modes ``static`` and ``faithful`` on the CPU:
``em.run_em_batched`` on a ``DppBatchWorkspace``, one flat MAP iteration
of every lane per lockstep step (the ``energy`` module's lane-axis forms on
lane-offset keys).

* Against the JAX package's ``run_em_batched`` (``vmap`` of ``run_em``,
  ``backend="xla"``) in each mode on one K = 2 stack: three 40x40 slices
  (seed 6, grid 5) padded to their joint bucket, whose lanes stop at 5, 6
  and 7 EM iterations (20, 26 and 31 MAP iterations).  Labels, counts and
  status exact; mu, sigma and energies within rtol/atol 1e-5, the tier of
  ``tests/test_torch_em.py``.  Each mode's JAX run is made once, in a
  module-scoped fixture.
* Every lane bit for bit its own serial ``run_em`` in the port (labels, mu,
  sigma, hood energies, total energy, counts, status) at K = 2, 3 and 9.
* The lane-axis forms against the serial functions lane by lane, the
  lane-offset keys and their int32 refusal, and a step's freezing of the
  lanes that are not active.
* ``Segmenter.segment_stack(batch="always")`` and ``drain`` in each mode
  against serial ``execute`` bit for bit, and ``launch.segment --batch
  always`` against ``--batch never``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pmrf import em as jax_em
from repro.core.pmrf import energy as jax_energy
from repro.core.pmrf import hoods as jax_hoods

from repro_torch import api
from repro_torch.core import dpp, synthetic
from repro_torch.core.pmrf import convert
from repro_torch.core.pmrf import em as torch_em
from repro_torch.core.pmrf import energy as E
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TickShape
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

MODES = ("static", "faithful")
MAX_EM, MAX_MAP = 20, 10
TOL = dict(rtol=1e-5, atol=1e-5)
# K -> (phases, seed, grid) of three 40x40 slices.
STACKS = {2: (2, 6, 5), 3: (3, 4, 6), 9: (3, 0, 7)}


def _session(mode, n_labels=2):
    grid = STACKS[n_labels][2]
    return api.Segmenter(api.ExecutionConfig(mode=mode, n_labels=n_labels, overseg_grid=(grid, grid),
                                             init="quantile", max_em_iters=MAX_EM,
                                             max_map_iters=MAX_MAP), device="cpu")


def _images(n_labels, n=3):
    phases, seed, _ = STACKS[n_labels]
    if phases == 2:
        return synthetic.make_synthetic_volume(seed=seed, n_slices=n, shape=(40, 40),
                                               device="cpu").images
    return synthetic.make_kary_volume(seed=seed, n_slices=n, shape=(40, 40), n_phases=phases,
                                      device="cpu").images


_stacks = {}


def _stack(n_labels):
    """``(session, plans, joint bucket, stacked inputs)`` of a K stack (the
    session's mode is ``static``; a stack's inputs do not depend on it)."""
    if n_labels not in _stacks:
        seg = _session("static", n_labels)
        plans = [seg.plan(im) for im in _images(n_labels)]
        joint = api.BucketKey(*(max(p.bucket[d] for p in plans) for d in range(3)))
        inputs = seg.stacked_inputs(plans, bucket=joint, seeds=[0] * len(plans))
        _stacks[n_labels] = (seg, plans, joint, inputs)
    return _stacks[n_labels]


def _config(mode):
    return torch_em.EMConfig(mode=mode, max_em_iters=MAX_EM, max_map_iters=MAX_MAP)


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _assert_same(got, want, what):
    for f in ("labels", "mu", "sigma", "hood_energy", "total_energy"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f"{what} {f}"
    assert (got.em_iters, got.map_iters, got.status) == (want.em_iters, want.map_iters,
                                                       want.status), what


def _jax_stack(inputs):
    """The port's stacked inputs as the JAX package's."""
    hoods, model, lab0, mu0, sig0 = inputs
    jh = jax_hoods.Hoods(**{f: jnp.asarray(getattr(hoods, f).numpy()) for f in convert.HOODS_ARRAYS},
                         **{f: getattr(hoods, f) for f in convert.HOODS_SIZES})
    jm = jax_energy.EnergyModel(*(jnp.asarray(t.numpy()) for t in model))
    return (jh, jm, *(jnp.asarray(t.numpy()) for t in (lab0, mu0, sig0)))


@pytest.fixture(scope="module", params=MODES)
def jax_batched(request):
    """One mode's JAX ``run_em_batched`` of the K = 2 stack (run once)."""
    mode = request.param
    _, _, _, inputs = _stack(2)
    cfg = jax_em.EMConfig(mode=mode, backend="xla", max_em_iters=MAX_EM, max_map_iters=MAX_MAP)
    return mode, jax_em.run_em_batched(*_jax_stack(inputs), cfg)


def test_run_em_batched_matches_jax(jax_batched):
    mode, want = jax_batched
    _, _, _, inputs = _stack(2)
    got = torch_em.run_em_batched(*inputs, _config(mode))
    assert len(set(got.map_iters)) == 3, "the stack's lanes stop at different iterations"
    for b in range(3):
        what = f"{mode} lane {b}"
        np.testing.assert_array_equal(got.labels[b].numpy(), np.asarray(want.labels[b]), what)
        assert (got.em_iters[b], got.map_iters[b], got.status[b]) == (
            int(want.em_iters[b]), int(want.map_iters[b]), int(want.status[b])), what
        for f in ("mu", "sigma", "hood_energy", "total_energy"):
            np.testing.assert_allclose(getattr(got, f)[b].numpy(), np.asarray(getattr(want, f)[b]),
                                       err_msg=f"{what} {f}", **TOL)
    assert got.steps == max(got.map_iters)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_labels", sorted(STACKS))
def test_every_lane_equals_its_serial_run_em(n_labels, mode):
    """Each lane of the flat lockstep bit for bit its own serial solve; the
    stack's lockstep steps are its slowest lane's MAP iterations summed
    over the EM iterations, and one workspace build serves two solves."""
    _, _, _, inputs = _stack(n_labels)
    cfg = _config(mode)
    ws = torch_em.make_workspace(TickShape.of(inputs[0], inputs[1]), cfg, device="cpu", batch=3)
    assert isinstance(ws, torch_em.DppBatchWorkspace)
    builds = ops.WORKSPACE_BUILDS
    for _ in range(2):
        ops.reset_launch_counts()
        got = torch_em.run_em_batched(*inputs, cfg, workspace=ws)
        assert ops.LANE_STEPS == got.steps
    assert ops.WORKSPACE_BUILDS == builds
    for b in range(3):
        lane = tuple(t[b] for t in inputs[2:])
        hoods = _lane_hoods(inputs[0], b)
        model = E.EnergyModel(*(t[b] for t in inputs[1]))
        _assert_same(got.lane(b), torch_em.run_em(hoods, model, *lane, cfg),
                     f"K={n_labels} {mode} lane {b}")


def _lane_hoods(hoods, b):
    import dataclasses

    return dataclasses.replace(hoods, **{f.name: getattr(hoods, f.name)[b]
                                         for f in dataclasses.fields(hoods)
                                         if isinstance(getattr(hoods, f.name), torch.Tensor)})


def test_lane_keys_and_their_refusal():
    keys = torch.tensor([[0, 2, 1], [1, 1, 0]], dtype=torch.int32)
    assert dpp.lane_keys(keys, 3).tolist() == [0, 2, 1, 4, 4, 3]
    assert dpp.lane_keys(keys, 3).dtype == torch.int64
    with pytest.raises(OverflowError, match="int32"):
        dpp.lane_keys(torch.zeros((4, 1), dtype=torch.int32), 2**29 + 1)
    # A stack or pool whose key spaces pass int32 is refused at build.
    big = TickShape(capacity=1 << 20, n_hoods=1 << 16, n_vertices=1 << 16, n_labels=9)
    with pytest.raises(ValueError, match="past int32; at most"):
        torch_em.make_workspace(big, _config("static"), device="cpu", batch=4096)
    # One problem's workspace is a one-lane stack's (its compiled program).
    one = torch_em.make_workspace(big, _config("static"), device="cpu")
    assert isinstance(one, torch_em.DppBatchWorkspace) and one.batch == 1


@pytest.mark.parametrize("n_labels", [2, 3])
def test_lane_forms_equal_serial_functions(n_labels):
    """Each lane-axis form, lane by lane, bit for bit its serial function
    from a mid-solve state (each lane's labels and parameters after two EM
    iterations); the M-step sums of the lanes left out are 0."""
    _, _, _, (hoods, model, lab0, mu0, sig0) = _stack(n_labels)
    cfg = _config("static")._replace(max_em_iters=2, max_map_iters=3)
    mid = torch_em.run_em_batched(hoods, model, lab0, mu0, sig0, cfg)
    labels, mu, sigma = mid.labels, mid.mu, mid.sigma * 1.3
    counts = E.hood_label_counts_lanes(hoods, labels, n_labels)
    energies = E.label_energies_lanes(hoods, model, labels, mu, sigma, counts)
    min_s, arg_s = E.min_energies_static_lanes(energies)
    min_f, arg_f = E.min_energies_faithful_lanes(hoods, energies)
    hood_e = E.hood_energy_sums_lanes(hoods, min_f)
    votes = E.vote_labels_lanes(hoods, arg_f, hoods.n_regions, n_labels)
    some = torch.tensor([True, False, True])
    sums = {m: E.m_step_sums_lanes(model, labels, m, lanes=some) for m in MODES}
    for b in range(3):
        h, m = _lane_hoods(hoods, b), E.EnergyModel(*(t[b] for t in model))
        c, n = E.hood_label_counts(h, labels[b], n_labels)
        assert torch.equal(counts[0][b], c) and torch.equal(counts[1][b], n)
        e = E.label_energies(h, m, labels[b], mu[b], sigma[b], hood_counts=(c, n))
        assert torch.equal(_bits(energies[b]), _bits(e)), f"lane {b} energies"
        ms, as_ = E.min_energies_static(e)
        mf, af = E.min_energies_faithful(h, e)
        assert torch.equal(_bits(min_s[b]), _bits(ms)) and torch.equal(arg_s[b], as_)
        assert torch.equal(_bits(min_f[b]), _bits(mf)) and torch.equal(arg_f[b], af)
        assert torch.equal(_bits(hood_e[b]), _bits(E.hood_energy_sums(h, mf)))
        assert torch.equal(votes[b], E.vote_labels(h, af, h.n_regions, n_labels))
        for mode in MODES:
            want = E.m_step_sums(m, labels[b], mode) if some[b] else [torch.zeros(n_labels)] * 3
            for got_s, want_s in zip(sums[mode], want):
                assert torch.equal(_bits(got_s[b]), _bits(want_s)), f"lane {b} {mode} M-step"


@pytest.mark.parametrize("mode", MODES)
def test_step_freezes_lanes_that_are_not_active(mode):
    """One step with lane 1 inactive: its labels, ring, hood sums, M-step
    sums and flag word stay as they were; the active lanes' rows are the
    step's, and a lane past the window whose ring holds its own sums
    converges and takes its M-step."""
    _, _, _, (hoods, model, lab0, mu0, sig0) = _stack(2)
    ws = torch_em.make_workspace(TickShape.of(hoods, model), _config(mode), device="cpu", batch=3)
    ws.start(hoods, model, lab0)
    sig = torch.maximum(sig0, model.sigma_min[:, None])
    ws.begin_em(mu0, sig, [True, False, True])
    ws.step(False)
    frozen = {n: getattr(ws, n)[1].clone() for n in ("labels", "ring", "hood_e", "stats")}
    ws.stats.fill_(-1.0)
    before = {n: getattr(ws, n).clone() for n in ("labels", "ring", "hood_e", "stats")}
    ws.ring[2] = ws.hood_e[2]  # lane 2's window holds its last sums: a fixed point converges
    labels2 = ws.labels[2].clone()
    ws.step(True)
    flags = ws.flags()
    assert flags[1] == 0 and not bool(ws.active[1])
    for n, t in frozen.items():
        want = before[n][1] if n == "stats" else t
        assert torch.equal(getattr(ws, n)[1], want), f"inactive lane's {n} written"
    new, he = torch_em.map_step(_lane_hoods(hoods, 2), E.EnergyModel(*(t[2] for t in model)),
                                mode, labels2, mu0[2], sig[2])
    assert torch.equal(ws.labels[2], new) and torch.equal(ws.hood_e[2], he)
    if torch.equal(new, labels2):
        assert flags[2] & ops.FLAG_CONVERGED and not bool(ws.active[2])
        want = E.m_step_sums(E.EnergyModel(*(t[2] for t in model)), new, mode)
        assert all(torch.equal(ws.stats[2, j], want[j]) for j in range(3))
    assert bool(ws.active[0]) == (flags[0] == 0)


@pytest.mark.parametrize("mode", MODES)
def test_segment_stack_and_drain_equal_serial_execute(mode):
    seg = _session(mode)
    imgs = _images(2)
    stacked, _ = seg.segment_stack(imgs, batch="always")
    serial, _ = seg.segment_stack(imgs, batch="never")
    for got, want in zip(stacked, serial):
        for f in ("region_labels", "segmentation", "mu", "sigma"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert (got.em_iters, got.map_iters, got.status, got.total_energy) == (
            want.em_iters, want.map_iters, want.status, want.total_energy)
    plans = [seg.plan(im) for im in imgs[:2]]
    for p in plans:
        seg.submit(p)
    builds = ops.WORKSPACE_BUILDS
    drained = seg.drain()
    assert ops.WORKSPACE_BUILDS == builds + 1  # the batch-2 executable's workspace
    for p, got in zip(plans, drained):
        want = seg.execute(p)
        np.testing.assert_array_equal(got.region_labels, want.region_labels)
        assert (got.em_iters, got.map_iters, got.status) == (want.em_iters, want.map_iters,
                                                           want.status)
    for p in plans:
        seg.submit(p)
    seg.drain()
    assert ops.WORKSPACE_BUILDS == builds + 1  # a warm drain builds nothing


@pytest.mark.parametrize("mode", MODES)
def test_launch_segment_batch_always(mode):
    """``launch.segment --mode m --batch always`` runs the flat stack and
    gives each slice the metrics of ``--batch never``."""
    from repro_torch.launch import segment as launch_segment

    args = ["--size", "40", "--grid", "5", "--slices", "3", "--device", "cpu", "--mode", mode]
    always = launch_segment.main(args + ["--batch", "always"])
    never = launch_segment.main(args + ["--batch", "never"])
    keys = ("accuracy", "em_iters", "map_iters", "status")
    assert [{k: r[k] for k in keys} for r in always] == [{k: r[k] for k in keys} for r in never]
