"""The sharded route's MAP iteration on a rank's plan-owned workspace
(``ref.PlainMapStepWorkspace``, the plain version of the CUDA
``map_step.MapStepWorkspace``) and the EM driver that runs it.

* Over whole solves at K = 2, 3 and 5 on a one-rank gloo group, the
  workspace gives at every MAP iteration the bits of the composition it
  replaced on the route (``energy.map_step_operands``, ``ref.fused_map_step``,
  the all-reduces, the argmax, a ``torch.cat``-rolled history, the window
  and finiteness tests): the step's hood sums and votes, the head's labels,
  the all-reduced sums it tested and the flag word.  A MAP loop makes one
  launch more than it has iterations, one all-reduce per iteration, and the
  AND of the flag word past the window.
* On spawned 2- and 4-rank gloo groups (``repro_torch.testing.ranks``), the
  label counts over each hood's whole run of the partition, which the CUDA
  step takes, equal the all-reduced counts the old composition gathered,
  and one workspace step equals the old kernel call on each rank's block.
* ``map_step.hood_runs``: the runs and their block parts, and the checks
  made when a workspace is built.

``tests/test_torch_sharded.py`` holds the route to the JAX package.  A test
marked ``cuda`` holds the kernel's workspace to the plain one on the card
and skips without one.  Everything here is compared bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import dpp, synthetic
from repro_torch.core.pmrf import collectives, convert
from repro_torch.core.pmrf import distributed as D
from repro_torch.core.pmrf import em as em_mod
from repro_torch.core.pmrf import energy as E
from repro_torch.core.pmrf import pipeline
from repro_torch.kernels import _build, map_step, ops, ref
from repro_torch.testing import ranks

# K: (phases, seed, size, grid)
PROBLEMS = {2: (2, 0, 48, 6), 3: (3, 0, 48, 6), 5: (5, 1, 48, 7)}
RANK_TIMEOUT_S = 120
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


def _problem_dict(n_labels):
    prob = _problem(n_labels)
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    d = {f: getattr(prob.hoods, f).numpy() for f in convert.HOODS_ARRAYS}
    d.update({f: getattr(prob.hoods, f) for f in convert.HOODS_SIZES})
    d.update({f: getattr(prob.model, f).numpy() for f in convert.MODEL_FIELDS})
    d.update(labels0=labels0.numpy(), mu0=mu0.numpy(), sigma0=sigma0.numpy())
    return d


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


class _Lockstep(ref.PlainMapStepWorkspace):
    """The plain workspace, checked at every launch against the composition
    the route ran before it (its own labels and its own rolled history),
    with the driver's launches, all-reduces and flag ANDs counted."""

    def start(self, y, w, nall_e, valid, labels0):
        super().start(y, w, nall_e, valid, labels0)
        h = self._hoods
        self.local = D.shard_block(h, 0, 1)
        self.sctx = E.StaticMapContext(y=y, w=w, validf=valid, nall_e=nall_e)
        self.old_labels = labels0.clone()
        self.launches = self.steps = 0

    def begin_em(self, mu, sigma):
        super().begin_em(mu, sigma)
        self.old_hist = torch.zeros_like(self.ring)
        self.old_i = 0
        self.pending = None

    def step(self, gate, step=True):
        super().step(gate, step)
        self.launches += 1
        what = f"launch {self.launches}"
        if self.pending is not None:  # the head tested the old iteration
            labels, hood_e, votes, flag = self.pending
            assert _same(self.labels, labels), what
            assert _same(self.hood_e, hood_e), what
            assert _same(self.votes, votes), what
            assert self.flag() == flag, what
            rows = self.ring.shape[0]
            newest = self.ring[[(self.head + r) % rows for r in range(min(self.old_i, rows))]]
            assert _same(newest, self.old_hist[: newest.shape[0]]), what
            self.pending = None
        else:
            assert self.flag() == 0, what
        assert gate == (self.old_i > em_mod.WINDOW), what
        if not step:
            return
        m = self._model
        mu, sig = self._params
        args, kw = E.map_step_operands(self.local, m, self.sctx, self.old_labels, mu, sig)
        assert _same(args[9], sig), what
        _, _, hood_e, votes = ref.fused_map_step(*args, **kw)
        assert _same(self.buffer, torch.cat([hood_e, votes.reshape(-1)])), what
        self.steps += 1
        new = torch.argmax(votes, dim=0).to(torch.int32)
        new[self.n_vertices - 1] = 0
        self.old_hist = torch.cat([hood_e[None], self.old_hist[:-1]])
        self.old_i += 1
        conv = bool(torch.all(em_mod._window_converged(self.old_hist))) and self.old_i > em_mod.WINDOW
        diverged = not bool(torch.all(torch.isfinite(hood_e)))
        flag = int(conv) * ref.FLAG_CONVERGED | int(diverged) * ref.FLAG_DIVERGED
        self.pending = (new, hood_e, votes, flag)
        self.old_labels = new


@pytest.mark.parametrize("n_labels", sorted(PROBLEMS))
def test_workspace_equals_old_composition_over_a_solve(n_labels, one_rank_group, monkeypatch):
    prob = _problem(n_labels)
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    parts = D.partition_hoods(prob.hoods, 1)
    ws = _Lockstep(parts, prob.model, conv_tol=em_mod.CONV_TOL, window=em_mod.WINDOW)
    calls = {"psum": 0, "and_flags": 0}
    for name in calls:
        plain = getattr(collectives.ReduceCtx, name)

        def counted(self, x, _plain=plain, _name=name):
            calls[_name] += 1
            return _plain(self, x)

        monkeypatch.setattr(collectives.ReduceCtx, name, counted)
    res = D.run_em_sharded(parts, prob.model, labels0, mu0, sigma0,
                           config=em_mod.EMConfig(), workspace=ws)
    assert res.status in (em_mod.STATUS_CONVERGED, em_mod.STATUS_MAX_ITERS)
    assert ws.steps >= res.map_iters > em_mod.WINDOW
    assert ws.launches == res.map_iters + res.em_iters
    assert calls["psum"] == res.map_iters
    assert 0 < calls["and_flags"] <= res.map_iters - em_mod.WINDOW
    # The result owns its tensors: the workspace's buffers stay the plan's.
    assert res.labels.data_ptr() != ws.labels.data_ptr() and torch.equal(res.labels, ws.labels)
    # ... and equals the single-device route's.
    single = em_mod.run_em(prob.hoods, prob.model, labels0, mu0, sigma0)
    assert (res.status, res.em_iters, res.map_iters) == (single.status, single.em_iters, single.map_iters)
    assert torch.equal(res.labels, single.labels)


@pytest.mark.parametrize("n_labels", sorted(PROBLEMS))
def test_workspace_m_step_is_the_keyed_m_step(n_labels):
    """The route's M-step on its workspace (the sums a launch that stops
    the MAP loop puts in ``stats``) gives the sums
    ``energy.update_parameters_stats`` forms with its three keyed
    reductions, bit for bit, and so the same parameters.  A launch that
    does not stop the loop leaves them as they were."""
    prob = _problem(n_labels)
    parts = D.partition_hoods(prob.hoods, 1)
    ws = ops.map_step_workspace(parts, prob.model)
    rng = np.random.default_rng(n_labels)
    labels = torch.from_numpy(rng.integers(0, n_labels, ws.n_vertices).astype(np.int32))
    labels[-1] = 0
    ws.start(*[torch.zeros(ws.block)] * 4, labels)
    ws.begin_em(torch.zeros(n_labels), torch.ones(n_labels))
    ws.step(False)  # a MAP loop's first launch: flag word 0, a step
    assert ws.flag() == 0 and not torch.any(ws.stats)
    ws.begin_em(torch.zeros(n_labels), torch.ones(n_labels))
    ws.step(False, step=False)  # stops the loop before any step: the caller's labels
    stats = ws.stats
    assert stats.shape == (3, n_labels)
    w, y = prob.model.region_weight, prob.model.region_mean
    lab = labels.long()
    for got, values in zip(stats, (w, w * y, w * y * y)):
        assert _same(got, dpp.reduce_by_key(lab, values, n_labels, op="add"))
    want = E.update_parameters_stats(prob.model, labels, "static-pallas")
    for a, b in zip(E.params_from_stats(prob.model, *stats), want):
        assert _same(a, b)


def test_k9_sharded_plain_path_is_the_single_device_plain_path(one_rank_group):
    """At K = 9 (the single-device tick's runtime-K variant) the sharded
    route's plain path on one gloo rank gives the single-device plain
    path's status, iteration counts and labels: both sum each hood in
    element order, the sum the CUDA kernels of both routes now take."""
    vol = synthetic.make_kary_volume(seed=0, n_slices=1, shape=(64, 64), n_phases=3, device="cpu")
    prob = pipeline.initialize(vol.images[0], overseg_grid=(8, 8), n_labels=9, device="cpu")
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    res = D.distributed_em(prob.hoods, prob.model, labels0, mu0, sigma0)
    single = em_mod.run_em(prob.hoods, prob.model, labels0, mu0, sigma0)
    assert res.map_iters > em_mod.WINDOW and res.status == em_mod.STATUS_CONVERGED
    assert (res.status, res.em_iters, res.map_iters) == (single.status, single.em_iters, single.map_iters)
    assert torch.equal(res.labels, single.labels)


def test_nan_ends_the_sharded_solve_as_diverged(one_rank_group):
    """A NaN region mean makes a hood sum NaN: the head of the second
    launch sets the diverged bit and the solve ends diverged after one EM
    and one MAP iteration, as the single-device route does."""
    prob = _problem(3)
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    mean = prob.model.region_mean.clone()
    mean[int(prob.hoods.vertex[int(prob.hoods.offsets[5])])] = float("nan")
    model = prob.model._replace(region_mean=mean)
    res = D.distributed_em(prob.hoods, model, labels0, mu0, sigma0)
    single = em_mod.run_em(prob.hoods, model, labels0, mu0, sigma0)
    assert (res.status, res.em_iters, res.map_iters) == (em_mod.STATUS_DIVERGED, 1, 1)
    assert (single.status, single.em_iters, single.map_iters) == (em_mod.STATUS_DIVERGED, 1, 1)


@pytest.mark.parametrize("world_size", [2, 4])
def test_whole_run_counts_equal_all_reduced_counts(world_size, tmp_path):
    rng = np.random.default_rng(world_size)
    problems = {}
    for k in sorted(PROBLEMS):
        d = _problem_dict(k)
        n_v = int(d["n_regions"]) + 1
        problems[f"K={k} quantile"] = (d, d["labels0"])
        noise = rng.integers(0, k, n_v).astype(np.int32)
        noise[-1] = 0
        problems[f"K={k} random"] = (d, noise)
    out = ranks.run_ranks(ranks.map_step_counts, world_size, tmp_path, {"problems": problems},
                          timeout=RANK_TIMEOUT_S)
    for name in problems:
        rows = [o[name] for o in out]
        assert sum(r["valid_in_block"] for r in rows) == int(problems[name][0]["n_elements"]), name
        # Every hood has a rank; a rank whose block is all padding has none.
        assert sum(r["n_local"] for r in rows) >= int(problems[name][0]["n_hoods"]), name
        for rank, r in enumerate(rows):
            what = f"{name} rank {rank}"
            assert r["plain_workspace"], what
            assert r["counts_equal"] and r["covered"] and r["step_equal"], what


def test_hood_runs_split_the_partition():
    prob = _problem(2)
    hoods, offsets = prob.hoods, prob.hoods.offsets.numpy()
    whole, lo, block = map_step.hood_runs(hoods, 0, 1)
    assert (lo, block) == (0, hoods.capacity)
    np.testing.assert_array_equal(whole[:, 0], offsets[:-1])
    np.testing.assert_array_equal(whole[:, 1], offsets[1:])
    np.testing.assert_array_equal(whole[:, 2:], whole[:, :2])
    parts = D.partition_hoods(hoods, 3)
    seen = 0
    for rank in range(3):
        ranges, lo, block = map_step.hood_runs(parts, rank, 3)
        assert block == parts.capacity // 3
        # whole runs are the plan's runs; block parts are clipped to the block
        np.testing.assert_array_equal(ranges[:, :2], whole[lo:lo + len(ranges), :2])
        assert np.all((rank * block <= ranges[:, 2]) & (ranges[:, 3] <= (rank + 1) * block))
        seen += int((ranges[:, 3] - ranges[:, 2]).sum())
    assert seen == hoods.n_elements
    # The valid elements are the hoods' runs in hood order.
    assert np.all(parts.hood_id[: hoods.n_elements].numpy() == np.repeat(np.arange(hoods.n_hoods), np.diff(offsets)))
    with pytest.raises(ValueError, match="split"):
        map_step.hood_runs(hoods, 0, 7 if hoods.capacity % 7 else 11)
    with pytest.raises(ValueError, match="rank"):
        map_step.hood_runs(parts, 3, 3)
    swapped = hoods.hood_id.clone()
    swapped[[0, hoods.n_elements - 1]] = swapped[[hoods.n_elements - 1, 0]]
    shuffled = type(hoods)(**{**hoods.__dict__, "hood_id": swapped})
    with pytest.raises(ValueError, match="sorted"):
        map_step.hood_runs(shuffled, 0, 1)


def test_workspace_routes_and_refusals(one_rank_group):
    """CPU tensors get the plain workspace and launch nothing; the CUDA
    workspace refuses CPU tensors before it builds anything; the sharded
    driver refuses a missing workspace, one of another K or another block."""
    prob = _problem(2)
    parts = D.partition_hoods(prob.hoods, 1)
    ops.reset_launch_counts()
    ws = D.make_workspace(parts, prob.model, em_mod.EMConfig())
    assert isinstance(ws, ref.PlainMapStepWorkspace)
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    D.run_em_sharded(parts, prob.model, labels0, mu0, sigma0, config=em_mod.EMConfig(), workspace=ws)
    assert ops.launch_counts()["fused_map_step"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        map_step.MapStepWorkspace(parts, prob.model)
    assert _build._libs == {}
    with pytest.raises(ValueError, match="workspace"):
        em_mod._em_driver(D.shard_block(parts, 0, 1), prob.model, labels0, mu0, sigma0,
                          em_mod.EMConfig(), collectives.ReduceCtx(group=dist.group.WORLD))
    k3 = _problem(3)
    with pytest.raises(ValueError, match="K = 3"):
        D.run_em_sharded(parts, prob.model, labels0, mu0, sigma0, config=em_mod.EMConfig(),
                         workspace=ops.map_step_workspace(parts, k3.model))
    other = ops.map_step_workspace(D.partition_hoods(prob.hoods, 2), prob.model, rank=1, n_shards=2)
    with pytest.raises(ValueError, match="block"):
        D.run_em_sharded(parts, prob.model, labels0, mu0, sigma0, config=em_mod.EMConfig(),
                         workspace=other)


@pytest.mark.cuda
@pytest.mark.parametrize("n_labels", sorted(PROBLEMS))
def test_kernel_workspace_equals_plain_on_the_card(n_labels):
    """The card's ``MapStepWorkspace`` against the plain workspace over a
    whole sharded solve on a one-rank NCCL group: iteration counts, status
    and labels equal; one launch per MAP iteration and one per EM one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (a CUDA kernel has no CPU mode)")
    prob = convert.problem_from_numpy(_problem_dict(n_labels), device="cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        ops.reset_launch_counts()
        got = D.distributed_em(prob.hoods, prob.model, prob.labels0, prob.mu0, prob.sigma0)
        assert ops.launch_counts()["fused_map_step"] == got.map_iters + got.em_iters
        want = D.distributed_em(prob.hoods, prob.model, prob.labels0, prob.mu0, prob.sigma0,
                                config=em_mod.EMConfig(backend="torch"))
    finally:
        dist.destroy_process_group()
    assert (got.status, got.em_iters, got.map_iters) == (want.status, want.em_iters, want.map_iters)
    assert torch.equal(got.labels, want.labels)
