"""The served pool's compiled tick in mode ``static-pallas`` on the CPU (its
plain version: the tick graph's control run by the host, ``em._tick_program``
with ``kernels.ref.tick_init``, ``tick_stops``, ``tick_tail`` and
``tick_publish``).

* Against the JAX package's ``run_em_ticked`` (mode ``static``,
  ``backend="xla"``: the fused route's trajectory is the static mode's) on
  three 48x48 K = 2 slices, each lane in its own slot: labels, counts and
  status exact; mu, sigma and energies within rtol/atol 1e-5.  The JAX run
  is made once, in a module-scoped fixture.
* Bit for bit the host-stepped tick it replaced (``testing.host_loop``) at
  tick sizes 1, 3 and 8 in pools of 2, 3 and 4 slots: after every tick the
  pool's state (host lists, micro-steps, lane buffers, EM level) equal;
  every lane its serial ``run_em`` at K = 2, 3 and 9; a mixed-K engine
  stream (K = 2 requests in a K = 3 pool) the same through either tick.
* The control's plain versions on hand-made words: the stop rule (flag
  word or cap, only lanes that ran), the partial-tick exit, the early exit
  once every lane is done, the out-words.
* A tick's census: one host read of its words, no copy; a tick of a pool
  whose lanes are all done launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pmrf import em as jax_em
from repro.core.pmrf import energy as jax_energy
from repro.core.pmrf import hoods as jax_hoods

from repro_torch import api
from repro_torch.analysis import census
from repro_torch.core import synthetic
from repro_torch.core.pmrf import convert
from repro_torch.core.pmrf import em as torch_em
from repro_torch.kernels import ref
from repro_torch.kernels.ref import TickShape
from repro_torch.serving import SegmentationEngine
from repro_torch.testing import host_loop
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

MAX_EM, MAX_MAP = 20, 10
TOL = dict(rtol=1e-5, atol=1e-5)
# K -> (phases, seed, grid) of three 48x48 slices.
PROBLEMS = {2: (2, 6, 6), 3: (3, 4, 6), 9: (3, 0, 7)}
_cache = {}


def _session(n_labels=2, **kw):
    grid = PROBLEMS[n_labels][2]
    return api.Segmenter(api.ExecutionConfig(mode="static-pallas", n_labels=n_labels,
                                             overseg_grid=(grid, grid), init="quantile",
                                             max_em_iters=MAX_EM, max_map_iters=MAX_MAP, **kw),
                         device="cpu")


def _images(n_labels, n=3):
    phases, seed, _ = PROBLEMS[n_labels]
    if phases == 2:
        return synthetic.make_synthetic_volume(seed=seed, n_slices=n, shape=(48, 48),
                                               device="cpu").images
    return synthetic.make_kary_volume(seed=seed, n_slices=n, shape=(48, 48), n_phases=phases,
                                      device="cpu").images


def _lanes(n_labels):
    """Three slices padded to their joint bucket: each lane's admission
    inputs ``(hoods, model, labels0, mu0, sigma0, sctx)``."""
    if n_labels not in _cache:
        seg = _session(n_labels)
        plans = [seg.plan(im) for im in _images(n_labels)]
        joint = api.BucketKey(*(max(p.bucket[d] for p in plans) for d in range(3)))
        _cache[n_labels] = [seg.lane_state(p, bucket=joint, seed=0) for p in plans]
    return _cache[n_labels]


def _config():
    return torch_em.EMConfig(mode="static-pallas", max_em_iters=MAX_EM, max_map_iters=MAX_MAP)


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _assert_same(got, want, what):
    for f in ("labels", "mu", "sigma", "hood_energy", "total_energy"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f"{what} {f}"
    assert (got.em_iters, got.map_iters, got.status) == (want.em_iters, want.map_iters,
                                                       want.status), what


def _pool(lanes, batch, tick_iters, ticked, record=None):
    """Every lane through a ``batch``-slot pool, each tick ``ticked(state,
    config, tick_iters)``; ``record(state)`` after each tick.  Returns the
    results by lane."""
    cfg = _config()
    ws = torch_em.make_workspace(TickShape.of(lanes[0][0], lanes[0][1]), cfg, device="cpu",
                                 batch=batch, pool=True)
    state = torch_em.blank_tick_state(ws)
    queue, slots, results = list(range(len(lanes))), [None] * batch, {}
    while queue or any(s is not None for s in slots):
        for b in range(batch):
            if slots[b] is None and queue:
                slots[b] = queue.pop(0)
                torch_em.init_tick_lane(state, b, *lanes[slots[b]])
        state, _ = ticked(state, cfg, tick_iters)
        if record is not None:
            record(state)
        for b in range(batch):
            if slots[b] is not None and state.done[b]:
                results[slots[b]] = torch_em.tick_result(state, b)
                slots[b] = None
    return results


def _snapshot(state):
    ws = state.workspace
    bufs = {n: getattr(ws, n).clone() for n in ("labels", "votes", "ring", "hood_e", "stats",
                                                 "active", "map_i", "mu", "sigma", "em_mu",
                                                 "em_sigma", "total_hist")}
    return (list(state.em_i), list(state.map_i), list(state.map_total), list(state.done),
            list(state.status), state.micro_steps), bufs


@pytest.fixture(scope="module")
def jax_ticked():
    """JAX ``run_em_ticked`` (mode static, XLA) of the K = 2 lanes, every
    lane in its own slot, ticked to the end (run once)."""
    lanes = _lanes(2)
    stack = lambda i: torch.stack([lane[i] for lane in lanes])  # noqa: E731
    hoods = jax_hoods.Hoods(
        **{f: jnp.asarray(np.stack([getattr(lane[0], f).numpy() for lane in lanes]))
           for f in convert.HOODS_ARRAYS},
        **{f: getattr(lanes[0][0], f) for f in convert.HOODS_SIZES})
    model = jax_energy.EnergyModel(*(jnp.asarray(np.stack([t.numpy() for t in field]))
                                     for field in zip(*(lane[1] for lane in lanes))))
    lab0, mu0, sig0 = (jnp.asarray(stack(i).numpy()) for i in (2, 3, 4))
    cfg = jax_em.EMConfig(mode="static", backend="xla", max_em_iters=MAX_EM, max_map_iters=MAX_MAP)
    state = jax.vmap(lambda l, m, s: jax_em.init_tick_lane(l, m, s, hoods.n_hoods))(lab0, mu0, sig0)
    vplan = jax.vmap(lambda v: jax_em.make_vote_plan(v, hoods.n_regions))(hoods.vertex)
    while not bool(np.all(np.asarray(state.done))):
        state, _ = jax_em.run_em_ticked(hoods, model, state, vplan, cfg, 8)
    return jax_em.tick_result(state)


def test_tick_program_matches_jax(jax_ticked):
    got = _pool(_lanes(2), 3, 8, torch_em.run_em_ticked)
    want = jax_ticked
    assert len({got[b].map_iters for b in range(3)}) > 1, "the lanes stop at different iterations"
    for b in range(3):
        what = f"lane {b}"
        np.testing.assert_array_equal(got[b].labels.numpy(), np.asarray(want.labels[b]), what)
        assert (got[b].em_iters, got[b].map_iters, got[b].status) == (
            int(want.em_iters[b]), int(want.map_iters[b]), int(want.status[b])), what
        for f in ("mu", "sigma", "hood_energy", "total_energy"):
            np.testing.assert_allclose(getattr(got[b], f).numpy(), np.asarray(getattr(want, f)[b]),
                                       err_msg=f"{what} {f}", **TOL)


@pytest.mark.parametrize("tick_iters,batch", [(1, 2), (3, 3), (8, 4)])
def test_tick_program_equals_the_host_stepped_tick(tick_iters, batch):
    lanes = _lanes(2)
    lanes = lanes + lanes[:2]
    seen = {"program": [], "host": []}
    got = _pool(lanes, batch, tick_iters, torch_em.run_em_ticked,
                lambda st: seen["program"].append(_snapshot(st)))
    want = _pool(lanes, batch, tick_iters, host_loop.run_em_ticked,
                 lambda st: seen["host"].append(_snapshot(st)))
    assert len(seen["program"]) == len(seen["host"])
    for t, ((lists, bufs), (lists_h, bufs_h)) in enumerate(zip(seen["program"], seen["host"])):
        assert lists == lists_h, f"tick {t}"
        for n, v in bufs.items():
            assert torch.equal(_bits(v), _bits(bufs_h[n])), f"tick {t} {n}"
    for b in range(len(lanes)):
        _assert_same(got[b], want[b], f"tick {tick_iters} lane {b}")


@pytest.mark.parametrize("n_labels", [2, 3, 9])
def test_every_lane_equals_its_serial_run_em(n_labels):
    lanes = _lanes(n_labels)
    got = _pool(lanes, 2, 3, torch_em.run_em_ticked)
    for b, lane in enumerate(lanes):
        _assert_same(got[b], torch_em.run_em(*lane[:5], _config()), f"K={n_labels} lane {b}")


def test_mixed_k_engine_equals_the_host_stepped_tick(monkeypatch):
    sess2, sess3 = _session(capacity_bucket=1024), _session(3, capacity_bucket=1024)
    plans = [sess2.plan(im) for im in _images(2, 2)] + [sess3.plan(im) for im in _images(3, 2)]

    def serve():
        engine = SegmentationEngine(sess3, max_batch=2, tick_iters=4)
        for rid, p in enumerate(plans):
            engine.submit(p, rid=rid, seed=0)
        return {c.rid: c.result for c in engine.run()}

    got = serve()
    monkeypatch.setattr(torch_em, "run_em_ticked", host_loop.run_em_ticked)
    want = serve()
    for rid in range(4):
        for f in ("region_labels", "mu", "sigma"):
            np.testing.assert_array_equal(getattr(got[rid], f), getattr(want[rid], f))
        assert (got[rid].em_iters, got[rid].map_iters, got[rid].status) == (
            want[rid].em_iters, want[rid].map_iters, want[rid].status)


def _words(active, map_i, flag, iters=3, em=(0, 0, 0), maps=(0, 0, 0), status=(0, 0, 0)):
    b = len(active)
    lane = torch.zeros((len(ref.LANE_WORDS), b), dtype=torch.int32)
    lane[ref.ACTIVE], lane[ref.MAP_I], lane[ref.FLAG] = (torch.tensor(v, dtype=torch.int32)
                                                          for v in (active, map_i, flag))
    ctl = torch.full((len(ref.CTL_WORDS),), 7, dtype=torch.int32)
    tick = torch.zeros((len(ref.TICK_WORDS),), dtype=torch.int32)
    ref.tick_init(lane, ctl, tick, torch.tensor([iters, *em, *maps, *status], dtype=torch.int32))
    return lane, ctl, tick


def test_control_plain_versions():
    # The start: the host's counters in, the running lanes, the loop's condition.
    lane, ctl, tick = _words([1, 0, 1], [0, 4, 2], [0, 2, 0], em=(3, 9, 1), maps=(30, 90, 10),
                             status=(0, 1, 0))
    assert lane[ref.RUNNING].tolist() == [1, 0, 1] and lane[ref.EM_ITERS].tolist() == [3, 9, 1]
    assert lane[ref.MAP_ITERS].tolist() == [30, 90, 10] and lane[ref.STATUS].tolist() == [0, 1, 0]
    assert ctl[5:].tolist() == [0] * 8 and ctl[:5].tolist() == [7] * 5
    assert tick.tolist()[:3] == [0, 3, 0] and int(tick[ref.T_LOOP]) == 1
    assert tick[ref.T_INIT_RUNS:].tolist() == [1, 0, 0]  # tick_init counted itself
    # The stop rule: a lane that ran stops on its flag word or at the cap; a
    # lane that did not run (its stale flag set) does not.
    lane[ref.FLAG] = torch.tensor([0, 2, 1], dtype=torch.int32)
    lane[ref.MAP_I] = torch.tensor([10, 4, 3], dtype=torch.int32)
    lane[ref.ACTIVE] = torch.tensor([0, 0, 0], dtype=torch.int32)
    ref.tick_stops(lane, tick, 10)
    assert lane[ref.RUNNING].tolist() == [1, 0, 1] and tick[ref.T_STOP] == 1
    assert tick[ref.T_STOPS] == 1 and tick[ref.T_STOP_RUNS] == 1
    assert tick[ref.T_LOOP] == 1  # the tail's to write
    # The tail: every active lane runs the next step; the partial-tick exit.
    for steps, want in ((1, 1), (2, 1), (3, 0)):
        lane[ref.ACTIVE] = torch.tensor([1, 0, 0], dtype=torch.int32)
        ref.tick_tail(lane, tick)
        assert tick[ref.T_STEPS] == steps and int(tick[ref.T_LOOP]) == want
        assert lane[ref.RUNNING].tolist() == [1, 0, 0]
    out = ref.tick_publish(lane, ctl, tick)
    assert out["lanes"][0] == (3, 30, 0, 10, 1) and out["steps"] == 3 and out["stops"] == 1
    assert (out["tick_init"], out["tick_stops"], out["tick_publish"]) == (1, 1, 1)
    assert tick[ref.T_INIT_RUNS:].tolist() == [0, 0, 0]  # published, then set back
    # No lane active, or a tick of size 0: the loop never starts.
    assert int(_words([0, 0, 0], [0] * 3, [0] * 3)[2][ref.T_LOOP]) == 0
    assert int(_words([1, 1, 1], [0] * 3, [0] * 3, iters=0)[2][ref.T_LOOP]) == 0


def test_partial_tick_exit_and_one_read():
    """Lanes that never stop run exactly ``tick_iters`` micro-steps per tick;
    a tick takes one host read of its words and no copy, none inside its
    loop, and a pool whose
    lanes are all done runs nothing."""
    lanes = _lanes(2)
    cfg = _config()._replace(max_map_iters=1000)
    ws = torch_em.make_workspace(TickShape.of(lanes[0][0], lanes[0][1]), cfg, device="cpu",
                                 batch=2, pool=True)
    state = torch_em.blank_tick_state(ws)
    assert torch_em.run_em_ticked(state, cfg, 3) == (state, 0) and state.micro_steps == 0
    for b in range(2):
        torch_em.init_tick_lane(state, b, *lanes[b])
    with census.take() as cen:
        _, steps = torch_em.run_em_ticked(state, cfg, 3)
    assert steps == 3 and state.micro_steps == 3 and state.map_i == [3, 3]
    s = cen.summary()
    assert s[census.SOLVE]["instances"] == 1
    assert (s[census.SOLVE]["max"]["host_reads"], s[census.SOLVE]["max"]["h2d_copies"]) == (1, 0)
    assert s[census.MAP_ITERATION]["instances"] == 3
    assert s[census.MAP_ITERATION]["max"]["host_reads"] == 0  # none inside the loop
    assert s[census.MAP_ITERATION]["max"]["h2d_copies"] == 0
    assert s[census.EM_BOUNDARY]["max"]["host_reads"] == 0
