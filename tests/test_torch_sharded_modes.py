"""The modes ``static`` and ``faithful`` on the port's sharded route, on the
CPU: ``run_em_sharded`` on one in-process gloo rank and on 2 and 4
spawned ranks (``repro_torch.testing.ranks``, 120 s cap each), against
the single-device port and the JAX package's ``distributed_em`` on a
one-device mesh.

The problems are 48x48 synthetic slices (K = 2, 3; quantile init) planned
by the port on the CPU; the same numpy arrays go to both packages, and
every rank solves each problem on the port's partition and on the JAX
package's (carried across with ``convert``).  The launcher runs
``--mode faithful --shards 2`` on the two ranks against its single-device
run.

Tolerances: one rank equals the single device bit for bit (its hood sums
are one block's element-order sums, all-reduced over one rank).  Over 2
and 4 ranks labels, EM and MAP iteration counts and status exact; mu,
sigma and hood energies within rtol 1e-5 (atol 1e-5): a hood that
straddles ranks adds its ranks' partial sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import Mesh

from repro.core.pmrf import distributed as jax_dist
from repro.core.pmrf import em as jax_em
from repro.core.pmrf import energy as jax_energy
from repro.core.pmrf import hoods as jax_hoods

from repro_torch.core import synthetic
from repro_torch.core.pmrf import convert, pipeline
from repro_torch.core.pmrf import distributed as torch_dist
from repro_torch.core.pmrf import em as torch_em
from repro_torch.launch import segment as launch_segment
from repro_torch.testing import ranks
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

# K: (seed, size, grid)
CASES = {2: (0, 48, 6), 3: (0, 48, 6)}
MODES = ("static", "faithful")
MAX_EM, MAX_MAP = 20, 10
RANK_TIMEOUT_S = 120

_cache = {}


def _arrays(n_labels):
    if n_labels not in _cache:
        seed, size, grid = CASES[n_labels]
        if n_labels == 2:
            vol = synthetic.make_synthetic_volume(seed=seed, n_slices=1, shape=(size, size),
                                                  device="cpu")
        else:
            vol = synthetic.make_kary_volume(seed=seed, n_slices=1, shape=(size, size),
                                             n_phases=n_labels, device="cpu")
        prob = pipeline.initialize(vol.images[0], overseg_grid=(grid, grid), n_labels=n_labels,
                                   device="cpu")
        init = pipeline.initial_params(prob, 0, "quantile")
        d = {f: getattr(prob.hoods, f).numpy() for f in convert.HOODS_ARRAYS}
        d.update({f: getattr(prob.hoods, f) for f in convert.HOODS_SIZES})
        d.update({f: getattr(prob.model, f).numpy() for f in convert.MODEL_FIELDS})
        d.update(zip(convert.INIT_FIELDS, (t.numpy() for t in init)))
        _cache[n_labels] = d
    return _cache[n_labels]


def _jax_hoods(d):
    return jax_hoods.Hoods(**{k: jnp.asarray(d[k]) for k in convert.HOODS_ARRAYS},
                           **{k: d[k] for k in convert.HOODS_SIZES})


def _hoods_dict(h):
    d = {f: np.asarray(getattr(h, f)) for f in convert.HOODS_ARRAYS}
    d.update({f: getattr(h, f) for f in convert.HOODS_SIZES})
    return d


def _config(mode):
    return dict(mode=mode, max_em_iters=MAX_EM, max_map_iters=MAX_MAP)


def _summary(res):
    return {f: (np.asarray(getattr(res, f)) if f in ("labels", "mu", "sigma", "hood_energy")
                else int(getattr(res, f)))
            for f in ("labels", "mu", "sigma", "hood_energy", "em_iters", "map_iters", "status")}


def _references(n_labels, mode):
    """The single-device port's solve and JAX ``distributed_em`` on a
    one-device mesh, as numpy summaries."""
    key = ("refs", n_labels, mode)
    if key not in _cache:
        d = _arrays(n_labels)
        single = torch_em.run_em(*convert.problem_from_numpy(d, device="cpu"),
                                 torch_em.EMConfig(**_config(mode)))
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        model = jax_energy.EnergyModel(*(jnp.asarray(d[f]) for f in convert.MODEL_FIELDS))
        jres = jax_dist.distributed_em(
            _jax_hoods(d), model, *(d[k] for k in convert.INIT_FIELDS), mesh, "data",
            jax_em.EMConfig(backend="xla", **_config(mode)))
        _cache[key] = (_summary(single), _summary(jres))
    return _cache[key]


def _assert_matches(got, want, what, exact=False):
    np.testing.assert_array_equal(got["labels"], want["labels"], err_msg=what)
    assert (got["em_iters"], got["map_iters"], got["status"]) == (
        want["em_iters"], want["map_iters"], want["status"]), what
    for f in ("mu", "sigma", "hood_energy"):
        if exact:
            np.testing.assert_array_equal(got[f].view(np.uint32), want[f].view(np.uint32),
                                          err_msg=f"{what}: {f}")
        else:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-5, err_msg=f"{what}: {f}")


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_labels", sorted(CASES))
def test_one_rank_equals_single_device_and_jax(n_labels, mode, one_rank_group):
    tp = convert.problem_from_numpy(_arrays(n_labels), device="cpu")
    got = torch_dist.run_em_sharded(torch_dist.partition_hoods(tp.hoods, 1), tp.model, tp.labels0,
                                    tp.mu0, tp.sigma0, config=torch_em.EMConfig(**_config(mode)))
    single, jax_sharded = _references(n_labels, mode)
    _assert_matches(_summary(got), single, "one rank vs single device", exact=True)
    _assert_matches(_summary(got), jax_sharded, "one rank vs JAX distributed_em")
    with pytest.raises(ValueError, match="no workspace"):
        torch_dist.run_em_sharded(torch_dist.partition_hoods(tp.hoods, 1), tp.model, tp.labels0,
                                  tp.mu0, tp.sigma0, config=torch_em.EMConfig(**_config(mode)),
                                  workspace=object())


@pytest.mark.parametrize("world_size", [2, 4])
def test_spawned_ranks_match_single_device_and_jax(world_size, tmp_path):
    problems = {}
    for k in sorted(CASES):
        d = _arrays(k)
        parts = _hoods_dict(jax_dist.partition_hoods(_jax_hoods(d), world_size))
        for mode in MODES:
            problems[f"K={k} {mode}"] = (d, parts, _config(mode))
    argv = ["--size", "48", "--grid", "6", "--labels", "3", "--seed", "1", "--device", "cpu",
            "--mode", "faithful"]
    payload = {"problems": problems}
    if world_size == 2:
        payload.update(launcher=argv + ["--shards", "2"])
    out = ranks.run_ranks(ranks.sharded_em, world_size, tmp_path, payload, timeout=RANK_TIMEOUT_S)
    for k in sorted(CASES):
        for mode in MODES:
            single, jax_sharded = _references(k, mode)
            for rank, o in enumerate(out):
                for part, got in o[f"K={k} {mode}"].items():
                    what = f"K={k} {mode} rank {rank} {part}"
                    _assert_matches(got, single, what + " vs the single device")
                    _assert_matches(got, jax_sharded, what + " vs JAX distributed_em")
    if world_size == 2:
        (want,) = launch_segment.main(argv)
        for o in out:
            (row,) = o["launcher"]
            assert row["shards"] == 2 and want["shards"] == 1
            for f in ("accuracy", "em_iters", "map_iters", "status"):
                assert row[f] == want[f], f
