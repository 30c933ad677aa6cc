"""The port's plan phase (SLIC, region graph, cliques, hoods, energy model,
initial parameters) and its data-parallel primitives against the JAX
package, on the CPU.

Images come from the JAX package's synthetic generator (the port's
``torch.Generator`` cannot reproduce ``jax.random`` streams).  The graph,
cliques and hoods are built from the JAX SLIC label map through the
``oversegmentation=`` passthrough, so they are compared on the same
partition whatever SLIC does; SLIC is compared on its own.  Tolerances:
label maps and every integer array exact; the energy model and the
quantile init within rtol 1e-6 (``torch.std``/``torch.quantile`` reduce
in another order than ``jnp.std``/``jnp.quantile``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dpp as jax_dpp
from repro.core import oversegment as jax_overseg
from repro.core import synthetic as jax_synthetic
from repro.core.pmrf import em as jax_em
from repro.core.pmrf import hoods as jax_hoods
from repro.core.pmrf import pipeline as jax_pipeline

from repro_torch.core import dpp
from repro_torch.core import oversegment
from repro_torch.core.pmrf import em as torch_em
from repro_torch.core.pmrf import hoods as torch_hoods
from repro_torch.core.pmrf import pipeline as torch_pipeline
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

# The problems of tests/test_golden.py (48x48 slices).
CASES = {
    2: dict(seed=0, shape=(48, 48), grid=(6, 6)),
    3: dict(seed=0, shape=(48, 48), grid=(6, 6)),
    5: dict(seed=1, shape=(48, 48), grid=(7, 7)),
}
HOOD_ARRAYS = ("vertex", "hood_id", "valid", "sizes", "offsets")
# Building a JAX problem costs about 12 s here (the hood construction
# compiles op by op for each new shape), so the plan-phase parity runs on
# two of the three problems: one binary, one K-ary with the other grid.
# tests/test_torch_em.py carries all three across.
PLAN_CASES = (2, 5)

_cache = {}


def _image(n_labels):
    spec = CASES[n_labels]
    if n_labels == 2:
        vol = jax_synthetic.make_synthetic_volume(seed=spec["seed"], n_slices=1, shape=spec["shape"])
    else:
        vol = jax_synthetic.make_kary_volume(
            seed=spec["seed"], n_slices=1, shape=spec["shape"], n_phases=n_labels
        )
    return np.asarray(vol.images[0])


def _problems(n_labels):
    """(image, JAX problem, port problem on the JAX label map)."""
    if n_labels not in _cache:
        img = _image(n_labels)
        jp = jax_pipeline.initialize(img, overseg_grid=CASES[n_labels]["grid"], n_labels=n_labels)
        tp = torch_pipeline.initialize(
            img, n_labels=n_labels, oversegmentation=jp.labels_px, device="cpu"
        )
        _cache[n_labels] = (img, jp, tp)
    return _cache[n_labels]


@pytest.mark.parametrize("n_labels", sorted(CASES))
def test_slic_matches_jax(n_labels):
    img = _image(n_labels)
    grid = CASES[n_labels]["grid"]
    want = np.asarray(jax_overseg.slic(jnp.asarray(img), grid=grid))
    got = oversegment.slic(img, grid=grid, device="cpu")
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_labels", sorted(CASES))
def test_slic_sums_go_through_reduce_by_key(n_labels, monkeypatch):
    """Each Lloyd iteration's centroid sums are one ``dpp.reduce_by_key``
    call (``segment_reduce``'s order-free ``add`` on the card) over the four
    value rows keyed ``j * k + label``, and the label map is still JAX's."""
    img = _image(n_labels)
    grid = CASES[n_labels]["grid"]
    k = grid[0] * grid[1]
    calls = []
    plain = dpp.reduce_by_key

    def counted(ids, values, num_segments, op="add", **kw):
        calls.append((num_segments, op, values.shape[0], values.dtype))
        return plain(ids, values, num_segments, op, **kw)

    monkeypatch.setattr(dpp, "reduce_by_key", counted)
    got = oversegment.slic(img, grid=grid, iters=5, device="cpu")
    assert calls == [(4 * k, "add", 4 * img.size, torch.float32)] * 5
    want = np.asarray(jax_overseg.slic(jnp.asarray(img), grid=grid, iters=5))
    np.testing.assert_array_equal(got.numpy(), want)


def test_slic_chunking_is_invisible(monkeypatch):
    """Taking the pixels in chunks changes no label."""
    img = _image(2)
    whole = oversegment.slic(img, grid=(6, 6), device="cpu")
    monkeypatch.setattr(oversegment, "CHUNK_ENTRIES", 36 * 100)  # 100 pixels a chunk
    np.testing.assert_array_equal(oversegment.slic(img, grid=(6, 6), device="cpu").numpy(), whole.numpy())


@pytest.mark.parametrize("n_labels", PLAN_CASES)
def test_graph_and_cliques_match_jax(n_labels):
    _, jp, tp = _problems(n_labels)
    jg, tg = jp.graph, tp.graph
    assert tg.n_regions == jg.n_regions and tg.max_degree == jg.max_degree
    for f in ("edges", "csr_offsets", "csr_neighbors", "adj"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), err_msg=f)
    np.testing.assert_array_equal(tg.region_size.numpy(), jg.region_size)
    np.testing.assert_allclose(tg.region_mean.numpy(), jg.region_mean, rtol=1e-6)
    np.testing.assert_array_equal(tp.cliques.members, jp.cliques.members)
    np.testing.assert_array_equal(tp.cliques.sizes, jp.cliques.sizes)


@pytest.mark.parametrize("n_labels", PLAN_CASES)
def test_verify_maximal_cliques_matches_jax(n_labels):
    """``verify_maximal_cliques`` on the port's cliques (maximal), on a set
    with one row cut short (a clique that is not maximal) and on one with
    a row that is no clique, against the reference's verdict on the same
    graph and sets."""
    from repro.core.pmrf import cliques as jax_cliques

    from repro_torch.core.pmrf import cliques as torch_cliques

    _, jp, tp = _problems(n_labels)
    members, sizes = tp.cliques.members, tp.cliques.sizes
    row = int(np.argmax(sizes))
    assert sizes[row] >= 3, "test premise: a clique of three or more"
    cut = members.copy(), sizes.copy()
    cut[0][row, sizes[row] - 1], cut[1][row] = -1, sizes[row] - 1
    strangers = np.flatnonzero(~tp.graph.adj[members[row, 0]])
    far = int(np.setdiff1d(strangers, members[row, :sizes[row]])[0])  # not adjacent to member 0
    broken = members.copy(), sizes.copy()
    broken[0][row, 1] = far
    for (m, s), want in (((members, sizes), True), (cut, False), (broken, False)):
        got = torch_cliques.verify_maximal_cliques(tp.graph, torch_cliques.CliqueSet(m, s))
        ref = jax_cliques.verify_maximal_cliques(jp.graph, jax_cliques.CliqueSet(m, s))
        assert got == ref == want


@pytest.mark.parametrize("n_labels", PLAN_CASES)
def test_hoods_match_jax(n_labels):
    _, jp, tp = _problems(n_labels)
    for f in HOOD_ARRAYS:
        want = np.asarray(getattr(jp.hoods, f))
        got = getattr(tp.hoods, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tp.hoods.n_hoods, tp.hoods.n_regions, tp.hoods.n_elements) == (
        jp.hoods.n_hoods, jp.hoods.n_regions, jp.hoods.n_elements,
    )
    # The layout the EM-tick kernel walks: hood h owns offsets[h]:offsets[h+1].
    off = tp.hoods.offsets.numpy()
    hid = tp.hoods.hood_id.numpy()
    for h in range(tp.hoods.n_hoods):
        assert np.all(hid[off[h]:off[h + 1]] == h)


@pytest.mark.parametrize("n_labels", PLAN_CASES)
def test_energy_model_and_quantile_init_match_jax(n_labels):
    _, jp, tp = _problems(n_labels)
    for f in jp.model._fields:
        np.testing.assert_allclose(
            getattr(tp.model, f).numpy(), np.asarray(getattr(jp.model, f)), rtol=1e-6, err_msg=f
        )
    jl, jm, js = jax_em.quantile_init(jp.graph.region_mean, jp.graph.n_regions, n_labels)
    tl, tm, ts = torch_em.quantile_init(tp.graph.region_mean, tp.graph.n_regions, n_labels)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_pad_hoods_matches_jax():
    _, jp, tp = _problems(2)
    h = jp.hoods
    kw = dict(capacity=h.capacity + 100, n_hoods=h.n_hoods + 7, n_regions=h.n_regions + 3)
    want = jax_hoods.pad_hoods(h, **kw)
    got = torch_hoods.pad_hoods(tp.hoods, **kw)
    for f in HOOD_ARRAYS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert got.capacity == want.capacity and got.n_hoods == want.n_hoods
    with pytest.raises(ValueError, match="smaller"):
        torch_hoods.pad_hoods(tp.hoods, capacity=1, n_hoods=h.n_hoods, n_regions=h.n_regions)


def test_random_init_is_seeded_and_in_range():
    gen = lambda: torch.Generator().manual_seed(7)
    a = torch_em.init_params(gen(), 50, 3)
    b = torch_em.init_params(gen(), 50, 3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    labels, mu, sigma = a
    assert labels.shape == (51,) and labels.dtype == torch.int32 and int(labels[-1]) == 0
    assert int(labels.min()) >= 0 and int(labels.max()) < 3
    assert torch.all(mu[1:] >= mu[:-1]) and float(mu.min()) >= 0.0 and float(mu.max()) <= 255.0
    assert float(sigma.min()) >= 10.0 and float(sigma.max()) <= 80.0


# --- data-parallel primitives -------------------------------------------


def test_expand_with_rank_matches_jax():
    counts = np.array([2, 0, 3, 1, 0, 4], np.int32)
    want_src, want_rank = jax_dpp.expand_with_rank(jnp.asarray(counts), 13)
    src, rank = dpp.expand_with_rank(torch.from_numpy(counts), 13)
    np.testing.assert_array_equal(src.numpy(), np.asarray(want_src))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want_rank))


def test_unique_and_offsets_match_jax():
    vals = np.array([1, 1, 2, 5, 5, 5, 9], np.int32)
    want_u, want_c = jax_dpp.unique_(jnp.asarray(vals), fill=-1)
    got_u, got_c = dpp.unique_(torch.from_numpy(vals), fill=-1)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    assert int(got_c) == int(want_c)
    counts = np.array([3, 0, 2, 4], np.int32)
    np.testing.assert_array_equal(
        dpp.counts_to_offsets(torch.from_numpy(counts)).numpy(),
        np.asarray(jax_dpp.counts_to_offsets(jnp.asarray(counts))),
    )


def test_sort_by_key_is_stable_and_compound_key_guarded():
    keys = torch.tensor([3, 1, 3, 1, 2])
    vals = torch.arange(5)
    sk, sv = dpp.sort_by_key(keys, vals)
    assert sk.tolist() == [1, 1, 2, 3, 3] and sv.tolist() == [1, 3, 4, 0, 2]
    major = torch.tensor([0, 2, 1], dtype=torch.int32)
    minor = torch.tensor([4, 0, 9], dtype=torch.int32)
    key = dpp.compound_key(major, minor, 10, major_span=3)
    assert key.dtype == torch.int64 and key.tolist() == [4, 20, 19]
    # A key space that the reference's int32 packing could not hold fits int64 ...
    assert int(dpp.compound_key(torch.tensor([70_000]), torch.tensor([5]), 70_001, major_span=70_001)) == 70_000 * 70_001 + 5
    # ... and one that int64 cannot hold raises instead of mis-sorting.
    with pytest.raises(OverflowError):
        dpp.compound_key(major, minor, 2**33, major_span=2**31)


def test_reduce_by_key_routes_floats_and_keeps_ints():
    ids = torch.tensor([0, 2, 2, 5, -1], dtype=torch.int32)
    f = dpp.reduce_by_key(ids, torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]), 3)
    i = dpp.reduce_by_key(ids, torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32), 3)
    assert f.tolist() == [1.0, 0.0, 5.0] and i.tolist() == [1, 0, 5]
    assert i.dtype == torch.int32
    m = dpp.reduce_by_key(ids, torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]), 3, op="min")
    assert m.tolist() == [1.0, float("inf"), 2.0]
