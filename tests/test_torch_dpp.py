"""The port's DPP layer (``repro_torch.core.dpp``) against the JAX
package's (``repro.core.dpp``) on the same numpy inputs.

The cases mirror ``tests/test_dpp.py`` and the primitive properties of
``tests/test_dpp_properties.py``, with the ``tests/_hyp.py`` shim (a
property test skips where hypothesis is missing; each has a pinned
companion).  Tolerances: integer outputs, indices, counts, sorts, minima
and maxima exact; float sums and scans within rtol 1e-5 (atol 1e-5): both
add in element order on the CPU, but XLA may vectorise a scan.  Random
floats have no subnormals, which XLA flushes to zero on the CPU.  The
profiler is held to the per-primitive counts of a faithful MAP iteration.
"""

import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # optional-hypothesis shim

import jax.numpy as jnp

from repro.core import dpp as jdpp

from repro_torch.core import dpp
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

# No subnormals: XLA on the CPU flushes them to zero, PyTorch keeps them.
_values = st.lists(st.floats(-100, 100, allow_nan=False, allow_subnormal=False, width=32),
                   min_size=1, max_size=48)
_ints = st.lists(st.integers(-50, 50), min_size=1, max_size=64)
_counts = st.lists(st.integers(0, 5), min_size=1, max_size=32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Scan, SortByKey, Unique
# ---------------------------------------------------------------------------


def _check_scan(vals, exclusive, dtype):
    x = np.asarray(vals).astype(dtype)
    got = _np(dpp.scan_(_t(x), exclusive=exclusive))
    want = np.asarray(jdpp.scan_(jnp.asarray(x), exclusive=exclusive))
    if dtype == np.int32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@settings(max_examples=25, deadline=None)
@given(_values, st.booleans(), st.sampled_from([np.float32, np.int32]))
def test_scan_matches_jax(vals, exclusive, dtype):
    _check_scan(vals, exclusive, dtype)


@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_matches_jax_pinned(exclusive):
    _check_scan([3.5, -1.0, 2.25, 0.0, 7.0], exclusive, np.float32)
    _check_scan([3, -1, 2, 0, 7], exclusive, np.int32)


def _check_sort(keys):
    k = np.asarray(keys, np.int32)
    v = np.arange(k.size, dtype=np.int32)
    f = (k * 0.5).astype(np.float32)
    got = dpp.sort_by_key(_t(k), _t(v), _t(f))
    want = jdpp.sort_by_key(jnp.asarray(k), jnp.asarray(v), jnp.asarray(f))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_array_equal(_np(got[1]), np.argsort(k, kind="stable"))


@settings(max_examples=25, deadline=None)
@given(_ints)
def test_sort_by_key_matches_jax_and_is_stable(keys):
    _check_sort(keys)


def test_sort_by_key_pinned():
    _check_sort([4, -2, 4, 0, -2, 9, 0])


def _check_unique(keys):
    srt = np.sort(np.asarray(keys, np.int32))
    out, count = dpp.unique_(_t(srt), fill=-7)
    jout, jcount = jdpp.unique_(jnp.asarray(srt), fill=-7)
    assert int(count) == int(jcount) == np.unique(srt).size
    np.testing.assert_array_equal(_np(out), np.asarray(jout))


@settings(max_examples=25, deadline=None)
@given(_ints)
def test_unique_matches_jax(keys):
    _check_unique(keys)


def test_unique_pinned():
    _check_unique([5, 1, 1, 3, 5, 5, -2])


# ---------------------------------------------------------------------------
# ReduceByKey, Reduce
# ---------------------------------------------------------------------------


def _check_reduce_by_key(vals, n_seg, seed, op):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n_seg + 1, len(vals)).astype(np.int32)  # out-of-range ids dropped
    v = np.asarray(vals, np.float32)
    got = _np(dpp.reduce_by_key(_t(ids), _t(v), n_seg, op=op))
    want = np.asarray(jdpp.reduce_by_key(jnp.asarray(ids), jnp.asarray(v), n_seg, op=op))
    if op == "min":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        ordered = _np(dpp.reduce_by_key(_t(ids), _t(v), n_seg, op="add", ordered=True))
        np.testing.assert_array_equal(ordered.view(np.uint32), got.view(np.uint32))
    ints = np.round(v).astype(np.int32)
    if op == "add":
        np.testing.assert_array_equal(
            _np(dpp.reduce_by_key(_t(ids), _t(ints), n_seg)),
            np.asarray(jdpp.reduce_by_key(jnp.asarray(ids), jnp.asarray(ints), n_seg)),
        )


@settings(max_examples=25, deadline=None)
@given(_values, st.integers(1, 12), st.integers(0, 2**31 - 1), st.sampled_from(["add", "min"]))
def test_reduce_by_key_matches_jax(vals, n_seg, seed, op):
    _check_reduce_by_key(vals, n_seg, seed, op)


@pytest.mark.parametrize("op", ["add", "min"])
def test_reduce_by_key_pinned(op):
    _check_reduce_by_key([1.5, -2.0, 0.25, 8.0, -3.5, 4.0, 2.0], 4, 3, op)


def test_reduce_by_key_refusals():
    ids, v = torch.zeros(3, dtype=torch.int32), torch.ones(3)
    with pytest.raises(ValueError, match="unknown"):
        dpp.reduce_by_key(ids, v, 2, op="max")
    with pytest.raises(ValueError, match="order-free"):
        dpp.reduce_by_key(ids, v, 2, op="min", ordered=True)
    with pytest.raises(ValueError, match="'add' only"):
        dpp.reduce_by_key(ids, ids, 2, op="min")


@pytest.mark.parametrize("op,initial", [("add", None), ("min", None), ("max", None),
                                        ("min", -500.0), ("max", 500.0)])
def test_reduce_matches_jax(op, initial):
    x = np.random.default_rng(2).normal(0, 10, 33).astype(np.float32)
    got = float(dpp.reduce_(_t(x), op, initial))
    want = float(jdpp.reduce_(jnp.asarray(x), op, initial))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown reduce op"):
        dpp.reduce_(_t(x), "mean")


# ---------------------------------------------------------------------------
# Scatter, Gather, Map
# ---------------------------------------------------------------------------


def _check_scatter(vals, seed, mode):
    rng = np.random.default_rng(seed)
    n_out = 6
    v = np.asarray(vals, np.float32)
    idx = rng.integers(-2, n_out + 2, v.size).astype(np.int32)
    mask = rng.random(v.size) < 0.7
    fill = {"set": -1.0, "add": 0.0, "min": np.inf, "max": -np.inf}[mode]
    if mode == "set":
        # A set that writes one index twice has no defined winner: keep the
        # first lane of each index.
        first = np.zeros(v.size, bool)
        first[np.unique(idx, return_index=True)[1]] = True
        mask &= first
    got = _np(dpp.scatter_(_t(v), _t(idx), n_out, mode=mode, fill=fill, mask=_t(mask)))
    want = np.asarray(jdpp.scatter_(jnp.asarray(v), jnp.asarray(idx), n_out, mode=mode,
                                    fill=fill, mask=jnp.asarray(mask)))
    if mode == "add":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@settings(max_examples=25, deadline=None)
@given(_values, st.integers(0, 2**31 - 1), st.sampled_from(["set", "add", "min", "max"]))
def test_scatter_matches_jax(vals, seed, mode):
    _check_scatter(vals, seed, mode)


@pytest.mark.parametrize("mode", ["set", "add", "min", "max"])
def test_scatter_modes_pinned(mode):
    # tests/test_dpp.py::test_scatter_modes and ::test_scatter_mask_drops
    v = torch.tensor([5.0, 3.0, 7.0, 1.0])
    idx = torch.tensor([0, 1, 0, 1])
    want = {"add": [12.0, 4.0], "min": [5.0, 1.0], "max": [7.0, 3.0]}
    if mode in want:
        fill = {"add": 0.0, "min": np.inf, "max": -np.inf}[mode]
        np.testing.assert_allclose(_np(dpp.scatter_(v, idx, 2, mode=mode, fill=fill)), want[mode])
    else:
        out = dpp.scatter_(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0, 1, 2]), 3, mode="set",
                           fill=-1.0, mask=torch.tensor([True, False, True]))
        np.testing.assert_allclose(_np(out), [1.0, -1.0, 3.0])
    _check_scatter([1.0, 2.0, -3.0, 4.5, 0.5, 9.0, -1.0], 11, mode)
    with pytest.raises(ValueError, match="unknown scatter mode"):
        dpp.scatter_(v, idx, 2, mode="mul")


def test_gather_and_map_match_jax():
    v = np.arange(10, dtype=np.float32) * 1.5
    idx = np.array([3, 0, 9, 3, 7], np.int32)
    np.testing.assert_array_equal(_np(dpp.gather_(_t(v), _t(idx))),
                                  np.asarray(jdpp.gather_(jnp.asarray(v), jnp.asarray(idx))))
    x, y = np.array([1.0, 2.0], np.float32), np.array([3.0, 4.0], np.float32)
    np.testing.assert_allclose(_np(dpp.map_(lambda a, b: a * b, _t(x), _t(y))), [3.0, 8.0])


# ---------------------------------------------------------------------------
# Composite idioms
# ---------------------------------------------------------------------------


def _check_expand(counts, pad):
    c = np.asarray(counts, np.int32)
    total = int(c.sum()) + pad
    src = _np(dpp.expand(_t(c), total))
    np.testing.assert_array_equal(src, np.asarray(jdpp.expand(jnp.asarray(c), total)))
    s2, rank = dpp.expand_with_rank(_t(c), total)
    js, jr = jdpp.expand_with_rank(jnp.asarray(c), total)
    np.testing.assert_array_equal(_np(s2), np.asarray(js))
    np.testing.assert_array_equal(_np(rank), np.asarray(jr))
    assert (src[int(c.sum()):] == c.size).all()


@settings(max_examples=25, deadline=None)
@given(_counts, st.integers(0, 8))
def test_expand_matches_jax(counts, pad):
    _check_expand(counts, pad)


def test_expand_pinned():
    _check_expand([2, 0, 3, 1], 3)
    with pytest.raises(ValueError, match="exceeds"):
        dpp.expand(torch.tensor([3, 3]), 4)


def _check_select(flags):
    f = np.asarray(flags, bool)
    v = np.arange(f.size, dtype=np.int32) * 3
    packed, count = dpp.select_flagged(_t(v), _t(f), fill=-1)
    jp, jc = jdpp.select_flagged(jnp.asarray(v), jnp.asarray(f), fill=-1)
    assert int(count) == int(jc) == int(f.sum())
    np.testing.assert_array_equal(_np(packed), np.asarray(jp))


@settings(max_examples=25, deadline=None)
@given(st.lists(st.booleans(), min_size=1, max_size=64))
def test_select_flagged_matches_jax(flags):
    _check_select(flags)


def test_select_flagged_pinned():
    _check_select([True, False, False, True, True, False])


def test_segments_offsets_and_compound_key_match_jax():
    keys = np.array([2, 2, 5, 5, 5, 9], np.int32)
    np.testing.assert_array_equal(_np(dpp.segments_from_sorted(_t(keys))), [0, 0, 1, 1, 1, 2])
    np.testing.assert_array_equal(_np(dpp.segments_from_sorted(_t(keys))),
                                  np.asarray(jdpp.segments_from_sorted(jnp.asarray(keys))))
    counts = np.array([2, 0, 3], np.int32)
    np.testing.assert_array_equal(_np(dpp.counts_to_offsets(_t(counts))),
                                  np.asarray(jdpp.counts_to_offsets(jnp.asarray(counts))))
    major, minor = np.array([1, 0, 1, 0], np.int32), np.array([0, 5, 3, 2], np.int32)
    key = dpp.compound_key(_t(major), _t(minor), 10)
    np.testing.assert_array_equal(_np(key), np.asarray(jdpp.compound_key(jnp.asarray(major),
                                                                           jnp.asarray(minor), 10)))
    np.testing.assert_array_equal(_np(dpp.sort_by_key(key, torch.arange(4))[1]), [3, 1, 0, 2])
    with pytest.raises(OverflowError):
        dpp.compound_key(_t(major), _t(minor), 2**40, major_span=2**30)


# ---------------------------------------------------------------------------
# Profiling (the paper's per-DPP breakdown)
# ---------------------------------------------------------------------------


def test_profiler_records_counts():
    """tests/test_dpp.py::test_profiler_records_counts, and nothing is
    recorded outside ``profiled()``."""
    x = torch.arange(8, dtype=torch.float32)
    with dpp.profiled() as prof:
        dpp.scan_(x)
        dpp.reduce_(x)
        dpp.reduce_(x, op="min")
        dpp.map_(torch.neg, x)
    assert prof.counts() == {"Scan": 1, "Reduce": 2, "Map": 1}
    assert all(t >= 0 for t in prof.totals().values())
    dpp.scan_(x)
    assert prof.counts()["Scan"] == 1


def test_profiled_faithful_map_step_breakdown():
    """A profiled faithful MAP iteration records the paper's primitives:
    counts, sizes, the per-element minimum and the hood sums are four
    ReduceByKeys, the minimum's SortByKey one, the votes one Scatter."""
    from repro_torch.core import synthetic
    from repro_torch.core.pmrf import em as em_mod
    from repro_torch.core.pmrf import pipeline

    vol = synthetic.make_synthetic_volume(seed=0, n_slices=1, shape=(32, 32), device="cpu")
    prob = pipeline.initialize(vol.images[0], overseg_grid=(4, 4), n_labels=2, device="cpu")
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    with dpp.profiled() as prof:
        em_mod.map_step(prob.hoods, prob.model, "faithful", labels0, mu0, sigma0)
    assert prof.counts() == {"ReduceByKey": 4, "SortByKey": 1, "Scatter": 1}
