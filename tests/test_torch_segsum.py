"""The numpy model of the ``segment_reduce`` kernel's order-free sum and
NaN-true minimum (``repro_torch.testing.segsum``) against the JAX
package's ``jax.ops.segment_sum`` / ``segment_min``, on the CPU.

``chip_smoke.py`` holds the CUDA kernel to this model bit for bit on the
card; here the model is held to JAX.  Tolerances:

* float sums within ``1e-5 * sum(|v|) + 1e-6`` per segment, the tier
  ``chip_smoke.py`` holds the kernel to against its plain version: the
  model rounds each value to its segment's fixed-point grid and the sum
  once, JAX adds float32 values in element order;
* integer-valued sums, non-finite results and every minimum exact (NaN
  equal to NaN; a -0.0 against +0.0 tie gives -0.0, as JAX does);
* bit for bit under any permutation of the elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jax_ref

from repro_torch.testing import segsum

PAD_ID = 2**30


def _jax_sum(values, ids, num_segments):
    return np.asarray(jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(ids), num_segments))


def _jax_min(values, ids, num_segments):
    return np.asarray(jax.ops.segment_min(jnp.asarray(values), jnp.asarray(ids), num_segments))


def _assert_in_tier(got, values, ids, num_segments):
    want = _jax_sum(values, ids, num_segments)
    mag = _jax_sum(np.abs(values), ids, num_segments)
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= 1e-5 * mag + 1e-6), f"largest error {err.max()}"


def _ids(rng, n, num_segments):
    ids = rng.integers(-2, num_segments + num_segments // 10 + 2, n).astype(np.int32)
    ids[::13] = PAD_ID
    return ids


@pytest.mark.parametrize("n,num_segments", [(7, 1), (1000, 5), (24_784, 1555), (50_000, 100_000)])
def test_random_sums_within_tier(n, num_segments):
    rng = np.random.default_rng(n + num_segments)
    values = rng.normal(0.0, 10.0, n).astype(np.float32)
    ids = _ids(rng, n, num_segments)
    _assert_in_tier(segsum.segment_sum(values, ids, num_segments), values, ids, num_segments)


def test_wide_range_sums_within_tier():
    """Magnitudes from 2^-40 to 2^40 with random signs in one segment set."""
    rng = np.random.default_rng(1)
    n, segs = 20_000, 37
    values = (np.exp2(rng.uniform(-40, 40, n)) * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    ids = _ids(rng, n, segs)
    _assert_in_tier(segsum.segment_sum(values, ids, segs), values, ids, segs)


def test_cancelling_sums_within_tier():
    """Each large value meets its negation; what is left are small values."""
    rng = np.random.default_rng(2)
    big = rng.normal(0.0, 1e6, 5000).astype(np.float32)
    small = rng.normal(0.0, 1e-3, 5000).astype(np.float32)
    values = np.concatenate([big, -big, small])
    ids = rng.integers(0, 50, 5000).astype(np.int32)
    ids = np.concatenate([ids, ids, rng.integers(0, 50, 5000).astype(np.int32)])
    order = rng.permutation(values.shape[0])
    values, ids = values[order], ids[order]
    _assert_in_tier(segsum.segment_sum(values, ids, 50), values, ids, 50)


def test_integer_sums_exact():
    rng = np.random.default_rng(3)
    n, segs = 262_144, 1024
    values = rng.integers(0, 3, n).astype(np.float32)
    ids = rng.integers(0, segs, n).astype(np.int32)
    np.testing.assert_array_equal(segsum.segment_sum(values, ids, segs), _jax_sum(values, ids, segs))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sum_is_bitwise_invariant_under_permutation(seed):
    rng = np.random.default_rng(10 + seed)
    n, segs = 30_000, 211
    values = (rng.normal(0.0, 1.0, n) * np.exp2(rng.integers(-20, 20, n))).astype(np.float32)
    ids = _ids(rng, n, segs)
    first = segsum.segment_sum(values, ids, segs).view(np.uint32)
    for _ in range(3):
        order = rng.permutation(n)
        again = segsum.segment_sum(values[order], ids[order], segs).view(np.uint32)
        np.testing.assert_array_equal(again, first)


def test_nonfinite_rules_match_jax():
    """NaN wins in both ops; +inf with -inf sums to NaN, one infinity to
    itself; an empty segment gives 0 / +inf."""
    values = np.array([1, np.nan, 3, -np.inf, np.inf, 2, np.inf, 5, -np.inf, np.nan, -np.inf],
                      np.float32)
    ids = np.array([0, 0, 1, 2, 2, 3, 5, 5, 6, 6, 7], np.int32)
    for op, model, want_fn in (("add", segsum.segment_sum, _jax_sum),
                               ("min", segsum.segment_min, _jax_min)):
        got = model(values, ids, 9)
        want = want_fn(values, ids, 9)
        np.testing.assert_array_equal(got, want, err_msg=op)  # NaN equals NaN here
        np.testing.assert_array_equal(
            got, np.asarray(jax_ref.segment_reduce(jnp.asarray(values), jnp.asarray(ids), 9, op))
        )
    nan_bits = np.array(segsum.QNAN_BITS, np.uint32).view(np.float32)
    assert segsum.segment_sum(values, ids, 9).view(np.uint32)[0] == nan_bits.view(np.uint32)
    assert list(segsum.segment_sum(values, ids, 9)[[4, 5, 7, 8]]) == [0.0, np.inf, -np.inf, 0.0]


def test_min_signed_zero_and_random_match_jax():
    values = np.array([0.0, -0.0, -0.0, 0.0, 0.0, 0.0], np.float32)
    ids = np.array([0, 0, 1, 1, 2, 2], np.int32)
    got = segsum.segment_min(values, ids, 3)
    np.testing.assert_array_equal(np.signbit(got), [True, True, False])
    np.testing.assert_array_equal(np.signbit(got), np.signbit(_jax_min(values, ids, 3)))
    rng = np.random.default_rng(4)
    values = rng.normal(0.0, 1.0, 10_000).astype(np.float32)
    ids = _ids(rng, 10_000, 700)
    np.testing.assert_array_equal(segsum.segment_min(values, ids, 700), _jax_min(values, ids, 700))


def test_no_int64_overflow_at_two_to_the_31():
    """By the model's bound: at n = 2^31 - 1 each value's integer is at
    most 2^frac_bits(n) in magnitude, and n of them stay below 2^63."""
    n = 2**31 - 1
    f = segsum.frac_bits(n)
    assert f == 31 and n * 2**f <= 2**62
    # The largest value a segment of key 254 (FLT_MAX's exponent) can hold
    # rounds to at most 2^f, whatever its neighbours.
    top = np.array([np.finfo(np.float32).max, -np.finfo(np.float32).max, 1.0], np.float32)
    keys = np.full(3, 254, np.int32)
    q = segsum.quantize(top, keys, n)
    assert np.all(np.abs(q) <= 2**f)
    assert int(np.abs(q).max()) * n < 2**63
    for m in (1, 2, 3, 1000, 2**20, 2**31 - 1, 2**31):
        assert m * 2 ** segsum.frac_bits(m) <= 2**62


def test_map_step_hood_sums_model():
    """The kernel's hood sums are the order-free sum of min_e * valid keyed
    by hood: against the JAX reference's hood sums within the tier of
    ``tests/test_torch_map_step.py``, and bitwise under permutation."""
    rng = np.random.default_rng(5)
    n, n_hoods, n_vertices, k = 3000, 12, 40, 3
    valid = (rng.random(n) < 0.85).astype(np.float32)
    hood_id = np.sort(rng.integers(0, n_hoods + 2, n)).astype(np.int32)  # hoods of ~200
    vertex = rng.integers(0, n_vertices, n).astype(np.int32)
    y = (rng.normal(100, 30, n) * valid).astype(np.float32)
    w = (rng.random(n) * valid).astype(np.float32)
    nall = rng.integers(1, 12, n).astype(np.float32)
    cnt = np.minimum(rng.integers(0, 12, (k, n)), nall).astype(np.float32)
    xf = (rng.integers(0, k, n) * valid).astype(np.float32)
    mu = np.linspace(60, 140, k).astype(np.float32)
    sigma = np.linspace(8, 14, k).astype(np.float32)
    args = [jnp.asarray(a) for a in (y, w, cnt, nall, xf, valid, hood_id, vertex, mu, sigma)]
    min_e, _arg, hood_e, _votes = jax_ref.fused_map_step(
        *args, 0.75, n_hoods=n_hoods, n_vertices=n_vertices
    )
    part = (np.asarray(min_e) * valid).astype(np.float32)
    keys = np.where(valid > 0, hood_id, -1).astype(np.int32)
    model = segsum.segment_sum(part, keys, n_hoods)
    np.testing.assert_allclose(model, np.asarray(hood_e), rtol=1e-5, atol=1e-4)
    order = rng.permutation(n)
    np.testing.assert_array_equal(
        segsum.segment_sum(part[order], keys[order], n_hoods).view(np.uint32), model.view(np.uint32)
    )
