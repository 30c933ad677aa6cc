"""``segment_reduce``'s element-order ``add`` (``ordered=True``): its plain
version against a numpy sequential sum, the rule its CUDA kernel rests on,
and (marked ``cuda``, skipped without a card) the kernel against the plain
version on the CPU, bit for bit (NaN equal to NaN: the card gives its
canonical NaN, the CPU an operand's).

The kernel (``kernels/csrc/segment_reduce.cu``) adds each segment's
elements one at a time in index order, leaving out the elements whose
value is zero: a sum that starts at +0.0 is never -0.0, and x + 0 = x for
every other x, NaN and infinities included.  ``_skip_zeros_sum`` is that
rule in numpy; it must give the sequential sum's bits on every case.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_reduce as sr
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()


def _sequential(values, ids, n_seg):
    """numpy's unbuffered ``add.at`` in float32: element by element, in
    index order, ids outside ``[0, n_seg)`` dropped."""
    out = np.zeros(n_seg, np.float32)
    keep = (ids >= 0) & (ids < n_seg)
    np.add.at(out, ids[keep], values[keep])
    return out


def _skip_zeros_sum(values, ids, n_seg):
    out = np.zeros(n_seg, np.float32)
    with np.errstate(invalid="ignore"):  # inf + -inf is NaN, as on the card
        for v, i in zip(values, ids):
            if 0 <= i < n_seg and v != 0.0:
                out[i] = np.float32(out[i] + v)
    return out


def _cases():
    rng = np.random.default_rng(0)
    cases = []
    for n, segs, runs in ((1, 1, True), (50, 7, False), (300, 40, True), (2000, 9, False)):
        ids = np.sort(rng.integers(-1, segs + 1, n)) if runs else rng.integers(-2, segs + 2, n)
        vals = rng.normal(0.0, 10.0, n).astype(np.float32)
        vals[rng.random(n) < 0.2] = 0.0
        vals[rng.random(n) < 0.05] = -0.0
        cases.append((f"n={n} segs={segs} runs={runs}", vals, ids.astype(np.int32), segs))
    special = np.array([np.nan, 1.0, np.inf, -np.inf, -0.0, 0.0, 2.0, -0.0, 1e30, -1e30, 3.0],
                       np.float32)
    cases.append(("special", special, np.array([0, 0, 1, 1, 2, 2, 3, 4, 5, 5, 5], np.int32), 7))
    return cases


@pytest.mark.parametrize("case", range(len(_cases())))
def test_plain_ordered_add_is_the_sequential_sum(case):
    what, vals, ids, segs = _cases()[case]
    want = _sequential(vals, ids, segs)
    got = ops.segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids), segs, ordered=True).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=what)
    np.testing.assert_array_equal(
        ref.segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids), segs).numpy().view(np.uint32),
        want.view(np.uint32), err_msg=what)
    # The kernel's rule: leaving the zeros out changes no bit.
    np.testing.assert_array_equal(_skip_zeros_sum(vals, ids, segs).view(np.uint32),
                                  want.view(np.uint32), err_msg=what)


def test_ordered_is_an_add_option():
    v, ids = torch.ones(4), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="order-free"):
        ops.segment_reduce(v, ids, 2, "min", ordered=True)
    with pytest.raises(ValueError, match="order-free"):
        ref.segment_reduce(v, ids, 2, "min", ordered=True)
    ops.reset_launch_counts()
    ops.segment_reduce(v, ids, 2, ordered=True)
    assert ops.segment_reduce_launches() == {"add": 0, "ordered_add": 0, "min": 0}


@pytest.mark.cuda
def test_kernel_ordered_add_equals_plain_on_the_cpu():
    """On the card, every case (and 10**6 elements in runs over 10**5
    segments, the hood sums' layout) bit for bit the plain version on the
    CPU; the launches are counted as ordered adds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (a CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(1)
    big_ids = np.sort(rng.integers(-2, 100_002, 1_000_000)).astype(np.int32)
    big = ("big", rng.normal(0, 1, 1_000_000).astype(np.float32), big_ids, 100_000)
    ops.reset_launch_counts()
    cases = _cases() + [big]
    for what, vals, ids, segs in cases:
        v, i = torch.from_numpy(vals), torch.from_numpy(ids)
        got = ops.segment_reduce(v.cuda(), i.cuda(), segs, ordered=True).cpu()
        want = ops.segment_reduce(v, i, segs, ordered=True)
        # The card's arithmetic gives its canonical NaN, the CPU's keeps a payload.
        nan = got.isnan()
        assert torch.equal(nan, want.isnan()), what
        assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)), what
    assert sr.launches_ordered == len(cases) == sr.launches
