"""The port's MAP-step and binary-energy kernels' plain versions
(``repro_torch.kernels.ops.fused_map_step`` / ``mrf_min_energy`` on CPU
tensors) against the JAX package's references
(``repro.kernels.ref.fused_map_step`` / ``mrf_min_energy``).

The CUDA kernels themselves are held to these plain versions on the card
by ``chip_smoke.py``.  Inputs are made with numpy from a seed and handed
to both sides; they include padding lanes (``valid == 0``), hood and
vertex ids past the segment counts, and exact ties between labels.
Tolerances: ``min_e``, ``arg`` and ``votes`` exact (votes are integers);
``hood_e`` within rtol 1e-5 / atol 1e-4 (both sum in element order on the
CPU, so in practice they agree bit for bit; the kernel's order-free hood
sum, modelled by ``repro_torch.testing.segsum``, rounds once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref

from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels.map_step import fused_map_step_cuda
from repro_torch.kernels.mrf_energy import mrf_min_energy_cuda
from repro_torch.testing import segsum
from repro_torch.testing.tick_problems import long_hood_map_step_problem
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

N_HOODS, N_VERTICES = 57, 81


def _map_step_problem(seed, n_labels, n=2000):
    """Operands of one MAP step: about 15 % padding lanes, ids up to 3
    past the segment counts, and two labels with identical parameters so
    that their energies tie exactly."""
    rng = np.random.default_rng(seed)
    valid = (rng.random(n) < 0.85).astype(np.float32)
    hood_id = rng.integers(0, N_HOODS + 3, n).astype(np.int32)
    vertex = rng.integers(0, N_VERTICES + 3, n).astype(np.int32)
    y = (rng.normal(100, 30, n) * valid).astype(np.float32)
    w = (rng.random(n) * valid).astype(np.float32)
    nall = rng.integers(1, 12, n).astype(np.float32)
    cnt = np.minimum(rng.integers(0, 12, (n_labels, n)), nall).astype(np.float32)
    cnt[-1] = cnt[0]  # with equal parameters below, the last label ties
    xf = (rng.integers(0, n_labels - 1, n) * valid).astype(np.float32)
    mu = np.linspace(60, 140, n_labels).astype(np.float32)
    sigma = np.linspace(8, 14, n_labels).astype(np.float32)
    mu[-1], sigma[-1] = mu[0], sigma[0]
    return (y, w, cnt, nall, xf, valid, hood_id, vertex, mu, sigma)


def _both(fn_jax, fn_torch, arrays, *args, **kw):
    want = fn_jax(*[jnp.asarray(a) for a in arrays], *args, **kw)
    got = fn_torch(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays], *args, **kw)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("n_labels", [2, 3, 5])
def test_fused_map_step_matches_jax(n_labels):
    arrays = _map_step_problem(n_labels, n_labels)
    kw = dict(n_hoods=N_HOODS, n_vertices=N_VERTICES)
    (min_w, arg_w, hood_w, votes_w), (min_g, arg_g, hood_g, votes_g) = _both(
        jax_ref.fused_map_step, ops.fused_map_step, arrays, 0.75, **kw
    )
    assert arg_g.dtype == np.int32 and votes_g.shape == (n_labels, N_VERTICES)
    np.testing.assert_array_equal(min_g, min_w)
    np.testing.assert_array_equal(arg_g, arg_w)
    np.testing.assert_array_equal(votes_g, votes_w)
    np.testing.assert_allclose(hood_g, hood_w, rtol=1e-5, atol=1e-4)
    # Where the last label's energy ties label 0's, the last label never wins.
    energies = torch_ref.label_energies_blocked(
        *[torch.from_numpy(arrays[i]) for i in (0, 1, 2, 3, 4, 5, 8, 9)], 0.75
    ).numpy()
    tie = energies[0] == energies[-1]
    assert tie.sum() > 100 and not np.any(arg_g[tie] == n_labels - 1)
    # Padding lanes and out-of-range ids vote nowhere.
    valid, vertex = arrays[5], arrays[7]
    assert votes_g.sum() == np.sum((valid > 0) & (vertex < N_VERTICES))


@pytest.mark.parametrize("n_labels", [2, 9])
def test_plain_map_step_takes_a_given_log_sigma(n_labels):
    """``log_sigma`` stands for ``torch.log(sigma)`` in the plain MAP step
    and tick (how a step on the host takes the card's bits): given the
    host's own log it changes no bit; given a log one ulp off it moves the
    energies."""
    t = [torch.from_numpy(a) for a in _map_step_problem(n_labels, n_labels)]
    y, w, cnt, nall, xf, valid, hood_id, vertex, mu, sigma = t
    kw = dict(n_hoods=N_HOODS, n_vertices=N_VERTICES)
    base = torch_ref.fused_map_step(*t, 0.75, **kw)
    same = torch_ref.fused_map_step(*t, 0.75, log_sigma=torch.log(sigma), **kw)
    for a, b in zip(base, same):
        assert torch.equal(a, b)
    off = torch.nextafter(torch.log(sigma), torch.full_like(sigma, np.inf))
    moved = torch_ref.fused_map_step(*t, 0.75, log_sigma=off, **kw)
    assert not torch.equal(moved[0], base[0])
    tick = (y, w, nall, xf, valid, hood_id, vertex, torch.ones(N_VERTICES),
            torch.ones(N_VERTICES), torch.zeros(4, N_HOODS), mu, sigma, 0.75)
    got = torch_ref.fused_em_tick(*tick, log_sigma=torch.log(sigma), **kw)
    for a, b in zip(torch_ref.fused_em_tick(*tick, **kw), got):
        assert torch.equal(a, b)


def test_fused_map_step_element_blocks_sum_to_the_whole():
    """Keyed sums over element blocks add up to the whole: votes exactly,
    hood sums to rounding (the sharded route's all-reduce relies on it)."""
    arrays = _map_step_problem(11, 3, n=2001)
    kw = dict(n_hoods=N_HOODS, n_vertices=N_VERTICES)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    whole = ops.fused_map_step(*t, 0.75, **kw)
    votes = torch.zeros_like(whole[3])
    hood_e = torch.zeros_like(whole[2])
    for part in torch.arange(2001).tensor_split(4):
        sub = [x[:, part].contiguous() if x.dim() == 2 else x[part] for x in t[:8]]
        _, _, h, v = ops.fused_map_step(*sub, *t[8:], 0.75, **kw)
        votes += v
        hood_e += h
    assert torch.equal(votes, whole[3])
    torch.testing.assert_close(hood_e, whole[2], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_labels", [2, 3])
def test_fused_map_step_long_hoods_matches_jax(n_labels):
    """Hoods of 100 and 300 elements, each spanning several warps of the
    kernel (``long_hood_map_step_problem``, the operands ``chip_smoke.py``
    holds the kernel's order-fixed hood sums on): the plain version
    against the JAX reference, and the kernel's order-free hood sum (the
    numpy model) within the same tier."""
    arrays, kw = long_hood_map_step_problem(n_labels, n_labels)
    assert np.bincount(arrays[6])[:2].tolist() == [100, 300]
    (min_w, arg_w, hood_w, votes_w), (min_g, arg_g, hood_g, votes_g) = _both(
        jax_ref.fused_map_step, ops.fused_map_step, arrays, 0.75, **kw
    )
    np.testing.assert_array_equal(min_g, min_w)
    np.testing.assert_array_equal(arg_g, arg_w)
    np.testing.assert_array_equal(votes_g, votes_w)
    np.testing.assert_allclose(hood_g, hood_w, rtol=1e-5, atol=1e-4)
    valid, hood_id = arrays[5], arrays[6]
    model = segsum.segment_sum(min_g * valid, np.where(valid > 0, hood_id, -1), kw["n_hoods"])
    np.testing.assert_allclose(model, hood_w, rtol=1e-5, atol=1e-4)


def _binary_problem(seed, n=3000):
    """K=2 operands; every third element is an exact tie (equal label
    parameters and a neighbourhood split so that both smoothness terms
    agree)."""
    rng = np.random.default_rng(seed)
    y = rng.normal(100, 30, n).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    xf = rng.integers(0, 2, n).astype(np.float32)
    n1 = rng.integers(0, 9, n).astype(np.float32)
    nall = (n1 + rng.integers(0, 9, n)).astype(np.float32)
    tie = np.arange(n) % 3 == 0
    # n1 - xf == (nall - n1) - (1 - xf)  <=>  nall == 2 n1 + 1 - 2 xf
    nall[tie] = np.maximum(2 * n1[tie] + 1 - 2 * xf[tie], 1)
    n1[tie] = (nall[tie] - 1 + 2 * xf[tie]) / 2
    return (y, w, n1, nall, xf), tie


@pytest.mark.parametrize("seed", [0, 1])
def test_mrf_min_energy_matches_jax(seed):
    arrays, _ = _binary_problem(seed)
    params = (np.array([80, 120], np.float32), np.array([10, 12], np.float32))
    (min_w, arg_w), (min_g, arg_g) = _both(
        jax_ref.mrf_min_energy, ops.mrf_min_energy, arrays + params, 0.75
    )
    assert arg_g.dtype == np.int32
    np.testing.assert_array_equal(min_g, min_w)
    np.testing.assert_array_equal(arg_g, arg_w)
    assert 0 < arg_g.mean() < 1


def test_mrf_min_energy_exact_ties_go_to_label_0():
    arrays, tie = _binary_problem(2)
    params = (np.array([100, 100], np.float32), np.array([10, 10], np.float32))
    (min_w, arg_w), (min_g, arg_g) = _both(
        jax_ref.mrf_min_energy, ops.mrf_min_energy, arrays + params, 0.75
    )
    np.testing.assert_array_equal(min_g, min_w)
    np.testing.assert_array_equal(arg_g, arg_w)
    assert tie.sum() > 900 and not np.any(arg_g[tie])


def test_mrf_min_energy_is_the_binary_map_step():
    """At K=2 with every lane valid and cnt_e = (nall - n1, n1), the
    elementwise kernel computes the MAP step's energies bit for bit."""
    (y, w, n1, nall, xf), _ = _binary_problem(3)
    mu, sigma = np.array([80, 120], np.float32), np.array([10, 12], np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    n = y.shape[0]
    min_b, arg_b = ops.mrf_min_energy(t(y), t(w), t(n1), t(nall), t(xf), t(mu), t(sigma), 0.75)
    min_m, arg_m, _, _ = ops.fused_map_step(
        t(y), t(w), t(np.stack([nall - n1, n1])), t(nall), t(xf), t(np.ones(n, np.float32)),
        t(np.zeros(n, np.int32)), t(np.zeros(n, np.int32)), t(mu), t(sigma), 0.75,
        n_hoods=1, n_vertices=1,
    )
    assert torch.equal(min_b, min_m) and torch.equal(arg_b, arg_m)


@pytest.mark.parametrize("case", ["n=1", "n=3", "n=4097", "offset 1"])
@pytest.mark.parametrize("beta_form", ["float", "0-d tensor"])
def test_mrf_min_energy_ragged_shapes_match_jax(case, beta_form):
    """The shapes at which the CUDA kernel takes its scalar head and tail
    (n % 4, an input at storage offset 1), with ``beta`` a Python float and
    a 0-d tensor: the plain version equals the JAX reference bit for bit."""
    arrays, _ = _binary_problem(4, n=4098)
    params = (np.array([80, 120], np.float32), np.array([10, 12], np.float32))
    cut = {"n=1": slice(0, 1), "n=3": slice(0, 3), "n=4097": slice(0, 4097), "offset 1": slice(1, None)}[case]
    elems = [torch.from_numpy(a)[cut] for a in arrays]
    if case == "offset 1":
        assert all(t.storage_offset() == 1 and t.is_contiguous() for t in elems)
    beta = 0.75 if beta_form == "float" else torch.tensor(0.75)
    min_g, arg_g = ops.mrf_min_energy(*elems, *map(torch.from_numpy, params), beta)
    min_w, arg_w = jax_ref.mrf_min_energy(*[jnp.asarray(t.numpy()) for t in elems],
                                          *map(jnp.asarray, params), 0.75)
    assert min_g.shape == (elems[0].shape[0],) and arg_g.dtype == torch.int32
    np.testing.assert_array_equal(min_g.numpy().view(np.uint32), np.asarray(min_w).view(np.uint32))
    np.testing.assert_array_equal(arg_g.numpy(), np.asarray(arg_w))


def test_new_wrappers_refuse_cpu_tensors_and_cpu_calls_launch_nothing():
    """The CUDA wrappers raise on a CPU tensor before anything is built;
    the CPU route through ``ops`` counts no launch."""
    arrays = [torch.from_numpy(a) for a in _map_step_problem(0, 2, n=300)]
    with pytest.raises(ValueError, match="CUDA"):
        fused_map_step_cuda(*arrays, 0.75, n_hoods=N_HOODS, n_vertices=N_VERTICES)
    (y, w, n1, nall, xf), _ = _binary_problem(0, n=30)
    bin_args = [torch.from_numpy(a) for a in (y, w, n1, nall, xf)]
    params = [torch.tensor([80.0, 120.0]), torch.tensor([10.0, 12.0])]
    with pytest.raises(ValueError, match="CUDA"):
        mrf_min_energy_cuda(*bin_args, *params, 0.75)
    with pytest.raises(ValueError, match="CUDA"):
        mrf_min_energy_cuda(*[t[1:] for t in bin_args], *params, torch.tensor(0.75))
    assert _build._libs == {}
    ops.reset_launch_counts()
    ops.fused_map_step(*arrays, 0.75, n_hoods=N_HOODS, n_vertices=N_VERTICES)
    ops.mrf_min_energy(*bin_args, *params, 0.75)
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="backend"):
        ops.mrf_min_energy(*bin_args, *params, 0.75, backend="xla")
