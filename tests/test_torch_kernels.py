"""The port's kernel layer (``repro_torch.kernels``) against the JAX
package's plain references (``repro.kernels.ref``) on the CPU.

On the CPU the dispatch takes each kernel's plain PyTorch version; the
CUDA kernels themselves are held to those versions on the card by
``chip_smoke.py``.  Inputs are made with numpy from a seed and handed to
both sides.  Tolerances:

* ``segment_reduce``: integer-valued ``add`` and every ``min`` exact;
  random-float ``add`` within rtol 1e-6 (both sum in element order on
  the CPU, so in practice they agree bit for bit); NaN and infinities
  exact, NaN equal to NaN.
* ``fused_em_tick`` at f32: labels, votes and the convergence flag exact;
  hood energies and M-step sums within rtol 1e-5.  At bf16 the drift tier
  of ``tests/test_golden.py``: at least 95 % label agreement, sums and
  energies within 2 %.
* ``label_energies_blocked`` at f32: bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import em_tick as jax_em_tick
from repro.kernels import ref as jax_ref

import repro_torch
from repro_torch.kernels import _build, em_tick, ops
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels.em_tick import fused_em_tick_cuda
from repro_torch.kernels.segment_reduce import segment_reduce_cuda
from repro_torch.testing.tick_problems import (
    FIELDS,
    random_tick_problem,
    sorted_tick_problem,
)
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

SEGMENT_SIZES = [1, 7, 1024, 2500]
SEGMENT_COUNTS = [1, 5, 513, 5000]
PAD_ID = 2**30


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _segment_inputs(n, num_segments, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, num_segments, n).astype(np.int32)
    ids[::5] = PAD_ID  # padding lanes: ignored by both
    ints = rng.integers(0, 4, n).astype(np.float32)
    floats = rng.normal(0.0, 10.0, n).astype(np.float32)
    return ids, ints, floats


@pytest.mark.parametrize("num_segments", SEGMENT_COUNTS)
@pytest.mark.parametrize("n", SEGMENT_SIZES)
def test_segment_reduce_matches_jax(n, num_segments):
    ids, ints, floats = _segment_inputs(n, num_segments, seed=n * 7919 + num_segments)
    tid = torch.from_numpy(ids)
    for op in ("add", "min"):
        for kind, vals in (("int", ints), ("float", floats)):
            want = np.asarray(
                jax_ref.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), num_segments, op)
            )
            got = ops.segment_reduce(torch.from_numpy(vals), tid, num_segments, op).numpy()
            assert got.shape == (num_segments,)
            if op == "add" and kind == "float":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{op} {kind}")


def test_segment_reduce_empty_segments_and_padding():
    ids = np.array([0, 0, 3, PAD_ID, 7, PAD_ID], np.int32)
    vals = np.array([1.0, 2.0, -1.5, 99.0, 4.0, -99.0], np.float32)
    tid, tv = torch.from_numpy(ids), torch.from_numpy(vals)
    add = ops.segment_reduce(tv, tid, 6, "add").numpy()
    mn = ops.segment_reduce(tv, tid, 6, "min").numpy()
    np.testing.assert_array_equal(add, [3.0, 0.0, 0.0, -1.5, 0.0, 0.0])
    np.testing.assert_array_equal(mn, [1.0, np.inf, np.inf, -1.5, np.inf, np.inf])
    for op, got in (("add", add), ("min", mn)):
        want = jax_ref.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), 6, op)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_segment_reduce_nonfinite_matches_jax():
    """NaN wins in ``add`` and ``min``; +inf with -inf sums to NaN, one
    infinity to itself; an empty segment gives 0 / +inf (NaN equal to NaN)."""
    vals = np.array([1, np.nan, 3, -np.inf, np.inf, 2, np.inf, 5, -np.inf, np.nan, -7, -np.inf],
                    np.float32)
    ids = np.array([0, 0, 1, 2, 2, 3, 5, 5, 6, 6, PAD_ID, 7], np.int32)
    for op in ("add", "min"):
        got = ops.segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids), 9, op).numpy()
        want = np.asarray(jax_ref.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), 9, op))
        np.testing.assert_array_equal(got, want, err_msg=op)
    add = ops.segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids), 9, "add").numpy()
    mn = ops.segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids), 9, "min").numpy()
    np.testing.assert_array_equal(add, [np.nan, 3, np.nan, 2, 0, np.inf, np.nan, -np.inf, 0])
    np.testing.assert_array_equal(mn, [np.nan, 3, -np.inf, 2, np.inf, 5, np.nan, -np.inf, np.inf])


def _compare_tick(want, got, precision):
    labels_w, hood_w, votes_w, conv_w, *sums_w = [np.asarray(x) for x in want]
    labels_g, hood_g, votes_g, conv_g, *sums_g = [x.numpy() for x in got]
    if precision == "f32":
        np.testing.assert_array_equal(labels_g, labels_w)
        np.testing.assert_array_equal(votes_g, votes_w)
        assert bool(conv_g) == bool(conv_w)
        np.testing.assert_allclose(hood_g, hood_w, rtol=1e-5, atol=1e-5)
        for g, w in zip(sums_g, sums_w):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        assert float(np.mean(labels_g == labels_w)) >= 0.95
        np.testing.assert_allclose(hood_g, hood_w, rtol=0.02, atol=1e-3)
        for g, w in zip(sums_g, sums_w):
            np.testing.assert_allclose(g, w, rtol=0.02, atol=1e-3)


TICK_KW = dict(n_hoods=37, n_vertices=61, conv_tol=1e-4)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n_labels", [2, 3, 5, 9, 16])
def test_fused_em_tick_matches_jax(n_labels, precision):
    arrays = random_tick_problem(n_labels, n_labels, 37, 61, 900)
    want = jax_ref.fused_em_tick(*_jax(arrays), 0.75, precision=precision, **TICK_KW)
    got = ops.fused_em_tick(*_torch(arrays), 0.75, precision=precision, **TICK_KW)
    _compare_tick(want, got, precision)


@pytest.mark.parametrize("n_labels", [2, 3, 5, 9, 16])
def test_fused_em_tick_sorted_layout(n_labels):
    """The (hood, vertex)-sorted layout the CUDA kernel takes: offsets
    delimit each hood's run, and the results match the reference on the
    same (permuted) operands."""
    arrays, offsets = sorted_tick_problem(n_labels + 10, n_labels, 37, 61, 900)
    hood_id = arrays[FIELDS.index("hood_id")]
    assert offsets[0] == 0 and offsets[-1] == hood_id.shape[0]
    for h in range(37):
        assert np.all(hood_id[offsets[h]:offsets[h + 1]] == h)
    want = jax_ref.fused_em_tick(*_jax(arrays), 0.75, precision="f32", **TICK_KW)
    got = ops.fused_em_tick(
        *_torch(arrays), 0.75, offsets=torch.from_numpy(offsets), precision="f32", **TICK_KW
    )
    _compare_tick(want, got, "f32")


def test_fused_em_tick_convergence_flag():
    """A history ring holding this tick's own energies converges."""
    arrays = random_tick_problem(3, 3, 37, 61, 900)
    first = jax_ref.fused_em_tick(*_jax(arrays), 0.75, **TICK_KW)
    hist = arrays[FIELDS.index("hist")]
    hist[:] = np.asarray(first[1])[None, :]
    want = jax_ref.fused_em_tick(*_jax(arrays), 0.75, **TICK_KW)
    got = ops.fused_em_tick(*_torch(arrays), 0.75, **TICK_KW)
    assert bool(want[3]) and bool(got[3])
    _compare_tick(want, got, "f32")


@pytest.mark.parametrize("n_labels", [2, 3, 5])
def test_label_energies_blocked_bitwise(n_labels):
    rng = np.random.default_rng(100 + n_labels)
    n = 777
    y = rng.normal(100, 30, n).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    nall = rng.integers(1, 12, n).astype(np.float32)
    cnt = np.minimum(rng.integers(0, 12, (n_labels, n)), nall).astype(np.float32)
    xf = rng.integers(0, n_labels, n).astype(np.float32)
    valid = (rng.random(n) < 0.9).astype(np.float32)
    mu = np.linspace(60, 140, n_labels).astype(np.float32)
    sig = np.linspace(8, 14, n_labels).astype(np.float32)
    args = (y, w, cnt, nall, xf, valid, mu, sig)
    want = jax_em_tick.label_energies_blocked(*_jax(args), 0.75, precision="f32")
    got = torch_ref.label_energies_blocked(*_torch(args), 0.75, precision="f32")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_leave_launch_counts_at_zero():
    ops.reset_launch_counts()
    arrays = random_tick_problem(0, 2, 37, 61, 300)
    ops.fused_em_tick(*_torch(arrays), 0.75, **TICK_KW)
    ops.segment_reduce(torch.ones(5), torch.zeros(5, dtype=torch.int32), 3)
    assert ops.launch_counts() == {
        "flash_attention": 0, "fused_em_tick": 0, "fused_map_step": 0, "mrf_min_energy": 0,
        "segment_reduce": 0,
    }


def test_kernel_wrappers_refuse_cpu_tensors_without_building():
    """The CUDA wrappers raise on a CPU tensor before anything is built;
    the dispatch knows no backend but ``auto`` and ``torch``."""
    with pytest.raises(ValueError, match="CUDA"):
        segment_reduce_cuda(torch.ones(5), torch.zeros(5, dtype=torch.int32), 3)
    arrays = random_tick_problem(0, 2, 37, 61, 300)
    offsets = torch.zeros(38, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fused_em_tick_cuda(*_torch(arrays), 0.75, offsets=offsets, **TICK_KW)
    for backend in ("cuda", "xla"):
        with pytest.raises(ValueError, match="backend"):
            ops.segment_reduce(torch.ones(5), torch.zeros(5, dtype=torch.int32), 3, backend=backend)
    assert _build._libs == {}


def test_fused_em_tick_label_limit_names_shared_memory():
    """Any K from 2 to MAX_LABELS reaches the kernel (K >= 9 by its runtime-K
    variant); above that the wrapper refuses and names the 227 KB a block
    may use, before it looks at the device or builds anything."""
    assert em_tick.MAX_LABELS == em_tick.SMEM_PER_BLOCK // 44 == 5282
    for k in (9, 16, 33, em_tick.MAX_LABELS):
        arrays = random_tick_problem(0, 2, 37, 61, 300)
        arrays[FIELDS.index("mu")] = np.linspace(60, 140, k).astype(np.float32)
        arrays[FIELDS.index("sigma")] = np.linspace(8, 14, k).astype(np.float32)
        with pytest.raises(ValueError, match="CUDA"):
            fused_em_tick_cuda(*_torch(arrays), 0.75, offsets=torch.zeros(38, dtype=torch.int32),
                               **TICK_KW)
    arrays[FIELDS.index("mu")] = np.zeros(em_tick.MAX_LABELS + 1, np.float32)
    arrays[FIELDS.index("sigma")] = np.ones(em_tick.MAX_LABELS + 1, np.float32)
    with pytest.raises(ValueError, match="227 KB"):
        fused_em_tick_cuda(*_torch(arrays), 0.75, offsets=torch.zeros(38, dtype=torch.int32),
                           **TICK_KW)
    assert _build._libs == {}


def test_resolve_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device(None)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_kernel_modules_import_without_nvcc():
    """Importing builds nothing: the kernels compile at first CUDA use."""
    for name in ("repro_torch.kernels.em_tick", "repro_torch.kernels.segment_reduce",
                 "repro_torch.kernels.map_step", "repro_torch.kernels.mrf_energy",
                 "repro_torch.kernels.flash_attention", "repro_torch.kernels.ops"):
        importlib.import_module(name)
    assert _build.sources() == ["em_tick", "flash_attention", "map_step", "mrf_energy", "segment_reduce"]
    assert _build._libs == {}


def test_build_target_follows_headers(tmp_path, monkeypatch):
    """A library's name hashes its source, every ``csrc/*.cuh`` and the
    flags: editing a header that a source may include names a new library,
    so the stale one is never loaded."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("#define A 1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert _build._target("k") == first
    header.write_text("#define A 2\n")
    second = _build._target("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "other.cuh").write_text("\n")
    assert _build._target("k") not in (first, second)
    assert _build.sources() == ["k"]
