"""The port's attention against the JAX package on the CPU.

On the CPU ``ops.flash_attention`` takes the kernel's plain version
(``repro_torch.kernels.ref.flash_attention``); the CUDA kernel itself is
held to it on the card by ``chip_smoke.py``.  The JAX package's Pallas
kernel cannot run here (jax rejects its ``compiler_params`` even in
interpret mode), so the references are its plain ``ref.flash_attention``
and its ``chunked_attention``.  Inputs are made with numpy from a seed.
Tolerances are the reference tests' tiers (``tests/test_kernels.py``):
float32 within 2e-4, bfloat16 within 2e-2 (against the float32 answer).
The port's decode attention (``chunked_attention``) is held to JAX's at
1e-5: the same chunked algorithm in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attention

from repro_torch.kernels import ops
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import attention as torch_attention
from repro_torch.testing import flash_cases as fc
from repro_torch.testing import flash_faults

SHAPES = [
    (1, 2, 2, 128, 32),   # MHA
    (2, 4, 2, 256, 64),   # GQA group=2
    (1, 8, 1, 128, 16),   # MQA
    (1, 2, 1, 512, 64),   # the long-sequence case
    (1, 4, 2, 200, 32),   # a ragged length
]


def _qkv(b, hq, hkv, s, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, hq, s, d) * 0.3).astype(np.float32)
    k = (rng.randn(b, hkv, s, d) * 0.3).astype(np.float32)
    v = rng.randn(b, hkv, s, d).astype(np.float32)
    return q, k, v


TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,hq,hkv,s,d", SHAPES)
def test_plain_flash_matches_jax_ref_and_chunked(b, hq, hkv, s, d, causal, dtype):
    """The port's plain attention in ``dtype`` against the JAX package's
    naive reference and its chunked scan, both in float32 on the same
    (for bf16: bf16-rounded) inputs, as ``tests/test_kernels.py`` forms
    its bf16 reference."""
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in _qkv(b, hq, hkv, s, d, hq * s + d))
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == (b, hq, s, d)
    inputs = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    tol = TOL[dtype]
    want = jax_ref.flash_attention(*inputs, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=tol, atol=tol)
    chunked = jax_attention.chunked_attention(*inputs, causal=causal, chunk=64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(chunked), rtol=tol, atol=tol)


def test_plain_flash_scale_argument():
    q, k, v = _qkv(1, 4, 2, 64, 16, 5)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, scale=0.1)
    want = jax_ref.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True, scale=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sk,chunk,offset,valid", [
    (64, 16, 40, 41),     # a decode position inside the cache
    (70, 32, 0, None),    # Sk not a chunk multiple: padded tail
    (48, 16, 47, 48),     # the last position
])
@pytest.mark.parametrize("sq,causal", [(1, False), (4, True)])
def test_chunked_attention_matches_jax(sk, chunk, offset, valid, sq, causal):
    rng = np.random.RandomState(sk + chunk)
    q = (rng.randn(2, 4, sq, 16) * 0.5).astype(np.float32)
    k = (rng.randn(2, 2, sk, 16) * 0.5).astype(np.float32)
    v = rng.randn(2, 2, sk, 16).astype(np.float32)
    kw = dict(causal=causal, chunk=chunk, q_offset=offset, kv_valid_len=valid)
    want = jax_attention.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = torch_attention.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_flash_leaves_launch_count_at_zero():
    ops.reset_launch_counts()
    q, k, v = _qkv(1, 2, 1, 32, 16, 1)
    ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    torch_attention.attention_dispatch(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert ops.launch_counts()["flash_attention"] == 0


def test_flash_wrapper_refuses_cpu_tensors_and_unknown_backends():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 32, 16, 2))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, causal=True)
    with pytest.raises(ValueError, match="backend"):
        ops.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="kv heads"):
        torch_ref.flash_attention(q, k[:, :1].expand(1, 3, 32, 16), v, causal=True)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA card: the C entry point makes the choice and reports it")
@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 16, "cuda_cores"),
    (torch.bfloat16, 256, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"),
])
def test_flash_variant_by_dtype_and_head_dim(dtype, d, want):
    """bfloat16 at D = 64 and 128 goes to the tensor-core kernel; float32
    at any D, and bfloat16 at other D, to the CUDA-core kernel.  The C
    entry point reports its choice and the wrapper counts it."""
    q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in _qkv(1, 2, 1, 64, d, 4))
    before = flash_module.launches, flash_module.launches_tc
    flash_attention_cuda(q, k, v, causal=True)
    after = flash_module.launches, flash_module.launches_tc
    assert (after[0] - before[0], after[1] - before[1]) == (1, int(want == "tensor_cores"))


def _refusal_cases():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 4, 2, 64, 64, 3))
    return {
        "q not contiguous": ((q.transpose(2, 3).contiguous().transpose(2, 3), k, v), "contiguous"),
        "k not contiguous": ((q, k.transpose(2, 3).contiguous().transpose(2, 3), v), "contiguous"),
        "v not contiguous": ((q, k, v.transpose(2, 3).contiguous().transpose(2, 3)), "contiguous"),
        "head dim 8": ((q[..., :8], k[..., :8], v[..., :8]), "head dim"),
        "head dim 24": ((q[..., :24].contiguous(), k[..., :24].contiguous(), v[..., :24].contiguous()),
                        "head dim"),
        "head dim 272": ((q.repeat(1, 1, 1, 5)[..., :272].contiguous(),) * 3, "head dim"),
        "3 q heads on 2 kv heads": ((q[:, :3].contiguous(), k, v), "kv heads"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_flash_wrapper_refuses_bad_operands(case):
    """The wrapper's checks run before the device is looked at, so they
    hold on the CPU: non-contiguous operands, D outside [16, 256] or not a
    multiple of 16, and Hq not a multiple of Hkv raise; nothing is built
    or launched."""
    args, match = _refusal_cases()[case]
    before = flash_module.launches, flash_module.launches_tc
    with pytest.raises(ValueError, match=match):
        flash_attention_cuda(*args, causal=True)
    assert (flash_module.launches, flash_module.launches_tc) == before


# The peaked-softmax cases that hold the tensor-core kernel on the card
# (chip_smoke.check_flash_peaked): the check must tell a right online
# softmax from a broken one.  The kernel's algorithm is modelled in numpy.

_CASE_IDS = [f"{'x'.join(map(str, sh))}-q{qs:g}-{'causal' if c else 'full'}" for sh, qs, c in fc.PEAKED_CASES]


def _peaked(i):
    shape, q_scale, causal = fc.PEAKED_CASES[i]
    q, k, v = fc.peaked_inputs(shape, q_scale, seed=100 + i)
    plain = torch_ref.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                                      causal=causal)
    return (q, k, v), causal, plain.float().numpy()


@pytest.mark.parametrize("i", range(len(fc.PEAKED_CASES)), ids=_CASE_IDS)
def test_peaked_case_scores_spread(i):
    """Every peaked case spreads its scores by at least MIN_SPREAD; the
    usual inputs at the same shape spread by less than one unit."""
    shape, q_scale, causal = fc.PEAKED_CASES[i]
    q, k, _ = fc.peaked_inputs(shape, q_scale, seed=100 + i)
    assert fc.score_spread(q, k, causal) >= fc.MIN_SPREAD
    q, k, _ = fc.peaked_inputs(shape, 1.0, seed=100 + i)
    assert fc.score_spread(q, k, causal) < 1.0


@pytest.mark.parametrize("i", range(len(fc.PEAKED_CASES)), ids=_CASE_IDS)
def test_online_softmax_model_within_row_tol(i):
    """The tensor-core kernel's algorithm (bf16 P, 64-key tiles) stays
    within ROW_TOL of the plain version on every peaked case."""
    qkv, causal, plain = _peaked(i)
    assert fc.row_relative_error(fc.online_softmax(*qkv, causal), plain) <= fc.ROW_TOL


_BROKEN = [(i, "no_rescale") for i in range(len(fc.PEAKED_CASES))]
_BROKEN += [(i, "no_max") for i, (_, q_scale, _) in enumerate(fc.PEAKED_CASES) if q_scale >= 1000]


@pytest.mark.parametrize("i,fault", _BROKEN, ids=[f"{_CASE_IDS[i]}-{f}" for i, f in _BROKEN])
def test_row_tol_rejects_broken_online_softmax(i, fault):
    """Without the accumulator's rescale every peaked case fails the limit;
    without the max subtraction the overflowing case does."""
    qkv, causal, plain = _peaked(i)
    kw = {"rescale": False} if fault == "no_rescale" else {"subtract_max": False}
    assert not fc.row_relative_error(fc.online_softmax(*qkv, causal, **kw), plain) <= fc.ROW_TOL


def test_row_relative_error_scales_by_row():
    """A row of small values is held as tightly as a row of large ones."""
    want = np.array([[1.0, -2.0], [0.01, 0.02]])
    assert fc.row_relative_error(want, want) == 0.0
    assert fc.row_relative_error(want + [[0.0, 0.0], [0.0, 0.001]], want) == pytest.approx(0.05)
    assert fc.row_relative_error(want + [[0.01, 0.0], [0.0, 0.0]], want) == pytest.approx(0.005)
    assert fc.row_relative_error(np.full((2, 2), np.nan), want) == float("inf")
    x = np.array([1.0, 1.00390625, 1.01171875, -3.3e38, 0.0], np.float32)
    np.testing.assert_array_equal(fc.bf16_round(x), torch.from_numpy(x).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("fault", sorted(flash_faults.FAULTS))
def test_flash_fault_edits_apply_to_the_source(fault):
    """Each deliberate fault of ``flash_faults`` finds its text exactly once
    in today's flash source, so the on-card fault run still breaks what it
    says it breaks."""
    text = (flash_faults.ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu").read_text()
    broken = flash_faults.apply_fault(text, fault)
    assert (broken == text) == (fault == "none")
    with pytest.raises(ValueError, match="exactly once"):
        flash_faults.apply_fault(text + text, "no_rescale")
