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
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import attention as torch_attention

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
