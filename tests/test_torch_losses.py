"""Every family's training loss in the port against the JAX package on the
CPU, and ``flash_attention`` under autograd.

Both packages run each family's reduced config in float32 (logit chunk
16, so a batch of 32 positions takes two chunks; attention chunk 16) on
the same weights: the port's ``init`` from a seeded generator, carried to
the JAX package's tree by ``convert.params_to_numpy`` and back by
``convert.params_from_jax`` (JAX's own init costs more time than the
gradients here).  Tokens, labels, the mask (a few
positions masked out), frames and patch embeddings are numpy draws from
a seed.  Tolerances: the loss rtol 1e-5; each gradient leaf within 1e-5
of the leaf's largest magnitude (the port's prefill attention is the
naive plain version, JAX's the chunked scan; matmuls sum in other
orders).  ``router_aux_loss`` rtol 1e-6.  The flash function's gradients
equal autograd through ``ref.flash_attention`` bit for bit on both routes
(the kernel route here is a stand-in that writes its output outside
autograd, as the ctypes kernel does).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import moe as jax_M
from repro.models.registry import get_api as jax_get_api

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import convert, layers
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_api

# one architecture per family
FAMILIES = {
    "dense": "qwen2-1.5b",
    "vlm": "llava-next-34b",
    "moe": "qwen3-moe-235b-a22b",
    "mla_moe": "deepseek-v2-lite-16b",
    "ssm": "mamba2-130m",
    "hybrid": "zamba2-2.7b",
    "encdec": "whisper-large-v3",
}
B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5


def _cfgs(arch, **kw):
    kw = dict(logit_chunk=16, attn_chunk=16, **kw)
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "mask": (rng.random((B, S)) > 0.1).astype(np.float32),
    }
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(0, 1, (B, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return out


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _port_loss_and_grads(cfg, params, batch, backend=None):
    params.requires_grad_(True)
    for p in params.parameters():
        p.grad = None
    loss = get_api(cfg).loss(params, _port_batch(batch), cfg, backend=backend)
    loss.backward()
    grads = convert.reference_tree(params, {n: p.grad for n, p in params.named_parameters()})
    return float(loss.detach()), {path: g.numpy() for path, g in grads.items()}


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for path, w in want.items():
        scale = float(np.max(np.abs(w))) or 1.0
        err = float(np.max(np.abs(got[path] - w)))
        assert err <= GRAD_TOL * scale, (path, err, scale)


@pytest.fixture(scope="module")
def jax_grads():
    """Per family: (cfg, JAX params, JAX loss, JAX gradients as float32 leaves)."""
    out = {}
    for family, arch in FAMILIES.items():
        jcfg, cfg = _cfgs(arch)
        japi = jax_get_api(jcfg)
        jparams = convert.params_to_numpy(get_api(cfg).init(torch.Generator().manual_seed(0), cfg))
        batch = _batch(cfg)
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: japi.loss(p, b, jcfg)))(
            jax.tree.map(jnp.asarray, jparams), {k: jnp.asarray(v) for k, v in batch.items()})
        out[family] = (cfg, jparams, float(loss), _flat(grads), batch)
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_loss_and_grads_match_jax(jax_grads, family):
    cfg, jparams, want_loss, want_grads, batch = jax_grads[family]
    params = convert.params_from_jax(jparams, cfg, device="cpu")
    loss, grads = _port_loss_and_grads(cfg, params, batch)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    _assert_grads_close(grads, want_grads)


@pytest.mark.parametrize("policy", ["none", "dots", "dots_nb", "full"])
def test_remat_policies_give_the_same_loss_and_grads(jax_grads, policy, monkeypatch):
    """Every remat policy gives JAX's loss and gradients; under a policy
    that checkpoints, each layer's attention forward runs again in the
    backward pass (the recompute), and the flash backward once."""
    cfg, jparams, want_loss, want_grads, batch = jax_grads["dense"]
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    params = convert.params_from_jax(jparams, cfg, device="cpu")
    calls = []
    plain = ref.flash_attention
    monkeypatch.setattr(ref, "flash_attention", lambda *a, **k: calls.append(torch.is_grad_enabled()) or plain(*a, **k))
    loss, grads = _port_loss_and_grads(cfg, params, batch)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    _assert_grads_close(grads, want_grads)
    forwards = 1 if policy == "none" else 2
    # forward calls run with grad off (inside the Function), the backward's recompute with it on
    assert calls.count(False) == forwards * cfg.n_layers
    assert calls.count(True) == cfg.n_layers


def test_unknown_remat_policy_raises(jax_grads):
    cfg, jparams, *_ , batch = jax_grads["dense"]
    cfg = dataclasses.replace(cfg, remat_policy="everything")
    params = convert.params_from_jax(jparams, cfg, device="cpu").requires_grad_(True)
    with pytest.raises(ValueError, match="remat_policy"):
        T.lm_loss(params, _port_batch(batch), cfg)


def test_chunked_softmax_xent_matches_jax():
    rng = np.random.default_rng(3)
    hidden = rng.normal(0, 1, (2, 12, 8)).astype(np.float32)
    w = rng.normal(0, 1, (8, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) > 0.3).astype(np.float32)
    want = jax_layers.chunked_softmax_xent(lambda h: h @ jnp.asarray(w), jnp.asarray(hidden), jnp.asarray(labels),
                                           jnp.asarray(mask), 4)
    tw = torch.from_numpy(w)
    got = layers.chunked_softmax_xent(lambda h: h @ tw, torch.from_numpy(hidden), torch.from_numpy(labels),
                                      torch.from_numpy(mask), 4)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    # an all-masked batch divides by 1, not 0
    zero = layers.chunked_softmax_xent(lambda h: h @ tw, torch.from_numpy(hidden), torch.from_numpy(labels),
                                       torch.zeros(2, 12), 4)
    assert float(zero) == 0.0
    with pytest.raises(ValueError, match="multiple of the chunk"):
        layers.chunked_softmax_xent(lambda h: h @ tw, torch.from_numpy(hidden), torch.from_numpy(labels),
                                    torch.from_numpy(mask), 5)


def test_router_aux_loss_matches_jax(jax_grads):
    cfg, jparams, *_ = jax_grads["moe"]
    router = np.array(jparams["layers"]["moe"]["router"][0])
    x = np.random.default_rng(5).normal(0, 1, (24, cfg.d_model)).astype(np.float32)
    want = jax_M.router_aux_loss({"router": jnp.asarray(router)}, jnp.asarray(x), cfg)
    got = M.router_aux_loss({"router": torch.from_numpy(router)}, torch.from_numpy(x), cfg)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    # perfectly balanced routing gives E * sum(k/E * 1/E) = k
    assert float(M.router_aux_loss({"router": torch.zeros(cfg.d_model, cfg.moe_num_experts)},
                                   torch.from_numpy(x), cfg)) == pytest.approx(cfg.moe_top_k, rel=1e-6)


# ---------------------------------------------------------------------------
# flash_attention under autograd
# ---------------------------------------------------------------------------


def _qkv(shape, seed, dtype=torch.float32):
    b, hq, hkv, s, d = shape
    rng = np.random.default_rng(seed)
    mk = lambda h: torch.from_numpy(rng.normal(0, 1, (b, h, s, d)).astype(np.float32)).to(dtype).requires_grad_(True)
    return mk(hq), mk(hkv), mk(hkv)


def _fake_kernel(q, k, v, *, causal, scale):
    """The kernel route's stand-in: the plain numbers, written outside
    autograd (as the ctypes kernel writes its output)."""
    with torch.no_grad():
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)


@pytest.fixture
def kernel_route(monkeypatch):
    """Every ``flash_attention`` call without ``backend="torch"`` goes to
    the stand-in kernel, which counts its launches."""
    launches = []
    monkeypatch.setattr(ops, "_use_kernel", lambda backend, where: backend != "torch")
    monkeypatch.setattr(ops._flash_attention, "flash_attention_cuda",
                        lambda *a, **k: launches.append(1) or _fake_kernel(*a, **k))
    return launches


@pytest.mark.parametrize("shape,causal", [((2, 4, 2, 24, 16), True), ((1, 3, 1, 17, 32), False),
                                          ((1, 2, 2, 8, 16), True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_grads_equal_autograd_through_plain(shape, causal, dtype, kernel_route):
    d_out = torch.from_numpy(np.random.default_rng(1).normal(0, 1, shape[:2] + shape[3:]).astype(np.float32)).to(dtype)
    q, k, v = _qkv(shape, 0, dtype)
    want = torch.autograd.grad(ref.flash_attention(q, k, v, causal=causal), (q, k, v), d_out)
    for backend in ("torch", None):   # plain route, kernel route
        out = ops.flash_attention(q, k, v, causal=causal, backend=backend)
        assert out.grad_fn is not None and out.dtype == dtype
        got = torch.autograd.grad(out, (q, k, v), d_out)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert len(kernel_route) == 1


def test_flash_function_only_where_autograd_records(kernel_route):
    q, k, v = _qkv((1, 2, 1, 8, 16), 2)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, causal=True).grad_fn is None
    out = ops.flash_attention(q.detach(), k.detach(), v.detach(), causal=True)
    assert out.grad_fn is None
    # the stand-in alone leaves its output outside the graph: the Function is what connects it
    assert ops._flash_attention.flash_attention_cuda(q, k, v, causal=True, scale=None).grad_fn is None
    # only k needs a gradient: the backward differentiates k alone
    out = ops.flash_attention(q.detach(), k, v.detach(), causal=True)
    (gk,) = torch.autograd.grad(out.sum(), (k,))
    assert gk.shape == k.shape and bool(gk.abs().sum() > 0)


def test_train_step_gives_every_gqa_projection_a_gradient_on_both_routes(jax_grads, kernel_route):
    """After one training step on the kernel route (the stand-in, launched
    once per layer) and on the plain route, wq, wk and wv of every layer
    have non-zero gradients, equal between the routes bit for bit."""
    cfg, jparams, _, _, batch = jax_grads["dense"]
    grads = {}
    for backend in ("torch", None):
        params = convert.params_from_jax(jparams, cfg, device="cpu")
        kernel_route.clear()
        _, grads[backend] = _port_loss_and_grads(cfg, params, batch, backend=backend)
        for lp in params.layers:
            for name in ("wq", "wk", "wv"):
                assert lp.attn[name].grad is not None and bool(lp.attn[name].grad.abs().sum() > 0), name
    # the dense config remats with "dots": the forward and its recompute
    assert len(kernel_route) == 2 * cfg.n_layers
    for path in grads["torch"]:
        assert np.array_equal(grads[None][path], grads["torch"][path]), path
