"""The port's ``parallel/`` against the JAX package on the CPU: the sharding
rules, sequence-parallel decode, expert parallelism, the gradient codecs
and the mesh constructor.

* Specs, no ranks: ``param_specs``, ``batch_specs``, ``cache_specs``,
  ``dp_axes`` and ``state_specs`` leaf by leaf against the reference's, for
  all seven families at full width (shapes from ``jax.eval_shape``), on
  stub meshes (data=2, model=4), (pod=2, data=2, model=2) and (data=16,
  model=16); the reduced models' per-parameter specs through
  ``convert.reference_tree``.
* On 2 and 4 spawned gloo ranks (one ``run_ranks`` call per world size,
  the JAX sides computed here and passed as payload): SP decode against
  the reference's single-device ``gqa_decode`` / ``mla_decode`` at reduced
  qwen2 / deepseek (output within 2e-4, caches within 1e-6: the
  reference's own bounds), with t in the first shard, on shard boundaries
  and in the last shard, so that some shards are all masked; EP
  ``moe_ffn`` at reduced qwen3-moe and deepseek in float32, forward and
  the gradients of ``sum(y * w)`` against ``jax.grad`` of the reference's
  ``moe_ffn(axis=None)``, within 2e-5 of each array's largest magnitude
  (the partial outputs' sum reorders float adds); int8 over 2 ranks; the
  mesh's row-major layout.
* Codecs on one rank bit for bit against the reference's, the int8 one
  with the reference's ``jax.random.uniform`` draws fed in.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_A
from repro.models import moe as jax_M
from repro.models.registry import get_api as jax_get_api
from repro.parallel import sharding as jax_SH
from repro.training import checkpoint as jax_CK
from repro.training import compression as jax_comp
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts

from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models.registry import get_api
from repro_torch.parallel import sharding as SH
from repro_torch.testing import ranks
from repro_torch.training import checkpoint as CK
from repro_torch.training import compression
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts_mod

RANK_TIMEOUT_S = 120
FAMILY_ARCHS = ("qwen2-1.5b", "llava-next-34b", "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b",
                "mamba2-130m", "zamba2-2.7b", "whisper-large-v3")
MESHES = {"data2_model4": (("data", "model"), (2, 4)),
          "pod2_data2_model2": (("pod", "data", "model"), (2, 2, 2)),
          "data16_model16": (("data", "model"), (16, 16))}
SP_TS = (5, 16, 32, 63)          # S = 64: first shard, boundaries, last shard
SP_TOL = dict(rtol=2e-4, atol=2e-4)
CACHE_TOL = dict(rtol=1e-6, atol=1e-6)
EP_REL = 2e-5


def _stubs(name):
    axes, shape = MESHES[name]
    jmesh = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape), shape=dict(zip(axes, shape)))
    return jmesh, types.SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _shapes(tree):
    """A JAX eval_shape tree as nested dicts of shape tuples."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _jax_specs(tree, prefix=()):
    """The reference's spec leaves by path (PartitionSpec is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jax_specs(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _port_specs(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _same(jspec, pspec) -> bool:
    return tuple(jspec) == tuple(pspec) and jax_CK._spec_to_str(jspec) == pspec.to_json()


# ---------------------------------------------------------------------------
# specs, no ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_param_specs_match_reference_at_full_width(arch, mesh_name):
    jmesh, pmesh = _stubs(mesh_name)
    cfg = jax_get_config(arch)
    shp = jax.eval_shape(lambda k: jax_get_api(cfg).init(k, cfg), jax.random.PRNGKey(0))
    want = _jax_specs(jax_SH.param_specs(shp, jmesh))
    got = _port_specs(SH.param_specs(_shapes(shp), pmesh))
    assert got.keys() == want.keys()
    bad = {p: (want[p], got[p]) for p in want if not _same(want[p], got[p])}
    assert not bad, bad
    assert SH.dp_axes(pmesh) == jax_SH.dp_axes(jmesh)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_and_cache_specs_match_reference(arch, mesh_name):
    jmesh, pmesh = _stubs(mesh_name)
    cfg = jax_get_config(arch)
    for batch in (32, 3):                       # divides every dp size; divides none
        bshape = jax.eval_shape(lambda: {"tokens": jnp.zeros((batch, 64), jnp.int32),
                                         "labels": jnp.zeros((batch, 64), jnp.int32),
                                         "mask": jnp.ones((batch, 64), jnp.float32)})
        want = _jax_specs(jax_SH.batch_specs(bshape, jmesh, global_batch=batch))
        got = _port_specs(SH.batch_specs(_shapes(bshape), pmesh, global_batch=batch))
        assert got.keys() == want.keys() and all(_same(want[p], got[p]) for p in want), (batch, got)
        cshape = jax.eval_shape(lambda: jax_get_api(cfg).init_cache(cfg, batch, 4096))
        cshape = {k: v for k, v in cshape.items()}
        want = _jax_specs(jax_SH.cache_specs(cshape, jmesh, cfg, batch=batch))
        got = _port_specs(SH.cache_specs(_shapes(cshape), pmesh, None, batch=batch))
        assert got.keys() == want.keys()
        bad = {p: (want[p], got[p]) for p in want if not _same(want[p], got[p])}
        assert not bad, (batch, bad)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_state_specs_match_reference_at_full_width(arch):
    """The port's ``state_specs`` (shapes from an init that allocates
    nothing) against the reference's, as the checkpoint's spec strings
    name and order them."""
    jmesh, pmesh = _stubs("pod2_data2_model2")
    for master in (True, False):
        ocfg = jax_opt.AdamWConfig(use_master_fp32=master)
        want = jax_ts.state_specs(jax_get_config(arch), ocfg, jmesh)
        flat, _ = jax_CK._flatten(want)
        got = CK.spec_strings(ts_mod.state_specs(get_config(arch), opt.AdamWConfig(use_master_fp32=master), pmesh))
        assert list(got) == [n for n, _ in flat]
        assert got == {n: jax_CK._spec_to_str(s) for n, s in flat}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reduced_model_specs_through_reference_tree(arch):
    """Each parameter of the port's reduced model gets its reference leaf's
    spec (the leading layer entry dropped for a stacked leaf)."""
    _, pmesh = _stubs("data2_model4")
    jmesh, _ = _stubs("data2_model4")
    cfg = get_config(arch).reduced()
    model = get_api(cfg).init(torch.Generator().manual_seed(0), cfg)
    tree = jax.tree.map(jnp.asarray, convert.params_to_numpy(model))
    want = _jax_specs(jax_SH.param_specs(tree, jmesh))
    got = SH.module_specs(model, pmesh)
    for name, (path, index) in convert.reference_layout(model).items():
        spec = tuple(want[path])
        assert tuple(got[name]) == (spec if index is None else spec[1:]), name


def test_partition_spec_json_pickle_and_projection():
    import pickle

    spec = SH.P(("pod", "data"), None, "model")
    assert spec.to_json() == '[["pod", "data"], null, "model"]'
    assert SH.P.from_json(spec.to_json()) == spec and SH.P.from_json("") is None
    assert pickle.loads(pickle.dumps(spec)) == spec and isinstance(pickle.loads(pickle.dumps(spec)), SH.P)
    _, pmesh = _stubs("data2_model4")
    assert SH.project_spec(spec, pmesh) == SH.P(("data",), None, "model")
    assert SH.project_spec(SH.P("pod", None), pmesh) == SH.P(None, None)
    assert SH.project_spec(None, pmesh) == SH.P()


# ---------------------------------------------------------------------------
# on gloo ranks
# ---------------------------------------------------------------------------


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _sp_case(arch, kind, seed):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), attn_chunk=32)
    rng = np.random.default_rng(seed)
    b, s = 2, 64
    init = jax_A.gqa_init if kind == "gqa" else jax_A.mla_init
    p = jax.tree.map(jnp.asarray, _np_tree(init(jax.random.PRNGKey(seed), jcfg, jnp.float32)))
    x = rng.standard_normal((b, 1, jcfg.d_model), dtype=np.float32)
    if kind == "gqa":
        shapes = {"k": (b, jcfg.n_kv_heads, s, jcfg.head_dim), "v": (b, jcfg.n_kv_heads, s, jcfg.head_dim)}
        fn = jax.jit(lambda pp, xx, c0, c1, t: jax_A.gqa_decode(pp, xx, jcfg, c0, c1, t))
    else:
        shapes = {"ckv": (b, s, jcfg.mla_kv_lora_rank), "krope": (b, 1, s, jcfg.mla_rope_head_dim)}
        fn = jax.jit(lambda pp, xx, c0, c1, t: jax_A.mla_decode(pp, xx, jcfg, c0, c1, t))
    caches = {k: rng.standard_normal(v, dtype=np.float32) for k, v in shapes.items()}
    want = {}
    for t in SP_TS:
        y, c0, c1 = fn(p, jnp.asarray(x), *(jnp.asarray(c) for c in caches.values()), jnp.asarray(t))
        want[t] = {"y": np.asarray(y), "c0": np.asarray(c0), "c1": np.asarray(c1)}
    payload = {"arch": arch, "overrides": {"attn_chunk": 32}, "params": _np_tree(p), "x": x, "ts": SP_TS, **caches}
    return payload, want


def _ep_case(arch, seed):
    jcfg = jax_get_config(arch).reduced()
    rng = np.random.default_rng(seed)
    p = _np_tree(jax_M.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    x = rng.standard_normal((2, 8, jcfg.d_model), dtype=np.float32)
    w = rng.standard_normal(x.shape, dtype=np.float32)

    def loss(pp, xx):
        y = jax_M.moe_ffn(pp, xx, jcfg, axis=None)
        return jnp.sum(y * w), y

    (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    grads = {k: np.asarray(v) for k, v in gp.items() if k != "shared"}
    grads.update({f"shared/{k}": np.asarray(v) for k, v in gp.get("shared", {}).items()})
    return {"arch": arch, "overrides": {}, "params": p, "x": x, "w": w}, {"y": np.asarray(y), "dx": np.asarray(gx),
                                                                          "grads": grads}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def model_ranks(request, tmp_path_factory):
    world = request.param
    gqa, want_gqa = _sp_case("qwen2-1.5b", "gqa", 1)
    mla, want_mla = _sp_case("deepseek-v2-lite-16b", "mla", 2)
    ep, want_ep = {}, {}
    for i, arch in enumerate(("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b")):
        ep[arch], want_ep[arch] = _ep_case(arch, 3 + i)
    rng = np.random.default_rng(5)
    int8 = {"g": rng.standard_normal((world, 64), dtype=np.float32), "seeds": list(range(200))}
    payload = {"gqa": gqa, "mla": mla, "ep": ep, "int8": int8}
    out = ranks.run_ranks(ranks.parallel_model, world, tmp_path_factory.mktemp(f"model{world}"), payload,
                          timeout=RANK_TIMEOUT_S)
    return {"world": world, "out": out, "gqa": want_gqa, "mla": want_mla, "ep": want_ep, "int8": int8}


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_sp_decode_matches_reference(model_ranks, kind):
    """Every rank's output equals the reference's single-device decode, and
    its cache slices the reference's new cache's."""
    world = model_ranks["world"]
    for t, want in model_ranks[kind].items():
        for rank, out in enumerate(model_ranks["out"]):
            got = out[kind][t]
            np.testing.assert_allclose(got["y"], want["y"], **SP_TOL, err_msg=f"{kind} t={t} rank {rank}")
            for c in ("c0", "c1"):
                axis = 2 if (kind == "gqa" or c == "c1") else 1
                whole = want[c]
                s_loc = whole.shape[axis] // world
                part = np.take(whole, np.arange(rank * s_loc, (rank + 1) * s_loc), axis=axis)
                np.testing.assert_allclose(got[c], part, **CACHE_TOL, err_msg=f"{kind} {c} t={t} rank {rank}")


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-lite-16b"])
def test_expert_parallel_forward_and_grads_match_reference(model_ranks, arch):
    """y, dx, the router's and the shared experts' gradients on every rank,
    and each rank's expert-stack gradient blocks, against ``jax.grad``."""
    world = model_ranks["world"]
    want = model_ranks["ep"][arch]

    def close(got, ref, what):
        scale = max(float(np.max(np.abs(ref))), 1e-30)
        assert float(np.max(np.abs(got - ref))) <= EP_REL * scale, (what, float(np.max(np.abs(got - ref))), scale)

    for rank, out in enumerate(model_ranks["out"]):
        got = out["ep"][arch]
        close(got["y"], want["y"], "y")
        close(got["dx"], want["dx"], "dx")
        for name, ref in want["grads"].items():
            if name in ("w_gate", "w_up", "w_down"):
                e_loc = ref.shape[0] // world
                ref = ref[rank * e_loc:(rank + 1) * e_loc]
            close(got["grads"][name], ref, name)


def test_int8_codec_over_ranks_is_unbiased_on_a_shared_grid(model_ranks):
    """Every rank decodes the same sum; each sum is within n * scale of the
    exact sum (scale the absmax over every rank / 127); the mean over 200
    seeds is within 5 standard deviations of stochastic rounding
    (sqrt(n / (4 * 200)) * scale) of it."""
    world = model_ranks["world"]
    g = model_ranks["int8"]["g"]
    outs = [o["int8"] for o in model_ranks["out"]]
    assert all(np.array_equal(o, outs[0]) for o in outs[1:])
    exact = g.sum(axis=0)
    scale = np.float32(np.max(np.abs(g))) / np.float32(127.0)
    assert np.max(np.abs(outs[0] - exact)) <= world * scale
    assert np.max(np.abs(outs[0].mean(axis=0) - exact)) <= 5 * np.sqrt(world / (4 * 200)) * scale


def test_mesh_is_row_major_and_checks_its_size(model_ranks):
    for rank, out in enumerate(model_ranks["out"]):
        assert out["model_rank"] == rank
        assert out["grid"] == (rank // 2, rank % 2)
        assert all(msg is not None and "ranks" in msg for msg in out["raises"]), out["raises"]


# ---------------------------------------------------------------------------
# codecs on one rank
# ---------------------------------------------------------------------------


def _codec_grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((7, 5), dtype=np.float32) * 3,
            "b": {"c": rng.standard_normal((11,), dtype=np.float32) * 1e-3, "d": np.zeros((3,), np.float32)}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_bf16_codec_on_one_rank_is_the_reference_bit_for_bit():
    g = _codec_grads(0)
    want = _leaves(jax_comp.bf16_allreduce(_jax(g), None))
    got = _leaves(jax.tree.map(lambda t: t.numpy(), compression.bf16_allreduce(_torch(g), None)))
    assert all(w.dtype == o.dtype and np.array_equal(w, o) for w, o in zip(want, got))


def test_int8_codec_with_the_reference_noise_is_the_reference_bit_for_bit(monkeypatch):
    g = _codec_grads(1)
    key = jax.random.PRNGKey(7)
    jg = _jax(g)
    leaves = jax.tree.leaves(jg)
    keys = jax.random.split(key, len(leaves))
    draws = iter([torch.from_numpy(np.array(jax.random.uniform(k, x.shape))) for k, x in zip(keys, leaves)])
    monkeypatch.setattr(compression, "_uniform", lambda shape, gen, device: next(draws))
    got = compression.int8_stochastic_allreduce(_torch(g), None, torch.Generator())
    want = _leaves(jax_comp.int8_stochastic_allreduce(jg, None, key))
    got = _leaves(jax.tree.map(lambda t: t.numpy(), got))
    assert all(np.array_equal(w, o) for w, o in zip(want, got))


def test_compress_allreduce_passes_through_without_a_group_and_checks_its_codec():
    g = _torch(_codec_grads(2))
    assert compression.compress_allreduce(g, None, codec="int8") is g
    with pytest.raises(ValueError, match="codec"):
        compression.compress_allreduce(g, object(), codec="fp4")
    with pytest.raises(ValueError, match="Generator"):
        compression.compress_allreduce(g, object(), codec="int8")
