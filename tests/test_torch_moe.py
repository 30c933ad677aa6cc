"""The port's MoE families (``moe``: qwen3-moe, ``mla_moe``: deepseek-v2-lite)
against the JAX package on the CPU: the MoE dispatch and FFN, MLA
attention and decode, prefill and decode of whole models, the serving
engine, the weight conversion and the launcher.

Both packages run the reduced configs in float32 (attention chunk 16, as
``tests/test_torch_lm.py`` uses) on the same weights: the JAX package's
``decoder_init`` at PRNGKey(0), carried across by
``repro_torch.models.convert.params_from_jax``.  Tolerances: expert
choices, keep masks, dropped counts and greedy tokens exactly; the MoE
FFN rtol/atol 1e-5; MLA, logits and caches rtol/atol 1e-4 (matmuls sum
in other orders).  The reduced configs drop no lane with their random
routers, so the capacity cases force drops with a router that sends
every token to one expert first.  JAX's functions are jitted once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_A
from repro.models import moe as jax_M
from repro.models.registry import get_api as jax_get_api
from repro.serving import lm as jax_lm
from repro.serving import sampler as jax_sampler

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import convert
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_api
from repro_torch.serving import Request, SamplerConfig, ServingEngine

ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b")
TOL = dict(rtol=1e-4, atol=1e-4)
FFN_TOL = dict(rtol=1e-5, atol=1e-5)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), logit_chunk=16, attn_chunk=16, **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), logit_chunk=16, attn_chunk=16, **kw)
    return jcfg, cfg


class Model:
    """One reduced configuration in both packages, JAX's entry points jitted."""

    def __init__(self, arch):
        self.jcfg, self.cfg = _cfgs(arch)
        self.japi, self.tapi = jax_get_api(self.jcfg), get_api(self.cfg)
        self.jparams = self.japi.init(jax.random.PRNGKey(0), self.jcfg)
        self.tparams = convert.params_from_jax(_tree_np(self.jparams), self.cfg, device="cpu")
        jcfg = self.jcfg
        self.jprefill = jax.jit(lambda p, tok: self.japi.prefill(p, {"tokens": tok}, jcfg, max_seq=24))
        self.jdecode = jax.jit(lambda p, c, tok: self.japi.decode_step(p, c, {"tokens": tok}, jcfg))


@pytest.fixture(scope="module")
def models():
    return {arch: Model(arch) for arch in ARCHS}


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------


def _moe_params(m: Model, shared: bool, dominant: bool, n_tokens: int, expert: int = 0):
    """Layer 0's MoE parameters (JAX dict and port ParameterDict) and
    ``n_tokens`` inputs.  ``dominant``: feature 0 of every token is 10 and
    the router's row 0 sends it to ``expert`` alone, so that expert
    receives every token and its capacity drops the later ones."""
    jp = {k: v for k, v in _tree_np(m.jparams["layers"]["moe"]).items()}
    jp = jax.tree.map(lambda a: a[0], jp)
    if not shared:
        jp.pop("shared", None)
    x = np.random.default_rng(11).normal(0, 1.0, (n_tokens, m.cfg.d_model)).astype(np.float32)
    if dominant:
        jp["router"] = jp["router"].copy()
        jp["router"][0] = 0.0
        jp["router"][0, expert] = 100.0
        x[:, 0] = 10.0
    tp = torch.nn.ParameterDict({
        k: (torch.nn.ParameterDict({kk: torch.nn.Parameter(torch.tensor(vv), requires_grad=False)
                                    for kk, vv in v.items()}) if isinstance(v, dict)
            else torch.nn.Parameter(torch.tensor(v), requires_grad=False))
        for k, v in jp.items()
    })
    return jp, tp, x


def _keep_oracle(experts: np.ndarray, cap: int, offset: int, e_loc: int) -> np.ndarray:
    """Keep mask (T, k) by a loop: tokens in order, each local expert
    keeps its first ``cap`` lanes."""
    seen = np.zeros(e_loc, np.int64)
    keep = np.zeros(experts.shape, bool)
    for t in range(experts.shape[0]):
        for j in range(experts.shape[1]):
            e = int(experts[t, j]) - offset
            if 0 <= e < e_loc:
                keep[t, j] = seen[e] < cap
                seen[e] += 1
    return keep


MOE_CASES = [
    # (arch, shared experts, dominant router, expert_offset, n_local_experts)
    ("qwen3-moe-235b-a22b", False, False, 0, None),
    ("qwen3-moe-235b-a22b", False, True, 0, None),
    ("qwen3-moe-235b-a22b", False, False, 2, 2),
    ("qwen3-moe-235b-a22b", False, True, 2, 2),
    ("deepseek-v2-lite-16b", True, False, 0, None),
    ("deepseek-v2-lite-16b", True, True, 0, None),
    ("deepseek-v2-lite-16b", False, True, 0, None),
]


@pytest.mark.parametrize("arch,shared,dominant,offset,n_local", MOE_CASES)
def test_moe_dispatch_and_ffn_match_jax(models, arch, shared, dominant, offset, n_local):
    m = models[arch]
    cfg, jcfg = m.cfg, m.jcfg
    t = 40
    jp, tp, x = _moe_params(m, shared, dominant, t, expert=offset)
    if n_local is not None:
        for name in ("w_gate", "w_up", "w_down"):
            jp[name] = jp[name][offset:offset + n_local]
            tp[name] = torch.nn.Parameter(torch.tensor(jp[name]), requires_grad=False)
    e_loc = n_local or cfg.moe_num_experts

    # the Map: JAX's expert choices, and the keep mask of the loop oracle
    want_e = np.asarray(jax.lax.top_k(jnp.asarray(x) @ jnp.asarray(jp["router"]), cfg.moe_top_k)[1])
    disp = M.dispatch(tp, torch.from_numpy(x), cfg, expert_offset=offset, n_local_experts=n_local)
    np.testing.assert_array_equal(disp.experts.numpy(), want_e)
    want_keep = _keep_oracle(want_e, M._capacity(t, cfg, cfg.moe_num_experts), offset, e_loc)
    np.testing.assert_array_equal(disp.keep_by_lane().numpy(), want_keep)
    local = (want_e >= offset) & (want_e < offset + e_loc)
    dropped = int(local.sum() - want_keep.sum())
    assert int(disp.local.sum() - disp.keep.sum()) == dropped
    if dominant:
        assert dropped > 0 and (want_e[:, 0] == offset).all()
    assert disp.cap == jax_M._capacity(t, jcfg, jcfg.moe_num_experts)

    # moe_ffn_local against the reference's; a token whose every lane was
    # dropped or non-local gets zeros in both
    want = jax_M.moe_ffn_local(jp, jnp.asarray(x), jcfg, expert_offset=offset, n_local_experts=n_local)
    got = M.moe_ffn_local(tp, torch.from_numpy(x), cfg, expert_offset=offset, n_local_experts=n_local)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    if n_local is None:
        x3 = x.reshape(2, t // 2, cfg.d_model)
        want = jax_M.moe_ffn(jp, jnp.asarray(x3), jcfg)
        got = M.moe_ffn(tp, torch.from_numpy(x3), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)


def test_moe_combine_is_ordered_and_logged(models):
    """The combine sums each token's k contributions in ascending expert
    order (a fixed order, no scatter-add): bit for bit a numpy loop over
    the dispatch's own lanes.  ``logged`` keeps the dispatches in call
    order and counts the lanes routed and kept by dispatch size; expert
    parallelism raises."""
    m = models["qwen3-moe-235b-a22b"]
    cfg = m.cfg
    _, tp, x = _moe_params(m, False, True, 40)
    xt = torch.from_numpy(x)
    with M.logged() as log:
        got = M.moe_ffn_local(tp, xt, cfg).numpy()
        M.moe_ffn_local(tp, xt[:4], cfg)
    disp = M.dispatch(tp, xt, cfg)
    summary = log.summary()
    assert sorted(summary) == [4, 40]
    assert summary[40]["lanes"] == 40 * cfg.moe_top_k
    assert summary[40]["dropped"] == int((~disp.keep).sum()) > 0 and summary[4]["dropped"] == 0
    assert [int(d.experts.shape[0]) for d in log.dispatches] == [40, 4]
    assert torch.equal(log.dispatches[0].keep, disp.keep) and torch.equal(log.dispatches[0].logits, disp.logits)

    e_loc, cap = disp.e_loc, disp.cap
    buf = np.zeros((e_loc * cap, cfg.d_model), np.float32)
    for i in np.flatnonzero(disp.keep.numpy()):
        buf[int(disp.slot[i])] = x[int(disp.s_token[i])]
    buf = torch.from_numpy(buf.reshape(e_loc, cap, -1))
    h = torch.nn.functional.silu(torch.bmm(buf, tp["w_gate"])) * torch.bmm(buf, tp["w_up"])
    out = torch.bmm(h, tp["w_down"]).reshape(e_loc * cap, -1).numpy()
    want = np.zeros_like(x)
    for tok in range(x.shape[0]):
        acc = None
        for i in np.flatnonzero(disp.s_token.numpy() == tok):  # ascending expert
            c = (out[int(disp.slot[i])] if disp.keep[i] else np.zeros_like(x[0])) * np.float32(disp.s_gate[i])
            acc = c if acc is None else acc + c
        want[tok] = acc
    np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError, match="process group"):  # expert parallelism takes the mesh axis's group
        M.moe_ffn(tp, xt[None], cfg, axis="model")


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def test_mla_attn_and_decode_match_jax(models):
    m = models["deepseek-v2-lite-16b"]
    cfg, jcfg = m.cfg, m.jcfg
    jp = jax.tree.map(lambda a: a[0], m.jparams["layers"]["attn"])
    tp = m.tparams.layers[0].attn
    rng = np.random.default_rng(12)
    b, s, s_max = 2, 9, 16
    x = rng.normal(0, 1.0, (b, s, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, xx: jax_A.mla_attn(p, xx, jcfg))(jp, jnp.asarray(x))
    np.testing.assert_allclose(A.mla_attn(tp, torch.from_numpy(x), cfg).numpy(), np.asarray(want), **TOL)

    r, dr = cfg.mla_kv_lora_rank, cfg.mla_rope_head_dim
    jckv, jkr = jnp.zeros((b, s_max, r)), jnp.zeros((b, 1, s_max, dr))
    tckv, tkr = torch.zeros((b, s_max, r)), torch.zeros((b, 1, s_max, dr))
    jdec = jax.jit(lambda p, xx, c, k, t: jax_A.mla_decode(p, xx, jcfg, c, k, t))
    for t in range(3):
        xt = rng.normal(0, 1.0, (b, 1, cfg.d_model)).astype(np.float32)
        jo, jckv, jkr = jdec(jp, jnp.asarray(xt), jckv, jkr, jnp.int32(t))
        to, tckv, tkr = A.mla_decode(tp, torch.from_numpy(xt), cfg, tckv, tkr, t)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL, err_msg=f"step {t}")
        np.testing.assert_allclose(tckv.numpy(), np.asarray(jckv), **TOL)
        np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), **TOL)


# ---------------------------------------------------------------------------
# whole models, the engine, conversion, the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(models, arch):
    m = models[arch]
    cfg = m.cfg
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jc = m.jprefill(m.jparams, jnp.asarray(prompt))
    ops.reset_launch_counts()
    tl, tc = m.tapi.prefill(m.tparams, {"tokens": torch.from_numpy(prompt).long()}, cfg, max_seq=24)
    assert ops.launch_counts()["flash_attention"] == 0
    assert tl.shape == (2, 1, cfg.vocab_size) and tl.dtype == torch.float32
    assert sorted(tc) == sorted(jc)
    for step in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {step}")
        for name in tc:
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL, err_msg=name)
        assert int(tc["t"]) == 11 + step
        if step == 3:
            break
        nxt = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
        jl, jc = m.jdecode(m.jparams, jc, jnp.asarray(nxt))
        tl, tc = m.tapi.decode_step(m.tparams, tc, {"tokens": torch.from_numpy(nxt).long()}, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_decoder_hidden_matches_jax(models, arch):
    from repro.models import transformer as jax_T

    m = models[arch]
    tokens = np.random.default_rng(2).integers(0, m.cfg.vocab_size, (1, 13)).astype(np.int32)
    want = jax.jit(lambda p, tok: jax_T.decoder_hidden(p, tok, m.jcfg))(m.jparams, jnp.asarray(tokens))
    got = T.decoder_hidden(m.tparams, torch.from_numpy(tokens).long(), m.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_jax_engine(models, arch):
    """Four requests over four slots (a wave of three, one mid-flight
    join): every request's greedy tokens equal the JAX engine's."""
    m = models[arch]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, m.cfg.vocab_size, n).astype(np.int32) for n in (6, 6, 7, 6)]

    def serve(engine, request):
        for rid, p in enumerate(prompts):
            engine.submit(request(rid=rid, prompt=p, max_new_tokens=4))
        return {c.rid: c for c in engine.run()}

    want = serve(jax_lm.ServingEngine(m.jcfg, m.jparams, max_batch=4, max_seq=24,
                                      sampler=jax_sampler.SamplerConfig(temperature=0.0)), jax_lm.Request)
    eng = ServingEngine(m.cfg, m.tparams, max_batch=4, max_seq=24, sampler=SamplerConfig(temperature=0.0),
                        device="cpu")
    got = serve(eng, Request)
    assert sorted(got) == sorted(want) == list(range(4))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].finish_reason == want[rid].finish_reason == "length"


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_router_stays_float32(models, arch):
    m = models[arch]
    want = _tree_np(m.jparams)
    got = convert.params_to_numpy(m.tparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert len(m.tparams.layers) + (m.tparams.first_layer is not None) == m.cfg.n_layers
    assert not any(p.requires_grad for p in m.tparams.parameters())

    cfg16 = dataclasses.replace(m.cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    for model in (convert.params_from_jax(want, cfg16, device="cpu"),
                  T.decoder_init(torch.Generator().manual_seed(0), cfg16)):
        for lp in model.layers:
            assert lp.ffn_kind == "moe" and lp.ffn["router"].dtype == torch.float32
            assert lp.ffn["w_gate"].dtype == torch.bfloat16
            assert lp.ffn["w_gate"].shape == (cfg16.moe_num_experts, cfg16.d_model, cfg16.moe_d_ff)
            assert ("shared" in lp.ffn) == bool(cfg16.moe_shared_experts)
        assert model.embed.dtype == torch.bfloat16
        assert (model.first_layer is not None) == bool(cfg16.dense_d_ff_first)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_launcher_on_cpu(arch, capsys):
    from repro_torch.launch import serve_lm

    out = serve_lm.main(["--arch", arch, "--requests", "3", "--prompt-len", "5", "--max-new", "4",
                         "--device", "cpu"])
    assert out["completed"] == 3 and out["generated_tokens"] == 12 and out["device"] == "cpu"
    assert f'"arch": "{arch}-reduced"' in capsys.readouterr().out


def test_write_slot_places_mla_caches(models):
    """A one-request MLA cache lands in its slot of the pool's caches
    (``ckv (L, B, S, r)``, ``krope (L, B, 1, S, dr)``, ``first_ckv (B, S,
    r)``, ``first_krope (B, 1, S, dr)``) and nowhere else."""
    from repro_torch.serving.lm import _write_slot

    m = models["deepseek-v2-lite-16b"]
    pool = T.init_cache(m.cfg, 3, 16)
    prompt = torch.arange(1, 8)[None]
    _, one = T.prefill(m.tparams, prompt, m.cfg, max_seq=16)
    _write_slot(pool, one, 1)
    assert sorted(pool) == ["ckv", "first_ckv", "first_krope", "krope", "t"]
    for name, ax in (("ckv", 1), ("krope", 1), ("first_ckv", 0), ("first_krope", 0)):
        assert pool[name].shape[ax] == 3 and one[name].shape[ax] == 1
        np.testing.assert_array_equal(pool[name].select(ax, 1).numpy(), one[name].select(ax, 0).numpy())
        for other in (0, 2):
            assert not pool[name].select(ax, other).any()
        assert one[name].select(ax, 0).any()
