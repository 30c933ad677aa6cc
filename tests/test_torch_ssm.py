"""The port's Mamba2 families (``ssm``: mamba2-130m, ``hybrid``:
zamba2-2.7b) against the JAX package on the CPU: the chunked SSD in both
inter-chunk forms with its states, the recurrent decode step, prefill and
decode of whole models, the serving engine, the weight conversion and the
launcher.

Both packages run the reduced configs in float32 (attention chunk 16, as
``tests/test_torch_lm.py`` uses) on the same weights: the JAX package's
``init`` at PRNGKey(0), with ``conv_b``, ``dt_bias``, ``d_skip`` and
``out_norm`` redrawn from numpy (init sets them to constants), carried
across by ``repro_torch.models.convert.params_from_jax``.  Tolerances:
single blocks rtol/atol 1e-5, whole models 1e-4, greedy tokens exactly.
JAX's functions are jitted once per shape.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mamba_lm as jax_MB
from repro.models import ssm as jax_S
from repro.models import zamba as jax_Z
from repro.models.registry import get_api as jax_get_api
from repro.serving import lm as jax_lm
from repro.serving import sampler as jax_sampler

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import convert, layers
from repro_torch.models import mamba_lm as MB
from repro_torch.models import ssm as S
from repro_torch.models import zamba as Z
from repro_torch.models.registry import get_api
from repro_torch.serving import Request, SamplerConfig, ServingEngine

ARCHS = ("mamba2-130m", "zamba2-2.7b")
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 40


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), logit_chunk=16, attn_chunk=16, **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), logit_chunk=16, attn_chunk=16, **kw)
    return jcfg, cfg


def _perturb(mamba: dict, seed: int) -> dict:
    """A Mamba2 parameter dict (stacked or not) with the leaves that init
    sets to constants redrawn from numpy."""
    rng = np.random.default_rng(seed)
    out = dict(mamba)
    for name, mean, std in (("conv_b", 0.0, 0.1), ("dt_bias", 0.0, 0.5), ("d_skip", 1.0, 0.3),
                            ("out_norm", 1.0, 0.1)):
        out[name] = jnp.asarray(rng.normal(mean, std, mamba[name].shape).astype(np.float32))
    return out


def _block(tree) -> torch.nn.ParameterDict:
    return torch.nn.ParameterDict({k: layers.frozen(torch.tensor(np.asarray(v))) for k, v in tree.items()})


class Model:
    """One reduced configuration in both packages, JAX's entry points jitted."""

    def __init__(self, arch):
        self.jcfg, self.cfg = _cfgs(arch)
        self.japi, self.tapi = jax_get_api(self.jcfg), get_api(self.cfg)
        jparams = self.japi.init(jax.random.PRNGKey(0), self.jcfg)
        key = "layers" if self.cfg.family == "ssm" else "mamba_layers"
        jparams[key] = {**jparams[key], "mamba": _perturb(jparams[key]["mamba"], 5)}
        self.jparams = jparams
        self.tparams = convert.params_from_jax(_tree_np(jparams), self.cfg, device="cpu")
        jcfg = self.jcfg
        self.jprefill = jax.jit(lambda p, tok: self.japi.prefill(p, {"tokens": tok}, jcfg, max_seq=MAX_SEQ))
        self.jdecode = jax.jit(lambda p, c, tok: self.japi.decode_step(p, c, {"tokens": tok}, jcfg))


@pytest.fixture(scope="module")
def models():
    return {arch: Model(arch) for arch in ARCHS}


# ---------------------------------------------------------------------------
# the SSD block
# ---------------------------------------------------------------------------


def _ssd_case(groups: int, seed: int = 0):
    """(JAX cfg, port cfg, JAX block params, port block params) of one
    mamba2 block with ``groups`` B/C groups."""
    jcfg, cfg = _cfgs("mamba2-130m", ssm_groups=groups)
    jp = _perturb(jax_S.mamba2_init(jax.random.PRNGKey(seed), jcfg, jnp.float32), seed + 1)
    return jcfg, cfg, jp, _block(jp)


SSD_CASES = [
    # (inter_chunk, S, ssm_groups): 4 chunks, below one chunk, two groups
    ("scan", 64, 1), ("assoc", 64, 1),
    ("scan", 8, 1), ("assoc", 8, 1),
    ("scan", 64, 2), ("assoc", 64, 2),
]


@pytest.mark.parametrize("inter_chunk,s,groups", SSD_CASES)
def test_ssd_forward_matches_jax(inter_chunk, s, groups):
    jcfg, cfg, jp, tp = _ssd_case(groups)
    x = np.random.default_rng(1).normal(0, 1.0, (2, s, cfg.d_model)).astype(np.float32)
    fwd = jax.jit(functools.partial(jax_S.ssd_forward, cfg=jcfg, inter_chunk=inter_chunk, return_state=True))
    want = fwd(jp, jnp.asarray(x))
    got = S.ssd_forward(tp, torch.from_numpy(x), cfg, inter_chunk=inter_chunk, return_state=True)
    assert got[1].shape == (2, cfg.ssm_conv - 1, cfg.d_inner + 2 * groups * cfg.ssm_state)
    assert got[2].shape == (2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim) and got[2].dtype == torch.float32
    for name, g, w in zip(("out", "conv_state", "ssm_state"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL, err_msg=name)
    plain = S.ssd_forward(tp, torch.from_numpy(x), cfg, inter_chunk=inter_chunk)
    np.testing.assert_array_equal(plain.numpy(), got[0].numpy())


@pytest.mark.parametrize("groups", (1, 2))
def test_ssd_assoc_matches_scan(groups):
    """The doubling scan over 6 chunks (not a power of two) against the
    chunk loop, in the port."""
    _, cfg, _, tp = _ssd_case(groups, seed=3)
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1.0, (2, 96, cfg.d_model)).astype(np.float32))
    scan = S.ssd_forward(tp, x, cfg, inter_chunk="scan", return_state=True)
    assoc = S.ssd_forward(tp, x, cfg, inter_chunk="assoc", return_state=True)
    for name, a, b in zip(("out", "conv_state", "ssm_state"), scan, assoc):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **BLOCK_TOL, err_msg=name)


def test_ssd_decode_matches_jax():
    """Three recurrent steps from the states of an 8-token forward (the
    conv ring zero-padded in front: S = 8 > K - 1, and a 2-token one where
    it is)."""
    jcfg, cfg, jp, tp = _ssd_case(2, seed=4)
    rng = np.random.default_rng(5)
    jdec = jax.jit(functools.partial(jax_S.ssd_decode, cfg=jcfg))
    for s in (8, 2):
        x = rng.normal(0, 1.0, (2, s, cfg.d_model)).astype(np.float32)
        _, jconv, jssm = jax.jit(functools.partial(jax_S.ssd_forward, cfg=jcfg, return_state=True))(
            jp, jnp.asarray(x))
        _, tconv, tssm = S.ssd_forward(tp, torch.from_numpy(x), cfg, return_state=True)
        if s < cfg.ssm_conv - 1:
            assert not tconv[:, :cfg.ssm_conv - 1 - s].any()
        for step in range(3):
            xt = rng.normal(0, 1.0, (2, 1, cfg.d_model)).astype(np.float32)
            jo, jconv, jssm = jdec(jp, jnp.asarray(xt), conv_state=jconv, ssm_state=jssm)
            to, tconv, tssm = S.ssd_decode(tp, torch.from_numpy(xt), cfg, tconv, tssm)
            for name, g, w in (("out", to, jo), ("conv", tconv, jconv), ("ssm", tssm, jssm)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL, err_msg=f"S={s} step {step} {name}")


def test_ssd_bad_length_raises_where_jax_asserts():
    jcfg, cfg, jp, tp = _ssd_case(1)
    x = np.zeros((1, cfg.ssm_chunk + 4, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jax_S.ssd_forward(jp, jnp.asarray(x), jcfg)
    for inter_chunk in S.INTER_CHUNK:
        with pytest.raises(ValueError, match="multiple of the chunk"):
            S.ssd_forward(tp, torch.from_numpy(x), cfg, inter_chunk=inter_chunk)
    with pytest.raises(ValueError, match="inter_chunk"):
        S.ssd_forward(tp, torch.from_numpy(x[:, :8]), cfg, inter_chunk="parallel")


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(models, arch):
    """Prefill over 32 tokens (two chunks): logits and every cache, then
    three decode steps."""
    m = models[arch]
    cfg = m.cfg
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    jl, jc = m.jprefill(m.jparams, jnp.asarray(prompt))
    ops.reset_launch_counts()
    tl, tc = m.tapi.prefill(m.tparams, {"tokens": torch.from_numpy(prompt).long()}, cfg, max_seq=MAX_SEQ)
    assert ops.launch_counts()["flash_attention"] == 0
    assert tl.shape == (2, 1, cfg.vocab_size) and tl.dtype == torch.float32
    assert sorted(tc) == sorted(jc) == (["conv", "ssm", "t"] if cfg.family == "ssm" else
                                        ["conv", "k", "ssm", "t", "v"])
    assert tc["ssm"].dtype == torch.float32 and tc["conv"].dtype == torch.float32
    for step in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {step}")
        for name in tc:
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL, err_msg=name)
        assert int(tc["t"]) == 32 + step
        if step == 3:
            break
        nxt = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
        jl, jc = m.jdecode(m.jparams, jc, jnp.asarray(nxt))
        tl, tc = m.tapi.decode_step(m.tparams, tc, {"tokens": torch.from_numpy(nxt).long()}, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_matches_jax(models, arch):
    m = models[arch]
    tokens = np.random.default_rng(2).integers(0, m.cfg.vocab_size, (1, 16)).astype(np.int32)
    if m.cfg.family == "ssm":
        want = jax.jit(lambda p, tok: jax_MB.mamba_hidden(p, tok, m.jcfg))(m.jparams, jnp.asarray(tokens))
        got = MB.mamba_hidden(m.tparams, torch.from_numpy(tokens).long(), m.cfg)
    else:
        want = jax.jit(lambda p, tok: jax_Z.zamba_hidden(p, tok, m.jcfg))(m.jparams, jnp.asarray(tokens))
        got = Z.zamba_hidden(m.tparams, torch.from_numpy(tokens).long(), m.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_longer_prefill(models, arch):
    """Prefill over S + 3 tokens against prefill over S and 3 decode steps
    of the next tokens (the chunked SSD and the recurrent step are one
    function), in the port."""
    m = models[arch]
    cfg = m.cfg
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16))).long()
    want, _ = m.tapi.prefill(m.tparams, {"tokens": prompt}, cfg, max_seq=MAX_SEQ)
    logits, cache = m.tapi.prefill(m.tparams, {"tokens": prompt[:, :13]}, cfg, max_seq=MAX_SEQ)
    for i in range(13, 16):
        logits, cache = m.tapi.decode_step(m.tparams, cache, {"tokens": prompt[:, i:i + 1]}, cfg)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **TOL)


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
def test_params_round_trip_and_ssm_params_stay_float32(models, arch):
    m = models[arch]
    want = _tree_np(m.jparams)
    got = convert.params_to_numpy(m.tparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert not any(p.requires_grad for p in m.tparams.parameters())
    bad = dataclasses.replace(m.cfg, n_layers=m.cfg.n_layers + 2)
    with pytest.raises(ValueError, match="layers"):
        convert.params_from_jax(want, bad, device="cpu")

    cfg16 = dataclasses.replace(m.cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    for model in (convert.params_from_jax(want, cfg16, device="cpu"),
                  get_api(cfg16).init(torch.Generator().manual_seed(0), cfg16)):
        mamba_layers = model.layers if cfg16.family == "ssm" else model.mamba_layers
        assert len(mamba_layers) == cfg16.n_layers
        for lp in mamba_layers:
            for name, t in lp.mamba.items():
                assert t.dtype == (torch.float32 if name in S.FLOAT32_PARAMS else torch.bfloat16), name
        assert model.embed.dtype == torch.bfloat16
        if cfg16.family == "hybrid":  # one shared block, not one per application
            assert sum(isinstance(mod, Z.SharedBlock) for mod in model.modules()) == 1
            assert model.shared.attn["wq"].dtype == torch.bfloat16


def test_write_slot_places_ssm_and_app_caches(models):
    """A one-request Zamba cache lands in its slot of the pool's caches
    (``conv (L, B, K-1, C)``, ``ssm (L, B, H, N, P)``, ``k``/``v``
    ``(n_apps, B, Hkv, S, hd)``) and nowhere else."""
    from repro_torch.serving.lm import _write_slot

    m = models["zamba2-2.7b"]
    pool = Z.zamba_init_cache(m.cfg, 3, 16)
    prompt = torch.arange(1, 8)[None]
    _, one = Z.zamba_prefill(m.tparams, prompt, m.cfg, max_seq=16)
    _write_slot(pool, one, 1)
    assert sorted(pool) == ["conv", "k", "ssm", "t", "v"]
    assert pool["k"].shape[0] == Z._n_apps(m.cfg) == 2
    for name in ("conv", "ssm", "k", "v"):
        assert pool[name].shape[1] == 3 and one[name].shape[1] == 1
        np.testing.assert_array_equal(pool[name][:, 1].numpy(), one[name][:, 0].numpy())
        for other in (0, 2):
            assert not pool[name][:, other].any()
        assert one[name][:, 0].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_launcher_on_cpu(arch, capsys):
    from repro_torch.launch import serve_lm

    out = serve_lm.main(["--arch", arch, "--requests", "3", "--prompt-len", "8", "--max-new", "4",
                         "--device", "cpu"])
    assert out["completed"] == 3 and out["generated_tokens"] == 12 and out["device"] == "cpu"
    assert f'"arch": "{arch}-reduced"' in capsys.readouterr().out
    with pytest.raises(ValueError, match="multiple of the chunk"):
        serve_lm.main(["--arch", arch, "--requests", "1", "--prompt-len", "17", "--device", "cpu"])
