"""The port's ``vlm`` family (llava-next-34b: the dense decoder with patch
embeddings spliced into the prompt) against the JAX package on the CPU:
the splice, prefill and decode, the hidden states, the serving engine
with a request's ``extras``, the weight conversion and the launcher.

Both packages run the reduced config in float32 (8 patches, attention
chunk 16) on the same weights: the JAX package's ``decoder_init`` at
PRNGKey(0), carried across by ``convert.params_from_jax``.  Patches are
random normal from numpy.  Tolerances: logits, caches and hidden states
rtol/atol 1e-4; the splice and greedy tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_T
from repro.models.registry import get_api as jax_get_api
from repro.serving import lm as jax_lm
from repro.serving import sampler as jax_sampler

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_api
from repro_torch.serving import Request, SamplerConfig, ServingEngine

ARCH = "llava-next-34b"
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 24


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params, port Decoder, jitted JAX prefill and decode)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), logit_chunk=16, attn_chunk=16)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), logit_chunk=16, attn_chunk=16)
    japi = jax_get_api(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    jprefill = jax.jit(lambda p, tok, ve: japi.prefill(p, {"tokens": tok, "vision_embeds": ve}, jcfg,
                                                       max_seq=MAX_SEQ))
    jdecode = jax.jit(lambda p, c, tok: japi.decode_step(p, c, {"tokens": tok}, jcfg))
    return jcfg, cfg, jparams, convert.params_from_jax(_tree_np(jparams), cfg, device="cpu"), jprefill, jdecode


def _patches(cfg, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 0.02, (b, cfg.vision_patches, cfg.d_model)).astype(np.float32)


def test_vlm_splice_with_own_embeddings_is_bit_for_bit(model):
    """Patches equal to the embedding rows of the prompt's first P ids give
    the prefill (logits and caches) of the prompt without patches, bit for
    bit; the hidden states with them give its logits, and random patches
    other hidden states."""
    _, cfg, _, tparams, _, _ = model
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13))).long()
    own = tparams.embed[tokens[:, :cfg.vision_patches]].detach().clone()
    api = get_api(cfg)
    l0, c0 = api.prefill(tparams, {"tokens": tokens}, cfg, max_seq=MAX_SEQ)
    l1, c1 = api.prefill(tparams, {"tokens": tokens, "vision_embeds": own}, cfg, max_seq=MAX_SEQ)
    assert torch.equal(l0, l1) and all(torch.equal(c0[n], c1[n]) for n in c0)
    h = T.decoder_hidden(tparams, tokens, cfg, vision_embeds=own)
    h_rand = T.decoder_hidden(tparams, tokens, cfg, vision_embeds=torch.from_numpy(_patches(cfg, 2, 9)))
    np.testing.assert_allclose(T.logits_fn(tparams, cfg, h[:, -1:]).numpy(), l0.numpy(), **TOL)
    assert not torch.allclose(h, h_rand, **TOL)


def test_vlm_prefill_and_decode_match_jax(model):
    """Random patches over the first 8 of 13 prompt tokens: logits and
    caches, then three decode steps (tokens only)."""
    _, cfg, jparams, tparams, jprefill, jdecode = model
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    ve = _patches(cfg, 2, 3)
    jl, jc = jprefill(jparams, jnp.asarray(prompt), jnp.asarray(ve))
    ops.reset_launch_counts()
    api = get_api(cfg)
    tl, tc = api.prefill(tparams, {"tokens": torch.from_numpy(prompt).long(), "vision_embeds": torch.from_numpy(ve)},
                         cfg, max_seq=MAX_SEQ)
    assert ops.launch_counts()["flash_attention"] == 0
    assert sorted(tc) == sorted(jc)
    for step in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {step}")
        for name in tc:
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL, err_msg=name)
        if step == 3:
            break
        nxt = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
        jl, jc = jdecode(jparams, jc, jnp.asarray(nxt))
        tl, tc = api.decode_step(tparams, tc, {"tokens": torch.from_numpy(nxt).long()}, cfg)


def test_vlm_hidden_matches_jax_and_short_prompts_raise(model):
    jcfg, cfg, jparams, tparams, _, _ = model
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    ve = _patches(cfg, 1, 5)
    want = jax.jit(lambda p, tok, v: jax_T.decoder_hidden(p, tok, jcfg, vision_embeds=v))(
        jparams, jnp.asarray(tokens), jnp.asarray(ve))
    got = T.decoder_hidden(tparams, torch.from_numpy(tokens).long(), cfg, vision_embeds=torch.from_numpy(ve))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    short = torch.from_numpy(tokens[:, :cfg.vision_patches - 1]).long()
    with pytest.raises(ValueError, match="cannot hold"):
        T.prefill(tparams, short, cfg, vision_embeds=torch.from_numpy(ve))
    with pytest.raises(ValueError, match="cannot hold"):
        T.decoder_hidden(tparams, short, cfg, vision_embeds=torch.from_numpy(ve))
    with pytest.raises(ValueError, match="needs vision_embeds"):
        T.decoder_hidden(tparams, torch.from_numpy(tokens).long(), cfg)


def test_vlm_engine_greedy_tokens_match_jax_engine(model):
    """Four requests with their own patches in ``extras`` (a wave of three,
    one mid-flight join): every request's greedy tokens equal the JAX
    engine's."""
    jcfg, cfg, jparams, tparams, _, _ = model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (10, 10, 11, 10)]
    patches = [_patches(cfg, 1, 10 + i)[0] for i in range(len(prompts))]

    def serve(engine, request):
        for rid, (p, ve) in enumerate(zip(prompts, patches)):
            engine.submit(request(rid=rid, prompt=p, max_new_tokens=4, extras={"vision_embeds": ve}))
        return {c.rid: c for c in engine.run()}

    want = serve(jax_lm.ServingEngine(jcfg, jparams, max_batch=4, max_seq=MAX_SEQ,
                                      sampler=jax_sampler.SamplerConfig(temperature=0.0)), jax_lm.Request)
    eng = ServingEngine(cfg, tparams, max_batch=4, max_seq=MAX_SEQ, sampler=SamplerConfig(temperature=0.0),
                        device="cpu")
    got = serve(eng, Request)
    assert sorted(got) == sorted(want) == list(range(4))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].finish_reason == want[rid].finish_reason == "length"


def test_vlm_params_round_trip(model):
    _, cfg, jparams, tparams, _, _ = model
    want = _tree_np(jparams)
    got = convert.params_to_numpy(tparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert all(lp.attn_kind == "gqa" and lp.ffn_kind == "mlp" for lp in tparams.layers)
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    assert convert.params_from_jax(want, cfg16, device="cpu").layers[0].attn["wq"].dtype == torch.bfloat16


def test_serve_lm_launcher_on_cpu(capsys):
    from repro_torch.launch import serve_lm

    out = serve_lm.main(["--arch", ARCH, "--requests", "3", "--prompt-len", "10", "--max-new", "4",
                         "--device", "cpu"])
    assert out["completed"] == 3 and out["generated_tokens"] == 12 and out["device"] == "cpu"
    assert f'"arch": "{ARCH}-reduced"' in capsys.readouterr().out
    with pytest.raises(ValueError, match="cannot hold"):
        serve_lm.main(["--arch", ARCH, "--requests", "1", "--prompt-len", "5", "--device", "cpu"])
