"""The port's ``encdec`` family (whisper-large-v3: encoder over frame
embeddings, decoder with cross-attention) against the JAX package on the
CPU: ``layer_norm`` and ``sinusoidal_positions``, the encoder, the
decoder's hidden states, prefill with all four caches, decode, the
serving engine with frames in a request's ``extras``, the weight
conversion and the launcher.

Both packages run the reduced config in float32 (2 encoder and 2 decoder
layers, ``encoder_seq`` 16) with attention chunk 12, so that the
cross-attention pads its 16 keys to 24 as the full model pads 1500 to
2048, on the same weights: the JAX package's ``whisper_init`` at
PRNGKey(0), carried across by ``convert.params_from_jax``.  Frames are
random normal from numpy.  Tolerances: rtol/atol 1e-4 (the norm and the
positions at the full model's widths too); greedy tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import whisper as jax_W
from repro.models.registry import get_api as jax_get_api
from repro.serving import lm as jax_lm
from repro.serving import sampler as jax_sampler

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import convert, layers
from repro_torch.models import whisper as W
from repro_torch.models.registry import ModelApi, get_api
from repro_torch.serving import Request, SamplerConfig, ServingEngine
from repro_torch.serving.lm import _write_slot
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

ARCH = "whisper-large-v3"
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 24


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params, port Whisper, jitted JAX prefill and decode)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), attn_chunk=12)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), attn_chunk=12)
    japi = jax_get_api(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    jprefill = jax.jit(lambda p, tok, fr: japi.prefill(p, {"tokens": tok, "frames": fr}, jcfg, max_seq=MAX_SEQ))
    jdecode = jax.jit(lambda p, c, tok: japi.decode_step(p, c, {"tokens": tok}, jcfg))
    return jcfg, cfg, jparams, convert.params_from_jax(_tree_np(jparams), cfg, device="cpu"), jprefill, jdecode


def _frames(cfg, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 1, (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def test_layer_norm_and_sinusoidal_positions_match_jax():
    """At the full model's widths: a LayerNorm of 1280 features with gain
    and bias, float32 and bfloat16 (computed in float32, cast back), and
    the (1500, 1280) position table, sines then cosines."""
    cfg = get_config(ARCH)
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2.0, (3, 7, cfg.d_model)).astype(np.float32)
    g, b = (rng.normal(1.0, 0.1, cfg.d_model).astype(np.float32), rng.normal(0, 0.1, cfg.d_model).astype(np.float32))
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = layers.layer_norm(torch.from_numpy(x).to(dt_t), torch.from_numpy(g), torch.from_numpy(b), 1e-5)
        want = jax_layers.layer_norm(jnp.asarray(x, dt_j), jnp.asarray(g), jnp.asarray(b), 1e-5)
        assert got.dtype == dt_t
        # bfloat16: one rounding of float32 values 1e-4 apart, so at most one step (2^-8 relative) apart
        rtol = TOL["rtol"] if dt_t == torch.float32 else 2.0 ** -8
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=TOL["atol"])
    pos = layers.sinusoidal_positions(cfg.encoder_seq, cfg.d_model)
    assert pos.shape == (cfg.encoder_seq, cfg.d_model) and pos.dtype == torch.float32
    np.testing.assert_allclose(pos.numpy(), np.asarray(jax_layers.sinusoidal_positions(cfg.encoder_seq, cfg.d_model)),
                               **TOL)


def test_encode_and_decode_hidden_match_jax(model):
    jcfg, cfg, jparams, tparams, _, _ = model
    frames = _frames(cfg, 2, 1)
    memory = jax.jit(lambda p, fr: jax_W.encode(p, fr, jcfg))(jparams, jnp.asarray(frames))
    ops.reset_launch_counts()
    got = W.encode(tparams, torch.from_numpy(frames), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(memory), **TOL)

    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = jax.jit(lambda p, tok, mem: jax_W.decode_hidden(p, tok, mem, jcfg))(jparams, jnp.asarray(tokens), memory)
    hidden = W.decode_hidden(tparams, torch.from_numpy(tokens).long(), torch.from_numpy(np.array(memory)), cfg)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want), **TOL)
    assert ops.launch_counts()["flash_attention"] == 0  # the CPU runs the plain version


def test_whisper_prefill_and_decode_match_jax(model):
    """Prefill of a 13-token prompt over its frames: logits and the caches
    ``k``, ``v``, ``xk``, ``xv``; then three decode steps."""
    _, cfg, jparams, tparams, jprefill, jdecode = model
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    frames = _frames(cfg, 2, 4)
    jl, jc = jprefill(jparams, jnp.asarray(prompt), jnp.asarray(frames))
    api = get_api(cfg)
    tl, tc = api.prefill(tparams, {"tokens": torch.from_numpy(prompt).long(), "frames": torch.from_numpy(frames)},
                         cfg, max_seq=MAX_SEQ)
    assert sorted(tc) == sorted(jc) == ["k", "t", "v", "xk", "xv"]
    assert tc["xk"].shape == (cfg.n_layers, 2, cfg.n_kv_heads, cfg.encoder_seq, cfg.head_dim)
    for step in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {step}")
        for name in tc:
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL, err_msg=f"{name} step {step}")
        if step == 3:
            break
        nxt = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
        jl, jc = jdecode(jparams, jc, jnp.asarray(nxt))
        tl, tc = api.decode_step(tparams, tc, {"tokens": torch.from_numpy(nxt).long()}, cfg)
    assert int(tc["t"]) == 16


def test_whisper_engine_greedy_tokens_match_jax_engine(model):
    """Four requests with their own frames in ``extras`` (a wave of three,
    one mid-flight join): every request's greedy tokens equal the JAX
    engine's."""
    jcfg, cfg, jparams, tparams, _, _ = model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (10, 10, 11, 10)]
    frames = [_frames(cfg, 1, 10 + i)[0] for i in range(len(prompts))]

    def serve(engine, request):
        for rid, (p, fr) in enumerate(zip(prompts, frames)):
            engine.submit(request(rid=rid, prompt=p, max_new_tokens=4, extras={"frames": fr}))
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


def test_write_slot_places_cross_caches_by_batch_axis(model):
    """A one-request prefill written into slot 1 of a 3-slot pool: every
    cache entry, the cross K/V ``(L, B, Hkv, encoder_seq, hd)`` included,
    lands on the pool's batch axis (axis 1) and nowhere else."""
    _, cfg, _, tparams, _, _ = model
    api = get_api(cfg)
    pool = api.init_cache(cfg, 3, MAX_SEQ)
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 9))).long()
    _, one = api.prefill(tparams, {"tokens": prompt, "frames": torch.from_numpy(_frames(cfg, 1, 9))}, cfg,
                         max_seq=MAX_SEQ)
    _write_slot(pool, one, 1)
    for name in ("k", "v", "xk", "xv"):
        assert torch.equal(pool[name][:, 1], one[name][:, 0]), name
        assert not pool[name][:, [0, 2]].any(), name
        assert pool[name][:, 1].any(), name
    assert int(pool["t"]) == 0


def test_whisper_params_round_trip_and_bad_inputs_raise(model):
    jcfg, cfg, jparams, tparams, _, _ = model
    want = _tree_np(jparams)
    got = convert.params_to_numpy(tparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    m16 = convert.params_from_jax(want, cfg16, device="cpu")
    assert m16.dec_layers[0]["cross_attn"]["wq"].dtype == m16.enc_norm["g"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="layers"):
        convert.params_from_jax(want, dataclasses.replace(cfg, encoder_layers=3), device="cpu")

    tokens = torch.zeros((1, 5), dtype=torch.long)
    for bad in (_frames(dataclasses.replace(cfg, encoder_seq=15), 1, 0), _frames(cfg, 2, 0)):
        with pytest.raises(ValueError, match="frames of shape"):
            W.whisper_prefill(tparams, tokens, torch.from_numpy(bad), cfg)
    with pytest.raises(ValueError, match="frames of shape"):
        get_api(cfg).prefill(tparams, {"tokens": tokens}, cfg)
    assert isinstance(get_api(get_config(ARCH)), ModelApi)
    with pytest.raises(ValueError, match="unknown model family"):
        get_api(dataclasses.replace(cfg, family="conv"))


def test_serve_lm_launcher_whisper_on_cpu(capsys):
    from repro_torch.launch import serve_lm

    out = serve_lm.main(["--arch", ARCH, "--requests", "3", "--prompt-len", "10", "--max-new", "4",
                         "--device", "cpu"])
    assert out["completed"] == 3 and out["generated_tokens"] == 12 and out["device"] == "cpu"
    assert f'"arch": "{ARCH}-reduced"' in capsys.readouterr().out
