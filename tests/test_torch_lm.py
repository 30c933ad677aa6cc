"""The port's LM serving path (dense family) against the JAX package on the
CPU: layers, the converted weights, prefill and decode, the sampler masks
and the serving engine.

Both packages run ``qwen2-1.5b.reduced()`` in float32 (attention chunk 16,
as ``tests/test_serving.py`` uses) on the same weights: the JAX package's
``decoder_init`` at PRNGKey(0), carried across by
``repro_torch.models.convert.params_from_jax``.  Tolerances: ``rms_norm``
and ``apply_rope`` rtol 1e-6; logits and the K/V cache rtol/atol 1e-4
(the port's prefill attention is the naive plain version, JAX's the
chunked scan; matmuls sum in other orders); greedy tokens and sampler
masks exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models.registry import get_api as jax_get_api
from repro.serving import lm as jax_lm
from repro.serving import sampler as jax_sampler

import repro_torch
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import dpp
from repro_torch.kernels import ops
from repro_torch.models import convert, layers
from repro_torch.models import transformer as T
from repro_torch.models.registry import ModelApi, get_api
from repro_torch.serving import Request, SamplerConfig, ServingEngine, sample_logits
from repro_torch.serving import sampler
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

TOL = dict(rtol=1e-4, atol=1e-4)
GREEDY = SamplerConfig(temperature=0.0)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    """(cfg, JAX params, port Decoder) on the same weights."""
    jcfg = dataclasses.replace(jax_get_config("qwen2-1.5b").reduced(), logit_chunk=16, attn_chunk=16)
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), logit_chunk=16, attn_chunk=16)
    jparams = jax_get_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    # Non-zero QKV biases, so that the test sees them (init sets them to 0).
    rng = np.random.default_rng(7)
    attn = dict(jparams["layers"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(rng.normal(0, 0.1, attn[name].shape).astype(np.float32))
    jparams = {**jparams, "layers": {**jparams["layers"], "attn": attn}}
    return jcfg, cfg, jparams, convert.params_from_jax(_tree_np(jparams), cfg, device="cpu")


def test_configs_are_copies_of_the_reference():
    for name, cfg in ARCHS.items():
        ref = jax_get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref.reduced())
        assert cfg.n_params() == ref.n_params()


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2.0, (2, 3, 9, 32)).astype(np.float32)
    gamma = rng.normal(1.0, 0.1, (32,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) + 5, (2, 3, 9))
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma), 1e-6).numpy(),
        np.asarray(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(gamma), 1e-6)), rtol=1e-6, atol=1e-6,
    )
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_allclose(
            layers.rope_freqs(32, theta).numpy(), np.asarray(jax_layers.rope_freqs(32, theta)), rtol=1e-6
        )
        np.testing.assert_allclose(
            layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta).numpy(),
            np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)), rtol=1e-6, atol=1e-6,
        )


def test_params_from_jax_round_trips(model):
    _, cfg, jparams, tparams = model
    want = _tree_np(jparams)
    got = convert.params_to_numpy(tparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert len(tparams.layers) == cfg.n_layers
    assert not any(p.requires_grad for p in tparams.parameters())


def test_prefill_and_decode_match_jax(model):
    jcfg, cfg, jparams, tparams = model
    japi, tapi = jax_get_api(jcfg), get_api(cfg)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcfg, max_seq=24)
    ops.reset_launch_counts()
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompt).long()}, cfg, max_seq=24)
    assert ops.launch_counts()["flash_attention"] == 0
    assert tl.shape == (2, 1, cfg.vocab_size) and tl.dtype == torch.float32
    assert tc["k"].shape == (cfg.n_layers, 2, cfg.n_kv_heads, 24, cfg.head_dim)
    for step in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)
        assert int(tc["t"]) == int(jc["t"]) == 11 + step
        if step == 3:
            break
        nxt = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
        jl, jc = japi.decode_step(jparams, jc, {"tokens": jnp.asarray(nxt)}, jcfg)
        tl, tc = tapi.decode_step(tparams, tc, {"tokens": torch.from_numpy(nxt).long()}, cfg)


def test_decoder_hidden_matches_jax(model):
    from repro.models import transformer as jax_T

    jcfg, cfg, jparams, tparams = model
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 13)).astype(np.int32)
    want = jax_T.decoder_hidden(jparams, jnp.asarray(tokens), jcfg)
    got = T.decoder_hidden(tparams, torch.from_numpy(tokens).long(), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        T.logits_fn(tparams, cfg, got).numpy(), np.asarray(jax_T.logits_fn(jparams, jcfg, want)), **TOL
    )


def _serve(engine, prompts, max_new=5, eos=None, request=Request):
    for rid, p in enumerate(prompts):
        engine.submit(request(rid=rid, prompt=p, max_new_tokens=max_new, eos_id=eos))
    return {c.rid: c for c in engine.run()}


def test_engine_greedy_tokens_match_jax_engine(model):
    """Mixed prompt lengths over four slots: a wave of three, two
    mid-flight joins and retirements; every request's greedy tokens equal
    the JAX engine's."""
    jcfg, cfg, jparams, tparams = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (6, 6, 8, 6, 9)]
    want = _serve(jax_lm.ServingEngine(jcfg, jparams, max_batch=4, max_seq=32,
                                       sampler=jax_sampler.SamplerConfig(temperature=0.0)),
                  prompts, request=jax_lm.Request)
    eng = ServingEngine(cfg, tparams, max_batch=4, max_seq=32, sampler=GREEDY, device="cpu")
    got = _serve(eng, prompts)
    assert eng.ticks < 3 * 4  # the 8- and 9-token prompts joined mid-flight
    assert sorted(got) == sorted(want) == list(range(5))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].finish_reason == want[rid].finish_reason
    assert ops.launch_counts()["flash_attention"] == 0


def test_engine_batched_results_match_single(model):
    _, cfg, _, tparams = model
    prompts = [np.arange(1, 7, dtype=np.int32), np.arange(3, 9, dtype=np.int32)]
    solo = [
        _serve(ServingEngine(cfg, tparams, max_batch=1, max_seq=32, sampler=GREEDY, device="cpu"), [p])[0].tokens
        for p in prompts
    ]
    batched = _serve(ServingEngine(cfg, tparams, max_batch=2, max_seq=32, sampler=GREEDY, device="cpu"), prompts)
    for i in range(2):
        np.testing.assert_array_equal(batched[i].tokens, solo[i])


def test_engine_batches_equal_length_requests(model):
    _, cfg, _, tparams = model
    eng = ServingEngine(cfg, tparams, max_batch=4, max_seq=32, sampler=GREEDY, device="cpu")
    comps = _serve(eng, [np.arange(1, 7, dtype=np.int32)] * 6, max_new=4)  # two waves
    assert len(comps) == 6
    assert len({tuple(c.tokens.tolist()) for c in comps.values()}) == 1


def test_engine_eos_stops_at_first_occurrence(model):
    _, cfg, _, tparams = model
    prompt = np.arange(1, 9, dtype=np.int32)
    ref = _serve(ServingEngine(cfg, tparams, max_batch=1, max_seq=32, sampler=GREEDY, device="cpu"),
                 [prompt], max_new=8)[0]
    eos = int(ref.tokens[2])
    expect = int(np.flatnonzero(ref.tokens == eos)[0]) + 1
    comp = _serve(ServingEngine(cfg, tparams, max_batch=1, max_seq=32, sampler=GREEDY, device="cpu"),
                  [prompt], max_new=8, eos=eos)[0]
    assert comp.finish_reason == "eos"
    assert len(comp.tokens) == expect <= 3
    np.testing.assert_array_equal(comp.tokens, ref.tokens[:expect])


def test_engine_continuous_admission(model):
    _, cfg, _, tparams = model
    e = ServingEngine(cfg, tparams, max_batch=2, max_seq=32, sampler=GREEDY, device="cpu")
    e.submit(Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32), max_new_tokens=10))
    e.step()           # pool_t = 6 -> 7
    e.step()           # 7 -> 8
    e.submit(Request(rid=1, prompt=np.arange(1, 9, dtype=np.int32), max_new_tokens=3))
    e.step()           # len 8 == pool_t: joins mid-flight
    assert e.slot_req[1] is not None and e.slot_req[1].rid == 1
    assert {c.rid for c in e.run()} == {0, 1}


def test_sampler_masks_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2.0, (3, 50)).astype(np.float32)
    logits[1, 7] = logits[1, 3]  # a tie
    for k in (1, 4, 17):
        np.testing.assert_array_equal(
            sampler._top_k_mask(torch.from_numpy(logits), k).numpy(),
            np.asarray(jax_sampler._top_k_mask(jnp.asarray(logits), k)),
        )
    for p in (0.1, 0.5, 0.9):
        np.testing.assert_array_equal(
            sampler._top_p_mask(torch.from_numpy(logits), p).numpy(),
            np.asarray(jax_sampler._top_p_mask(jnp.asarray(logits), p)),
        )
    np.testing.assert_array_equal(
        sampler.greedy(torch.from_numpy(logits)).numpy(),
        np.asarray(jax_sampler.greedy(jnp.asarray(logits))),
    )


def test_sampling_stays_in_top_k_and_scan_matches_jax():
    from repro.core import dpp as jax_dpp

    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
    topk = np.argsort(logits.numpy(), axis=-1)[:, -5:]
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        toks = sample_logits(logits, gen, SamplerConfig(temperature=1.0, top_k=5)).numpy()
        assert all(toks[b] in topk[b] for b in range(8))
    vals = rng.normal(size=(6, 4)).astype(np.float32)
    for exclusive in (False, True):
        np.testing.assert_allclose(
            dpp.scan_(torch.from_numpy(vals), exclusive=exclusive, axis=1).numpy(),
            np.asarray(jax_dpp.scan_(jnp.asarray(vals), exclusive=exclusive, axis=1)), rtol=1e-6,
        )


def test_other_families_and_default_device_raise(model):
    _, cfg, _, tparams = model
    for name in ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b", "llava-next-34b", "mamba2-130m", "zamba2-2.7b",
                 "whisper-large-v3"):
        assert isinstance(get_api(get_config(name)), ModelApi)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(cfg, tparams, max_batch=1, max_seq=32)
    assert repro_torch.resolve_device("cpu").type == "cpu"


def test_params_from_jax_defaults_to_the_card(model, monkeypatch):
    """Like every entry point, ``params_from_jax`` runs on the card unless
    asked for the CPU: without CUDA its default raises as
    ``resolve_device`` does."""
    _, cfg, jparams, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax(_tree_np(jparams), cfg)
    assert convert.params_from_jax(_tree_np(jparams), cfg, device="cpu").embed.device.type == "cpu"


def test_serve_lm_launcher_on_cpu(capsys):
    from repro_torch.launch import serve_lm

    out = serve_lm.main(["--requests", "3", "--prompt-len", "5", "--max-new", "4", "--device", "cpu"])
    assert out["completed"] == 3 and out["generated_tokens"] == 12 and out["device"] == "cpu"
    assert '"arch": "qwen2-1.5b-reduced"' in capsys.readouterr().out
