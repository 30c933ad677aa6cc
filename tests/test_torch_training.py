"""The port's trainer against the JAX package on the CPU: the optimizer,
the data pipeline, the train step with microbatching, the checkpoints
(read and written by either package), crash recovery and the launcher.

Models are ``qwen2-1.5b.reduced()`` (float32 unless a test says
otherwise; logit and attention chunks 16), on the port's ``init`` from a
seeded generator, carried to the JAX package's tree by
``convert.params_to_numpy``; gradients and batches are numpy draws from
a seed.  Tolerances: ``adamw_update``, ``lr_schedule`` and clipping
rtol/atol 1e-6; batches bit for bit; the train step's step-0 loss rtol
1e-5 and gradients within 1e-5 of each leaf's largest magnitude, three
steps' losses rtol 1e-4; microbatches 1 and 4 as the reference's own test
(loss rtol 1e-4, parameters rtol 2e-4); checkpoints and crash recovery
bit for bit.
"""

import dataclasses
import json
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.training import checkpoint as jax_CK
from repro.training import data as jax_data
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts

from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models.registry import get_api
from repro_torch.training import checkpoint as CK
from repro_torch.training import data as data_mod
from repro_torch.training import optimizer as opt
from repro_torch.training.fault import run_training
from repro_torch.training.train_step import TrainStepConfig, make_sharded_train_state, make_train_step
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

ARCH = "qwen2-1.5b"
TIGHT = dict(rtol=1e-6, atol=1e-6)


def _cfgs(**kw):
    kw = {"logit_chunk": 16, "attn_chunk": 16, **kw}
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _model(cfg, seed=0):
    return get_api(cfg).init(torch.Generator().manual_seed(seed), cfg).requires_grad_(True)


def _jax_tree(model):
    return jax.tree.map(jnp.asarray, convert.params_to_numpy(model))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(jnp.asarray(tree, jnp.float32))}


def _port_leaves(model, values=None):
    return {p: t.float().numpy() for p, t in convert.reference_tree(model, values).items()}


def _grads_like(model, seed):
    """Random gradients: the reference's tree (numpy) and the port's, by name."""
    rng = np.random.default_rng(seed)
    tree = {p: rng.normal(0, 1, s).astype(np.float32) for p, s in convert.reference_shapes(model).items()}
    named = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    convert.load_reference_tree(model, tree, named)
    return convert.nest(tree), named


def _batch(cfg, step, batch=4, seq=32):
    dcfg = data_mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    return data_mod.make_batch(dcfg, step)


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_adamw_update_matches_reference_with_stacked_decay():
    """Two steps on the reduced model's tree, decay 0.5: the moments, the
    master and the parameters equal the reference's; the stacked layer
    norms and QKV biases decay, ``final_norm`` does not."""
    _, cfg = _cfgs()
    model = _model(cfg)
    ocfg = opt.AdamWConfig(lr=0.05, weight_decay=0.5, grad_clip=1.0, warmup_steps=1, total_steps=10)
    jparams = _jax_tree(model)
    jstate = jax_opt.adamw_init(jparams, ocfg)
    state = opt.adamw_init(model, ocfg)
    jupdate = jax.jit(jax_opt.adamw_update, static_argnums=3)
    for seed in (1, 2):
        jgrads, grads = _grads_like(model, seed)
        jparams, jstate, jm = jupdate(jax.tree.map(jnp.asarray, jgrads), jstate, jparams, ocfg)
        model, state, m = opt.adamw_update(grads, state, model, ocfg)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state.step) == int(jstate.step) == 2
    for field in ("m", "v", "master"):
        got, want = _port_leaves(model, getattr(state, field)), _flat(getattr(jstate, field))
        for path in want:
            np.testing.assert_allclose(got[path], want[path], **TIGHT, err_msg=f"{field} {path}")
    got, want = _port_leaves(model), _flat(jparams)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], **TIGHT, err_msg=str(path))

    # zero gradients: only the decay moves a parameter
    ranks = opt.reference_ranks(model)
    assert ranks["layers.0.ln1"] == 2 and ranks["layers.0.attn.bq"] == 2 and ranks["final_norm"] == 1
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    opt.adamw_update(zeros, opt.adamw_init(model, ocfg), model, ocfg)
    moved = {n: not torch.equal(p, before[n]) for n, p in model.named_parameters()}
    assert moved["layers.0.ln1"] and moved["layers.1.attn.bk"] and moved["embed"]
    assert not moved["final_norm"]


def test_adamw_without_master_and_on_a_dict():
    ocfg = opt.AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.3, grad_clip=1e9,
                           warmup_steps=0, total_steps=10**9, min_lr_frac=1.0, use_master_fp32=False)
    params = {"w": torch.tensor([[1.0, -2.0]]), "b": torch.tensor([0.5, 1.5])}
    grads = {"w": torch.tensor([[0.5, 0.25]]), "b": torch.tensor([0.1, -0.2])}
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    want, _, _ = jax.jit(jax_opt.adamw_update, static_argnums=3)({k: jnp.asarray(v.numpy()) for k, v in grads.items()},
                                      jax_opt.adamw_init(jparams, ocfg), jparams, ocfg)
    state = opt.adamw_init(params, ocfg)
    assert state.master is None
    got, _, _ = opt.adamw_update(grads, state, params, ocfg)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TIGHT)


def test_lr_schedule_matches_reference():
    for ocfg in (opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1),
                 opt.AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=7, min_lr_frac=0.0),
                 opt.AdamWConfig()):
        for s in list(range(0, 130, 3)) + [10_000, 20_000]:
            want = float(jax_opt.lr_schedule(jnp.asarray(s), ocfg))
            assert opt.lr_schedule(s, ocfg) == pytest.approx(want, rel=1e-6, abs=1e-12), (ocfg, s)
    assert opt.lr_schedule(torch.tensor(5, dtype=torch.int32), opt.AdamWConfig(lr=1.0, warmup_steps=10)) == 0.5


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_clip_by_global_norm_matches_reference(scale):
    rng = np.random.default_rng(int(scale * 10))
    tree = {"a": rng.normal(0, scale, (3, 5)).astype(np.float32), "b": rng.normal(0, scale, (7,)).astype(np.float32)}
    want, want_norm = jax_opt.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()}, 1.0)
    got, norm = opt.clip_by_global_norm({k: torch.from_numpy(v) for k, v in tree.items()}, 1.0)
    assert float(norm) == pytest.approx(float(want_norm), rel=1e-6)
    assert float(opt.global_norm(got.values())) <= 1.0 + 1e-6
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TIGHT)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [(1000, 64, 4, 0), (151936, 40, 2, 3), (256, 8, 6, 1)])
def test_batches_equal_the_reference_bit_for_bit(vocab, seq, batch, seed):
    cfg = data_mod.DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    jcfg = jax_data.DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    for step in (0, 7):
        got, want = data_mod.make_batch(cfg, step), jax_data.make_batch(jcfg, step)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    for host in range(2 if batch % 2 == 0 else 1):
        got = data_mod.make_batch(cfg, 3, host_index=host, host_count=2 if batch % 2 == 0 else 1)
        want = jax_data.make_batch(jcfg, 3, host_index=host, host_count=2 if batch % 2 == 0 else 1)
        assert np.array_equal(got["tokens"], want["tokens"])
    it = data_mod.stream(cfg, 5)
    (s0, _), (s1, b1) = next(it), next(it)
    assert (s0, s1) == (5, 6) and np.array_equal(b1["tokens"], jax_data.make_batch(jcfg, 6)["tokens"])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _train_setup(cfg, jcfg, ocfg, seed=0):
    model = _model(cfg, seed)
    jparams = _jax_tree(model)
    ts = TrainStepConfig(optimizer=ocfg)
    jstate = {"params": jparams, "opt": jax_opt.adamw_init(jparams, ocfg)}
    state = {"params": model, "opt": opt.adamw_init(model, ocfg)}
    return (state, make_train_step(cfg, None, ts)), (jstate, jax_ts.make_train_step(jcfg, None, jax_ts.TrainStepConfig(
        optimizer=jax_opt.AdamWConfig(**dataclasses.asdict(ocfg)))))


def test_train_step_matches_reference():
    """Three steps of the port's train step and the reference's from the
    same state on the same batches.  With no clipping the first step's
    first moment is (1 - b1) times the step-0 gradient in both, so the
    gradients are compared through it."""
    jcfg, cfg = _cfgs()
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1e9)
    (state, step), (jstate, jstep) = _train_setup(cfg, jcfg, ocfg)
    losses, jlosses = [], []
    for i in range(3):
        b = _batch(cfg, i)
        state, metrics = step(state, _port_batch(b))
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        jlosses.append(float(jmetrics["loss"]))
        assert float(metrics["grad_norm"]) == pytest.approx(float(jmetrics["grad_norm"]), rel=1e-4)
        if i == 0:
            assert losses[0] == pytest.approx(jlosses[0], rel=1e-5)
            got = _port_leaves(state["params"], state["opt"].m)
            for path, w in _flat(jstate["opt"].m).items():
                assert float(np.max(np.abs(got[path] - w))) <= 1e-5 * float(np.max(np.abs(w))), path
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert int(state["opt"].step) == 3
    assert all(p.grad is None for p in state["params"].parameters())


def test_microbatch_accumulation_matches_full_batch():
    _, cfg = _cfgs()
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    batch = _port_batch(_batch(cfg, 0, batch=8))
    outs = {}
    for n_micro in (1, 4):
        ts = TrainStepConfig(optimizer=ocfg, microbatches=n_micro)
        state, _ = make_sharded_train_state(cfg, None, ts, device="cpu")
        new_state, metrics = make_train_step(cfg, None, ts)(state, batch)
        outs[n_micro] = (float(metrics["loss"]), new_state["params"].final_norm.detach().numpy().copy(),
                         float(metrics["grad_norm"]))
    assert outs[1][0] == pytest.approx(outs[4][0], rel=1e-4)
    assert outs[1][2] == pytest.approx(outs[4][2], rel=1e-4)
    np.testing.assert_allclose(outs[1][1], outs[4][1], rtol=2e-4, atol=1e-6)


def test_training_reduces_loss_quickly():
    """The reference's test: a tiny LM on the copy-task stream drops its
    loss within 30 steps."""
    _, cfg = _cfgs(logit_chunk=32, attn_chunk=32)
    ts = TrainStepConfig(optimizer=opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40, use_master_fp32=False))
    state, _ = make_sharded_train_state(cfg, None, ts, device="cpu")
    step = make_train_step(cfg, None, ts)
    losses = []
    for i in range(30):
        state, metrics = step(state, _port_batch(_batch(cfg, i, batch=8, seq=64)))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_mesh_and_grad_codec_wait_for_parallel():
    """``parallel/`` is ported: a mesh must be a DeviceMesh (the sharded
    step's tests are tests/test_torch_parallel_train.py), and without a
    mesh the codec is not used, as in the reference."""
    _, cfg = _cfgs()
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(cfg, object(), TrainStepConfig())
    state, specs = make_sharded_train_state(cfg, None, TrainStepConfig(grad_codec="int8"), device="cpu")
    assert specs is None and isinstance(state["params"], torch.nn.Module)


# ---------------------------------------------------------------------------
# checkpoints and crash recovery
# ---------------------------------------------------------------------------


def _toy_state():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": torch.arange(4).to(torch.bfloat16),
        "opt": {"step": torch.tensor(3, dtype=torch.int32)},
    }


def _train_state(cfg, seed, ocfg=opt.AdamWConfig()):
    model = _model(cfg, seed)
    return {"params": model, "opt": opt.adamw_init(model, ocfg)}


def _state_bits(state):
    return {name: CK._to_numpy(leaf)[0].tobytes() for name, leaf in CK.state_leaves(state)}


def test_checkpoint_roundtrip_and_retention():
    state = _toy_state()
    with tempfile.TemporaryDirectory() as d:
        for s in (10, 20, 30, 40):
            CK.save_checkpoint(d, s, state, keep_last=2)
        assert CK.latest_step(d) == 40
        steps = sorted(int(p.name[5:]) for p in Path(d).glob("step_*") if p.is_dir())
        assert steps == [30, 40]
        step, restored, _ = CK.restore_checkpoint(d, state)
        assert step == 40
        assert torch.equal(restored["w"], state["w"]) and restored["b"].dtype == torch.bfloat16
        assert torch.equal(restored["b"], state["b"]) and int(restored["opt"]["step"]) == 3

    # a train state in bf16: written, overwritten by another init, restored bit for bit
    _, cfg = _cfgs(param_dtype="bfloat16")
    state = _train_state(cfg, 0)
    _, grads = _grads_like(state["params"], 4)
    opt.adamw_update(grads, state["opt"], state["params"], opt.AdamWConfig())
    state["opt"] = state["opt"]._replace(step=torch.tensor(1, dtype=torch.int32))
    want = _state_bits(state)
    with tempfile.TemporaryDirectory() as d:
        CK.save_checkpoint(d, 1, state, extra={"note": "x"})
        manifest = json.loads((Path(d) / "step_00000001" / "manifest.json").read_text())
        names = [e["name"] for e in manifest["leaves"]]
        assert names[0] == "opt_step" and "params_layers_attn_wq" in names and "opt_master_embed" in names
        assert {e["dtype"] for e in manifest["leaves"] if e["name"].startswith("params_")} == {"bfloat16"}
        other = _train_state(cfg, 1)
        step, restored, extra = CK.restore_checkpoint(d, other)
        assert step == 1 and extra == {"note": "x"} and restored["params"] is other["params"]
        assert _state_bits(restored) == want


def test_checkpoint_detects_corruption():
    state = _toy_state()
    with tempfile.TemporaryDirectory() as d:
        CK.save_checkpoint(d, 5, state)
        victim = Path(d) / "step_00000005" / "w.npy"
        raw = bytearray(victim.read_bytes())
        raw[-1] ^= 0xFF
        victim.write_bytes(bytes(raw))
        with pytest.raises(IOError, match="hash mismatch"):
            CK.restore_checkpoint(d, state)


def test_checkpoint_ignores_uncommitted_and_rejects_other_shapes():
    state = _toy_state()
    with tempfile.TemporaryDirectory() as d:
        CK.save_checkpoint(d, 5, state)
        (Path(d) / "step_00000009").mkdir()
        assert CK.latest_step(d) == 5
        with pytest.raises(FileNotFoundError, match="not committed"):
            CK.restore_checkpoint(d, state, step=9)
        with pytest.raises(ValueError, match="shape mismatch"):
            CK.restore_checkpoint(d, {**state, "w": torch.zeros(4, 3)})
        with pytest.raises(KeyError, match="missing leaf"):
            CK.restore_checkpoint(d, {**state, "extra_leaf": torch.zeros(1)})
    _, cfg = _cfgs()
    with tempfile.TemporaryDirectory() as d:
        CK.save_checkpoint(d, 1, _train_state(cfg, 0))
        with pytest.raises(ValueError, match="wants"):
            CK.restore_checkpoint(d, _train_state(dataclasses.replace(cfg, n_layers=3), 0))


def test_crash_recovery_resumes_exactly():
    """Four uninterrupted steps, against a run that crashes after step 3
    (checkpoint every 2) and restarts: the restart resumes from step 2
    and steps 2-3 give the same losses and the same final state, bit for
    bit."""
    jcfg, cfg = _cfgs()
    ts = TrainStepConfig(optimizer=opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    step_fn = make_train_step(cfg, None, ts)
    make_batch = lambda i: _port_batch(_batch(cfg, i))
    quiet = dict(log_every=0, log_fn=lambda s: None)

    last = {}

    def recorded(state, batch):
        last["state"], metrics = step_fn(state, batch)
        return last["state"], metrics

    ref = run_training(step_fn=recorded, state=_train_state(cfg, 0, ts.optimizer), make_batch=make_batch,
                       num_steps=4, **quiet)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="injected failure"):
            run_training(step_fn=step_fn, state=_train_state(cfg, 0, ts.optimizer), make_batch=make_batch,
                         num_steps=4, ckpt_dir=d, ckpt_every=2, crash_at_step=3, **quiet)
        assert CK.latest_step(d) == 2
        state = _train_state(cfg, 7, ts.optimizer)
        report = run_training(step_fn=step_fn, state=state, make_batch=make_batch, num_steps=4,
                              ckpt_dir=d, ckpt_every=2, **quiet)
        assert report.resumed_from == 2 and report.last_step == 4
        assert report.losses == ref.losses[2:]
        _, final, _ = CK.restore_checkpoint(d, _train_state(cfg, 9, ts.optimizer))
    assert _state_bits(final) == _state_bits(last["state"])


def _filled_opt(model, seed):
    """AdamW state for ``model`` at step 1 with random moments and master."""
    rng = np.random.default_rng(seed)
    draw = lambda: {n: torch.from_numpy(rng.normal(0, 1, tuple(p.shape)).astype(np.float32))
                    for n, p in model.named_parameters()}
    return opt.AdamWState(step=torch.tensor(1, dtype=torch.int32), m=draw(), v=draw(), master=draw())


def test_checkpoints_cross_between_the_packages():
    """A reference checkpoint restores in the port and a port checkpoint in
    the reference, bf16 parameters and float32 moments bit for bit."""
    _, cfg = _cfgs(param_dtype="bfloat16")
    source = {"params": _model(cfg, 0)}
    source["opt"] = _filled_opt(source["params"], 5)
    # the reference's tree of the same numbers
    jax_dtypes = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    tree = lambda values: convert.nest({p: jnp.asarray(t.float().numpy()).astype(jax_dtypes[t.dtype])
                                        for p, t in convert.reference_tree(source["params"], values).items()})
    o = source["opt"]
    jfull = {"params": tree(None), "opt": jax_opt.AdamWState(step=jnp.asarray(1, jnp.int32), m=tree(o.m),
                                                             v=tree(o.v), master=tree(o.master))}
    want = {name: CK._to_numpy(leaf)[0] for name, leaf in CK.state_leaves(source)}
    with tempfile.TemporaryDirectory() as d:
        jax_CK.save_checkpoint(d, 7, jfull)
        step, state, _ = CK.restore_checkpoint(d, _train_state(cfg, 3))
        assert step == 7 and int(state["opt"].step) == 1
        got = {name: CK._to_numpy(leaf)[0] for name, leaf in CK.state_leaves(state)}
        assert got.keys() == want.keys() == {name for name, _ in jax_CK._flatten(jfull)[0]}
        assert all(got[n].dtype == want[n].dtype and np.array_equal(got[n], want[n]) for n in want)

        # the port's checkpoint, restored in the reference
        CK.save_checkpoint(d, 9, source)
        step, restored, _ = jax_CK.restore_checkpoint(d, jfull)
    assert step == 9
    for name, leaf in jax_CK._flatten(restored)[0]:
        back = np.asarray(leaf)
        back = back.view(np.uint16) if back.dtype == jnp.bfloat16 else back
        assert back.dtype == want[name].dtype and np.array_equal(back, want[name]), name


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launch_train_on_the_cpu(capsys, monkeypatch, tmp_path):
    out = launch_train.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and line["last_step"] == 3 and line["resumed_from"] is None
    assert np.isfinite(line["loss_first5_mean"]) and CK.latest_step(tmp_path) == 3
    # a second run resumes from the last commit and has nothing left to do
    again = launch_train.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32",
                               "--ckpt-dir", str(tmp_path)])
    assert again["resumed_from"] == 3 and again["last_step"] == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--steps", "1"])
