"""The port's sharded train step and elastic checkpoints on the CPU, held
to the port's single-device step and to the JAX package.

One ``run_ranks`` call on 4 spawned gloo ranks steps reduced qwen2 and
reduced qwen3-moe (float32, the data pipeline's batches, logit and
attention chunks 16) for 2 steps on the meshes (data=2, model=2) and
(pod=2, data=2), and one step through each cross-pod codec at (pod=2,
data=2); the second batch's mask differs between the data shards (a mean
of per-rank means would give another loss).  It saves the (data=2,
model=2) qwen2 state with its specs.  One call on 2 ranks restores that
save, and a save the reference wrote with specs, onto (data=2), and
runs ``testing.ranks.parallel_card`` (the card's multi-rank checks) at
reduced size.

MoE capacity is per dispatch, so a rank that dispatches its own rows
drops other tokens than one device dispatching the whole batch (in the
reference as in the port); the MoE runs take ``moe_capacity_factor`` =
E / k = 2, at which no token is dropped, so that they hold the sharding
arithmetic alone.

Tolerances: against the port's single-device step, losses and grad norms
rtol 1e-4 (``test_torch_training.py``'s against the reference); the
moments m and v within 1e-5 of each leaf's largest magnitude (its bound
for gradients, read through m); parameters and master rtol 2e-4 (its
microbatch test's) with atol 1e-2 * lr: AdamW divides each gradient
element by its running RMS, so an element whose gradient is near zero
turns the reordered float sums of the sharded gradient into a visible
difference of its step, which stays below lr.  The losses and grad
norms against the reference's single-device ``make_train_step`` rtol
1e-4; the codecs within the reference's own bounds against the
uncompressed step (loss 1e-3 absolute, grad norm 2 % for bf16 and 5 % for
int8, ``tests/_distributed_runner.py``); restored states bit for bit.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.training import checkpoint as jax_CK
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts

from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.testing import ranks
from repro_torch.training import checkpoint as CK
from repro_torch.training import data as data_mod
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainStepConfig, make_sharded_train_state, make_train_step
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

RANK_TIMEOUT_S = 240
ARCHS = {"dense": "qwen2-1.5b", "moe": "qwen3-moe-235b-a22b"}
OVERRIDES = {"logit_chunk": 16, "attn_chunk": 16}
MOE_OVERRIDES = {"moe_capacity_factor": 2.0}        # E / k: no token dropped
MESHES = {"dm": ((2, 2), ("data", "model")), "pd": ((2, 2), ("pod", "data"))}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SEED = 0
STEP_TOL = dict(rel=1e-4)
MOMENT_REL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=1e-2 * OPT["lr"])
CODEC_BOUNDS = {"bf16": 0.02, "int8": 0.05}
# testing.ranks.parallel_card, the card's multi-rank checks, at reduced size
CARD = {"reduced": True, "train": {"arch": "qwen2-1.5b", "n_layers": 2, "batch": 4, "seq": 32, "steps": 2,
                                   "optimizer": OPT},
        "ep": {"arch": "qwen3-moe-235b-a22b", "n_layers": 2, "batch": 2, "seq": 32},
        "sp": {"batch": 4, "max_seq": 64, "t": 63}}


def _overrides(arch):
    return {**OVERRIDES, **(MOE_OVERRIDES if arch == ARCHS["moe"] else {})}


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), **_overrides(arch))


def _batches(cfg):
    """The pipeline's first two batches (8 x 32); the second one's mask
    keeps all of rows 0-1, half of rows 2-3, a quarter of rows 4-5 and
    none of rows 6-7."""
    dcfg = data_mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    b0, b1 = data_mod.make_batch(dcfg, 0), data_mod.make_batch(dcfg, 1)
    keep = np.repeat([32, 16, 8, 0], 2)
    b1["mask"] = (np.arange(32)[None, :] < keep[:, None]).astype(np.float32)
    return [b0, b1]


def _single_device(arch, batches):
    cfg = _cfg(arch)
    ts = TrainStepConfig(optimizer=AdamWConfig(**OPT), seed=SEED)
    state, _ = make_sharded_train_state(cfg, None, ts, device="cpu")
    step = make_train_step(cfg, None, ts)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "leaves": {n: CK._to_numpy(t)[0] for n, t in CK.state_leaves(state)}}


def _reference(arch, batches):
    """The reference's single-device step from the port's init."""
    cfg = _cfg(arch)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **OVERRIDES)
    state, _ = make_sharded_train_state(cfg, None, TrainStepConfig(seed=SEED), device="cpu")
    jparams = jax.tree.map(jnp.asarray, convert.params_to_numpy(state["params"]))
    ocfg = jax_opt.AdamWConfig(**OPT)
    jstate = {"params": jparams, "opt": jax_opt.adamw_init(jparams, ocfg)}
    step = jax_ts.make_train_step(jcfg, None, jax_ts.TrainStepConfig(optimizer=ocfg))
    losses, norms = [], []
    for b in batches:
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms}


def _run(name, arch, mesh, batches, codec="none", **kw):
    return {"name": name, "arch": arch, "overrides": _overrides(arch), "mesh": MESHES[mesh], "codec": codec,
            "optimizer": OPT, "seed": SEED, "batches": batches, **kw}


def _jax_state_like(leaves):
    """A reference train state holding ``leaves`` (the port's leaf names)."""
    cfg = jax_get_config(ARCHS["dense"]).reduced()
    cfg = dataclasses.replace(cfg, **OVERRIDES)
    ocfg = jax_opt.AdamWConfig(**OPT)
    shapes = jax_ts.state_shape(cfg, ocfg)
    flat, treedef = jax_CK._flatten(shapes)
    return jax.tree.unflatten(treedef, [jnp.asarray(leaves[n]).view(jnp.bfloat16) if leaves[n].dtype == np.uint16
                                        else jnp.asarray(leaves[n]) for n, _ in flat])


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    cfg = _cfg(ARCHS["dense"])
    batches = _batches(cfg)
    save, ref_save = tmp / "ckpt_dm", tmp / "ckpt_ref"
    runs = [_run(f"{fam}_{mesh}", arch, mesh, batches, **({"save": str(save)} if (fam, mesh) == ("dense", "dm") else {}))
            for fam, arch in ARCHS.items() for mesh in MESHES]
    runs += [_run(f"codec_{c}", ARCHS["dense"], "pd", batches[:1], codec=c) for c in ("none", "bf16", "int8")]
    four = ranks.run_ranks(ranks.parallel_train, 4, tmp_path_factory.mktemp("four"), {"runs": runs},
                           timeout=RANK_TIMEOUT_S)

    # the reference saves the same state with its specs on a (data=2) mesh
    saved = four[0]["dense_dm"]["leaves"]
    jmesh = types.SimpleNamespace(axis_names=("data",), devices=np.empty((2,)), shape={"data": 2})
    jspecs = jax_ts.state_specs(dataclasses.replace(jax_get_config(ARCHS["dense"]).reduced(), **OVERRIDES),
                                jax_opt.AdamWConfig(**OPT), jmesh)
    jax_CK.save_checkpoint(ref_save, 2, _jax_state_like(saved), specs=jspecs, mesh=jmesh)

    restores = [dict(_run(name, ARCHS["dense"], "dm", batches, restore=str(d)), mesh=((2,), ("data",)), seed=SEED + 5)
                for name, d in (("restore_port", save), ("restore_ref", ref_save))]
    two = ranks.run_ranks(ranks.in_turn, 2, tmp_path_factory.mktemp("two"),
                          {"restore": ("parallel_train", {"runs": restores}), "card": ("parallel_card", CARD)},
                          timeout=RANK_TIMEOUT_S)
    return {"four": four, "two": two, "batches": batches, "save": save, "ref_save": ref_save, "saved": saved,
            "single": {fam: _single_device(arch, batches) for fam, arch in ARCHS.items()},
            "reference": _reference(ARCHS["dense"], batches)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fam", sorted(ARCHS))
def test_sharded_step_matches_the_single_device_step(train_ranks, fam, mesh):
    single = train_ranks["single"][fam]
    for rank, out in enumerate(train_ranks["four"]):
        run = out[f"{fam}_{mesh}"]
        assert run["step"] == 2
        assert run["losses"] == pytest.approx(single["losses"], **STEP_TOL), rank
        assert run["grad_norms"] == pytest.approx(single["grad_norms"], **STEP_TOL), rank
    leaves = train_ranks["four"][0][f"{fam}_{mesh}"]["leaves"]
    assert leaves.keys() == single["leaves"].keys()
    for name, want in single["leaves"].items():
        if name.startswith(("opt_m_", "opt_v_")):
            err = float(np.max(np.abs(leaves[name] - want)))
            assert err <= MOMENT_REL * float(np.max(np.abs(want))), (name, err)
        else:
            np.testing.assert_allclose(leaves[name], want, **PARAM_TOL, err_msg=name)


def test_sharded_step_matches_the_reference(train_ranks):
    """Loss and grad norm of both steps on both meshes against the JAX
    package's single-device step from the same weights and batches."""
    ref = train_ranks["reference"]
    for mesh in MESHES:
        run = train_ranks["four"][0][f"dense_{mesh}"]
        assert run["losses"] == pytest.approx(ref["losses"], **STEP_TOL)
        assert run["grad_norms"] == pytest.approx(ref["grad_norms"], **STEP_TOL)


def test_the_loss_is_over_the_global_mask_count(train_ranks):
    """The second batch's rows hold 64, 32, 16 and 0 tokens per (pod=2,
    data=2) rank: the mean of the ranks' means differs from the masked
    mean the step reports (the single-device loss)."""
    from repro_torch.models.registry import get_api

    cfg = _cfg(ARCHS["dense"])
    b = {k: torch.from_numpy(v) for k, v in train_ranks["batches"][1].items()}
    model = get_api(cfg).init(torch.Generator().manual_seed(SEED), cfg)
    with torch.no_grad():
        whole = float(get_api(cfg).loss(model, b, cfg))
        parts = [float(get_api(cfg).loss(model, {k: v[2 * r:2 * r + 2] for k, v in b.items()}, cfg)) for r in range(3)]
    assert abs(np.mean(parts + [0.0]) - whole) > 0.1 * whole
    got = train_ranks["four"][0]["dense_pd"]["losses"][1]
    assert got == pytest.approx(train_ranks["single"]["dense"]["losses"][1], **STEP_TOL)


@pytest.mark.parametrize("codec", sorted(CODEC_BOUNDS))
def test_codecs_at_two_pods_within_the_reference_bounds(train_ranks, codec):
    out = train_ranks["four"][0]
    none, got = out["codec_none"], out[f"codec_{codec}"]
    assert abs(got["losses"][0] - none["losses"][0]) < 1e-3
    assert abs(got["grad_norms"][0] - none["grad_norms"][0]) / none["grad_norms"][0] < CODEC_BOUNDS[codec]
    assert all(o[f"codec_{codec}"]["grad_norms"] == got["grad_norms"] for o in train_ranks["four"])


def test_checkpoint_manifest_has_the_reference_spec_strings(train_ranks):
    manifest = json.loads((train_ranks["save"] / "step_00000002" / "manifest.json").read_text())
    jmesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((2, 2)), shape={"data": 2, "model": 2})
    jcfg = dataclasses.replace(jax_get_config(ARCHS["dense"]).reduced(), **OVERRIDES)
    flat, _ = jax_CK._flatten(jax_ts.state_specs(jcfg, jax_opt.AdamWConfig(**OPT), jmesh))
    want = {n: jax_CK._spec_to_str(s) for n, s in flat}
    assert {e["name"]: e["spec"] for e in manifest["leaves"]} == want
    assert train_ranks["four"][0]["dense_dm"]["spec_strings"] == want
    assert manifest["mesh_shape"] == {"data": 2, "model": 2}


@pytest.mark.parametrize("which", ["restore_port", "restore_ref"])
def test_checkpoint_restores_onto_another_mesh(train_ranks, which):
    """A (data=2, model=2) save, and the reference's save of the same state,
    restored onto (data=2): every leaf equal, on both ranks."""
    saved = train_ranks["saved"]
    for out in train_ranks["two"]:
        assert out["restore"][which]["step"] == 2
    leaves = train_ranks["two"][0]["restore"][which]["leaves"]
    assert leaves.keys() == saved.keys()
    assert all(leaves[n].dtype == saved[n].dtype and np.array_equal(leaves[n], saved[n]) for n in saved)


def test_checkpoint_restores_onto_one_device_and_into_the_reference(train_ranks):
    saved = train_ranks["saved"]
    like, _ = make_sharded_train_state(_cfg(ARCHS["dense"]), None, TrainStepConfig(optimizer=AdamWConfig(**OPT),
                                                                                   seed=SEED + 3), device="cpu")
    step, state, _ = CK.restore_checkpoint(train_ranks["save"], like)
    got = {n: CK._to_numpy(t)[0] for n, t in CK.state_leaves(state)}
    assert step == 2 and got.keys() == saved.keys()
    assert all(np.array_equal(got[n], saved[n]) for n in saved)
    step, restored, _ = jax_CK.restore_checkpoint(train_ranks["save"], _jax_state_like(saved))
    assert step == 2
    for name, leaf in jax_CK._flatten(restored)[0]:
        back = np.asarray(leaf)
        back = back.view(np.uint16) if back.dtype == jnp.bfloat16 else back
        assert np.array_equal(back, saved[name]), name


def test_the_card_checks_on_two_ranks(train_ranks):
    """``testing.parallel_checks`` through ``ranks.parallel_card`` (what
    ``chip_smoke.py`` runs on two cards) at reduced size: the (data=2)
    step against each rank's single-device step (rtol 1e-4, parameters
    within 1e-2 * lr), EP on (model=2) against every expert on one rank
    (loss rtol 1e-5, gradients within 1e-5), SP decode within 2e-4 with
    the cache slices bit for bit."""
    for out in train_ranks["two"]:
        card = out["card"]
        tr, ep = card["train"], card["ep"]
        assert tr["loss_rel_diff"] <= 1e-4 and tr["grad_norm_rel_diff"] <= 1e-4, tr
        assert tr["param_max_abs_diff"] <= 1e-2 * OPT["lr"], tr
        assert ep["expert_leaves_cut"] == 6 and ep["grads"] == 23, ep
        assert abs(ep["loss_ep"] - ep["loss"]) <= 1e-5 * abs(ep["loss"]) and ep["max_abs_grad_diff"] <= 1e-5, ep
        for kind in ("gqa", "mla"):
            assert card["sp"][kind]["max_abs_err"] <= 2e-4 and card["sp"][kind]["cache_max_abs_err"] == 0.0, card["sp"]


def test_mesh_and_codec_arguments_are_checked():
    cfg = _cfg(ARCHS["dense"])
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(cfg, object(), TrainStepConfig())
    with pytest.raises(ValueError, match="grad_codec"):
        make_sharded_train_state(cfg, None, TrainStepConfig(grad_codec="fp4"), device="cpu")
