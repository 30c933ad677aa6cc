"""The port's launchers against the JAX package on the CPU: the op-cost
counter (``launch.op_cost``, the counterpart of ``hlo_cost``) on programs of
known cost, the roofline under the H100's figures against the reference's
``Roofline`` fed the same inputs, the input stand-ins of every cell, the
dry run of a reduced qwen2-1.5b prefill against the reference's HLO count,
the collectives of a reduced sharded train step on a fake (data=2, model=2)
mesh against a closed form from ``param_specs``, ``SegMetrics.as_dict``,
and the examples (the quickstart run at its size; no ``jax`` or ``repro``
import in the examples or the launchers).

The fake process group is started inside the test that needs it and
destroyed before it returns, so no other test sees it.
"""

import ast
import dataclasses
import itertools
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.core import metrics as jax_metrics
from repro.launch import hlo_cost
from repro.launch import roofline as jax_roofline
from repro.launch import specs as jax_specs
from repro.models.registry import get_api as jax_get_api

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.core import metrics
from repro_torch.launch import dryrun, mesh as mesh_mod, op_cost, roofline, specs
from repro_torch.models import convert
from repro_torch.parallel import sharding as SH
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

ROOT = Path(__file__).resolve().parents[1]
H100 = {"PEAK_FLOPS_BF16": 989e12, "HBM_BW": 3.35e12, "ICI_BW": 50e9}


# ---------------------------------------------------------------------------
# op_cost on programs of known cost (tests/test_dryrun.py's counterparts)
# ---------------------------------------------------------------------------


def _cost(fn, *args):
    with FakeTensorMode():
        fake = [torch.empty(a) if isinstance(a, tuple) else a for a in args]
        _, totals = op_cost.count(fn, *fake)
    return totals


def test_single_matmul_flops_exact():
    m, n, k = 32, 48, 64
    t = _cost(lambda a, b: a @ b, (m, k), (k, n))
    assert t.flops == 2 * m * n * k
    assert t.dot_flops == 2 * m * n * k
    assert t.dot_flops_by_shape == {f"float32[{m},{n}]": 2 * m * n * k}


def test_python_loop_counted_every_iteration():
    """Eager Python runs each of the 10 iterations, and each is counted:
    the trip count the reference reads from the HLO is not needed."""
    m = 64

    def loop(a, b):
        for _ in range(10):
            a = torch.tanh(a @ b)
        return a

    t = _cost(loop, (m, m), (m, m))
    assert t.dot_flops == 10 * 2 * m ** 3
    assert t.flops == 10 * (2 * m ** 3 + m * m)


def test_nested_loops_multiply():
    def nested(x):
        for _ in range(3):
            for _ in range(5):
                x = x * 2.0
        return x

    t = _cost(nested, (128,))
    assert t.flops == 3 * 5 * 128
    assert t.hbm_bytes == 3 * 5 * 2 * 128 * 4


def test_slice_write_charged_at_slice_size():
    """A write into a 32-float slice of a 4096-float buffer moves the slice
    (read the update, write the slice), not the buffer."""
    big, small = 4096, 32

    def f(buf, upd):
        for j in range(8):
            buf[j * small:(j + 1) * small] = upd
        return buf

    t = _cost(f, (big,), (small,))
    assert t.hbm_bytes == 8 * 2 * small * 4
    assert t.peak_bytes == (big + small) * 4


# ---------------------------------------------------------------------------
# roofline against the reference's, under the H100's figures
# ---------------------------------------------------------------------------


def test_hardware_constants_are_the_h100s():
    assert mesh_mod.PEAK_FLOPS_BF16 == H100["PEAK_FLOPS_BF16"]
    assert mesh_mod.HBM_BW == H100["HBM_BW"]
    assert mesh_mod.IB_BW == H100["ICI_BW"]
    assert (mesh_mod.PEAK_FLOPS_F32, mesh_mod.NVLINK_BW) == (67e12, 450e9)
    # a 16-wide axis spans two nodes of 8; (data=2, model=4) stays in one
    assert mesh_mod.axis_crosses_nodes({"data": 16, "model": 16}, "model")
    assert mesh_mod.axis_crosses_nodes({"data": 16, "model": 16}, "data")
    assert not mesh_mod.axis_crosses_nodes({"data": 2, "model": 4}, "data")
    assert mesh_mod.axis_crosses_nodes({"pod": 2, "data": 2, "model": 4}, "pod")


@pytest.mark.parametrize("case", range(4))
def test_roofline_matches_reference(monkeypatch, case):
    for name, value in H100.items():
        monkeypatch.setattr(jax_roofline, name, value)
    rng = np.random.default_rng(case)
    kw = dict(
        flops_per_chip=float(rng.uniform(1e12, 1e15)),
        hbm_bytes_per_chip=float(rng.uniform(1e9, 1e13)),
        coll_bytes_per_chip=float(rng.uniform(0, 1e11)) * (case > 0),
        n_chips=int((1, 256, 512, 256)[case]),
        model_flops=float(rng.uniform(1e14, 1e17)),
        flash_bytes_per_chip=float(rng.uniform(0, 1e9)),
        kernel_flash_bytes=float(rng.uniform(0, 2e9)),
    )
    ours = roofline.Roofline(**kw).as_dict()
    ref = jax_roofline.Roofline(**kw).as_dict()
    assert list(ours) == list(ref)
    for key in ref:
        if isinstance(ref[key], str):
            assert ours[key] == ref[key], key
        else:
            assert ours[key] == pytest.approx(ref[key], rel=1e-12, abs=0.0), key


def test_collective_term_takes_each_axis_bandwidth():
    r = roofline.Roofline(flops_per_chip=0.0, hbm_bytes_per_chip=0.0, coll_bytes_per_chip=3e9, n_chips=8,
                          model_flops=1.0, coll_bytes_by_axis={"data": 1e9, "model": 1e9, "world": 1e9},
                          mesh_shape={"data": 2, "model": 4})
    assert r.collective_s == pytest.approx(3e9 / 450e9, rel=1e-12)
    r = dataclasses.replace(r, n_chips=256, mesh_shape={"data": 16, "model": 16})
    assert r.collective_s == pytest.approx(3e9 / 50e9, rel=1e-12)


def test_model_flops_matches_reference():
    for kind, n, a, tokens in itertools.product(("train", "prefill", "decode"), (10, 1543569408),
                                               (10, 22_000_000_000), (1, 100, 1 << 20)):
        assert roofline.model_flops_for(kind, n, a, tokens) == jax_roofline.model_flops_for(kind, n, a, tokens)


def test_analytic_flash_traffic_matches_reference():
    meshes = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
    for arch, shape_name, mesh_shape in itertools.product(sorted(JAX_ARCHS), SHAPES, meshes):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for kind in ("train", "prefill", "decode"):
            ours = roofline.analytic_flash_traffic(cfg, SHAPES[shape_name], mesh_shape, kind, block_q=1024)
            ref = jax_roofline.analytic_flash_traffic(jcfg, jax_specs.SHAPES[shape_name], mesh_shape, kind)
            assert ours == ref, (arch, shape_name, mesh_shape, kind)
    assert roofline.FLASH_BLOCK_Q == 64


# ---------------------------------------------------------------------------
# input stand-ins
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert specs.runnable_cells(cfg) == jax_specs.runnable_cells(jcfg)
    assert (cfg.n_params(), cfg.active_params()) == (jcfg.n_params(), jcfg.active_params())
    for shape_name in specs.runnable_cells(cfg):
        ours = dict(_leaves(specs.input_specs(cfg, shape_name)))
        ref = dict(_leaves(jax_specs.input_specs(jcfg, shape_name)))
        assert sorted(ours) == sorted(ref), (shape_name, sorted(ours), sorted(ref))
        for path, s in ref.items():
            o = ours[path]
            assert o.shape == tuple(s.shape), (shape_name, path)
            assert str(o.dtype).replace("torch.", "") == str(np.dtype(s.dtype)), (shape_name, path)


# ---------------------------------------------------------------------------
# dry run: one device against the reference's HLO count; a fake mesh
# ---------------------------------------------------------------------------


def test_dryrun_prefill_dot_flops_match_reference_hlo():
    """A reduced qwen2-1.5b prefill at (B = 2, S = 64), one device: the
    products the port dispatches against the reference's ``hlo_cost`` of the
    same step compiled on the CPU, within 5 %."""
    b, s = 2, 64
    cfg, jcfg = get_config("qwen2-1.5b").reduced(), jax_get_config("qwen2-1.5b").reduced()
    rec = dryrun.cost_cell(cfg, ShapeSpec("prefill_64", s, b, "prefill"))

    api = jax_get_api(jcfg)
    params = jax.eval_shape(lambda k: api.init(k, jcfg), jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    fn = jax.jit(lambda p, bt: api.prefill(p, bt, jcfg, None, max_seq=s))
    ref = hlo_cost.analyze(fn.lower(params, batch).compile().as_text())
    ref_dots = sum(ref.dot_flops_by_shape.values())
    assert rec["dot_flops"] == pytest.approx(ref_dots, rel=0.05), (rec["dot_flops"], ref_dots)
    # forward attention is the kernel's on the card: its products are apart
    attn = 2 * 2 * b * cfg.n_heads * s * s * cfg.head_dim * cfg.n_layers
    assert rec["dot_flops"] - rec["non_attention_dot_flops"] == attn
    assert rec["roofline"]["n_chips"] == 1 and rec["collectives"]["total_bytes"] == 0


def _gather_closed_form(model, mesh_sizes, mesh):
    """(counts, operand bytes) by collective of one sharded train step,
    from ``param_specs`` over the reference-shaped tree."""
    specs_tree = SH.param_specs(convert.nest(convert.reference_shapes(model)), mesh)
    flat = dict(_leaves(specs_tree))
    count = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    nbytes = dict.fromkeys(count, 0)
    for name, (path, index) in convert.reference_layout(model).items():
        spec = flat[tuple(path)]
        if index is not None:
            spec = spec[1:]
        p = dict(model.named_parameters())[name]
        full = p.numel() * p.element_size()
        axes = [a for e in spec for a in reversed(SH._entry_axes(e))]
        block = full // int(np.prod([mesh_sizes[a] for a in axes] or [1]))
        for a in axes:                           # the gather, innermost axis first
            count["all-gather"] += 1
            nbytes["all-gather"] += block
            block *= mesh_sizes[a]
        cut = [a for a in axes if a != "data"]   # the gradient, cut along model, summed over data
        g = full // int(np.prod([mesh_sizes[a] for a in cut] or [1]))
        kind = "reduce-scatter" if "data" in axes else "all-reduce"
        count[kind] += 1
        nbytes[kind] += g
    # the loss's global mask count, the loss, the gradient norm: float32 scalars
    count["all-reduce"] += 3
    nbytes["all-reduce"] += 3 * 4
    return count, nbytes


def test_dryrun_fake_mesh_collectives_match_closed_form():
    import torch.distributed as dist

    cfg = get_config("qwen2-1.5b").reduced()
    shape = ShapeSpec("train_32", 32, 4, "train")
    dryrun.start_fake_group(4)
    try:
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device_type="cpu")
        rec = dryrun.cost_cell(cfg, shape, mesh)
        with FakeTensorMode():
            model = _port_model(cfg)
            want_count, want_bytes = _gather_closed_form(model, {"data": 2, "model": 2}, mesh)
    finally:
        dist.destroy_process_group()
    got = rec["collectives"]
    assert got["count_by_op"] == {k: float(v) for k, v in want_count.items()}
    assert got["bytes_by_op"] == {k: float(v) for k, v in want_bytes.items()}
    assert rec["roofline"]["n_chips"] == 4
    assert sum(got["bytes_by_axis"].values()) == got["total_bytes"]


FAMILY_ARCHS = ("qwen2-1.5b", "llava-next-34b", "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b",
                "mamba2-130m", "zamba2-2.7b", "whisper-large-v3")


@pytest.mark.parametrize("arch, kind", [(a, k) for a in FAMILY_ARCHS for k in ("train", "prefill", "decode")
                                        if not (k == "train" and a in ("qwen2-1.5b", "llava-next-34b"))])
def test_dryrun_every_family_on_a_fake_mesh(arch, kind):
    """Each family's reduced step for rank 0 of a fake (data=2, model=2)
    mesh: it runs from shapes alone, gathers its weights over the mesh,
    and a decode step's cache is the rank's block (its sequence split over
    ``model`` where ``serve_runtime`` says).  The dense train step is the
    closed-form test's."""
    import torch.distributed as dist

    cfg = get_config(arch).reduced()
    seq = 32 if kind != "decode" else 64
    shape = ShapeSpec(f"{kind}_{seq}", seq, 4, kind)
    dryrun.start_fake_group(4)
    try:
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device_type="cpu")
        rec = dryrun.cost_cell(cfg, shape, mesh)
        with FakeTensorMode():
            cell = specs.build_step(cfg, shape, mesh)
            rt = specs.serve_runtime(cfg, shape, mesh)
    finally:
        dist.destroy_process_group()
    assert rec["kind"] == kind and rec["roofline"]["n_chips"] == 4
    assert rec["dot_flops"] > 0 and rec["collectives"]["count_by_op"]["all-gather"] > 0
    assert rec["memory"]["peak_bytes_estimate"] >= rec["memory"]["argument_bytes"] > 0
    if kind == "decode":
        full = specs.input_specs(cfg, shape)["cache"]
        split = 2 if rt.seq_axis else 1
        for name, t in cell.args[1].items():
            if name in ("k", "v"):
                assert t.shape[1] == full[name].shape[1] // 2 and t.shape[3] == full[name].shape[3] // split
        assert int(cell.args[1]["t"]) == seq - 1


def _port_model(cfg):
    from repro_torch.models.registry import get_api

    return get_api(cfg).init(torch.Generator().manual_seed(0), cfg)


# ---------------------------------------------------------------------------
# metrics, examples, imports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmetrics_as_dict_matches_reference(seed):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 2, size=(24, 24))
    pred = np.where(rng.random((24, 24)) < 0.2, 1 - truth, truth)
    ours = metrics.evaluate(torch.from_numpy(pred), truth).as_dict()
    ref = jax_metrics.evaluate(pred, truth).as_dict()
    assert list(ours) == list(ref)
    assert ours == ref


def test_quickstart_example_runs_on_the_cpu():
    mod = runpy.run_path(str(ROOT / "examples" / "torch_quickstart.py"))
    out = mod["main"](["--device", "cpu"])
    assert out["result"].status in ("converged", "max_iters")
    assert out["ours"].accuracy > out["threshold"].accuracy - 0.05


PORT_FILES = (
    [ROOT / "examples" / f"torch_{n}.py" for n in ("quickstart", "segment_volume", "serve_lm", "train_lm")]
    + [ROOT / "src" / "repro_torch" / "launch" / f"{n}.py" for n in ("specs", "dryrun", "op_cost", "roofline")]
)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
