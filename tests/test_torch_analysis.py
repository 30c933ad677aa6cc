"""The port's auditor (``repro_torch.analysis``) on the CPU: findings,
the calibration audit, the kernel pass's static part, the budget
sentinel and the CLI.

* ``findings.apply_suppressions`` and ``report_to_json`` give the
  reference's (``repro.analysis.findings``) output on the same findings
  and suppressions.
* The CT pass over the reference's table (``src/repro/planning/
  calibration.json``) and over corrupted copies gives the findings of the
  reference's ``_audit_calibration`` (code, severity, site); on the
  port's committed table it gives none; each CT code fires on a corrupted
  copy (unreadable, an edited coefficient, a negative and a NaN
  coefficient, a dropped mode, a non-monotone fit).
* The kernel pass's coverage: the ten exported entries that launch a
  kernel, each named by a case; the waits, host words and error strings
  launch nothing; a case list missing an entry is KC105.  The barrier and
  broadcast lints: clean on ``kernels/csrc``, each lint fixture caught
  exactly once by its own lint, and a barrier moved under a
  thread-dependent branch of the real tick caught.
* The sentinel measures cold_compile 1, warm_execute 0, warm_tick 0.
* ``--check`` is clean against the committed baseline
  (``src/repro_torch/analysis/ANALYSIS.json``); ``--kernels`` without a
  card exits non-zero; the package's own modules import the standard
  library only.
"""

import json
from pathlib import Path

import pytest

from repro.analysis import findings as ref_findings
from repro_torch.analysis import cli, findings, kernel_check, registry

ROOT = Path(__file__).resolve().parents[1]
PORT_TABLE = ROOT / "src/repro_torch/planning/calibration.json"
REF_TABLE = ROOT / "src/repro/planning/calibration.json"

_FINDINGS = [
    ("PT001", "error", "run_em[static/K=2]/em_boundary", "float64 value(s) made by sum"),
    ("PT002", "error", "run_em[faithful/K=3]/map_iteration", "2 host read(s)"),
    ("PT005", "error", "run_em_ticked[static/K=5]/em_boundary", "device_ops 90"),
    ("KC101", "error", "kernel:em_tick/em_tick/solve/K=2/f32", "guard bytes changed"),
    ("CT004", "warning", "calibration:faithful", "mode missing"),
]
_SUPPRESSIONS = [
    ("PT001", "run_em*/em_boundary", "float64 boundary"),
    ("PT005", "run_em_ticked*", "ticked boundary"),
    ("KC102", "kernel:*", "stale: matches nothing"),
    ("CT004", "calibration:static", "another mode"),
]


def _port_and_ref(mod):
    fs = [mod.Finding(*f) for f in _FINDINGS]
    ss = [mod.Suppression(*s) for s in _SUPPRESSIONS]
    return mod.apply_suppressions(fs, ss)


def test_apply_suppressions_matches_reference():
    (pf, ps), (rf, rs) = _port_and_ref(findings), _port_and_ref(ref_findings)
    assert [f.as_dict() for f in pf] == [f.as_dict() for f in rf]
    assert [(s.code, s.site_pattern, s.reason) for s in ps] == \
        [(s.code, s.site_pattern, s.reason) for s in rs]
    assert [f.suppressed for f in pf] == [True, False, True, False, False]
    report = {"findings": [f.as_dict() for f in pf], "n": 3}
    assert findings.report_to_json(report) == ref_findings.report_to_json(report)


# ---------------------------------------------------------------------------
# The calibration audit
# ---------------------------------------------------------------------------


def _corrupt(kind, src, dst):
    if kind == "unreadable":
        dst.write_text("{not json")
        return
    table = json.loads(src.read_text())
    coeffs = table["coefficients"]
    if kind == "edited":
        coeffs["static"]["em_boundary/loops"] *= 1.5
    elif kind == "negative":
        coeffs["faithful"]["dispatch/transfer"] = -1.0e-6
    elif kind == "nan":
        coeffs["static-pallas"]["em_boundary/loops"] = float("nan")
    elif kind == "dropped_mode":
        del coeffs["faithful"]
    elif kind == "non_monotone":
        coeffs["static"]["count/loops"] = -1.0e-3
    text = json.dumps(table, indent=2, sort_keys=True, allow_nan=True) + "\n"
    dst.write_text(text)


_EXPECT = {
    "unreadable": {"CT001"},
    "edited": {"CT002"},
    "negative": {"CT002", "CT003"},
    "nan": {"CT002", "CT003"},
    "dropped_mode": {"CT002", "CT004"},
    "non_monotone": {"CT002", "CT003", "CT005"},
}


def _port_ct(path):
    fs, _ = cli.audit_calibration(lambda s: None, path)
    return sorted((f.code, f.severity, f.site) for f in fs)


def _ref_ct(monkeypatch, path):
    from repro.analysis import cli as ref_cli
    from repro.planning import costmodel as ref_costmodel

    monkeypatch.setattr(ref_costmodel, "default_table_path", lambda: Path(path))
    fs, _ = ref_cli._audit_calibration(lambda s: None)
    return sorted((f.code, f.severity, f.site) for f in fs)


def test_calibration_pass_clean_on_committed_table():
    fs, entry = cli.audit_calibration(lambda s: None)
    assert fs == []
    assert entry["platform"] == "gpu" and entry["modes"] == sorted(registry.MODES)


@pytest.mark.parametrize("kind", [None, *sorted(_EXPECT)])
def test_calibration_pass_matches_reference(kind, tmp_path, monkeypatch):
    """The reference's table as committed (no finding), and corrupted
    copies of it, each firing its CT codes."""
    path = REF_TABLE
    if kind is not None:
        path = tmp_path / "calibration.json"
        _corrupt(kind, REF_TABLE, path)
    port = _port_ct(path)
    assert port == _ref_ct(monkeypatch, path)
    assert {code for code, _, _ in port} == _EXPECT.get(kind, set())


# ---------------------------------------------------------------------------
# The kernel pass: coverage and lints
# ---------------------------------------------------------------------------

LAUNCHING = {
    "repro_fused_em_tick", "repro_em_tick_step", "repro_em_tick_step_batched",
    "repro_em_tick_step_pool", "repro_fused_map_step", "repro_map_step_iteration",
    "repro_mrf_min_energy", "repro_segment_reduce_f32", "repro_segment_reduce_ordered_f32",
    "repro_flash_attention",
}


def test_exports_launching_and_not():
    table = kernel_check.exports()
    launching = {e for ents in table.values() for e, l in ents.items() if l}
    quiet = {f"{k}:{e}" for k, ents in table.items() for e, l in ents.items() if not l}
    assert launching == LAUNCHING
    assert {"em_tick:repro_em_tick_wait", "em_tick:repro_em_tick_wait_batched",
            "em_tick:repro_em_tick_host_word", "em_tick:repro_em_tick_free_host_word"} <= quiet
    assert {f"{k}:repro_error_string" for k in table} <= quiet


def test_coverage_clean_on_tree_and_fails_without_a_case():
    fs, entry = kernel_check.coverage()
    assert fs == []
    assert set(entry["launching"]) == LAUNCHING
    assert all(entry["launching"][e] for e in LAUNCHING)
    cases = [c for c in registry.KERNEL_CASES if "repro_mrf_min_energy" not in c.entries]
    fs, _ = kernel_check.coverage(cases)
    assert [(f.code, f.site) for f in fs] == [("KC105", "kernel:mrf_energy/repro_mrf_min_energy")]


def test_lints_clean_on_kernels():
    assert kernel_check.lint_sources(sorted(kernel_check.CSRC.glob("*.cu"))) == []


@pytest.mark.parametrize("fixture,code", [("smem_race", "KC102"), ("divergent_sync", "KC103")])
def test_lint_fixture_caught_exactly_once(fixture, code):
    found = kernel_check.lint_sources([kernel_check.FIXTURES / f"{fixture}.cu"])
    assert [f.code for f in found] == [code]


def test_barrier_moved_into_thread_branch_is_caught(tmp_path):
    """Mutation of the real tick: its finalize's barrier (``take_flag``)
    under ``if (threadIdx.x == 0)``."""
    src = (kernel_check.CSRC / "em_tick.cu").read_text()
    old = "  if (threadIdx.x == 0) word = flagword::take_word(p.sync, p.gate);\n  __syncthreads();"
    assert old in src
    bad = src.replace(old, "  if (threadIdx.x == 0) {\n    word = flagword::take_word(p.sync, "
                           "p.gate);\n    __syncthreads();\n  }")
    for h in kernel_check.CSRC.glob("*.cuh"):
        (tmp_path / h.name).write_text(h.read_text())
    (tmp_path / "em_tick.cu").write_text(bad)
    found = kernel_check.lint_sources([tmp_path / "em_tick.cu"])
    assert [(f.code, f.site.split("/")[1].split(":")[0]) for f in found] == [("KC103", "take_flag")]


def test_static_kernel_pass_clean():
    fs, entry = kernel_check.audit_static()
    assert fs == []
    assert entry["fixtures_by_lint"] == {"divergent_sync": ["KC103"], "smem_race": ["KC102"]}


# ---------------------------------------------------------------------------
# Sentinel and CLI
# ---------------------------------------------------------------------------


def test_budget_sentinel_measures_one_zero_zero():
    from repro_torch.analysis import budget

    budget.reset_all()
    fs, entry = cli.audit_budgets(lambda s: None)
    assert fs == []
    assert entry["measured"] == {"cold_compile": 1, "warm_execute": 0, "warm_tick": 0}


def test_check_is_clean_against_committed_baseline(capsys):
    assert cli.main(["--check", "-q"]) == 0
    out = capsys.readouterr().out
    assert "analysis: OK" in out
    report = json.loads((ROOT / "src/repro_torch/analysis/ANALYSIS.json").read_text())
    assert report["unsuppressed_findings"] == [] and report["stale_suppressions"] == []
    assert {f["code"] for f in report["suppressed_findings"]} == {"PT001"}


def test_kernels_without_a_card_exits_nonzero(capsys):
    assert cli.main(["--kernels", "-q"]) != 0
    assert "needs a CUDA device" in capsys.readouterr().err


def test_import_stays_light():
    """The package imports the ledger and the findings only (``kernels.ops``
    imports it); the census, the kernel pass and the CLI load on use."""
    import ast

    tree = ast.parse((ROOT / "src/repro_torch/analysis/__init__.py").read_text())
    imported = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert imported == {"budget", "findings"}
    for name in ("budget", "findings", "registry"):
        tree = ast.parse((ROOT / f"src/repro_torch/analysis/{name}.py").read_text())
        mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert mods <= {"__future__", "contextlib", "dataclasses", "typing", "fnmatch", "json"}


def test_code_table_names_every_emitted_code():
    doc = findings.__doc__
    for code in ("PT001", "PT002", "PT003", "PT004", "PT005", "BG001", *(f"CT00{i}" for i in
                 range(1, 6)), *(f"KC10{i}" for i in range(1, 8))):
        assert f"``{code}``" in doc
