"""``python -m repro_torch.analysis``: audit the port's EM drivers and
kernels (counterpart of ``repro.analysis.cli``).

Four passes, one deterministic report (no timings):

1. **census**: every (driver, mode, K) of ``registry`` solved on the CPU
   at the registry's synthetic plan under
   :func:`repro_torch.analysis.census.take`; per scope the counts of an
   instance (device ops, scatters, gathers, launches, host reads,
   host-to-device copies) against the declared budgets (PT codes).
2. **kernel pass** (:mod:`repro_torch.analysis.kernel_check`): on any host
   the static part (launch coverage of every exported C entry, the
   barrier and broadcast lints, the lint fixtures); with ``--kernels`` on
   the card the cases under ``compute-sanitizer`` (or its guard fallback)
   and the fixtures.  ``--kernels`` without a CUDA device exits non-zero.
3. **budget sentinel**: one tiny scenario in the default mode
   (``static-pallas``, whose cold compile builds a workspace) against
   ``budget.BUDGETS``: ``cold_compile`` exactly 1, ``warm_execute`` and
   ``warm_tick`` 0 (BG001).
4. **calibration audit** of ``planning/calibration.json`` (CT codes).

Exit status 0 when every finding is suppressed and, under ``--check``,
nothing is stale and the baseline ``analysis/ANALYSIS.json`` matches;
``--write`` regenerates the baseline.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from . import budget as budget_mod
from . import census as census_mod
from . import kernel_check
from . import registry
from .findings import Finding, apply_suppressions, report_to_json

__all__ = ["scenario", "run_census", "audit_census", "audit_budgets", "audit_calibration",
           "run_audit", "main"]

BASELINE = Path(__file__).resolve().parent / "ANALYSIS.json"


def _images(k: int, n: int, size: int, device="cpu"):
    from repro_torch.core import synthetic

    if k == 2:
        return synthetic.make_synthetic_volume(seed=0, n_slices=n, shape=(size, size),
                                               device=device).images
    return synthetic.make_kary_volume(seed=0, n_slices=n, shape=(size, size),
                                      n_phases=min(k, 3), device=device).images


def scenario(driver: str, mode: str, k: int, *, device="cpu", size: int = registry.AUDIT_SIZE,
             grid: int = registry.AUDIT_GRID, batch: int = registry.AUDIT_BATCH,
             max_em_iters: int = registry.AUDIT_MAX_EM_ITERS,
             max_map_iters: int = registry.AUDIT_MAX_MAP_ITERS):
    """A solve of ``driver`` at the registry's synthetic plan on
    ``device``, as a function of no arguments (planned and padded here;
    each call solves again on the same workspace)."""
    from repro_torch import api
    from repro_torch.core.pmrf import em

    cfg = api.ExecutionConfig(mode=mode, n_labels=k, overseg_grid=(grid, grid),
                              max_em_iters=max_em_iters, max_map_iters=max_map_iters)
    seg = api.Segmenter(cfg, device=device)
    emc = cfg.em_config()
    n = 1 if driver == "run_em" else batch
    plans = [seg.plan(img) for img in _images(k, n, size, device)]
    bucket = plans[0].bucket
    for p in plans[1:]:
        bucket = tuple(max(a, b) for a, b in zip(bucket, p.bucket))
    shape = em.TickShape(bucket[0], bucket[1], bucket[2] + 1, k)
    if driver == "run_em":
        args = seg.lane_inputs(plans[0])
        ws = em.make_workspace(shape, emc, device=device) if mode == "static-pallas" else None
        return lambda: em.run_em(*args, emc, workspace=ws)
    if driver == "run_em_batched":
        args = seg.stacked_inputs(plans, bucket=bucket, seeds=range(n))
        ws = em.make_workspace(shape, emc, device=device, batch=n)
        return lambda: em.run_em_batched(*args, emc, workspace=ws)
    if driver == "run_em_ticked":
        lanes = [seg.lane_state(p, bucket=bucket, seed=b) for b, p in enumerate(plans)]
        ws = em.make_workspace(shape, emc, device=device, batch=n, pool=True)

        def solve():
            state = em.blank_tick_state(ws)
            for b, lane in enumerate(lanes):
                em.init_tick_lane(state, b, *lane)
            while not all(state.done):
                em.run_em_ticked(state, emc, registry.AUDIT_TICK_ITERS)
            return state

        return solve
    raise ValueError(f"unknown driver {driver!r}; have {registry.DRIVERS}")


def run_census(driver: str, mode: str, k: int, **kw) -> Dict[str, Dict]:
    """The census summary of one warm solve of :func:`scenario` (a first
    solve runs before it, outside the census)."""
    solve = scenario(driver, mode, k, **kw)
    solve()
    with census_mod.take() as cen:
        solve()
    return cen.summary()


def audit_census(log) -> Tuple[List[Finding], List[Dict]]:
    findings: List[Finding] = []
    entries: List[Dict] = []
    for mode in registry.MODES:
        for k in registry.KS:
            for driver in registry.DRIVERS:
                site = f"{driver}[{mode}/K={k}]"
                log(f"  census {site}")
                summary = run_census(driver, mode, k)
                b = registry.census_budget(driver, mode)
                fs = census_mod.check(summary, site, b)
                findings.extend(fs)
                entries.append({"driver": driver, "mode": mode, "k": k, "census": summary,
                                "budget": b, "findings": [f.as_dict() for f in sorted(fs)]})
    return findings, entries


def audit_budgets(log) -> Tuple[List[Finding], Dict]:
    """The sentinel: cold compile, warm execute and a warm tick of one
    32x32 plan in mode ``static-pallas`` on the CPU."""
    from repro_torch import api
    from repro_torch.core.pmrf import em

    log("  budget sentinel (static-pallas, 32x32)")
    findings: List[Finding] = []
    measured: Dict[str, int] = {}
    seg = api.Segmenter(api.ExecutionConfig(mode="static-pallas", max_em_iters=2,
                                            max_map_iters=2, overseg_grid=(4, 4)), device="cpu")
    plan = seg.plan(_images(2, 1, registry.AUDIT_SIZE)[0])

    def run(phase, fn, exact):
        b = budget_mod.budget_for(phase)
        before = budget_mod.LEDGER.total(b.section)
        try:
            with budget_mod.expect(phase):
                fn()
        except budget_mod.BudgetExceeded as exc:
            findings.append(Finding("BG001", "error", f"budget:{phase}", str(exc)))
        measured[phase] = budget_mod.LEDGER.total(b.section) - before
        if measured[phase] < exact:  # a sentinel that saw no build checks nothing
            findings.append(Finding("BG001", "error", f"budget:{phase}",
                                    f"phase {phase!r} used {measured[phase]} {b.section} "
                                    f"event(s); the sentinel expects exactly {exact}"))

    run("cold_compile", lambda: seg.execute(plan), 1)
    run("warm_execute", lambda: seg.execute(plan), 0)
    exe = seg.compile_ticked(plan, batch=2, tick_iters=2)
    state = seg.ticked_pool(plan, batch=2)
    em.init_tick_lane(state, 0, *seg.lane_state(plan))
    run("warm_tick", lambda: exe(state), 0)
    declared = [{"phase": b.phase, "section": b.section, "max_delta": b.max_delta,
                 "note": b.note} for b in budget_mod.BUDGETS]
    return findings, {"declared": declared, "measured": measured}


def audit_calibration(log, path: Optional[Path] = None) -> Tuple[List[Finding], Dict]:
    """The CT pass over a calibration table (the checked-in one by
    default): readable, reproducible from its own observations, finite
    non-negative coefficients for every audited mode, and predictions
    monotone along the probe ladders."""
    from repro_torch.planning import costmodel as planning

    log("  calibration table audit")
    path = Path(path) if path is not None else planning.default_table_path()
    findings: List[Finding] = []
    entry: Dict = {"path": "src/repro_torch/planning/calibration.json"
                   if path == planning.default_table_path() else path.name}
    try:
        table = planning.load_table(path)
    except (OSError, ValueError, KeyError) as exc:
        findings.append(Finding("CT001", "error", "calibration:table",
                                f"unreadable calibration table: {type(exc).__name__}"))
        return findings, entry
    entry.update({
        "platform": table.get("meta", {}).get("platform"),
        "observations": len(table.get("observations", [])),
        "modes": sorted(table.get("coefficients", {})),
        "serial_frac": table.get("width", {}).get("serial_frac"),
        "iter_cv": table.get("priors", {}).get("iter_cv"),
    })
    refit = planning.fit_table(table["observations"], table["meta"])
    if planning.table_to_json(refit) != path.read_text():
        findings.append(Finding(
            "CT002", "error", "calibration:table",
            "stored coefficients do not reproduce from the stored observations (stale fit "
            "or hand edit); regenerate with python -m repro_torch.planning.calibrate --refit"))
    for mode, coeffs in sorted(table.get("coefficients", {}).items()):
        for name, v in sorted(coeffs.items()):
            if not (isinstance(v, (int, float)) and math.isfinite(v) and v >= 0):
                findings.append(Finding("CT003", "error", f"calibration:{mode}/{name}",
                                        f"coefficient {v!r} is not a finite non-negative number"))
    for mode in registry.MODES:
        if mode not in table.get("coefficients", {}):
            findings.append(Finding("CT004", "warning", f"calibration:{mode}",
                                    "mode missing from the calibration grid; its predictions "
                                    "borrow another mode's coefficients"))
    model = planning.CostModel(table)
    probe = registry.CALIBRATION_PROBE_BUCKETS
    for mode in registry.MODES:
        ladders = {
            "capacity": ([model.predict_solve(mode=mode, bucket=b) for b in probe],
                         f"predicted solve seconds not monotone over the bucket ladder {probe}"),
            "K": ([model.predict_solve(mode=mode, bucket=probe[1], n_labels=k)
                   for k in registry.KS],
                  f"predicted solve seconds not monotone over K={registry.KS}"),
            "width": ([model.predict_batched(mode=mode, bucket=probe[1], width=w)
                       for w in registry.CALIBRATION_PROBE_WIDTHS],
                      "predicted lockstep seconds not monotone over widths "
                      f"{registry.CALIBRATION_PROBE_WIDTHS}"),
        }
        for ladder, (ys, msg) in ladders.items():
            if any(b < a for a, b in zip(ys, ys[1:])):
                findings.append(Finding("CT005", "error", f"calibration:{mode}/{ladder}", msg))
    return findings, entry


def run_audit(verbose: bool = True, kernels: bool = False) -> Dict:
    """Run every pass; returns the (deterministic) report."""
    log = (lambda s: print(s, file=sys.stderr)) if verbose else (lambda s: None)
    log("census:")
    pt_findings, pt_entries = audit_census(log)
    log("kernel pass:")
    kc_findings, kc_entry = kernel_check.audit_static()
    if kernels:
        card_findings, card = kernel_check.audit_card(log)
        kc_findings += card_findings
        kc_entry["card"] = card
    else:
        kc_entry["card"] = ("not run: the static part only (coverage, lints, lint fixtures); "
                            "--kernels runs the cases on the card")
    budget_mod.reset_all()  # the census's own workspace builds do not count
    log("budget sentinel:")
    bg_findings, budgets = audit_budgets(log)
    log("calibration audit:")
    ct_findings, calibration = audit_calibration(log)

    found = sorted(pt_findings + kc_findings + bg_findings + ct_findings)
    found, stale = apply_suppressions(found, registry.SUPPRESSIONS)
    unsuppressed = [f for f in found if not f.suppressed]
    return {
        "version": 1,
        "matrix": {
            "size": registry.AUDIT_SIZE,
            "grid": registry.AUDIT_GRID,
            "batch": registry.AUDIT_BATCH,
            "tick_iters": registry.AUDIT_TICK_ITERS,
            "max_em_iters": registry.AUDIT_MAX_EM_ITERS,
            "max_map_iters": registry.AUDIT_MAX_MAP_ITERS,
            "modes": list(registry.MODES),
            "drivers": list(registry.DRIVERS),
            "ks": list(registry.KS),
        },
        "census": pt_entries,
        "kernels": kc_entry,
        "budgets": budgets,
        "calibration": calibration,
        "suppressions": [{"code": s.code, "site_pattern": s.site_pattern, "reason": s.reason}
                         for s in registry.SUPPRESSIONS],
        "stale_suppressions": [{"code": s.code, "site_pattern": s.site_pattern} for s in stale],
        "summary": {
            "findings": len(found),
            "suppressed": len(found) - len(unsuppressed),
            "unsuppressed": len(unsuppressed),
        },
        "suppressed_findings": [f.as_dict() for f in found if f.suppressed],
        "unsuppressed_findings": [f.as_dict() for f in unsuppressed],
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static auditor of the port: op and host-read census per scope, kernel "
                    "pass, budget sentinel, calibration audit")
    p.add_argument("--check", action="store_true",
                   help="fail on any unsuppressed finding, stale suppression, or drift from "
                        "the checked-in baseline")
    p.add_argument("--write", action="store_true", help="regenerate the baseline")
    p.add_argument("--kernels", action="store_true",
                   help="also run the kernel cases on the card (needs CUDA; the report then "
                        "differs from the CPU baseline, so it is not compared)")
    p.add_argument("--out", default=str(BASELINE), help="baseline path")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)

    if args.kernels:
        import torch

        if not torch.cuda.is_available():
            print("analysis: --kernels needs a CUDA device; none is available", file=sys.stderr)
            return 2
    report = run_audit(verbose=not args.quiet, kernels=args.kernels)
    text = report_to_json(report)
    s = report["summary"]
    print(f"analysis: {s['findings']} finding(s), {s['suppressed']} suppressed, "
          f"{s['unsuppressed']} unsuppressed")
    for f in report["unsuppressed_findings"]:
        print(f"  {f['severity'].upper()} {f['code']} {f['site']}: {f['message']}")
    for s_ in report["stale_suppressions"]:
        print(f"  STALE suppression {s_['code']} {s_['site_pattern']}")

    rc = 0
    if report["unsuppressed_findings"]:
        rc = 1
    if args.write and not args.kernels:
        Path(args.out).write_text(text)
        print(f"wrote {args.out}")
    if args.check:
        if report["stale_suppressions"]:
            rc = 1
        if not args.kernels:
            try:
                baseline = Path(args.out).read_text()
            except OSError:
                print(f"missing baseline {args.out} (run with --write)")
                rc = 1
            else:
                if baseline != text:
                    print(f"baseline {args.out} drifted (regenerate with --write)")
                    rc = 1
    if rc == 0:
        print("analysis: OK")
    return rc
