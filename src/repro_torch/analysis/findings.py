"""Finding and report types shared by every pass of the auditor
(counterpart of ``repro.analysis.findings``).

A *finding* is one defect candidate, identified by a stable detector
code, the site it was found at and a message.  Findings are value
objects: deterministic, orderable and JSON-serializable, so the
checked-in baseline (``analysis/ANALYSIS.json``) diffs cleanly and
``--check`` can gate on "no unsuppressed findings".

Detector codes (the port's table; one class per failure mode):

==========  ============================================================
``PT001``   a float64 value made inside a census scope (the counterpart
            of JX001: the MAP iteration and the EM boundary run in
            float32; a widening there leaks past the oracle's bits)
``PT002``   host reads in a MAP iteration above the declared budget
            (JX002: a per-iteration host round trip joined the loop)
``PT003``   a host-to-device copy inside a MAP iteration (JX003:
            per-iteration data baked in from the host)
``PT004``   reserved: JX004 (donation) has no eager counterpart, since
            in-place reuse is the budget ledger's ``warm_execute`` and
            ``warm_tick`` phases; never emitted
``PT005``   a census count of a scope above its declared budget (JX005:
            device ops, scatters, gathers, launches or copies joined a
            hot scope undeclared)
``KC101``   out-of-bounds or misaligned global access (memcheck, or the
            guard allocator's bounds check)
``KC102``   shared-memory data race (racecheck, or the barrier-interval
            lint of ``csrc``)
``KC103``   barrier in divergent code (synccheck, or the barrier lint
            of ``csrc``)
``KC104``   read of uninitialised device memory (initcheck, or the
            guard allocator's two-poison check)
``KC105``   an exported C entry that launches a kernel has no case
            (static coverage over ``csrc/*.cu``)
``KC106``   the checker could not run a case, or a known-bad fixture
            was not caught exactly once by its own tool (the pass would
            be vacuous)
``KC107``   a case's outputs changed between repeats from one state
            (the guard fallback's determinism check)
``BG001``   a measured phase exceeded its declared build budget
``CT001``   checked-in calibration table missing or unreadable
``CT002``   stored calibration coefficients do not reproduce from the
            stored observations (stale fit or hand edit)
``CT003``   calibration coefficient is not a finite non-negative number
``CT004``   an audited mode is absent from the calibration grid (its
            predictions borrow another mode's coefficients)
``CT005``   cost-model prediction non-monotone along a probe ladder
            (capacity / K / width)
==========  ============================================================

Severity is ``error`` for defects that corrupt results (races, bounds,
budget blowouts) and ``warning`` for latent hazards.  ``--check`` gates
on both: the baseline must carry zero unsuppressed findings.

Standard library only.
"""

from __future__ import annotations

import fnmatch
import json
from dataclasses import asdict, dataclass
from typing import Dict, List, Sequence, Tuple

__all__ = [
    "Finding",
    "Suppression",
    "apply_suppressions",
    "report_to_json",
]


@dataclass(frozen=True, order=True)
class Finding:
    """One defect candidate."""

    code: str       # detector code, e.g. "PT002"
    severity: str   # "error" | "warning"
    site: str       # where: "run_em[static/K=2]/map_iteration" or "kernel:em_tick/memcheck"
    message: str    # deterministic (no addresses, no timings)
    suppressed_by: str = ""  # the reason, when a suppression matched

    @property
    def suppressed(self) -> bool:
        return bool(self.suppressed_by)

    def as_dict(self) -> Dict[str, str]:
        return asdict(self)


@dataclass(frozen=True)
class Suppression:
    """A declared, reviewed exemption: (code, site glob) -> reason.

    Suppressions live in :mod:`repro_torch.analysis.registry` beside the
    audit matrix, so every exemption carries its rationale.  A
    suppression that matches nothing in a full audit is reported (stale
    suppressions rot).
    """

    code: str           # exact detector code
    site_pattern: str   # fnmatch glob over Finding.site
    reason: str         # why the finding is deliberate

    def matches(self, finding: Finding) -> bool:
        return finding.code == self.code and fnmatch.fnmatchcase(finding.site, self.site_pattern)


def apply_suppressions(
    findings: Sequence[Finding], suppressions: Sequence[Suppression]
) -> Tuple[List[Finding], List[Suppression]]:
    """Mark suppressed findings; return ``(findings, stale_suppressions)``."""
    used = set()
    out: List[Finding] = []
    for f in findings:
        reason = ""
        for i, s in enumerate(suppressions):
            if s.matches(f):
                reason = s.reason
                used.add(i)
                break
        out.append(Finding(f.code, f.severity, f.site, f.message, suppressed_by=reason)
                   if reason else f)
    stale = [s for i, s in enumerate(suppressions) if i not in used]
    return out, stale


def report_to_json(report: Dict) -> str:
    """Serialize a report deterministically (sorted keys; callers keep
    timings out)."""
    return json.dumps(report, indent=2, sort_keys=True) + "\n"
