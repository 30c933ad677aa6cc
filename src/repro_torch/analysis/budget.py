"""Compile/trace budget ledger and per-phase sentinel (counterpart of
``repro.analysis.budget``).

One process-global :class:`Ledger` of monotonically-increasing counters,
grouped into named *sections*.  It is the one store for the port's
trace, compile and serve counters:

=========  ==========================================================
section    who writes it
=========  ==========================================================
"trace"    ``kernels.ops`` counts every MAP-iteration workspace built
           (the port's form of a trace: PyTorch runs eagerly, so what
           a compile builds is the workspace), one key per kind;
           ``kernels.ops.WORKSPACE_BUILDS`` reads this section's total
"compile"  ``api.session`` records every executable built on a miss
           (``lower_compile``) and every warm LRU hit (``warm_hit``)
"serve"    the serving engine records ``ticks`` and ``lane_steps``
=========  ==========================================================

On top of the ledger sit *declared phase budgets*, the reference's
zero-rebuild / one-build contracts as named :class:`PhaseBudget` rows;
``expect(phase)`` turns any overshoot into :class:`BudgetExceeded`.

Standard library only: ``kernels.ops`` imports it.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = [
    "Ledger",
    "LEDGER",
    "PhaseBudget",
    "BUDGETS",
    "budget_for",
    "expect",
    "reset_all",
    "BudgetExceeded",
]


class BudgetExceeded(AssertionError):
    """A measured phase burned more traces/compiles than it declared."""

    def __init__(self, phase: str, section: str, delta: int, max_delta: int):
        self.phase, self.section = phase, section
        self.delta, self.max_delta = delta, max_delta
        super().__init__(
            f"phase {phase!r} used {delta} {section} event(s); "
            f"budget allows {max_delta}"
        )


class Ledger:
    """Named sections of named int counters.

    ``section()`` hands out the *live* dict, so legacy counter stores
    (``em.TRACE_COUNTS``) can alias a section directly: incrementing the
    dict IS incrementing the ledger.  Resets zero values in place —
    section identity is stable for the life of the process, which is
    what lets module-level aliases keep working across resets.
    """

    def __init__(self) -> None:
        self._sections: Dict[str, Dict[str, int]] = {}

    def section(self, name: str, keys: Tuple[str, ...] = ()) -> Dict[str, int]:
        sec = self._sections.setdefault(name, {})
        for k in keys:
            sec.setdefault(k, 0)
        return sec

    def bump(self, section: str, key: str, n: int = 1) -> int:
        sec = self.section(section)
        sec[key] = sec.get(key, 0) + n
        return sec[key]

    def total(self, section: str) -> int:
        return sum(self._sections.get(section, {}).values())

    def reset(self, section: Optional[str] = None) -> None:
        sections = (
            [self._sections[section]] if section in self._sections
            else ([] if section is not None else list(self._sections.values()))
        )
        for sec in sections:
            for k in sec:
                sec[k] = 0

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {name: dict(sec) for name, sec in sorted(self._sections.items())}


#: The process-global ledger every counter of the port writes through.
LEDGER = Ledger()


def reset_all() -> None:
    """Zero every counter in every section (the one test-reset hook)."""
    LEDGER.reset()


@dataclass(frozen=True)
class PhaseBudget:
    """A declared ceiling on one section's event count during a phase."""

    phase: str      # name, e.g. "warm_execute"
    section: str    # ledger section the ceiling applies to
    max_delta: int  # inclusive ceiling on the section total's growth
    note: str       # the contract this formalizes


#: The declared build/compile contracts: the reference's phases, sections
#: and ceilings.  A port route that exceeds one is a fault to repair, not
#: a budget to raise.
BUDGETS: Tuple[PhaseBudget, ...] = (
    PhaseBudget(
        "cold_compile", "trace", 1,
        "a cold ExecutableKey builds its workspace at most once",
    ),
    PhaseBudget(
        "warm_execute", "trace", 0,
        "a warm LRU hit builds no workspace",
    ),
    PhaseBudget(
        "warm_tick", "trace", 0,
        "advancing a warm ticked pool builds no workspace: admission, "
        "ticks and retirement are writes to the pool's own buffers",
    ),
)

_BY_NAME = {b.phase: b for b in BUDGETS}


def budget_for(phase: str) -> PhaseBudget:
    return _BY_NAME[phase]


@contextmanager
def expect(phase: str):
    """Assert the wrapped block stays within ``phase``'s declared budget."""
    b = budget_for(phase)
    before = LEDGER.total(b.section)
    yield
    delta = LEDGER.total(b.section) - before
    if delta > b.max_delta:
        raise BudgetExceeded(b.phase, b.section, delta, b.max_delta)
