"""Analysis (counterpart of ``repro.analysis``).

So far the budget ledger alone (:mod:`repro_torch.analysis.budget`): the
one store of the port's workspace-build, compile and serve counters, and
the declared budgets over them.
"""

from .budget import BUDGETS, LEDGER, BudgetExceeded, expect, reset_all

__all__ = ["BUDGETS", "LEDGER", "BudgetExceeded", "expect", "reset_all"]
