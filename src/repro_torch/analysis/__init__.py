"""The port's static auditor (counterpart of ``repro.analysis``).

* :mod:`repro_torch.analysis.census`: the op and host-read census of the
  EM drivers' hot scopes (MAP iteration, EM boundary) against declared
  budgets (PT codes);
* :mod:`repro_torch.analysis.kernel_check`: launch coverage, barrier and
  broadcast lints of ``kernels/csrc``, and on the card the kernel cases
  under ``compute-sanitizer`` or its guard fallback (KC codes);
* :mod:`repro_torch.analysis.budget`: the counter ledger and the declared
  build budgets (BG codes).  ``kernels.ops`` imports it, so this package
  stays light: it imports the census and the kernel pass only when the
  CLI runs them.

Run the audit with ``python -m repro_torch.analysis`` (see ``--help``).
"""

from .budget import BUDGETS, LEDGER, BudgetExceeded, expect, reset_all
from .findings import Finding, Suppression

__all__ = ["BUDGETS", "LEDGER", "BudgetExceeded", "expect", "reset_all", "Finding",
           "Suppression"]
