"""What the EM boundary's order-fixed sums cost a warm solve, on the card.

Run on a CUDA card from the root of a checkout::

    PYTHONPATH=src python3 -m repro_torch.testing.boundary_sums

The boundary sums each lane's hood energies (the total-energy ring) in
float64 and rounds once (``em._total_energy``), and its label masses (the
dead-label threshold) label by label (``energy.label_total``), so that
neither a bucket's padding nor the batch shape of the device's reduction
moves a bit.  This plans the K = 2 512x512 slice of ``chip_smoke.py`` and
times warm ``Segmenter.execute`` solves with those sums ("fixed") and
with one float32 ``torch.sum`` each in their place ("float32"),
alternating which goes first, 60 solves each; it prints each side's min,
quartiles and median, then the device operations of one solve each way
(``torch.profiler``).
"""

from __future__ import annotations

import json

import torch

from repro_torch import api
from repro_torch.core import synthetic
from repro_torch.core.pmrf import em as em_mod
from repro_torch.core.pmrf import energy as E

SOLVES = 60

FIXED = (em_mod._total_energy, E.label_total)
FLOAT32 = (lambda h: torch.sum(h, dim=-1), lambda w: torch.sum(w, dim=-1, keepdim=True))


def _use(sums) -> None:
    em_mod._total_energy, E.label_total = sums


def main() -> int:
    if not torch.cuda.is_available():
        print("boundary_sums: no CUDA device")
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    vol = synthetic.make_synthetic_volume(seed=0, n_slices=1, shape=(512, 512), device=dev)
    seg = api.Segmenter(api.ExecutionConfig(n_labels=2, overseg_grid=(32, 32), init="quantile"),
                        device=dev)
    plan = seg.plan(vol.images[0])
    seg.execute(plan)
    sides = {"fixed": FIXED, "float32": FLOAT32}
    times = {name: [] for name in sides}
    try:
        for i in range(SOLVES):
            for name in (("fixed", "float32") if i % 2 == 0 else ("float32", "fixed")):
                _use(sides[name])
                times[name].append(seg.execute(plan).optimize_seconds)
        for name, v in times.items():
            s = sorted(v)
            print(json.dumps({"sums": name, "solves": SOLVES, "min": s[0], "q1": s[SOLVES // 4],
                              "median": s[SOLVES // 2], "q3": s[3 * SOLVES // 4]}))
        for name, sums in sides.items():
            _use(sums)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                seg.execute(plan)
            ops = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
            print(json.dumps({"sums": name, "device_ops_per_solve": ops}))
    finally:
        _use(FIXED)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
