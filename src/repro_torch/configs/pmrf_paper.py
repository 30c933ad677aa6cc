"""The paper's own experimental configuration (PMRF side): a copy of
``repro.configs.pmrf_paper``, standard library only.

Captures §4.1's setup as a config object (the calibration's batched
stack, ``planning.calibrate``, reads it) — the analogue of an LM arch
config for the segmentation workload.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class PMRFConfig:
    name: str = "pmrf-paper"
    # datasets (paper §4.1.1) — regenerated synthetically at these scales;
    # the paper's full volumes are 512x512x512 (synthetic) and
    # 1813x1830x500 (experimental beamline 8.3.2)
    synthetic_slices: int = 4
    synthetic_shape: Tuple[int, int] = (128, 128)
    experimental_slices: int = 2
    experimental_shape: Tuple[int, int] = (192, 192)
    # corruption (paper: salt&pepper + Gaussian sigma=100 + ringing)
    gaussian_sigma: float = 60.0
    salt_pepper_frac: float = 0.03
    # optimization (paper §3.2.2)
    n_labels: int = 2                 # binary segmentation
    max_em_iters: int = 20            # "most invocations converge within 20"
    max_map_iters: int = 10
    convergence_window: int = 3       # the paper's L
    convergence_tol: float = 1.0e-4   # the paper's threshold
    k_hop: int = 1                    # k=1 neighborhoods
    beta: float = 0.75                # smoothness weight
    mode: str = "faithful"            # the paper's primitive sequence;
                                      # "static" / "static-pallas" are the
                                      # beyond-paper modes
    backend: str = "auto"             # kernel dispatch (kernels/ops.py)


CONFIG = PMRFConfig()
