"""Carry a problem across from numpy arrays: the port's counterpart of
loading weights.

``problem_from_numpy`` takes a dict of numpy arrays holding the hoods and
energy-model fields of a planned problem plus its initial parameters, and
builds the port's ``Hoods``, ``EnergyModel`` and ``(labels0, mu0,
sigma0)`` on ``device``.  Tests fill the dict from the JAX package's
``Problem`` with ``np.asarray``; nothing here imports it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device, to_tensor
from repro_torch.core.pmrf.energy import EnergyModel
from repro_torch.core.pmrf.hoods import Hoods

HOODS_ARRAYS = ("vertex", "hood_id", "valid", "sizes", "offsets")
HOODS_SIZES = ("n_hoods", "n_regions", "n_elements")
MODEL_FIELDS = EnergyModel._fields
INIT_FIELDS = ("labels0", "mu0", "sigma0")


class LoadedProblem(NamedTuple):
    hoods: Hoods
    model: EnergyModel
    labels0: torch.Tensor
    mu0: torch.Tensor
    sigma0: torch.Tensor


def problem_from_numpy(d: Dict[str, np.ndarray], device: DeviceLike = None) -> LoadedProblem:
    """Build the port's problem from ``d``; keys are ``HOODS_ARRAYS``,
    ``HOODS_SIZES``, ``MODEL_FIELDS`` and ``INIT_FIELDS``."""
    dev = resolve_device(device)
    missing = [k for k in HOODS_ARRAYS + HOODS_SIZES + MODEL_FIELDS + INIT_FIELDS if k not in d]
    if missing:
        raise KeyError(f"problem_from_numpy: missing {missing}")

    def t(name, dtype):
        return to_tensor(d[name], dtype, dev)

    i32, f32 = torch.int32, torch.float32
    hoods = Hoods(
        vertex=t("vertex", i32),
        hood_id=t("hood_id", i32),
        valid=t("valid", torch.bool),
        sizes=t("sizes", i32),
        offsets=t("offsets", i32),
        **{k: int(d[k]) for k in HOODS_SIZES},
    )
    model = EnergyModel(**{k: t(k, f32) for k in MODEL_FIELDS})
    return LoadedProblem(hoods, model, t("labels0", i32), t("mu0", f32), t("sigma0", f32))
