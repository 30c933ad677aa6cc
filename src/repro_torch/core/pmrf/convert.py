"""Carry a problem across from numpy arrays: the port's counterpart of
loading weights.

``problem_from_numpy`` takes a dict of numpy arrays holding the hoods and
energy-model fields of a planned problem plus its initial parameters, and
builds the port's ``Hoods``, ``EnergyModel`` and ``(labels0, mu0,
sigma0)`` on ``device``.  ``hoods_from_numpy`` carries a ``Hoods`` alone,
label-replication arrays included, so a hoods layout that
``partition_hoods`` made in the JAX package runs in the port as it is.
Tests fill the dicts from the JAX package's objects with ``np.asarray``;
nothing here imports it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device, to_tensor
from repro_torch.core.pmrf.energy import EnergyModel
from repro_torch.core.pmrf.hoods import Hoods

HOODS_ARRAYS = (
    "vertex", "hood_id", "valid", "sizes", "offsets",
    "rep_old_index", "rep_test_label", "rep_hood_id", "rep_valid",
)
HOODS_SIZES = ("n_hoods", "n_regions", "n_elements")
MODEL_FIELDS = EnergyModel._fields
INIT_FIELDS = ("labels0", "mu0", "sigma0")


class LoadedProblem(NamedTuple):
    hoods: Hoods
    model: EnergyModel
    labels0: torch.Tensor
    mu0: torch.Tensor
    sigma0: torch.Tensor


def _require_keys(d: Dict[str, np.ndarray], keys, what: str) -> None:
    missing = [k for k in keys if k not in d]
    if missing:
        raise KeyError(f"{what}: missing {missing}")


def hoods_from_numpy(d: Dict[str, np.ndarray], device: DeviceLike = None) -> Hoods:
    """Build the port's ``Hoods`` from ``d``; keys are ``HOODS_ARRAYS`` and
    ``HOODS_SIZES``."""
    dev = resolve_device(device)
    _require_keys(d, HOODS_ARRAYS + HOODS_SIZES, "hoods_from_numpy")
    dtypes = dict(valid=torch.bool, rep_valid=torch.bool)
    return Hoods(
        **{k: to_tensor(d[k], dtypes.get(k, torch.int32), dev) for k in HOODS_ARRAYS},
        **{k: int(d[k]) for k in HOODS_SIZES},
    )


def problem_from_numpy(d: Dict[str, np.ndarray], device: DeviceLike = None) -> LoadedProblem:
    """Build the port's problem from ``d``; keys are ``HOODS_ARRAYS``,
    ``HOODS_SIZES``, ``MODEL_FIELDS`` and ``INIT_FIELDS``."""
    dev = resolve_device(device)
    _require_keys(d, HOODS_ARRAYS + HOODS_SIZES + MODEL_FIELDS + INIT_FIELDS, "problem_from_numpy")

    def t(name, dtype):
        return to_tensor(d[name], dtype, dev)

    i32, f32 = torch.int32, torch.float32
    model = EnergyModel(**{k: t(k, f32) for k in MODEL_FIELDS})
    return LoadedProblem(
        hoods_from_numpy(d, dev), model, t("labels0", i32), t("mu0", f32), t("sigma0", f32)
    )
