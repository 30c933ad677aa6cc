"""Calibrated cost model and plan autotuner (counterpart of
``repro.planning``).

``planning`` answers one question for the session layer, the serving
engine and the launch CLIs: *given this problem's bucket and this
execution config, how many seconds will each candidate plan cost?*  So
``segment_stack(batch="auto")``, ``launch.segment --shards auto`` and the
engine's tick-cost prior route on predictions from one model, calibrated
on the card (``python -m repro_torch.planning.calibrate``), instead of
hard-coded platform checks.

Importable without the session layer (which imports *us*) and without
torch: ``costmodel`` and ``lsq`` are numpy and the standard library.
"""

from .costmodel import (
    BatchDecision,
    CostModel,
    ShardDecision,
    autotune_disabled,
    default_table_path,
    fit_table,
    legacy_batch_choice,
    load_table,
    model_for,
    platform_of,
    reset_models,
    table_to_json,
)
from .lsq import DecayedAffineFit, nnls

__all__ = [
    "BatchDecision",
    "CostModel",
    "DecayedAffineFit",
    "ShardDecision",
    "autotune_disabled",
    "default_table_path",
    "fit_table",
    "legacy_batch_choice",
    "load_table",
    "model_for",
    "nnls",
    "platform_of",
    "reset_models",
    "table_to_json",
]
