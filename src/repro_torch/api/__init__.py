"""Public session API: plan -> execute.

Quickstart::

    from repro_torch import api

    seg = api.Segmenter(api.ExecutionConfig(mode="static-pallas", n_labels=2))
    result = seg.segment(image)         # on the CUDA device
    result.segmentation                 # (H, W) int32 labels
    results, mean_s = seg.segment_stack(slices, batch="always")  # one batched solve
"""

from repro_torch.api.config import ExecutionConfig
from repro_torch.api.errors import FallbackError, PlanError, RequestError, ServingError
from repro_torch.api.session import (
    BucketKey,
    CacheStats,
    Executable,
    ExecutableKey,
    Plan,
    Segmenter,
    default_session,
    reset_sessions,
    session_for,
)

__all__ = [
    "BucketKey",
    "CacheStats",
    "Executable",
    "ExecutableKey",
    "ExecutionConfig",
    "FallbackError",
    "Plan",
    "PlanError",
    "RequestError",
    "Segmenter",
    "ServingError",
    "default_session",
    "reset_sessions",
    "session_for",
]
