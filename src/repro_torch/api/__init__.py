"""Public session API: plan -> execute.

Quickstart::

    from repro_torch import api

    seg = api.Segmenter(api.ExecutionConfig(mode="static-pallas", n_labels=2))
    result = seg.segment(image)         # on the CUDA device
    result.segmentation                 # (H, W) int32 labels
"""

from repro_torch.api.config import ExecutionConfig
from repro_torch.api.errors import FallbackError, PlanError, RequestError, ServingError
from repro_torch.api.session import Plan, Segmenter

__all__ = [
    "ExecutionConfig",
    "FallbackError",
    "Plan",
    "PlanError",
    "RequestError",
    "Segmenter",
    "ServingError",
]
