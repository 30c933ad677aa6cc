"""Architecture configs (one module per assigned arch) + registry.

Copies of ``repro.configs``: shapes only.  Which families the port can
run is ``repro_torch.models.registry.get_api``'s to say."""

from repro_torch.configs.base import ModelConfig, ShapeSpec, SHAPES
from repro_torch.configs.registry import ARCHS, get_config

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "ARCHS", "get_config"]
