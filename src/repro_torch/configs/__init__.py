"""Architecture configs (one module per assigned arch) + registry, and the
paper's own PMRF configuration (``pmrf_paper``).

Copies of ``repro.configs``: shapes only.  Which families the port can
run is ``repro_torch.models.registry.get_api``'s to say."""

from repro_torch.configs.base import ModelConfig, ShapeSpec, SHAPES
from repro_torch.configs.pmrf_paper import CONFIG as PMRF_PAPER, PMRFConfig
from repro_torch.configs.registry import ARCHS, get_config

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "ARCHS", "get_config", "PMRF_PAPER", "PMRFConfig"]
