"""Serving substrate of the port: the LM token-generation engine and its
samplers (``repro.serving``'s ``lm`` and ``sampler``).  The segmentation
serving engine is not ported yet (ROADMAP.md Queue 1, 'Ticked serving')."""

from repro_torch.serving.lm import Completion, Request, ServingEngine
from repro_torch.serving.sampler import SamplerConfig, greedy, sample_logits

__all__ = ["Completion", "Request", "SamplerConfig", "ServingEngine", "greedy", "sample_logits"]
