"""Serving substrate of the port: the continuous-batching segmentation
engine (``repro_torch.serving.engine``: a fixed pool of slots over one
bucket, one ``fused_em_tick`` pool launch per micro-step, admission and
retirement between ticks) and the LM token-generation engine with its
samplers (``lm``, ``sampler``), as ``repro.serving`` has them."""

from repro_torch.serving.engine import SegCompletion, SegmentationEngine, SegRequest
from repro_torch.serving.lm import Completion, Request, ServingEngine
from repro_torch.serving.sampler import SamplerConfig, greedy, sample_logits

__all__ = [
    "Completion", "Request", "SamplerConfig", "SegCompletion", "SegRequest",
    "SegmentationEngine", "ServingEngine", "greedy", "sample_logits",
]
