"""The training step: loss -> gradients -> AdamW, with microbatch
gradient accumulation.

Counterpart of ``repro.training.train_step`` on one device.  The state is
the reference's ``{"params": ..., "opt": AdamWState}``, with the port's
model (an ``nn.Module`` whose gradients are on) as ``params``; the step
updates it in place and returns it.  The loss is the family's
``ModelApi.loss``, so GQA attention runs on the flash kernel
(``kernels.ops.FlashAttention``) with ``backend=None`` on a CUDA device.
With ``microbatches = n > 1`` the batch's leading axis is cut into n
equal slices; their losses and float32 gradients are summed, then scaled
by 1/n, as the reference's scan does.

A mesh (FSDP/TP specs) and the cross-pod gradient codec
(``grad_codec != "none"``) wait for ``parallel/`` (ROADMAP.md Queue 1):
both raise :class:`NotImplementedError`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import get_api
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

Tensor = torch.Tensor
Batch = Dict[str, Tensor]
State = Dict[str, Any]


@dataclass(frozen=True)
class TrainStepConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1             # gradient-accumulation chunks
    grad_codec: str = "none"          # none | bf16 | int8 (cross-pod hop)
    seed: int = 0


class TrainState:
    """Bundles params + optimizer state (a plain dict of the two)."""

    def __init__(self, params, opt: AdamWState):
        self.params = params
        self.opt = opt

    def as_tree(self) -> State:
        return {"params": self.params, "opt": self.opt}


def _single_device(mesh, ts_cfg: TrainStepConfig) -> None:
    if mesh is not None:
        raise NotImplementedError("a sharded train state (mesh=...) waits for parallel/ "
                                  "(ROADMAP.md Queue 1, 'LM stack, still to port')")
    if ts_cfg.grad_codec != "none":
        raise NotImplementedError(f"grad_codec={ts_cfg.grad_codec!r} (the cross-pod codec) waits for parallel/ "
                                  "and training/compression.py (ROADMAP.md Queue 1)")


def make_sharded_train_state(
    cfg: ModelConfig,
    mesh: Any = None,
    ts_cfg: TrainStepConfig = TrainStepConfig(),
    *,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[State, None]:
    """Returns (state, None): the family's ``init`` from ``generator``
    (default: one on ``device`` seeded with ``ts_cfg.seed``; ``device``
    None is the card, as ``resolve_device``), its gradients on, and AdamW
    state on the same device."""
    _single_device(mesh, ts_cfg)
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)).manual_seed(ts_cfg.seed)
    params = get_api(cfg).init(generator, cfg)
    params.requires_grad_(True)
    return {"params": params, "opt": adamw_init(params, ts_cfg.optimizer)}, None


def _microbatch(batch: Batch, n: int, i: int) -> Batch:
    """Slice ``i`` of ``n`` of every leaf's leading axis."""
    def one(x: Tensor) -> Tensor:
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]

    return {k: one(x) for k, x in batch.items()}


def make_train_step(
    cfg: ModelConfig,
    mesh: Any = None,
    ts_cfg: TrainStepConfig = TrainStepConfig(),
    *,
    backend: Optional[str] = None,
) -> Callable[[State, Batch], Tuple[State, Dict[str, Any]]]:
    """``step(state, batch) -> (state, metrics)``; metrics ``loss`` and
    ``grad_norm`` (0-d float32 tensors on the device; reading them waits
    for the step) and ``lr`` (a float).  ``backend`` is the attention
    route (``"torch"``: the plain version, on any device)."""
    _single_device(mesh, ts_cfg)
    api = get_api(cfg)
    n_micro = ts_cfg.microbatches

    def loss_and_grads(params, batch: Batch):
        named = list(params.named_parameters())
        if n_micro == 1:
            for _, p in named:
                p.grad = None
            loss = api.loss(params, batch, cfg, backend=backend)
            loss.backward()
            return loss.detach(), {n: p.grad for n, p in named}
        loss_sum = None
        grad_sum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named}
        for i in range(n_micro):
            for _, p in named:
                p.grad = None
            loss = api.loss(params, _microbatch(batch, n_micro, i), cfg, backend=backend)
            loss.backward()
            for n, p in named:
                grad_sum[n] += p.grad.float()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        inv = 1.0 / n_micro
        return loss_sum * inv, {n: g * inv for n, g in grad_sum.items()}

    def step(state: State, batch: Batch) -> Tuple[State, Dict[str, Any]]:
        params = state["params"]
        loss, grads = loss_and_grads(params, batch)
        params, opt, metrics = adamw_update(grads, state["opt"], params, ts_cfg.optimizer)
        for p in params.parameters():
            p.grad = None
        return {"params": params, "opt": opt}, dict(metrics, loss=loss)

    return step
