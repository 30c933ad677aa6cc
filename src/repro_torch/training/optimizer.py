"""AdamW with decoupled weight decay, global-norm clipping, and warmup +
cosine decay, written out (no ``torch.optim``).

Counterpart of ``repro.training.optimizer``, with its arithmetic: the
moments ``m`` and ``v`` are float32, and with ``use_master_fp32`` (the
default) so is a master copy of the parameters, which the update reads
and writes; the parameters get the master cast to their dtype.  The
moments and the master live on the parameters' device, as dicts keyed
by the model's parameter names; the step counter is a 0-d int32 tensor
on the host, so the learning rate and the bias corrections are host
numbers (float32, as the reference computes them) and cost no device
read.  The update writes the moments, the master and the parameters in
place (the reference returns new arrays and donates the old).

Weight decay: the reference decays a leaf of rank >= 2.  Its layer
parameters are stacked on a leading layer axis, so every layer's norm
gains and biases ((L, D)) decay there, while ``final_norm`` ((D,)) does
not.  The port holds one tensor per layer, so the rank is taken from
the reference's leaf (``models.convert.reference_layout``): a tensor's
own rank, plus one inside a stacked group.

On a mesh the parameters are a ``parallel.sharding.ShardedParams``: the
update runs on this rank's blocks (master, m and v are blocks too), and
the clipping norm is the whole gradient's (:func:`global_norm` with the
mesh), so that every rank clips by the same, single-device scale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.models import convert
from repro_torch.parallel.sharding import ShardedParams, axis_sizes, spec_axes

Tensor = torch.Tensor
Params = Union[nn.Module, Mapping[str, Tensor], ShardedParams]
_F32 = np.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1          # cosine floor as a fraction of lr
    use_master_fp32: bool = True      # keep an fp32 master parameter copy


class AdamWState(NamedTuple):
    step: Tensor                          # 0-d int32, on the host
    m: Dict[str, Tensor]                  # fp32, by parameter name
    v: Dict[str, Tensor]                  # fp32
    master: Optional[Dict[str, Tensor]]   # fp32 master params (None if disabled)


def named_params(params: Params) -> Dict[str, Tensor]:
    """The parameters by name: a module's ``named_parameters``, or the
    mapping (a ``ShardedParams``: its blocks)."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def reference_ranks(params: Params) -> Dict[str, int]:
    """Each parameter's rank in the reference's tree: a module's layer
    tensors count their stacked layer axis; a dict's tensors their own
    rank."""
    if isinstance(params, ShardedParams):
        params = params.model
    if not isinstance(params, nn.Module):
        return {name: t.dim() for name, t in params.items()}
    dims = {name: p.dim() for name, p in params.named_parameters()}
    return {name: dims[name] + (index is not None)
            for name, (_, index) in convert.reference_layout(params).items()}


def adamw_init(params: Params, config: AdamWConfig) -> AdamWState:
    """Zero moments and (``use_master_fp32``) a float32 copy of every
    parameter, on the parameter's device; step 0."""
    named = named_params(params)
    zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named.items()}
    master = ({n: p.detach().to(torch.float32, copy=True) for n, p in named.items()}
              if config.use_master_fp32 else None)
    return AdamWState(step=torch.zeros((), dtype=torch.int32), m=zeros(), v=zeros(), master=master)


def lr_schedule(step, config: AdamWConfig) -> float:
    """Linear warmup then cosine decay to ``min_lr_frac * lr``, in float32
    as the reference computes it; ``step`` an int or a 0-d tensor."""
    step_f = _F32(int(step))
    warm = min(step_f / _F32(max(config.warmup_steps, 1)), _F32(1.0))
    progress = np.clip((step_f - _F32(config.warmup_steps))
                       / _F32(max(config.total_steps - config.warmup_steps, 1)), _F32(0.0), _F32(1.0))
    cos = _F32(0.5) * (_F32(1.0) + np.cos(_F32(np.pi) * progress))
    floor = _F32(config.min_lr_frac)
    return float(_F32(config.lr) * warm * (floor + _F32(1.0 - config.min_lr_frac) * cos))


def global_norm(tensors, mesh=None, specs=None) -> Tensor:
    """sqrt of the sum of squares of every tensor (float32, 0-d, on the
    tensors' device).

    With a ``mesh``, ``tensors`` are this rank's blocks and ``specs`` their
    specs (in the same order): each rank sums the squares of its blocks,
    a block replicated over an axis counting only on that axis's
    coordinate 0, and one all-reduce over the mesh's ranks gives the
    whole gradient's norm."""
    tensors = list(tensors)
    device = tensors[0].device if tensors else None
    if mesh is not None:
        sizes = axis_sizes(mesh)
        zero = {a: mesh.get_local_rank(a) == 0 for a in sizes}
        tensors = [t for t, spec in zip(tensors, specs)
                   if all(zero[a] for a in sizes if a not in spec_axes(spec))]
    if not tensors:
        total = torch.zeros((), dtype=torch.float32, device=device)
    else:
        total = torch.sum(torch.stack([torch.sum(torch.square(t.float())) for t in tensors]))
    if mesh is not None:
        import torch.distributed as dist

        dist.all_reduce(total)
    return torch.sqrt(total)


def _clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Mapping[str, Tensor], max_norm: float) -> Tuple[Dict[str, Tensor], Tensor]:
    """``grads`` scaled by ``min(1, max_norm / max(norm, 1e-12))`` (no
    device read), and the norm."""
    norm = global_norm(grads.values())
    scale = _clip_scale(norm, max_norm)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


def adamw_update(
    grads: Mapping[str, Tensor],
    state: AdamWState,
    params: Params,
    config: AdamWConfig,
) -> Tuple[Params, AdamWState, Dict[str, object]]:
    """One AdamW step: returns (params, state, metrics) with the moments,
    the master and the parameters written in place.  ``grads`` is keyed by
    parameter name.  Metrics: ``grad_norm`` (a 0-d device tensor, before
    clipping) and ``lr`` (a float)."""
    named = named_params(params)
    ranks = reference_ranks(params)
    # clip_by_global_norm's scale, applied tensor by tensor below (no
    # float32 copy of every gradient at once)
    if isinstance(params, ShardedParams):
        norm = global_norm([grads[n] for n in named], params.mesh, [params.specs[n] for n in named])
    else:
        norm = global_norm(grads.values())
    scale = _clip_scale(norm, config.grad_clip)

    step = int(state.step) + 1
    lr = lr_schedule(step, config)
    b1, b2 = config.b1, config.b2
    bc1 = float(_F32(1.0) - _F32(b1) ** _F32(step))
    bc2 = float(_F32(1.0) - _F32(b2) ** _F32(step))
    with torch.no_grad():
        for name, p in named.items():
            g = grads[name].float() * scale
            m, v = state.m[name], state.v[name]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + config.eps)
            wd = config.weight_decay if ranks[name] >= 2 else 0.0
            if state.master is not None:
                p32 = state.master[name]
                p32.sub_(lr * (delta + wd * p32))
                p.copy_(p32)
            else:
                p32 = p.float()
                p.copy_(p32 - lr * (delta + wd * p32))
    new_state = AdamWState(step=torch.tensor(step, dtype=torch.int32), m=state.m, v=state.v, master=state.master)
    return params, new_state, {"grad_norm": norm, "lr": lr}
