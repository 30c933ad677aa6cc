"""Gradient compression for the cross-pod hop.

Counterpart of ``repro.training.compression``.  At 2+ pods the step's
gradient all-reduce crosses the slow inter-pod link once; compressing
that hop halves (bf16) or quarters (int8) its bytes.  Within a pod
gradients stay in the compute dtype.

Two codecs, each over a process group (the reference's ``axis``; None
passes the gradients through):

* ``bf16``  — cast to bf16, all-reduce in bf16, upcast to float32.
  Deterministic, 2x.  (The sharded train step's bf16 branch, like the
  reference's, instead rounds each pod's gradient to bf16 and sums in
  float32.)
* ``int8``  — per-tensor symmetric scale + **stochastic rounding**: the
  scale is the tensor's absmax all-reduced with MAX (so every rank
  quantises on the same grid), over 127, floored at 1e-30; each value
  becomes ``floor(g / scale + U)`` as int8, U uniform on [0, 1), summed
  as int32 and decoded with ``* scale``.  Unbiased: E[decode(encode(g))]
  = g.  4x.

Gradients are dicts of tensors (any nesting of dicts).  The noise comes
from an explicit ``torch.Generator``, drawn in :func:`_uniform`, one
draw per leaf in the dicts' order.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

Tensor = torch.Tensor
Grads = Any


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _all_reduce(x: Tensor, group, op=None) -> Tensor:
    import torch.distributed as dist

    if group is not None:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


def _uniform(shape, generator: torch.Generator, device) -> Tensor:
    """U[0, 1) float32 noise of ``shape`` from ``generator`` (on its device),
    moved to ``device``."""
    return torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32).to(device)


def bf16_allreduce(grads: Grads, group) -> Grads:
    """Cast -> all-reduce in bf16 -> upcast.  The caller takes the mean."""
    return _map(lambda g: _all_reduce(g.to(torch.bfloat16).clone(), group).float(), grads)


def int8_stochastic_allreduce(grads: Grads, group, generator: torch.Generator) -> Grads:
    """Unbiased int8 all-reduce: shared absmax grid + stochastic rounding."""
    import torch.distributed as dist

    def one(g: Tensor) -> Tensor:
        g32 = g.float()
        scale = _all_reduce(torch.amax(torch.abs(g32)), group, dist.ReduceOp.MAX) / 127.0
        scale = torch.clamp(scale, min=1e-30)
        q = torch.floor(g32 / scale + _uniform(tuple(g.shape), generator, g.device)).to(torch.int8)
        summed = _all_reduce(q.to(torch.int32), group)
        return summed.float() * scale

    return _map(one, grads)


def compress_allreduce(
    grads: Grads,
    group,
    *,
    codec: str = "none",
    generator: Optional[torch.Generator] = None,
    mean_denom: Optional[int] = None,
) -> Grads:
    """All-reduce ``grads`` over ``group`` with the selected codec, then
    mean (``mean_denom``).  ``group=None`` is a pass-through."""
    if group is None:
        return grads
    if codec == "none":
        out = _map(lambda g: _all_reduce(g.clone(), group), grads)
    elif codec == "bf16":
        out = bf16_allreduce(grads, group)
    elif codec == "int8":
        if generator is None:
            raise ValueError("the int8 codec needs a torch.Generator")
        out = int8_stochastic_allreduce(grads, group, generator)
    else:
        raise ValueError(f"unknown codec {codec!r}")
    if mean_denom is None:
        return out
    inv = 1.0 / mean_denom
    return _map(lambda g: g * inv, out)
