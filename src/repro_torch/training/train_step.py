"""The training step: loss -> gradients -> (optional cross-pod codec) ->
AdamW, with microbatch gradient accumulation, on one device or a mesh.

Counterpart of ``repro.training.train_step``.  The state is the
reference's ``{"params": ..., "opt": AdamWState}``; the step updates it
in place and returns it.  The loss is the family's ``ModelApi.loss``, so
GQA attention runs on the flash kernel (``kernels.ops.FlashAttention``)
with ``backend=None`` on a CUDA device.  With ``microbatches = n > 1``
the batch's leading axis (a rank's rows, on a mesh) is cut into n equal
slices; their losses and float32 gradients are summed, then scaled by
1/n, as the reference's scan does.

On one device ``params`` is the port's model.  On a mesh (a
``DeviceMesh``, ``parallel.sharding``) it is a ``ShardedParams``: every
rank runs the same seeded init and keeps its blocks, split as
``state_specs`` says (FSDP over ``data``, the ``model`` splits, experts
on ``model``, replicated over ``pod``); the moments and the master copy
are blocks of the same specs.  A step then

1. gathers the blocks into the work model (``ShardedParams.gather``);
2. takes this rank's rows of the batch (``batch_specs``; a batch that
   does not divide over the dp axes is replicated);
3. forms the loss as the rank's masked NLL sum over the **global** mask
   count (one all-reduce): the reference's loss is one masked mean over
   the whole batch, and a mean of per-rank means is another number.  With
   microbatches, microbatch i is each rank's i-th slice of its rows,
   over its own global count;
4. runs backward (MoE experts expert-parallel over ``model``), sums the
   gradients over the dp axes and cuts them to the blocks
   (``reduce_grad``);
5. runs AdamW on the blocks, the clipping norm the whole gradient's.

On one rank every collective is a copy, and the step equals the
single-device step bit for bit.

The codec branch (``grad_codec`` ``bf16`` or ``int8`` and a mesh with
``pod``) follows the reference: each pod computes the gradient of its
own rows' mean loss (summed over ``data`` only), and the cross-pod sum
runs through the codec, then divides by the pod count.  ``bf16``: each
pod's gradient rounded to bf16, summed in float32.  ``int8``: scale =
max over the whole gradient of every pod of |g| / 127 (floored at
1e-30), ``floor(g / scale + U)`` as int8, an int32 sum, ``* scale /
n_pods``; U is drawn for the whole leaf of every pod from a generator
seeded by (``seed``, step), leaf by leaf in parameter order, so the
result does not depend on the data/model layout.  The loss is the mean
of the pods' losses.  Without ``pod`` in the mesh, or without a mesh,
the codec is not used, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import get_api
from repro_torch.models.transformer import ParallelRuntime
from repro_torch.parallel import sharding as SH
from repro_torch.training import compression
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

Tensor = torch.Tensor
Batch = Dict[str, Tensor]
State = Dict[str, Any]
CODECS = ("none", "bf16", "int8")


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


def _check(mesh, ts_cfg: TrainStepConfig) -> None:
    if ts_cfg.grad_codec not in CODECS:
        raise ValueError(f"unknown grad_codec {ts_cfg.grad_codec!r}; have {CODECS}")
    if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a DeviceMesh with mesh_dim_names, not {type(mesh).__name__}")


def make_runtime(mesh) -> Optional[ParallelRuntime]:
    if mesh is None:
        return None
    return ParallelRuntime(mesh=mesh, dp_axes=SH.dp_axes(mesh),
                           tp_axis="model" if "model" in SH.axis_sizes(mesh) else "")


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------


def state_shape(cfg: ModelConfig, opt_cfg: AdamWConfig) -> Dict[str, Any]:
    """The shapes of the full train state under the reference's names
    (params + AdamW moments), from an init that allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import convert

    with FakeTensorMode():
        shapes = convert.nest(convert.reference_shapes(get_api(cfg).init(torch.Generator(), cfg)))
    return {"params": shapes, "opt": AdamWState(step=(), m=shapes, v=shapes,
                                                master=shapes if opt_cfg.use_master_fp32 else None)}


def _specs_of(shapes: Dict[str, Any], opt_cfg: AdamWConfig, mesh) -> Dict[str, Any]:
    pspecs = SH.param_specs(shapes, mesh)
    return {"params": pspecs, "opt": AdamWState(step=SH.P(), m=pspecs, v=pspecs,
                                                 master=pspecs if opt_cfg.use_master_fp32 else None)}


def state_specs(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh) -> Dict[str, Any]:
    """PartitionSpecs for the full state — moments/master inherit their
    parameter's spec; the step counter is replicated."""
    return _specs_of(state_shape(cfg, opt_cfg)["params"], opt_cfg, mesh)


def make_sharded_train_state(
    cfg: ModelConfig,
    mesh: Any = None,
    ts_cfg: TrainStepConfig = TrainStepConfig(),
    *,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[State, Optional[Dict[str, Any]]]:
    """Returns (state, specs): the family's ``init`` from ``generator``
    (default: one on ``device`` seeded with ``ts_cfg.seed``; ``device``
    None is the card, as ``resolve_device``), its gradients on, and AdamW
    state on the same device.  Without a mesh the specs are None; with
    one, ``params`` is a ``ShardedParams`` of this rank's blocks (their
    values the unsharded init's) and the specs are ``state_specs``."""
    _check(mesh, ts_cfg)
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)).manual_seed(ts_cfg.seed)
    params = get_api(cfg).init(generator, cfg)
    params.requires_grad_(True)
    if mesh is None:
        return {"params": params, "opt": adamw_init(params, ts_cfg.optimizer)}, None
    from repro_torch.models import convert

    specs = _specs_of(convert.nest(convert.reference_shapes(params)), ts_cfg.optimizer, mesh)
    sharded = SH.ShardedParams.from_model(params, mesh)
    return {"params": sharded, "opt": adamw_init(sharded, ts_cfg.optimizer)}, specs


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _microbatch(batch: Batch, n: int, i: int) -> Batch:
    """Slice ``i`` of ``n`` of every leaf's leading axis."""
    def one(x: Tensor) -> Tensor:
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]

    return {k: one(x) for k, x in batch.items()}


def _all_reduce(x: Tensor, mesh, axes, op=None) -> Tensor:
    import torch.distributed as dist

    for a in axes:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=mesh.get_group(a))
    return x


def _fold_seed(seed: int, step: int) -> int:
    """The int8 codec's generator seed for a step (the reference folds the
    step into ``PRNGKey(seed)``)."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])


def make_train_step(
    cfg: ModelConfig,
    mesh: Any = None,
    ts_cfg: TrainStepConfig = TrainStepConfig(),
    *,
    state_partition: Optional[Dict[str, Any]] = None,
    batch_shape: Optional[Dict[str, Any]] = None,
    backend: Optional[str] = None,
) -> Callable[[State, Batch], Tuple[State, Dict[str, Any]]]:
    """``step(state, batch) -> (state, metrics)``; metrics ``loss`` and
    ``grad_norm`` (0-d float32 tensors on the device; reading them waits
    for the step) and ``lr`` (a float).  ``batch`` is the global batch on
    every rank.  ``backend`` is the attention route (``"torch"``: the
    plain version, on any device).  ``state_partition`` and
    ``batch_shape`` are the reference's (it pins its jit's shardings with
    them); the port reads the specs from the state and the batch."""
    _check(mesh, ts_cfg)
    api = get_api(cfg)
    rt = make_runtime(mesh)
    n_micro = ts_cfg.microbatches

    def loss_and_grads(params, batch: Batch, count_axes):
        """(loss, grads by name) of the model ``params``; on a mesh each
        microbatch's loss is over its global mask count (``count_axes``)."""
        named = list(params.named_parameters())
        loss_sum, grad_sum = None, None
        for i in range(n_micro):
            for _, p in named:
                p.grad = None
            mb = batch if n_micro == 1 else _microbatch(batch, n_micro, i)
            loss = api.loss(params, mb, cfg, rt, backend=backend)
            if mesh is not None:
                count = torch.sum(mb["mask"].float())
                total = _all_reduce(count.clone(), mesh, count_axes)
                loss = loss * (torch.clamp(count, min=1.0) / torch.clamp(total, min=1.0))
            loss.backward()
            loss = loss.detach()
            if n_micro == 1:
                return loss, {n: p.grad for n, p in named}
            if grad_sum is None:
                grad_sum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named}
            for n, p in named:
                grad_sum[n] += p.grad.float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        inv = 1.0 / n_micro
        return loss_sum * inv, {n: g * inv for n, g in grad_sum.items()}

    def apply_grads(state: State, loss: Tensor, grads) -> Tuple[State, Dict[str, Any]]:
        params, opt, metrics = adamw_update(grads, state["opt"], state["params"], ts_cfg.optimizer)
        return {"params": params, "opt": opt}, dict(metrics, loss=loss)

    if mesh is None:
        def step(state: State, batch: Batch) -> Tuple[State, Dict[str, Any]]:
            params = state["params"]
            loss, grads = loss_and_grads(params, batch, ())
            for p in params.parameters():
                p.grad = None
            return apply_grads(state, loss, grads)

        return step

    sizes = SH.axis_sizes(mesh)
    use_codec = ts_cfg.grad_codec != "none" and "pod" in sizes

    def step(state: State, batch: Batch) -> Tuple[State, Dict[str, Any]]:
        sp = state["params"]
        model = sp.gather()
        gb = int(next(iter(batch.values())).shape[0])
        lead = SH.spec_axes(SH.batch_specs({"x": (gb,)}, mesh, global_batch=gb)["x"])
        if use_codec and "pod" not in lead:
            raise ValueError(f"the {ts_cfg.grad_codec} codec splits the batch over pods: "
                             f"{gb} rows do not divide over {SH.dp_axes(mesh)}")
        local = {k: SH.local_slice(x, (lead,), mesh) for k, x in batch.items()}
        # the axes whose ranks hold other rows: summed in the loss's count
        # and the gradient (the codec takes the pod axis itself)
        inner = tuple(a for a in lead if not (use_codec and a == "pod"))
        loss, grads = loss_and_grads(model, local, inner)
        loss = _all_reduce(loss.clone(), mesh, inner)
        for p in model.parameters():
            p.grad = None
        grads = sp.reduce_grads(grads, over=inner)
        if use_codec:
            grads = _pod_codec(grads, sp, mesh, ts_cfg, int(state["opt"].step))
            loss = _all_reduce(loss, mesh, ("pod",)) / sizes["pod"]
        return apply_grads(state, loss, grads)

    return step


def _pod_codec(grads: Dict[str, Tensor], sp, mesh, ts_cfg: TrainStepConfig, step: int) -> Dict[str, Tensor]:
    """The pods' gradient blocks summed through the codec, over the pod count."""
    import torch.distributed as dist

    n_pods = SH.axis_sizes(mesh)["pod"]
    pod = mesh.get_group("pod")
    out = {}
    if ts_cfg.grad_codec == "bf16":
        for n, g in grads.items():
            g = g.to(torch.bfloat16).float()
            dist.all_reduce(g, group=pod)
            out[n] = g / n_pods
        return out
    device = next(iter(grads.values())).device
    gen = torch.Generator(device=device).manual_seed(_fold_seed(ts_cfg.seed, step))
    pod_index = mesh.get_local_rank("pod")
    for n, g in grads.items():
        g = g.float()
        spec = sp.specs[n]
        amax = torch.amax(torch.abs(g))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX)          # every pod's whole leaf
        scale = torch.clamp(amax / 127.0, min=1e-30)
        noise = compression._uniform((n_pods,) + sp.full_shape(n), gen, device)[pod_index]
        q = torch.floor(g / scale + SH.local_slice(noise, spec, mesh)).to(torch.int8).to(torch.int32)
        dist.all_reduce(q, group=pod)
        out[n] = q.float() * scale / n_pods
    return out
