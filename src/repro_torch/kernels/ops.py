"""Kernel dispatch: every caller reaches a kernel through this module.

Counterpart of ``repro.kernels.ops``.  The route follows the tensor, with
one explicit override:

* ``backend=None`` / ``"auto"``: a CUDA tensor goes to the CUDA kernel, a
  CPU tensor to the plain PyTorch version in ``ref``;
* ``backend="torch"``: the plain version on any device.  It is the one way
  to run the plain version on the card (used to hold the kernels to it).

There is no fallback: a CUDA tensor that reaches a kernel that fails to
build or launch raises.  ``flash_attention`` under autograd is the
:class:`FlashAttention` function: the route's forward, the plain
version's recompute as its backward.  Each kernel module counts its launches;
:func:`launch_counts` reads the counts and :func:`reset_launch_counts`
zeroes them (``flash_attention.launches_tc`` too, the tensor-core share
of the flash launches, ``em_tick.launches_batched`` and
``em_tick.launches_pool``, the batched and the pool entry's shares of the
tick's, the compiled program's graph and boundary launches
(:func:`program_launch_counts`), and ``segment_reduce.launches_ordered`` and ``launches_min``, the
element-order ``add``'s and ``min``'s shares of ``segment_reduce``'s;
:func:`segment_reduce_launches` splits them; :data:`LANE_STEPS` counts
the steps of the modes' DPP workspaces, whose launches are
``segment_reduce``'s).  ``WORKSPACE_BUILDS``
counts the MAP-iteration workspaces built in this process: a session
builds one per bucket (and one per ticked pool) and reuses it, so a warm
solve adds none.  The count is the total of the budget ledger's
``"trace"`` section (:data:`BUILDS`, one key per workspace kind), its one
store.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis import budget as _budget
from repro_torch.kernels import em_tick as _em_tick
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import map_step as _map_step
from repro_torch.kernels import mrf_energy as _mrf_energy
from repro_torch.kernels import ref
from repro_torch.kernels import segment_reduce as _segment_reduce

BACKENDS = ("auto", "torch")
FLAG_CONVERGED, FLAG_DIVERGED = ref.FLAG_CONVERGED, ref.FLAG_DIVERGED
TickShape = ref.TickShape

#: MAP-iteration workspaces built in this process, by kind: the budget
#: ledger's ``"trace"`` section itself (the modes' DPP workspaces are
#: counted by ``count_workspace_build``).  ``WORKSPACE_BUILDS`` (a module
#: attribute, read through ``__getattr__``) is its total.
BUILDS = _budget.LEDGER.section("trace", keys=("tick", "batch_tick", "pool_tick", "map_step", "dpp"))
#: Compiled EM programs built in this process, by kind: the ledger's
#: ``"program"`` section (``PROGRAM_BUILDS`` is its total).  A
#: static-pallas workspace built with the EM limits compiles its program
#: beside its buffers (on the card a CUDA graph, on the plain route the
#: plain program bound to the workspace), so a session builds one per
#: bucket (and batch size) and a warm solve adds none.
PROGRAMS = _budget.LEDGER.section("program", keys=("solve", "stack", "pool"))
#: Steps of the modes' DPP workspaces (``em.DppBatchWorkspace``,
#: ``em.DppPoolWorkspace``) since the last ``reset_launch_counts``: one flat
#: MAP iteration of every lane each, whose kernel launches are
#: ``segment_reduce``'s.
LANE_STEPS = 0


def __getattr__(name: str):
    if name == "WORKSPACE_BUILDS":
        return _budget.LEDGER.total("trace")
    if name == "PROGRAM_BUILDS":
        return _budget.LEDGER.total("program")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def count_workspace_build(kind: str = "dpp") -> None:
    """Count a MAP-iteration workspace built outside this module."""
    _budget.LEDGER.bump("trace", kind)


def count_lane_step(n: int = 1) -> None:
    """Count ``n`` steps of a DPP workspace (``LANE_STEPS``)."""
    global LANE_STEPS
    LANE_STEPS += n


def count_program_build(kind: str) -> None:
    """Count a compiled program built outside this module (``"solve"``,
    ``"stack"`` or ``"pool"``)."""
    _budget.LEDGER.bump("program", kind)


def count_boundaries(n: int) -> None:
    """Add ``n`` boundary launches a graph made (counted on the device)."""
    _em_tick.launches_boundary += n


def _use_kernel(backend: Optional[str], where) -> bool:
    """True when a call on ``where`` (a tensor or a device) with ``backend``
    goes to the kernel."""
    device = torch.device(where.device if isinstance(where, torch.Tensor) else where)
    if backend in (None, "auto"):
        if device.type == "cuda":
            return True
        if device.type == "cpu":
            return False
        raise ValueError(
            f"no route for a tensor on {device}: the kernels are CUDA "
            "and the plain path runs on the CPU or with backend='torch'"
        )
    if backend == "torch":
        return False
    raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far in this process, by kernel name."""
    return {
        "flash_attention": _flash_attention.launches,
        "fused_em_tick": _em_tick.launches,
        "fused_map_step": _map_step.launches,
        "mrf_min_energy": _mrf_energy.launches,
        "segment_reduce": _segment_reduce.launches,
    }


def reset_launch_counts() -> None:
    global LANE_STEPS
    LANE_STEPS = 0
    for module in (_em_tick, _flash_attention, _map_step, _mrf_energy, _segment_reduce):
        module.launches = 0
    _flash_attention.launches_tc = 0
    _em_tick.launches_batched = 0
    _em_tick.launches_pool = 0
    _em_tick.launches_boundary = 0
    _em_tick.launches_graph = 0
    for kind in _em_tick.launches_control:
        _em_tick.launches_control[kind] = 0
    _segment_reduce.launches_ordered = 0
    _segment_reduce.launches_min = 0


def program_launch_counts() -> Dict[str, int]:
    """The compiled EM program's launches so far: ``graph`` the graph
    launches (one per solve), ``em_boundary`` the boundary kernel's (one per
    lockstep EM iteration inside a graph, and each standalone call); the
    tick's launches inside a graph are ``launch_counts()["fused_em_tick"]``'s."""
    return {"graph": _em_tick.launches_graph, "em_boundary": _em_tick.launches_boundary}


def control_launch_counts() -> Dict[str, int]:
    """The programs' control kernels' launches so far, by kernel (counted on
    the device inside the graphs, ``em_tick.launches_control``)."""
    return dict(_em_tick.launches_control)


def segment_reduce_launches() -> Dict[str, int]:
    """``segment_reduce``'s launches so far by variant: the order-free
    ``add``, the element-order ``add`` (``ordered``) and ``min``."""
    s = _segment_reduce
    return {"add": s.launches - s.launches_ordered - s.launches_min,
            "ordered_add": s.launches_ordered, "min": s.launches_min}


def segment_reduce(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op: str = "add",
    *,
    backend: Optional[str] = None,
    ordered: bool = False,
) -> torch.Tensor:
    """1-D ReduceByKey (``add`` or ``min``) into ``num_segments`` buckets;
    ids outside ``[0, num_segments)`` are ignored.  ``ordered=True`` asks
    for each segment's sum in element order (the plain version's order on
    the CPU; the kernel's default ``add`` is order-free)."""
    if _use_kernel(backend, values):
        return _segment_reduce.segment_reduce_cuda(values, segment_ids, num_segments, op,
                                                   ordered=ordered)
    return ref.segment_reduce(values, segment_ids, num_segments, op, ordered=ordered)


def fused_em_tick(
    y: torch.Tensor,
    w: torch.Tensor,
    nall_e: torch.Tensor,
    xf: torch.Tensor,
    valid: torch.Tensor,
    hood_id: torch.Tensor,
    vertex: torch.Tensor,
    region_mean: torch.Tensor,
    region_weight: torch.Tensor,
    hist: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    beta,
    *,
    n_hoods: int,
    n_vertices: int,
    offsets: Optional[torch.Tensor] = None,
    precision: str = "f32",
    conv_tol: float = 1.0e-4,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """One EM tick: ``(labels, hood_e, votes, conv, sum_w, sum_wy,
    sum_wyy)``.  The kernel needs ``offsets`` (the hoods' run boundaries in
    the sorted element arrays); the plain version ignores it."""
    if _use_kernel(backend, y):
        if offsets is None:
            raise ValueError("the fused_em_tick kernel needs the hoods' offsets")
        return _em_tick.fused_em_tick_cuda(
            y, w, nall_e, xf, valid, hood_id, vertex, region_mean, region_weight,
            hist, mu, sigma, beta, offsets=offsets, n_hoods=n_hoods,
            n_vertices=n_vertices, precision=precision, conv_tol=conv_tol,
        )
    return ref.fused_em_tick(
        y, w, nall_e, xf, valid, hood_id, vertex, region_mean, region_weight,
        hist, mu, sigma, beta, n_hoods=n_hoods, n_vertices=n_vertices,
        precision=precision, conv_tol=conv_tol,
    )


def tick_workspace(
    shape: TickShape,
    *,
    device,
    batch: Optional[int] = None,
    pool: bool = False,
    max_map_iters: int = 10,
    max_em_iters: Optional[int] = 20,
    precision: str = "f32",
    conv_tol: float = 1.0e-4,
    window: int = 3,
    backend: Optional[str] = None,
):
    """The EM driver's MAP-iteration workspace for a bucket's ``shape``
    (``TickShape.of(hoods, model)`` for one problem) on ``device``: built
    from the shapes alone, bound to a solve by its ``start``.  With
    ``batch=None`` the single-device route's (:class:`em_tick.TickWorkspace`,
    one kernel launch per MAP iteration, on a CUDA device; else
    :class:`ref.PlainTickWorkspace`); with ``batch=B`` the batched driver's
    for B lanes (:class:`em_tick.BatchTickWorkspace`, one launch per MAP
    iteration for all running lanes; else
    :class:`ref.PlainBatchTickWorkspace`); with ``batch=B, pool=True`` the
    continuous-batching driver's pool of B slots, each lane at its own MAP
    iteration and stopping at ``max_map_iters``
    (:class:`em_tick.PoolTickWorkspace`, one launch per micro-step; else
    :class:`ref.PlainPoolTickWorkspace`).

    The single and batched workspaces also compile the EM program of the
    limits ``max_em_iters`` and ``max_map_iters`` (the defaults are
    ``em.EMConfig``'s; ``max_em_iters=None`` builds none) over their
    buffers (``em.run_em`` and ``em.run_em_batched`` run it; a pool takes
    none): on the card one CUDA graph (``em_tick.SolveGraph``), on the
    plain route the plain program (``ref.run_program``);
    ``PROGRAM_BUILDS`` counts them."""
    kernel = _use_kernel(backend, device)
    kw = dict(device=device, precision=precision, conv_tol=conv_tol, window=window)
    if pool and batch is None:
        raise ValueError("a pool workspace needs batch=B")
    limits = dict(max_em_iters=max_em_iters, max_map_iters=max_map_iters)
    if batch is None:
        cls = _em_tick.TickWorkspace if kernel else ref.PlainTickWorkspace
        ws, kind = cls(TickShape(*shape), **kw, **limits), "tick"
    elif pool:
        cls = _em_tick.PoolTickWorkspace if kernel else ref.PlainPoolTickWorkspace
        ws, kind = cls(TickShape(*shape), batch, max_map_iters=max_map_iters,
                       max_em_iters=max_em_iters, **kw), "pool_tick"
    else:
        cls = _em_tick.BatchTickWorkspace if kernel else ref.PlainBatchTickWorkspace
        ws, kind = cls(TickShape(*shape), batch, **kw, **limits), "batch_tick"
    count_workspace_build(kind)
    if max_em_iters is not None:
        _budget.LEDGER.bump("program", "pool" if pool else "solve" if batch is None else "stack")
    return ws


def em_boundary(state: ref.BoundaryState, *, max_em_iters: int, max_map_iters: int,
                conv_tol: float = 1.0e-4, backend: Optional[str] = None) -> None:
    """The EM boundary of one problem, in place (``ref.BoundaryState``
    without the lane axis): the boundary kernel's single form, or
    ``ref.em_boundary``.  Outside a program it sets no loop condition."""
    if _use_kernel(backend, state.hood_e):
        return _em_tick.em_boundary_cuda(state, max_em_iters=max_em_iters,
                                         max_map_iters=max_map_iters, conv_tol=conv_tol)
    return ref.em_boundary(state, max_em_iters=max_em_iters, max_map_iters=max_map_iters,
                           conv_tol=conv_tol)


def em_boundary_lanes(state: ref.BoundaryState, *, max_em_iters: int, max_map_iters: int,
                      conv_tol: float = 1.0e-4, backend: Optional[str] = None) -> None:
    """The EM boundary of a stack's lanes, in place: the boundary kernel's
    lane form (one block per lane), or ``ref.em_boundary_lanes``."""
    if _use_kernel(backend, state.hood_e):
        return _em_tick.em_boundary_cuda(state, max_em_iters=max_em_iters,
                                         max_map_iters=max_map_iters, conv_tol=conv_tol,
                                         lanes=True)
    return ref.em_boundary_lanes(state, max_em_iters=max_em_iters, max_map_iters=max_map_iters,
                                 conv_tol=conv_tol)


def map_step_workspace(
    hoods,
    model,
    *,
    rank: int = 0,
    n_shards: int = 1,
    conv_tol: float = 1.0e-4,
    window: int = 3,
    backend: Optional[str] = None,
):
    """The sharded EM driver's MAP-iteration workspace for rank ``rank`` of
    a partition (``distributed.partition_hoods(hoods, n_shards)``):
    :class:`map_step.MapStepWorkspace` (one kernel launch per MAP
    iteration) for CUDA tensors, else :class:`ref.PlainMapStepWorkspace`."""
    cls = _map_step.MapStepWorkspace if _use_kernel(backend, hoods.vertex) else ref.PlainMapStepWorkspace
    ws = cls(hoods, model, rank=rank, n_shards=n_shards, conv_tol=conv_tol, window=window)
    count_workspace_build("map_step")
    return ws


def fused_map_step(
    y: torch.Tensor,
    w: torch.Tensor,
    cnt_e: torch.Tensor,
    nall_e: torch.Tensor,
    xf: torch.Tensor,
    valid: torch.Tensor,
    hood_id: torch.Tensor,
    vertex: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    beta,
    *,
    n_hoods: int,
    n_vertices: int,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One MAP step from per-element label counts ``cnt_e`` (K, H):
    ``(min_e, arg, hood_e, votes)`` with ``votes`` (K, n_vertices)."""
    if _use_kernel(backend, y):
        return _map_step.fused_map_step_cuda(
            y, w, cnt_e, nall_e, xf, valid, hood_id, vertex, mu, sigma, beta,
            n_hoods=n_hoods, n_vertices=n_vertices,
        )
    return ref.fused_map_step(
        y, w, cnt_e, nall_e, xf, valid, hood_id, vertex, mu, sigma, beta,
        n_hoods=n_hoods, n_vertices=n_vertices,
    )


def mrf_min_energy(
    y: torch.Tensor,
    w: torch.Tensor,
    n1_e: torch.Tensor,
    nall_e: torch.Tensor,
    xf: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    beta,
    *,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary energies and their per-element minimum: ``(min_e, arg)``."""
    if _use_kernel(backend, y):
        return _mrf_energy.mrf_min_energy_cuda(y, w, n1_e, nall_e, xf, mu, sigma, beta)
    return ref.mrf_min_energy(y, w, n1_e, nall_e, xf, mu, sigma, beta)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Attention ``softmax(scale * Q K^T) V`` with the GQA head map: q
    ``(B, Hq, S, D)``, k/v ``(B, Hkv, S, D)``; output in q's dtype.

    Where autograd records (grad mode on and an input that requires a
    gradient) the call is a :class:`FlashAttention` function on either
    route, so the kernel's output, written through ``ctypes``, is part of
    the graph; otherwise the route is called directly."""
    kernel = _use_kernel(backend, q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale, kernel)
    if kernel:
        return _flash_attention.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    return ref.flash_attention(q, k, v, causal=causal, scale=scale)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` under autograd.  The forward is the route's (the
    CUDA kernel, or ``ref.flash_attention``); the backward recomputes
    ``ref.flash_attention`` from the saved q, k, v and differentiates it,
    so both routes give the plain version's gradients bit for bit.  The
    reference has no backward kernel either (its Pallas kernel has no
    ``custom_vjp``; JAX differentiates its chunked scan)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float], kernel: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        if kernel:
            return _flash_attention.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, d_out):
        wanted = ctx.needs_input_grad[:3]
        inputs = [t.detach().requires_grad_(w) for t, w in zip(ctx.saved_tensors, wanted)]
        with torch.enable_grad():
            out = ref.flash_attention(*inputs, causal=ctx.causal, scale=ctx.scale)
            grads = iter(torch.autograd.grad(out, [t for t, w in zip(inputs, wanted) if w], d_out))
        return tuple(next(grads) if w else None for w in wanted) + (None, None, None)
