"""Mixture-of-Experts FFN with DPP-based dispatch.

Counterpart of ``repro.models.moe``.  Token-to-expert dispatch is the
DPP-PMRF replicate/reduce pattern, on the port's own primitives
(``repro_torch.core.dpp``):

  Map          router logits (float32) and the top-k gates
  SortByKey    (expert, token) pairs, so each expert's tokens are contiguous
  Scan         rank within expert (capacity position), a running max
  Scatter      tokens into the (E, C, D) dispatch buffer (capacity drop)
  Gather       expert outputs back to the sorted lanes
  ReduceByKey  the weighted combine over each token's k lanes

The combine is no scatter-add: each token's k contributions are brought
together by a second SortByKey (on the token, stable, so they stay in
ascending expert order, the order the reference's ``.at[].add`` adds
them) and summed in that fixed order.  No atomic is involved, so a CUDA
device repeats its bits from run to run.  The expert products are three
``torch.bmm`` (the reference's einsums, outside any Pallas kernel).

Expert parallelism: ``moe_ffn(axis=group)`` runs on each rank of the
process group (the mesh's ``model`` axis) ``moe_ffn_local`` over its
E/m experts (``expert_offset = rank * E/m``; the stacks hold only those)
and sums the partial outputs over the group.  The input is the same on
every rank of the group, so the sum is a pair of autograd functions
(:class:`_CopyToGroup` on the input and the router, identity forward and
all-reduce backward; :class:`_ReduceFromGroup` on the output, all-reduce
forward and identity backward): each rank's cotangent of the input, and
of the router, covers only its own experts' lanes.
(``torch.distributed.nn.functional.all_reduce`` would all-reduce the
output's cotangent again in its backward, which is already the same on
every rank, and make every gradient m times too large.)
``router_aux_loss`` is the reference's load-balancing loss; as there, no
training loss adds it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dpp
from repro_torch.models import layers as L

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> nn.ParameterDict:
    """Router ``(d, E)`` in float32 whatever ``dtype`` is; experts ``(E,
    d_in, d_out)`` in ``dtype``; ``"shared"`` (when the config has shared
    experts) a SwiGLU MLP of width ``moe_d_ff * moe_shared_experts``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.moe_num_experts
    p = nn.ParameterDict({
        "router": L.frozen(L.dense_init(gen, d, e, torch.float32)),
        "w_gate": L.frozen(_expert_init(gen, e, d, f, dtype)),
        "w_up": L.frozen(_expert_init(gen, e, d, f, dtype)),
        "w_down": L.frozen(_expert_init(gen, e, f, d, dtype)),
    })
    if cfg.moe_shared_experts:
        fs = cfg.moe_d_ff * cfg.moe_shared_experts
        p["shared"] = nn.ParameterDict({
            "w_gate": L.frozen(L.dense_init(gen, d, fs, dtype)),
            "w_up": L.frozen(L.dense_init(gen, d, fs, dtype)),
            "w_down": L.frozen(L.dense_init(gen, fs, d, dtype)),
        })
    return p


def _expert_init(gen: torch.Generator, e: int, d_in: int, d_out: int, dtype: torch.dtype) -> Tensor:
    """``(e, d_in, d_out)`` normal with std ``d_in**-0.5``, drawn in float32."""
    w = torch.randn((e, d_in, d_out), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * (1.0 / (d_in ** 0.5))).to(dtype)


def _capacity(n_tokens: int, cfg: ModelConfig, n_experts_pool: int) -> int:
    c = int(n_tokens * cfg.moe_top_k * cfg.moe_capacity_factor / n_experts_pool)
    return max(8, -(-c // 8) * 8)  # multiple of 8 lanes


class Dispatch(NamedTuple):
    """One dispatch of T tokens, k lanes each.  Lane ``i`` is (token ``i //
    k``, choice ``i % k``); the ``s_*`` arrays are in sorted (expert,
    token) order."""

    logits: Tensor    # (T, E) float32 router logits
    experts: Tensor   # (T, k) int64 global expert ids, the router's top-k order
    gates: Tensor     # (T, k) float32 softmax over the top-k logits
    s_lane: Tensor    # (T*k,) the lane at each sorted position
    s_token: Tensor   # (T*k,)
    s_gate: Tensor    # (T*k,) float32
    slot: Tensor      # (T*k,) dispatch-buffer row; e_loc * cap for a lane not kept
    keep: Tensor      # (T*k,) bool: a local expert, within its capacity
    local: Tensor     # (T*k,) bool: routed to a local expert
    cap: int
    e_loc: int

    def keep_by_lane(self) -> Tensor:
        """``keep`` in lane order, shaped (T, k)."""
        out = torch.empty_like(self.keep)
        out[self.s_lane] = self.keep
        return out.reshape(self.experts.shape)


class DispatchLog:
    """Every dispatch inside :func:`logged`, in call order."""

    def __init__(self) -> None:
        self.dispatches: List[Dispatch] = []

    def summary(self) -> Dict[int, dict]:
        """{tokens: {"calls", "lanes", "kept", "dropped", "dropped_share"}}
        by dispatch size, ``lanes`` counting the lanes routed to a local
        expert."""
        out: Dict[int, dict] = {}
        for d in self.dispatches:
            row = out.setdefault(int(d.experts.shape[0]), {"calls": 0, "lanes": 0, "kept": 0})
            row["calls"] += 1
            row["lanes"] += int(d.local.sum())
            row["kept"] += int(d.keep.sum())
        for row in out.values():
            row["dropped"] = row["lanes"] - row["kept"]
            row["dropped_share"] = row["dropped"] / row["lanes"] if row["lanes"] else 0.0
        return out


_tls = threading.local()


@contextlib.contextmanager
def logged():
    """Record every dispatch inside the block; yields the :class:`DispatchLog`."""
    log = DispatchLog()
    prev = getattr(_tls, "log", None)
    _tls.log = log
    try:
        yield log
    finally:
        _tls.log = prev


def dispatch(
    p, x2d: Tensor, cfg: ModelConfig, *, expert_offset: int = 0, n_local_experts: Optional[int] = None
) -> Dispatch:
    """Map, SortByKey and Scan of ``moe_ffn_local``: the router's choices,
    their (expert, token) order, capacity ranks and keep mask."""
    t = int(x2d.shape[0])
    e_loc = n_local_experts if n_local_experts is not None else int(p["w_gate"].shape[0])
    k = cfg.moe_top_k
    cap = _capacity(t, cfg, cfg.moe_num_experts)
    dev = x2d.device

    # --- Map: router + top-k gates (float32 for a stable softmax) ----------
    logits = x2d.float() @ p["router"].float()
    top, experts = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)

    # keep only local experts; re-base ids, the rest to the sentinel bucket
    local_e = experts.reshape(-1) - expert_offset
    is_local = (local_e >= 0) & (local_e < e_loc)
    local_e = torch.where(is_local, local_e, e_loc)

    # --- SortByKey: group (expert, token) pairs by expert ------------------
    key = dpp.compound_key(local_e, flat_token, t)
    lanes = torch.arange(t * k, device=dev)
    s_key, s_lane = dpp.sort_by_key(key, lanes)
    s_token = dpp.gather_(flat_token, s_lane)
    s_gate = dpp.gather_(gates.reshape(-1), s_lane)
    s_expert = s_key // t

    # --- Scan: rank within expert (capacity position) ----------------------
    seg_start = torch.ones_like(s_expert, dtype=torch.bool)
    seg_start[1:] = s_expert[1:] != s_expert[:-1]
    first = torch.cummax(torch.where(seg_start, lanes, -1), dim=0).values
    rank = lanes - first

    keep = (s_expert < e_loc) & (rank < cap)
    slot = torch.where(keep, s_expert * cap + rank, e_loc * cap)
    d = Dispatch(logits, experts, gates, s_lane, s_token, s_gate, slot, keep, s_expert < e_loc, cap, e_loc)
    log = getattr(_tls, "log", None)
    if log is not None:
        log.dispatches.append(d)
    return d


def moe_ffn_local(
    p, x2d: Tensor, cfg: ModelConfig, *, expert_offset: int = 0, n_local_experts: Optional[int] = None
) -> Tensor:
    """Dispatch and expert FFN over a local expert slice.

    x2d: (T, D) tokens.  ``p['w_*']`` hold only the local experts (E_loc,
    ...); the router is global (E columns).  Returns the combined output
    for the tokens' local experts (zeros elsewhere), in x2d's dtype."""
    t, dm = x2d.shape
    k = cfg.moe_top_k
    disp = dispatch(p, x2d, cfg, expert_offset=expert_offset, n_local_experts=n_local_experts)
    e_loc, cap = disp.e_loc, disp.cap

    # --- Scatter: tokens into the (E_loc * C, D) dispatch buffer -----------
    x_sorted = dpp.gather_(x2d, disp.s_token)
    buf = dpp.scatter_(x_sorted, disp.slot, e_loc * cap).reshape(e_loc, cap, dm)

    # --- expert FFN (SwiGLU), batched over local experts -------------------
    h = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    h = torch.nn.functional.silu(h.float()).to(u.dtype) * u
    out = torch.bmm(h, p["w_down"]).reshape(e_loc * cap, dm)

    # --- Gather + weighted combine back to token order ---------------------
    gathered = dpp.gather_(out, torch.clamp(disp.slot, max=e_loc * cap - 1))
    gathered = gathered.masked_fill(~disp.keep[:, None], 0)
    contrib = gathered.float() * disp.s_gate[:, None]
    # ReduceByKey on the token: every token has exactly k lanes, so the
    # stable sort by token makes (T, k) rows in ascending expert order,
    # summed left to right.
    _, by_token = dpp.sort_by_key(disp.s_token, torch.arange(t * k, device=x2d.device))
    parts = dpp.gather_(contrib, by_token).reshape(t, k, dm)
    combined = parts[:, 0]
    for j in range(1, k):
        combined = combined + parts[:, j]
    return combined.to(x2d.dtype)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the cotangent all-reduced over the group backward."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """The partial outputs all-reduced over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g: Tensor):
        return g, None


def moe_ffn(p, x: Tensor, cfg: ModelConfig, *, axis=None) -> Tensor:
    """MoE FFN over (B, S, D) activations, shared experts included.

    ``axis`` is the process group the experts are split over (expert
    parallelism; ``p``'s stacks hold this rank's E/m experts), None for
    every expert on this rank."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    if axis is None:
        out = moe_ffn_local(p, x2d, cfg)
    else:
        import torch.distributed as dist

        if isinstance(axis, str):
            raise TypeError(f"moe_ffn's axis is the process group the experts are split over "
                            f"(mesh.get_group({axis!r})), not the axis name")
        e_loc = cfg.moe_num_experts // dist.get_world_size(axis)
        local = {k: p[k] for k in ("w_gate", "w_up", "w_down")}
        local["router"] = _CopyToGroup.apply(p["router"], axis)
        out = moe_ffn_local(local, _CopyToGroup.apply(x2d, axis), cfg,
                            expert_offset=dist.get_rank(axis) * e_loc, n_local_experts=e_loc)
        out = _ReduceFromGroup.apply(out, axis)
    out = out.reshape(b, s, d)
    if cfg.moe_shared_experts and "shared" in p:
        sp = p["shared"]
        h = torch.nn.functional.silu((x @ sp["w_gate"]).float()).to(x.dtype)
        out = out + (h * (x @ sp["w_up"])) @ sp["w_down"]
    return out


def router_aux_loss(p, x2d: Tensor, cfg: ModelConfig) -> Tensor:
    """Load-balancing auxiliary loss (Switch-style) of tokens x2d (T, D):
    ``E * sum_e f_e * P_e``, with ``f_e`` the mean count of top-k choices
    of expert e per token and ``P_e`` its mean router probability
    (float32, a 0-d tensor)."""
    e = cfg.moe_num_experts
    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    _, experts = torch.topk(logits, cfg.moe_top_k, dim=-1)
    frac = torch.nn.functional.one_hot(experts, e).float().sum(dim=1).mean(dim=0)
    return e * torch.sum(frac * probs.mean(dim=0))
