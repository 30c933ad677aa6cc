"""Plain PyTorch versions of the CUDA kernels.

Each function here is the contract its kernel is held to, and the path a
CPU tensor takes through ``ops``.  The keyed reductions use
``index_add_``, which on the CPU accumulates in element order, the order
``jax.ops.segment_sum`` uses on the CPU; so on the host these functions
agree with ``repro.kernels.ref`` bit for bit wherever the elementwise
arithmetic does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor

#: Bits of the flag word of a MAP iteration (``fused_map_iteration``, and
#: the CUDA kernel's ``TickWorkspace``).
FLAG_CONVERGED = 1  # every hood inside its convergence window, gate open
FLAG_DIVERGED = 2   # a hood energy is not finite


class TickShape(NamedTuple):
    """The shapes a MAP-iteration workspace is built for (a bucket's):
    element capacity, hoods, vertices (regions + the sentinel) and K."""

    capacity: int
    n_hoods: int
    n_vertices: int
    n_labels: int

    @classmethod
    def of(cls, hoods, model) -> "TickShape":
        return cls(hoods.capacity, hoods.n_hoods, hoods.n_regions + 1, model.n_labels)


def _spare_bucket(keys: Tensor, num_segments: int) -> Tensor:
    """``keys`` as int64, with those outside ``[0, num_segments)`` sent to
    one spare bucket ``num_segments`` that the caller drops."""
    keys = keys.long()
    return torch.where((keys >= 0) & (keys < num_segments), keys, num_segments)


def keyed_sum(values: Tensor, keys: Tensor, num_segments: int) -> Tensor:
    """Segment sum into ``num_segments`` buckets (any dtype); keys outside
    ``[0, num_segments)`` are dropped."""
    out = torch.zeros(num_segments + 1, dtype=values.dtype, device=values.device)
    return out.index_add_(0, _spare_bucket(keys, num_segments), values)[:num_segments]


def segment_reduce(
    values: Tensor, segment_ids: Tensor, num_segments: int, op: str = "add",
    *, ordered: bool = False,
) -> Tensor:
    """1-D ReduceByKey.  Ids outside ``[0, num_segments)`` are ignored;
    empty segments give 0 (``add``) or +inf (``min``).  ``add`` is
    :func:`keyed_sum`, which adds in element order on the CPU: it is the
    plain version of the kernel's ``ordered=True`` sum too."""
    if ordered and op != "add":
        raise ValueError("ordered=True applies to add; min is order-free")
    if op == "add":
        return keyed_sum(values, segment_ids, num_segments)
    if op == "min":
        out = torch.full(
            (num_segments + 1,), float("inf"), dtype=values.dtype, device=values.device
        )
        ids = _spare_bucket(segment_ids, num_segments)
        return out.scatter_reduce_(0, ids, values, "amin", include_self=True)[:num_segments]
    raise ValueError(f"unknown segment_reduce op {op!r}; have ('add', 'min')")


def label_energies_blocked(
    y: Tensor,
    w: Tensor,
    cnt: Tensor,
    nall: Tensor,
    xf: Tensor,
    valid: Tensor,
    mu: Tensor,
    sig: Tensor,
    beta,
    *,
    precision: str = "f32",
    log_sig: Optional[Tensor] = None,
) -> Tensor:
    """(K, N) label energies from label-blocked inputs.

    The op order of the JAX helper it mirrors, one PyTorch op per JAX op:
    ``w*(d*d/(2*sig*sig) + log sig) + beta*max((nall-cnt)-(1-eq),0)/denom*valid``
    with ``denom = max(nall-1, 1)``.  ``precision="bf16"`` casts every
    operand to bfloat16, so each op rounds to bfloat16; callers cast the
    result back to float32 before accumulating.  ``log_sig`` (K,), when
    given, is used for ``log sig`` (cast to the working precision): a step
    on the host can take the bits another device's ``log`` gave.
    """
    cd = torch.bfloat16 if precision == "bf16" else torch.float32
    y = y.to(cd)
    w = w.to(cd)
    nall = nall.to(cd)
    xf = xf.to(cd)
    valid = valid.to(cd)
    cnt = cnt.to(cd)
    mu = mu.to(cd)[:, None]
    log_s = torch.log(sig.to(cd)[:, None]) if log_sig is None else log_sig.to(cd)[:, None]
    sig = sig.to(cd)[:, None]
    beta = torch.as_tensor(beta, device=y.device).to(cd)
    labf = torch.arange(cnt.shape[0], device=y.device, dtype=torch.float32).to(cd)[:, None]
    denom = torch.clamp_min(nall - 1.0, 1.0)
    d = y[None, :] - mu
    eq = (xf[None, :] == labf).to(cd)
    return w[None, :] * (d * d / (2.0 * sig * sig) + log_s) + beta * torch.clamp_min(
        (nall[None, :] - cnt) - (1.0 - eq), 0.0
    ) / denom[None, :] * valid[None, :]


def mrf_min_energy(
    y: Tensor,
    w: Tensor,
    n1_e: Tensor,
    nall_e: Tensor,
    xf: Tensor,
    mu: Tensor,
    sigma: Tensor,
    beta,
) -> Tuple[Tensor, Tensor]:
    """Binary (K = 2) energies and their per-element minimum, from
    pre-gathered per-element arrays: ``(min_e, arg)`` with label 1 only
    where its energy is strictly lower.  The op order of
    ``repro.kernels.ref.mrf_min_energy``; ``n1_e`` counts label 1 in the
    element's neighbourhood, and the energies carry no ``valid`` factor."""
    denom = torch.clamp_min(nall_e - 1.0, 1.0)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=y.device)

    def energy(l: int) -> Tensor:
        d = y - mu[l]
        data = w * (d * d / (2.0 * sigma[l] * sigma[l]) + torch.log(sigma[l]))
        diff = (nall_e - n1_e) - (1.0 - xf) if l == 1 else n1_e - xf
        return data + beta * torch.clamp_min(diff, 0.0) / denom

    e0, e1 = energy(0), energy(1)
    return torch.minimum(e0, e1), (e1 < e0).to(torch.int32)


def fused_map_step(
    y: Tensor,
    w: Tensor,
    cnt_e: Tensor,
    nall_e: Tensor,
    xf: Tensor,
    valid: Tensor,
    hood_id: Tensor,
    vertex: Tensor,
    mu: Tensor,
    sigma: Tensor,
    beta,
    *,
    n_hoods: int,
    n_vertices: int,
    log_sigma: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One MAP step given the per-element label counts ``cnt_e`` (K, H):
    the K energies (``label_energies_blocked`` at f32, the op order of
    ``repro.kernels.ref.fused_map_step``), per-element ``min_e`` and
    ``arg`` (ties to the lowest label), per-hood sums of ``min_e * valid``
    and the (K, n_vertices) votes.  Lanes with ``valid == 0`` and ids
    outside ``[0, n_hoods)`` / ``[0, n_vertices)`` add to no sum.
    ``log_sigma`` as ``label_energies_blocked``'s ``log_sig``.

    Returns ``(min_e, arg, hood_e, votes)``.
    """
    n_labels = int(mu.shape[0])
    energies = label_energies_blocked(y, w, cnt_e, nall_e, xf, valid, mu, sigma, beta,
                                      log_sig=log_sigma)
    min_e, arg = torch.min(energies, dim=0)  # first minimum on ties
    seg_h = torch.where(valid > 0, hood_id.long(), n_hoods)
    hood_e = keyed_sum(min_e * valid, seg_h, n_hoods + 1)[:n_hoods]
    seg_v = torch.where(valid > 0, vertex.long(), n_vertices)
    votes = (
        keyed_sum(valid, seg_v * n_labels + arg, (n_vertices + 1) * n_labels)
        .reshape(n_vertices + 1, n_labels)
        .T[:, :n_vertices]
    )
    return min_e, arg.to(torch.int32), hood_e, votes.contiguous()


def fused_em_tick(
    y: Tensor,
    w: Tensor,
    nall_e: Tensor,
    xf: Tensor,
    valid: Tensor,
    hood_id: Tensor,
    vertex: Tensor,
    region_mean: Tensor,
    region_weight: Tensor,
    hist: Tensor,
    mu: Tensor,
    sigma: Tensor,
    beta,
    *,
    n_hoods: int,
    n_vertices: int,
    precision: str = "f32",
    conv_tol: float = 1.0e-4,
    log_sigma: Optional[Tensor] = None,
) -> Tuple[Tensor, ...]:
    """One EM tick: per-(hood, label) counts, K energies, per-element
    min/argmin (ties to the lowest label), per-hood energy sums, votes,
    plurality labels (sentinel vertex ``n_vertices - 1`` set to 0), the
    M-step sums and the convergence-window flag over ``hist``.

    Returns ``(labels, hood_e, votes, conv, sum_w, sum_wy, sum_wyy)``.
    The CUDA kernel's ``offsets`` layout argument has no counterpart here:
    this version reads the hood of each element from ``hood_id``.
    ``log_sigma`` as ``label_energies_blocked``'s ``log_sig``.
    """
    n_labels = int(mu.shape[0])
    seg_h = torch.where(valid > 0, hood_id.long(), n_hoods)
    xi = torch.clamp(xf.to(torch.int32), 0, n_labels - 1).long()
    counts = keyed_sum(
        valid, seg_h * n_labels + xi, (n_hoods + 1) * n_labels
    ).reshape(n_hoods + 1, n_labels)
    cnt_e = counts[torch.clamp(hood_id.long(), 0, n_hoods - 1)].T  # (K, H)

    energies = label_energies_blocked(
        y, w, cnt_e, nall_e, xf, valid, mu, sigma, beta, precision=precision, log_sig=log_sigma
    )
    min_e, arg = torch.min(energies, dim=0)  # first minimum on ties
    min_e = min_e.to(torch.float32)

    hood_e = keyed_sum(min_e * valid, seg_h, n_hoods + 1)[:n_hoods]
    seg_v = torch.where(valid > 0, vertex.long(), n_vertices)
    votes = (
        keyed_sum(valid, seg_v * n_labels + arg, (n_vertices + 1) * n_labels)
        .reshape(n_vertices + 1, n_labels)
        .T[:, :n_vertices]
    )
    labels = torch.argmax(votes, dim=0).to(torch.int32)  # first maximum on ties
    labels[n_vertices - 1] = 0

    lab = labels.long()
    sum_w = keyed_sum(region_weight, lab, n_labels)
    sum_wy = keyed_sum(region_weight * region_mean, lab, n_labels)
    sum_wyy = keyed_sum(region_weight * region_mean * region_mean, lab, n_labels)

    scale = torch.clamp_min(torch.abs(hood_e), 1.0)
    ok = torch.abs(hood_e - hist[0, :n_hoods]) < conv_tol * scale
    for r in range(int(hist.shape[0]) - 2):
        ok = ok & (torch.abs(hist[r, :n_hoods] - hist[r + 1, :n_hoods]) < conv_tol * scale)
    conv = torch.all(ok)
    return labels, hood_e, votes.contiguous(), conv, sum_w, sum_wy, sum_wyy


def fused_map_iteration(
    y: Tensor,
    w: Tensor,
    nall_e: Tensor,
    valid: Tensor,
    hood_id: Tensor,
    vertex: Tensor,
    region_mean: Tensor,
    region_weight: Tensor,
    ring: Tensor,
    head: int,
    labels: Tensor,
    mu: Tensor,
    sigma: Tensor,
    beta,
    *,
    gate: bool,
    n_hoods: int,
    n_vertices: int,
    precision: str = "f32",
    conv_tol: float = 1.0e-4,
    log_sigma: Optional[Tensor] = None,
) -> Tuple[Tensor, ...]:
    """One MAP iteration of the single-device route: the label gather
    (``xf = labels[vertex] * valid``), :func:`fused_em_tick` with the
    history ring's rows newest first from row ``head``, then ``hood_e``
    written into the ring's oldest row (in place) and the flag word:
    ``FLAG_CONVERGED`` for the window predicate with ``gate`` open,
    ``FLAG_DIVERGED`` for a hood energy that is not finite.  ``sigma`` is already
    clamped at ``sigma_min``.

    Returns ``(labels, hood_e, votes, flag, sum_w, sum_wy, sum_wyy)``,
    ``flag`` a 0-dim int32 tensor.  The next iteration's ``head`` is
    ``(head - 1) % rows``.
    """
    rows = int(ring.shape[0])
    order = [(head + r) % rows for r in range(rows)]
    xf = labels[vertex.long()].to(torch.float32) * valid
    new_labels, hood_e, votes, conv, sum_w, sum_wy, sum_wyy = fused_em_tick(
        y, w, nall_e, xf, valid, hood_id, vertex, region_mean, region_weight,
        ring[order], mu, sigma, beta, n_hoods=n_hoods, n_vertices=n_vertices,
        precision=precision, conv_tol=conv_tol, log_sigma=log_sigma,
    )
    ring[order[-1]] = hood_e
    flag = (conv & bool(gate)).to(torch.int32) * FLAG_CONVERGED | (
        ~torch.all(torch.isfinite(hood_e))).to(torch.int32) * FLAG_DIVERGED
    return new_labels, hood_e, votes, flag, sum_w, sum_wy, sum_wyy


class _PlainProgram:
    """The plain program of a workspace built with the EM limits
    (``max_em_iters`` not None): the lane block, the program's words, the
    EM-level parameters and the total-energy ring beside the MAP
    iteration's buffers, and the steps :func:`run_program` drives.  A
    subclass gives :meth:`_program` (its tensors with a lane axis)."""

    max_em_iters = None

    def _program_buffers(self, batch: int, window: int, max_em_iters, max_map_iters) -> None:
        self.max_em_iters, self.max_map_iters = max_em_iters, max_map_iters
        k, dev, f32 = self.n_labels, self.device, torch.float32
        lead = () if batch is None else (batch,)
        self.lane = torch.zeros((len(LANE_WORDS),) + lead, dtype=torch.int32, device=dev)
        self.ctl = torch.zeros((len(CTL_WORDS),), dtype=torch.int32, device=dev)
        self.em_mu = torch.zeros(lead + (k,), dtype=f32, device=dev)
        self.em_sigma = torch.ones(lead + (k,), dtype=f32, device=dev)
        self.mu = torch.zeros(lead + (k,), dtype=f32, device=dev)
        self.sigma = torch.ones(lead + (k,), dtype=f32, device=dev)
        self.total_hist = torch.zeros(lead + (window + 1,), dtype=f32, device=dev)

    def program_begin(self) -> None:
        program_begin(self._program(), max_em_iters=self.max_em_iters,
                      max_map_iters=self.max_map_iters)

    def program_step(self) -> None:
        program_map_iteration(self._program(), max_map_iters=self.max_map_iters,
                              n_hoods=self.shape.n_hoods, n_vertices=self.shape.n_vertices,
                              precision=self.precision, conv_tol=self._conv_tol)

    def program_boundary(self) -> None:
        em_boundary_lanes(self._program().boundary, max_em_iters=self.max_em_iters,
                          max_map_iters=self.max_map_iters, conv_tol=self._conv_tol)

    def run_program(self, marks=None) -> None:
        """The solve bound by ``start``: the plain program (:func:`run_program`)."""
        if self.max_em_iters is None:
            raise ValueError("this workspace was built without the EM limits: it has no program")
        run_program(self, marks)

    def program_result(self) -> Tuple[list, list, list, int]:
        """The last solve's counters (:func:`program_result`), one read."""
        lane = self.lane if self.lane.dim() == 2 else self.lane[:, None]
        return program_result(lane, self.ctl)

    def program_views(self) -> tuple:
        """(B, ...) views of the program's outputs: labels, the EM-level mu
        and sigma, the hood energies and the total-energy ring."""
        p = self._program()
        b = p.boundary
        return p.labels, b.em_mu, b.em_sigma, b.hood_e, b.total_hist


class PlainTickWorkspace(_PlainProgram):
    """The plain version of ``em_tick.TickWorkspace`` (same methods and
    views), one :func:`fused_map_iteration` per step: the single-device
    EM driver's route on the CPU, or on the card with ``backend="torch"``.
    Its ``stats`` are every step's M-step sums (the kernel's only those of
    a step that stops the MAP loop, which are the ones the driver reads).
    Built with the EM limits it also runs the compiled EM program's plain
    version (:meth:`run_program`) on the solve :meth:`start` binds.
    """

    #: The EM mode whose MAP iteration the workspace steps.
    mode = "static-pallas"

    def __init__(self, shape: TickShape, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3, max_em_iters=None,
                 max_map_iters=None):
        self.shape, self.device, self.precision = shape, torch.device(device), precision
        self.n_labels, self._conv_tol = shape.n_labels, conv_tol
        f32 = torch.float32
        self.ring = torch.zeros((window + 1, shape.n_hoods), dtype=f32, device=self.device)
        self.labels = torch.zeros((shape.n_vertices,), dtype=torch.int32, device=self.device)
        self.hood_e = torch.zeros((shape.n_hoods,), dtype=f32, device=self.device)
        self.votes = torch.zeros((shape.n_labels, shape.n_vertices), dtype=f32, device=self.device)
        self.stats = torch.zeros((3, shape.n_labels), dtype=f32, device=self.device)
        self.head = 0
        self._flag = torch.zeros((), dtype=torch.int32)
        if max_em_iters is not None:
            self._program_buffers(None, window, max_em_iters, max_map_iters)

    def start(self, hoods, model, y, w, nall_e, valid, labels0, mu0=None, sigma0=None) -> None:
        """Bind a solve; ``mu0`` and ``sigma0`` are the program's start."""
        if TickShape.of(hoods, model) != self.shape:
            raise ValueError(f"a problem of {TickShape.of(hoods, model)}; the workspace was "
                             f"built for {self.shape}")
        self._hoods, self._model = hoods, model
        self._elements = (y, w, nall_e, valid)
        self._start = (labels0, mu0, sigma0)
        self.labels = labels0.clone()

    def _program(self) -> ProgramState:
        h, m = self._hoods, self._model
        labels0, mu0, sigma0 = self._start
        one = lambda t: t.reshape(1, *t.shape)  # noqa: E731
        scalar = lambda t: t.reshape(1)  # noqa: E731
        bnd = BoundaryState(
            one(self.stats), one(self.hood_e), self.lane[:, None], self.ctl, one(self.em_mu),
            one(self.em_sigma), one(self.mu), one(self.sigma), one(self.ring),
            one(self.total_hist), scalar(m.sigma_min), one(m.reseed_mu), scalar(m.reseed_sigma))
        return ProgramState(*(one(t) for t in self._elements), one(h.hood_id), one(h.vertex),
                            one(m.region_mean), one(m.region_weight), scalar(m.beta), one(mu0),
                            one(sigma0), one(labels0), one(self.labels), one(self.votes), bnd)

    def begin_em(self, mu, sigma, log_sigma=None) -> None:
        """``log_sigma``, when given, stands for ``torch.log(sigma)``
        (``label_energies_blocked``'s ``log_sig``)."""
        self._params, self._log_sigma = (mu, sigma), log_sigma
        self.ring.zero_()
        self.head = 0

    def step(self, gate: bool, cap: bool = False) -> None:
        h, m = self._hoods, self._model
        y, w, nall_e, valid = self._elements
        self.labels, self.hood_e, self.votes, self._flag, *sums = fused_map_iteration(
            y, w, nall_e, valid, h.hood_id, h.vertex, m.region_mean, m.region_weight,
            self.ring, self.head, self.labels, *self._params, m.beta, gate=gate,
            n_hoods=h.n_hoods, n_vertices=h.n_regions + 1, precision=self.precision,
            conv_tol=self._conv_tol, log_sigma=self._log_sigma,
        )
        self.stats = torch.stack(sums)
        self.head = (self.head - 1) % int(self.ring.shape[0])

    def flag(self) -> int:
        return int(self._flag)


# ---------------------------------------------------------------------------
# The compiled EM program's plain version (``csrc/em_boundary.cuh`` and the
# graph of ``csrc/em_tick.cu``).
# ---------------------------------------------------------------------------

#: Rows of a program's lane block ((len(LANE_WORDS), B) int32), as
#: ``csrc/em_boundary.cuh`` numbers them.  The plain workspaces keep the
#: parity row at 0 (their label buffers are not swapped).
LANE_WORDS = ("active", "map_i", "flag", "running", "em_iters", "map_iters", "status", "parity")
ACTIVE, MAP_I, FLAG, RUNNING, EM_ITERS, MAP_ITERS, STATUS, PARITY = range(len(LANE_WORDS))
#: A program's words ((len(CTL_WORDS),) int32): the lockstep EM iteration,
#: the lockstep MAP iterations, the lanes still in the MAP loop, the two
#: loops' conditions, the boundary's join scratch, the launches of the
#: tick and of the boundary in the solve, and the ``segment_reduce``
#: launches a mode's captured step and M-step made in the graph (by
#: variant), each counted by the kernel.
CTL_WORDS = ("em_i", "steps", "map_live", "em_cond", "map_cond", "ticket", "step_max", "go_on",
             "tick_launches", "boundary_launches", "seg_add", "seg_ordered", "seg_min")
EM_I, STEPS, MAP_LIVE, EM_COND, MAP_COND = range(5)
TICK_LAUNCHES, BOUNDARY_LAUNCHES, SEG_ADD, SEG_ORDERED, SEG_MIN = range(8, 13)

# The health codes (``em.STATUS_*``) and the M-step's constants
# (``energy.params_from_stats``, ``energy.label_total``, ``energy.INERT_MU``).
_OK, _CONVERGED, _MAX_ITERS, _DIVERGED, _DEGENERATE = range(5)
_SEQUENTIAL_LABELS = 8
_INERT_MU = 1.0e8


class BoundaryState(NamedTuple):
    """What an EM boundary reads and writes, with a leading lane axis
    (the single form: the same tensors without it, ``lane`` (8,)).  Every
    tensor is written in place."""

    stats: Tensor         # (B, 3, K): each lane's stopping launch's M-step sums
    hood_e: Tensor        # (B, n_hoods)
    lane: Tensor          # (len(LANE_WORDS), B) int32
    ctl: Tensor           # (len(CTL_WORDS),) int32
    em_mu: Tensor         # (B, K): the EM-level parameters (the solve's result)
    em_sigma: Tensor      # (B, K)
    mu: Tensor            # (B, K): the tick's parameters
    sigma: Tensor         # (B, K): the tick's, clamped at sigma_min
    ring: Tensor          # (B, window + 1, n_hoods): the tick's history ring
    total_hist: Tensor    # (B, window + 1): the total-energy ring, newest first
    sigma_min: Tensor     # (B,)
    reseed_mu: Tensor     # (B, K)
    reseed_sigma: Tensor  # (B,)

    def lanes(self) -> "BoundaryState":
        """The single form's state as one lane (views)."""
        return BoundaryState(*(t if t is self.ctl else t[:, None] if t is self.lane else t[None]
                               for t in self))


def _label_total(sum_w: Tensor) -> Tensor:
    """``energy.label_total``."""
    n_labels = int(sum_w.shape[-1])
    if n_labels > _SEQUENTIAL_LABELS:
        return torch.sum(sum_w, dim=-1, keepdim=True, dtype=torch.float64).to(torch.float32)
    total = sum_w[..., :1]
    for l in range(1, n_labels):
        total = total + sum_w[..., l:l + 1]
    return total


def _window_ok(hist: Tensor, conv_tol: float) -> Tensor:
    """The window test of each row of ``hist`` (newest first)."""
    deltas = torch.abs(hist[:, :-1] - hist[:, 1:])
    scale = torch.clamp_min(torch.abs(hist[:, :1]), 1.0)
    return torch.all(deltas < conv_tol * scale, dim=1)


def em_boundary_lanes(st: BoundaryState, *, max_em_iters: int, max_map_iters: int,
                      conv_tol: float = 1.0e-4, stats_at_zero: bool = False) -> None:
    """The EM boundary of every lane that ran the EM iteration (its
    ``running`` word set), each at its own EM iteration (its ``em_iters``
    word plus one: in a stack every running lane's is the program's, in a
    pool each lane's own), in place: the plain version of the boundary
    kernel, the counterpart of the reference's ``em_body``.

    For such a lane: the M-step's closed form from its stopping launch's
    sums (zeros when its MAP loop ran no iteration) with the cluster-death
    reseed (``energy.params_from_stats``), the divergence test (with the
    MAP loop's ``FLAG_DIVERGED``), the degeneracy test, the total energy
    (float64 sum, rounded once) into its ring, the window test past
    ``window`` EM iterations, its counters and status (``em._boundary_status``),
    and, if it goes on, its next parameters (sigma clamped), an empty
    history ring and its MAP words re-armed.  Then the program's words:
    the EM iteration, the lockstep MAP iterations, the lanes that go on
    (the next MAP loop's live count) and the two loops' conditions.
    ``stats_at_zero`` reads a lane's sums even when its MAP loop ran no
    iteration (the modes, whose M-step reads the labels it starts from)."""
    lane, ctl = st.lane, st.ctl
    window = int(st.total_hist.shape[1]) - 1
    run = lane[RUNNING] != 0
    i = lane[MAP_I].clone()
    stats = st.stats if stats_at_zero else torch.where((i > 0)[:, None, None], st.stats, 0.0)
    sum_w, sum_wy, sum_wyy = stats[:, 0], stats[:, 1], stats[:, 2]
    safe_w = torch.clamp_min(sum_w, 1e-6)
    mu = sum_wy / safe_w
    var = (sum_wyy / safe_w).double() - mu.double() * mu.double()
    var = torch.clamp_min(var.float(), 0.0)
    sigma = torch.maximum(torch.sqrt(var), st.sigma_min[:, None])
    dead = sum_w < 1e-3 * _label_total(sum_w)
    mu = torch.where(dead, st.reseed_mu, mu)
    sigma = torch.where(dead, st.reseed_sigma[:, None], sigma)
    div = ~torch.all(torch.isfinite(mu), dim=-1) | ~torch.all(torch.isfinite(sigma), dim=-1)
    deg = torch.any(dead & (st.reseed_mu < _INERT_MU) & (sigma <= st.sigma_min[:, None]), dim=-1)
    total = torch.sum(st.hood_e, dim=-1, dtype=torch.float64).to(torch.float32)
    hist = torch.cat([total[:, None], st.total_hist[:, :-1]], dim=1)
    em_i = lane[EM_ITERS] + 1  # each lane's own EM iteration (a pool's differ)
    conv = (em_i > window) & _window_ok(hist, conv_tol)
    div = div | ((lane[FLAG] & FLAG_DIVERGED) != 0)
    finished = div | ~((em_i < max_em_iters) & ~conv)
    status = torch.where(div, _DIVERGED, torch.where(finished & deg, _DEGENERATE, torch.where(
        conv, _CONVERGED, torch.where(em_i >= max_em_iters, _MAX_ITERS, _OK)))).to(torch.int32)
    go = run & ~finished
    on = run[:, None]
    st.em_mu.copy_(torch.where(on, mu, st.em_mu))
    st.em_sigma.copy_(torch.where(on, sigma, st.em_sigma))
    st.total_hist.copy_(torch.where(on, hist, st.total_hist))
    st.mu.copy_(torch.where(go[:, None], mu, st.mu))
    st.sigma.copy_(torch.where(go[:, None], torch.maximum(sigma, st.sigma_min[:, None]), st.sigma))
    st.ring.masked_fill_(go[:, None, None], 0.0)
    lane[EM_ITERS] = torch.where(run, em_i, lane[EM_ITERS])
    lane[MAP_ITERS] += torch.where(run, i, 0)
    lane[STATUS] = torch.where(run, status, lane[STATUS])
    lane[RUNNING] = torch.where(run, (~(conv | div)).to(torch.int32), lane[RUNNING])
    lane[MAP_I] = torch.where(go, 0, i)
    lane[FLAG] = torch.where(go, 0, lane[FLAG])
    lane[ACTIVE] = torch.where(go, int(max_map_iters > 0), lane[ACTIVE])
    n_go = go.sum().to(torch.int32)
    ctl[STEPS] += torch.max(torch.where(run, i, 0))
    ctl[BOUNDARY_LAUNCHES] += 1
    ctl[EM_I] += 1
    ctl[MAP_LIVE] = n_go
    ctl[EM_COND] = (n_go > 0).to(torch.int32)
    ctl[MAP_COND] = int(max_map_iters > 0)


def em_boundary(st: BoundaryState, *, max_em_iters: int, max_map_iters: int,
                conv_tol: float = 1.0e-4) -> None:
    """:func:`em_boundary_lanes` of one problem (``st`` without the lane
    axis, ``lane`` (8,)): the single form."""
    em_boundary_lanes(st.lanes(), max_em_iters=max_em_iters, max_map_iters=max_map_iters,
                      conv_tol=conv_tol)


class ProgramState(NamedTuple):
    """A plain program's tensors, with a leading lane axis: the solve's
    inputs, the MAP iteration's state and the EM boundary's."""

    y: Tensor
    w: Tensor
    nall: Tensor
    valid: Tensor
    hood_id: Tensor
    vertex: Tensor
    region_mean: Tensor
    region_weight: Tensor
    beta: Tensor           # (B,)
    mu0: Tensor
    sigma0: Tensor
    labels0: Tensor
    labels: Tensor         # (B, n_vertices)
    votes: Tensor          # (B, K, n_vertices)
    boundary: BoundaryState


def program_begin(p: ProgramState, *, max_em_iters: int, max_map_iters: int) -> None:
    """The start of a solve, in place: the plain version of the program's
    init kernel (every lane's initial labels, empty rings and hood
    energies, parameters from ``mu0``/``sigma0``, every lane running and,
    if the MAP loop runs at all, active; the program's words).  With no
    ``labels0`` the labels are left as they are (the modes' ``start``
    copies them in)."""
    b = p.boundary
    if p.labels0 is not None:
        p.labels.copy_(p.labels0)
    b.hood_e.zero_()
    b.ring.zero_()
    b.total_hist.zero_()
    b.em_mu.copy_(p.mu0)
    b.em_sigma.copy_(p.sigma0)
    b.mu.copy_(p.mu0)
    b.sigma.copy_(torch.maximum(p.sigma0, b.sigma_min[:, None]))
    b.lane.zero_()
    b.lane[ACTIVE] = int(max_em_iters > 0 and max_map_iters > 0)
    b.lane[RUNNING] = 1
    b.ctl.zero_()
    b.ctl[MAP_LIVE] = int(b.lane.shape[1]) if max_map_iters > 0 else 0
    b.ctl[EM_COND] = int(max_em_iters > 0)
    b.ctl[MAP_COND] = int(max_map_iters > 0)


def program_map_iteration(p: ProgramState, *, max_map_iters: int, n_hoods: int, n_vertices: int,
                          precision: str = "f32", conv_tol: float = 1.0e-4) -> None:
    """One MAP iteration of every active lane, in place: the plain version
    of the tick's lane entry in the program (each lane's ring head, gate
    and cap from its MAP counter, as :func:`fused_map_iteration_batched`
    with ``map_i`` takes them); the lanes that stop leave the live count,
    and the last to stop ends the MAP loop (``map_cond`` 0)."""
    b = p.boundary
    active = b.lane[ACTIVE]
    before = active.clone()
    fused_map_iteration_batched(
        p.y, p.w, p.nall, p.valid, p.hood_id, p.vertex, p.region_mean, p.region_weight, b.ring, 0,
        p.labels, p.votes, b.hood_e, b.stats, b.lane[FLAG], active, b.mu, b.sigma, p.beta,
        gate=False, cap=False, n_hoods=n_hoods, n_vertices=n_vertices, precision=precision,
        conv_tol=conv_tol, map_i=b.lane[MAP_I], max_map_iters=max_map_iters)
    b.ctl[MAP_LIVE] -= (before - active).sum().to(torch.int32)
    b.ctl[MAP_COND] = (b.ctl[MAP_LIVE] > 0).to(torch.int32)
    b.ctl[TICK_LAUNCHES] += 1


def run_program(ws, marks=None, map_scope: str = "map_iteration",
                em_scope: str = "em_boundary") -> None:
    """The compiled EM program's control structure on a plain workspace
    (``ws``: ``program_begin``, ``program_step``, ``program_boundary`` and
    its ``ctl`` words), the plain version of the graph: the loops the graph
    holds (none when ``max_em_iters`` is 0, no MAP loop when
    ``max_map_iters`` is 0), each steered by the condition word the step
    or the boundary wrote, read after it, as a graph's WHILE node reads its
    handle.  ``marks`` (a census, or None) gets a scope per MAP iteration
    and per EM boundary."""
    ctl = ws.ctl
    ws.program_begin()
    if ws.max_em_iters <= 0:
        return
    while True:
        if ws.max_map_iters > 0:
            while True:
                if marks is not None:
                    marks.enter(map_scope)
                ws.program_step()
                if not int(ctl[MAP_COND]):
                    break
            if marks is not None:
                marks.leave(map_scope)
        if marks is not None:
            marks.enter(em_scope)
        ws.program_boundary()
        if not int(ctl[EM_COND]):
            break
    if marks is not None:
        marks.leave(em_scope)


def program_result(lane: Tensor, ctl: Tensor) -> Tuple[list, list, list, int]:
    """A program's counters, one host read: each lane's EM iterations, MAP
    iterations and status, and the lockstep MAP iterations."""
    words = torch.cat([lane[EM_ITERS:STATUS + 1].reshape(-1), ctl[STEPS:STEPS + 1]]).tolist()
    n = int(lane.shape[1])
    return words[:n], words[n:2 * n], words[2 * n:3 * n], words[3 * n]


#: A tick's words (``csrc/em_control.cuh``'s ``TickWord``): the micro-steps
#: taken (``tick_tail``'s count), the tick's size, the micro-steps in which
#: some lane stopped, the plain version's WHILE and IF conditions (on the
#: card the handles), and the launches of ``tick_init``, ``tick_stops`` and
#: ``tick_publish``, each counted by the kernel and set back to 0 once
#: published.
TICK_WORDS = ("steps", "iters", "stops", "loop_cond", "stop_cond", "init_runs", "stop_runs",
              "publish_runs")
T_STEPS, T_ITERS, T_STOPS, T_LOOP, T_STOP, T_INIT_RUNS, T_STOP_RUNS, T_PUBLISH_RUNS = range(
    len(TICK_WORDS))
#: What :func:`tick_publish` reads after the lanes' words (``em_tick.TICK_OUT``).
TICK_OUT = ("steps", "ticks", "boundaries", "stops", "tick_init", "tick_stops", "tick_publish",
            "seg_add", "seg_ordered", "seg_min")


def tick_init(lane: Tensor, ctl: Tensor, tick: Tensor, in_words: Tensor) -> None:
    """The plain version of ``em_control::tick_init``: each lane's EM
    counters and status from ``in_words`` ((1 + 3 B,) int32 on the host:
    the tick's size, then ``em_iters``, ``map_iters`` and ``status`` of
    every lane; the card's are mapped host words),
    every active lane running the next step, the tick's words and the
    program's counters zeroed, its own launch counted, the loop's
    condition."""
    b = int(lane.shape[1])
    in_words = in_words.to(lane.device)
    for row, j in ((EM_ITERS, 1), (MAP_ITERS, 1 + b), (STATUS, 1 + 2 * b)):
        lane[row].copy_(in_words[j:j + b])
    act = lane[ACTIVE] != 0
    lane[RUNNING].copy_(act)
    tick[:T_INIT_RUNS].zero_()
    tick[T_ITERS] = in_words[0]
    tick[T_INIT_RUNS] += 1
    ctl[5:].zero_()  # the boundary's join scratch and the launch counts
    tick[T_LOOP] = (in_words[0] > 0) & act.any()


def tick_stops(lane: Tensor, tick: Tensor, max_map_iters: int) -> None:
    """The plain version of ``em_control::tick_stops``: a lane that ran the
    step stops its MAP loop when its flag word is set or its counter is at
    the cap; ``running`` is left set for those lanes alone, and the IF
    condition is set when there is one; its own launch counted."""
    stop = (lane[RUNNING] != 0) & ((lane[FLAG] != 0) | (lane[MAP_I] == max_map_iters))
    lane[RUNNING].copy_(stop)
    some = stop.any()
    tick[T_STOP_RUNS] += 1
    tick[T_STOPS] += some
    tick[T_STOP] = some


def tick_tail(lane: Tensor, tick: Tensor) -> None:
    """The plain version of ``em_control::tick_tail``: one more micro-step,
    every active lane running the next, and the loop's condition (steps
    below the tick's size and some lane active)."""
    act = lane[ACTIVE] != 0
    lane[RUNNING].copy_(act)
    tick[T_STEPS] += 1
    tick[T_LOOP] = (tick[T_STEPS] < tick[T_ITERS]) & act.any()


def tick_publish(lane: Tensor, ctl: Tensor, tick: Tensor) -> dict:
    """The plain version of ``em_control::tick_publish`` and of its read:
    its own launch counted, then one host read of every lane's
    ``(em_iters, map_iters, status, map_i, active)`` (under ``"lanes"``)
    and of :data:`TICK_OUT` (the micro-steps, the step's and the
    boundary's launches, the micro-steps in which some lane stopped, the
    control kernels' and the ``segment_reduce`` launches); the control
    kernels' counts are set back to 0."""
    b = int(lane.shape[1])
    tick[T_PUBLISH_RUNS] += 1
    per_lane = torch.stack([lane[EM_ITERS], lane[MAP_ITERS], lane[STATUS], lane[MAP_I],
                            lane[ACTIVE]], dim=1).reshape(-1)
    words = torch.cat([per_lane, tick[T_STEPS:T_STEPS + 1], ctl[TICK_LAUNCHES:BOUNDARY_LAUNCHES + 1],
                       tick[T_STOPS:T_STOPS + 1], tick[T_INIT_RUNS:], ctl[SEG_ADD:]]).tolist()
    tick[T_INIT_RUNS:].zero_()
    out = dict(zip(TICK_OUT, words[5 * b:]))
    out["lanes"] = [tuple(words[5 * j:5 * j + 5]) for j in range(b)]
    return out


def map_ctl(lane: Tensor, ctl: Tensor) -> None:
    """The plain version of ``em_control::map_ctl``: the step's count and
    the MAP loop's condition (some lane still active)."""
    ctl[TICK_LAUNCHES] += 1
    ctl[MAP_COND] = (lane[ACTIVE] != 0).any()


def lane_controls(map_i: int, rows: int, max_map_iters: int) -> Tuple[int, bool, bool]:
    """The ring head, gate and cap bit of the MAP iteration ``i = map_i +
    1`` of a lane whose loop has taken ``map_i``, as the pool entry of the
    kernel derives them and as the single-problem driver passes them: head
    0 at ``i = 1`` and one row back per iteration, the gate open past the
    window (``rows - 1``), the cap at ``max_map_iters``."""
    i = map_i + 1
    return (-(i - 1)) % rows, i > rows - 1, i == max_map_iters


def fused_map_iteration_batched(
    y: Tensor,
    w: Tensor,
    nall_e: Tensor,
    valid: Tensor,
    hood_id: Tensor,
    vertex: Tensor,
    region_mean: Tensor,
    region_weight: Tensor,
    ring: Tensor,
    head: int,
    labels: Tensor,
    votes: Tensor,
    hood_e: Tensor,
    stats: Tensor,
    flags: Tensor,
    active: Tensor,
    mu: Tensor,
    sigma: Tensor,
    beta: Tensor,
    *,
    gate: bool,
    cap: bool,
    n_hoods: int,
    n_vertices: int,
    precision: str = "f32",
    conv_tol: float = 1.0e-4,
    log_sigma: Optional[Tensor] = None,
    map_i: Optional[Tensor] = None,
    max_map_iters: int = 0,
) -> None:
    """One MAP iteration of every active lane of a stack, in place: the
    plain version of the batched tick.  Every argument but ``head`` and the
    keywords carries a leading lane axis (``beta`` (B,), ``active`` (B,)
    bool, ``flags`` (B,) int32).  Lane b, if ``active[b]``, runs
    :func:`fused_map_iteration` on its rows and writes its ``labels``,
    ``votes``, ``hood_e``, ring row and flag word; if the lane stops (its
    flag word set, or ``cap``) it also writes its M-step sums into
    ``stats`` and clears ``active[b]``.  An inactive lane's rows stay as
    they were.

    With ``map_i`` ((B,) int32, the pool entry's MAP counters) each lane
    takes its own ``head``, ``gate`` and ``cap`` from :func:`lane_controls`
    (``head``, ``gate`` and ``cap`` are then ignored) and its counter goes
    up by one."""
    rows = int(ring.shape[1])
    for b in torch.nonzero(active).flatten().tolist():
        if map_i is not None:
            i = int(map_i[b])
            head, gate, cap = lane_controls(i, rows, max_map_iters)
            map_i[b] = i + 1
        new_labels, he, v, flag, *sums = fused_map_iteration(
            y[b], w[b], nall_e[b], valid[b], hood_id[b], vertex[b], region_mean[b],
            region_weight[b], ring[b], head, labels[b], mu[b], sigma[b], beta[b], gate=gate,
            n_hoods=n_hoods, n_vertices=n_vertices, precision=precision, conv_tol=conv_tol,
            log_sigma=None if log_sigma is None else log_sigma[b],
        )
        labels[b], votes[b], hood_e[b], flags[b] = new_labels, v, he, flag
        if int(flag) or cap:
            stats[b] = torch.stack(sums)
            active[b] = False


class PlainBatchTickWorkspace(_PlainProgram):
    """The plain version of ``em_tick.BatchTickWorkspace`` (same methods
    and views), one :func:`fused_map_iteration_batched` per step: the
    batched EM driver's route on the CPU, or on the card with
    ``backend="torch"``; built with the EM limits, the plain program of a
    stack (:meth:`run_program`)."""

    #: The EM mode whose MAP iteration the workspace steps.
    mode = "static-pallas"

    def __init__(self, shape: TickShape, batch: int, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3, max_em_iters=None,
                 max_map_iters=None):
        self.shape, self.batch = shape, batch
        self.device, self.precision = torch.device(device), precision
        self.n_labels, self._conv_tol = shape.n_labels, conv_tol
        dev, f32 = self.device, torch.float32
        self.ring = torch.zeros((batch, window + 1, shape.n_hoods), dtype=f32, device=dev)
        self.labels = torch.zeros((batch, shape.n_vertices), dtype=torch.int32, device=dev)
        self.votes = torch.zeros((batch, shape.n_labels, shape.n_vertices), dtype=f32, device=dev)
        self.hood_e = torch.zeros((batch, shape.n_hoods), dtype=f32, device=dev)
        self.stats = torch.zeros((batch, 3, shape.n_labels), dtype=f32, device=dev)
        self.active = torch.zeros((batch,), dtype=torch.bool, device=dev)
        self._flags = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.head = 0
        if max_em_iters is not None:
            self._program_buffers(batch, window, max_em_iters, max_map_iters)

    def start(self, hoods, model, y, w, nall_e, valid, labels0, mu0=None, sigma0=None) -> None:
        """Bind a stack's solve; ``mu0`` and ``sigma0`` (B, K) are the
        program's start."""
        if TickShape.of(hoods, model) != self.shape or labels0.shape[0] != self.batch:
            raise ValueError(f"a stack of {labels0.shape[0]} problems of "
                             f"{TickShape.of(hoods, model)}; the workspace was built for "
                             f"{self.batch} of {self.shape}")
        self._hoods, self._model = hoods, model
        self._elements = (y, w, nall_e, valid)
        self._start = (labels0, mu0, sigma0)
        self.labels.copy_(labels0)
        self.active.zero_()

    def _program(self) -> ProgramState:
        h, m = self._hoods, self._model
        labels0, mu0, sigma0 = self._start
        bnd = BoundaryState(self.stats, self.hood_e, self.lane, self.ctl, self.em_mu,
                            self.em_sigma, self.mu, self.sigma, self.ring, self.total_hist,
                            m.sigma_min, m.reseed_mu, m.reseed_sigma)
        return ProgramState(*self._elements, h.hood_id, h.vertex, m.region_mean, m.region_weight,
                            m.beta, mu0, sigma0, labels0, self.labels, self.votes, bnd)

    def begin_em(self, mu, sigma, active, log_sigma=None) -> None:
        """``log_sigma`` (B, K), when given, stands for ``torch.log(sigma)``."""
        self._params, self._log_sigma = (mu, sigma), log_sigma
        self.active.copy_(torch.as_tensor([bool(a) for a in active]))
        self.ring.zero_()
        self.head = 0

    def step(self, gate: bool, cap: bool = False) -> None:
        h, m = self._hoods, self._model
        fused_map_iteration_batched(
            *self._elements, h.hood_id, h.vertex, m.region_mean, m.region_weight, self.ring,
            self.head, self.labels, self.votes, self.hood_e, self.stats, self._flags,
            self.active, *self._params, m.beta, gate=gate, cap=cap, n_hoods=h.n_hoods,
            n_vertices=h.n_regions + 1, precision=self.precision, conv_tol=self._conv_tol,
            log_sigma=self._log_sigma,
        )
        self.head = (self.head - 1) % int(self.ring.shape[1])

    def flags(self) -> list:
        return self._flags.tolist()


class PlainPoolTickWorkspace:
    """The plain version of ``em_tick.PoolTickWorkspace`` (same methods and
    views): the continuous-batching driver's route on the CPU, or on the
    card with ``backend="torch"``.  One :func:`fused_map_iteration_batched`
    with the pool's MAP counters per step.  It owns its lanes' inputs, the
    element arrays' ``hood_id`` too (the kernel reads the hood runs from
    ``offsets`` instead).  ``log_sigma`` ((B, K), or None), when set,
    stands for ``torch.log(sigma)`` of every lane
    (``label_energies_blocked``'s ``log_sig``)."""

    #: The EM mode whose MAP iteration the workspace steps.
    mode = "static-pallas"
    #: Its tick is the plain program's (``em._tick_program``), not a graph.
    graph_tick = False
    program = None

    def __init__(self, shape: TickShape, batch: int, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3, max_map_iters: int = 10,
                 max_em_iters=None):
        self.max_em_iters = max_em_iters
        if batch < 1 or max_map_iters < 1:
            raise ValueError(f"PlainPoolTickWorkspace needs batch >= 1 and max_map_iters >= 1, "
                             f"got {batch} and {max_map_iters}")
        self.shape, self.batch, self.max_map_iters = shape, batch, max_map_iters
        self.device, self.precision = torch.device(device), precision
        self.n_labels, self._conv_tol = shape.n_labels, conv_tol
        dev, f32, i32 = self.device, torch.float32, torch.int32
        cap, nh, nv, k = shape
        z = lambda *s, dtype=f32: torch.zeros((batch, *s), dtype=dtype, device=dev)  # noqa: E731
        self.y, self.w, self.nall, self.valid = (z(cap) for _ in range(4))
        self.hood_id, self.vertex = z(cap, dtype=i32), z(cap, dtype=i32)
        self.region_mean, self.region_weight = z(nv), z(nv)
        self.beta = z()
        self.mu, self.sigma = z(k), torch.ones((batch, k), dtype=f32, device=dev)
        self.log_sigma = None
        self.labels = z(nv, dtype=i32)
        self.votes = z(k, nv)
        self.ring = z(window + 1, nh)
        self.hood_e = z(nh)
        self.stats = z(3, k)
        self.em_mu, self.em_sigma = z(k), torch.ones((batch, k), dtype=f32, device=dev)
        self.total_hist = z(window + 1)
        self.sigma_min, self.reseed_sigma = (torch.ones((batch,), dtype=f32, device=dev)
                                             for _ in range(2))
        self.reseed_mu = z(k)
        # The lane block: the step's active word, MAP counter and flag word
        # are views of its rows.
        self.lane = torch.zeros((len(LANE_WORDS), batch), dtype=i32, device=dev)
        self.ctl = torch.zeros((len(CTL_WORDS),), dtype=i32, device=dev)
        self.tick = torch.zeros((len(TICK_WORDS),), dtype=i32, device=dev)
        self.active, self.map_i, self._flags = self.lane[ACTIVE], self.lane[MAP_I], self.lane[FLAG]
        self.owner = None

    def admit(self, slot: int, hoods, model, y, w, nall_e, valid, labels0) -> None:
        if (hoods.capacity, hoods.n_hoods, hoods.n_regions + 1, model.n_labels) != self.shape:
            raise ValueError(f"a problem of {TickShape.of(hoods, model)}; the pool was built "
                             f"for {self.shape}")
        self.active[slot] = False
        for dst, src in ((self.y, y), (self.w, w), (self.nall, nall_e), (self.valid, valid),
                         (self.hood_id, hoods.hood_id), (self.vertex, hoods.vertex),
                         (self.region_mean, model.region_mean),
                         (self.region_weight, model.region_weight), (self.beta, model.beta),
                         (self.labels, labels0)):
            dst[slot].copy_(src)
        self.votes[slot].zero_()
        self.map_i[slot] = 0

    def begin_lanes(self, slots, mu, sigma) -> None:
        for j, b in enumerate(slots):
            self.mu[b], self.sigma[b] = mu[j], sigma[j]
            self.ring[b].zero_()
            self.map_i[b] = 0
            self.active[b] = True

    def retire(self, slot: int) -> None:
        self.active[slot] = False

    def program_step(self) -> None:
        """The plain tick's step (:meth:`step`)."""
        self.step()

    def step(self) -> None:
        nh, nv = self.shape.n_hoods, self.shape.n_vertices
        fused_map_iteration_batched(
            self.y, self.w, self.nall, self.valid, self.hood_id, self.vertex, self.region_mean,
            self.region_weight, self.ring, 0, self.labels, self.votes, self.hood_e, self.stats,
            self._flags, self.active, self.mu, self.sigma, self.beta, gate=False, cap=False,
            n_hoods=nh, n_vertices=nv, precision=self.precision, conv_tol=self._conv_tol,
            log_sigma=self.log_sigma, map_i=self.map_i, max_map_iters=self.max_map_iters,
        )

    def flags(self) -> list:
        return self._flags.tolist()

    def boundary_state(self) -> BoundaryState:
        """The boundary's tensors over the pool (its lane form)."""
        return BoundaryState(self.stats, self.hood_e, self.lane, self.ctl, self.em_mu,
                             self.em_sigma, self.mu, self.sigma, self.ring, self.total_hist,
                             self.sigma_min, self.reseed_mu, self.reseed_sigma)


class PlainMapStepWorkspace:
    """The plain version of ``map_step.MapStepWorkspace`` (same methods and
    views): the sharded EM driver's route on the CPU, or on the card with
    ``backend="torch"``.

    A step's head takes the labels from the last buffer's votes (first
    maximum, the sentinel vertex 0), tests its hood sums against the
    history ring (the window predicate of :func:`fused_em_tick`, gated, and
    finiteness) and writes them into the ring; the step counts the labels
    of every hood over the whole partition, gathers the counts per element
    of this rank's block and runs :func:`fused_map_step` on the block.  Its
    hood sums are zero for hoods with no element in the block, since the
    keyed sum gives those nothing.  A step whose flag word is not 0, or
    that takes no step, also puts the M-step sums of the head's labels in
    ``stats``, as :func:`fused_em_tick` sums them.
    """

    def __init__(self, hoods, model, *, rank: int = 0, n_shards: int = 1,
                 conv_tol: float = 1.0e-4, window: int = 3):
        cap = hoods.capacity
        if n_shards < 1 or cap % n_shards or not 0 <= rank < n_shards:
            raise ValueError(f"rank {rank} of {n_shards} does not split capacity {cap}")
        self.device, self.n_labels = hoods.vertex.device, model.n_labels
        self.block = cap // n_shards
        self.base = rank * self.block
        self._hoods, self._model, self._conv_tol = hoods, model, conv_tol
        self.n_hoods, self.n_vertices = hoods.n_hoods, hoods.n_regions + 1
        f32 = torch.float32
        self._labels = torch.zeros((self.n_vertices,), dtype=torch.int32, device=self.device)
        self._buffers = torch.zeros((3, self.n_hoods + self.n_labels * self.n_vertices), dtype=f32,
                                    device=self.device)
        self.ring = torch.zeros((window + 1, self.n_hoods), dtype=f32, device=self.device)
        self.flag_word = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self.stats = torch.zeros((3, self.n_labels), dtype=f32, device=self.device)
        self.rot, self.head, self.first = 0, 0, True

    def start(self, y, w, nall_e, valid, labels0) -> None:
        self._elements = (y, w, nall_e, valid)
        self._labels.copy_(labels0)

    def begin_em(self, mu, sigma, log_sigma=None) -> None:
        """``log_sigma``, when given, stands for ``torch.log(sigma)``
        (``label_energies_blocked``'s ``log_sig``)."""
        self._params, self._log_sigma = (mu, sigma), log_sigma
        self.first = True
        self.head = 0

    def step(self, gate: bool, step: bool = True) -> None:
        h, m = self._hoods, self._model
        nh, nv, n_labels = self.n_hoods, self.n_vertices, self.n_labels
        prev, cur, nxt = (self._buffers[(self.rot + d) % 3] for d in (2, 0, 1))
        flag = 0
        if not self.first:
            he, votes = prev[:nh], prev[nh:].view(n_labels, nv)
            self._labels.copy_(torch.argmax(votes, dim=0))  # first maximum on ties
            self._labels[nv - 1] = 0
            rows = int(self.ring.shape[0])
            order = [(self.head + r) % rows for r in range(rows)]
            hist = torch.cat([he[None], self.ring[order[:-1]]])
            scale = torch.clamp_min(torch.abs(he), 1.0)
            ok = torch.all(torch.abs(hist[:-1] - hist[1:]) < self._conv_tol * scale)
            self.ring[order[-1]] = he
            self.head = (self.head - 1) % rows
            flag = int(bool(ok) and gate) * FLAG_CONVERGED | int(
                not bool(torch.all(torch.isfinite(he)))) * FLAG_DIVERGED
        self.flag_word.fill_(flag)
        if flag or not step:
            lab, w, y = self._labels.long(), m.region_weight, m.region_mean
            self.stats = torch.stack([keyed_sum(v, lab, n_labels) for v in (w, w * y, w * y * y)])
        if step:
            x = self._labels[h.vertex.long()]
            seg_h = torch.where(h.valid, h.hood_id.long(), nh)
            counts = keyed_sum(h.valid.to(torch.float32), seg_h * n_labels + x.long(),
                               (nh + 1) * n_labels).reshape(nh + 1, n_labels)
            b = slice(self.base, self.base + self.block)
            hood_id, vertex = h.hood_id[b], h.vertex[b]
            y, w, nall_e, valid = self._elements
            cnt_e = counts[hood_id.long()].T.contiguous()
            xf = x[b].to(torch.float32) * valid
            mu, sigma = self._params
            _, _, hood_e, votes = fused_map_step(
                y, w, cnt_e, nall_e, xf, valid, hood_id, vertex, mu, sigma, m.beta,
                n_hoods=nh, n_vertices=nv, log_sigma=self._log_sigma)
            cur[:nh] = hood_e
            cur[nh:] = votes.reshape(-1)
        nxt[nh:] = 0.0
        self.first = False
        self.rot = (self.rot + 1) % 3

    def flag(self) -> int:
        return int(self.flag_word[0])

    @property
    def buffer(self) -> Tensor:
        return self._buffers[(self.rot - 1) % 3]

    @property
    def labels(self) -> Tensor:
        return self._labels

    @property
    def hood_e(self) -> Tensor:
        return self._buffers[(self.rot - 2) % 3, : self.n_hoods]

    @property
    def votes(self) -> Tensor:
        return self._buffers[(self.rot - 2) % 3, self.n_hoods:].view(self.n_labels, self.n_vertices)


def flash_attention(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False, scale: float | None = None
) -> Tensor:
    """Naive ``softmax(scale * Q K^T [causal-masked]) V`` with the GQA head
    map (kv head = q head // group): the contract of the flash kernel.

    q: (B, Hq, S, D), k/v: (B, Hkv, S, D) with Hq % Hkv == 0.  Computed in
    float32 whatever the input type, as the kernel does; the output is in
    q's dtype.  ``repro.kernels.ref.flash_attention`` computes the same
    function (in the input type up to the softmax).
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads do not split into {hkv} kv heads")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
