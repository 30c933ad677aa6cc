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
    values: Tensor, segment_ids: Tensor, num_segments: int, op: str = "add"
) -> Tensor:
    """1-D ReduceByKey.  Ids outside ``[0, num_segments)`` are ignored;
    empty segments give 0 (``add``) or +inf (``min``)."""
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


class PlainTickWorkspace:
    """The plain version of ``em_tick.TickWorkspace`` (same methods and
    views), one :func:`fused_map_iteration` per step: the single-device
    EM driver's route on the CPU, or on the card with ``backend="torch"``.
    Its ``stats`` are every step's M-step sums (the kernel's only those of
    a step that stops the MAP loop, which are the ones the driver reads).
    """

    def __init__(self, shape: TickShape, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3):
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

    def start(self, hoods, model, y, w, nall_e, valid, labels0) -> None:
        if TickShape.of(hoods, model) != self.shape:
            raise ValueError(f"a problem of {TickShape.of(hoods, model)}; the workspace was "
                             f"built for {self.shape}")
        self._hoods, self._model = hoods, model
        self._elements = (y, w, nall_e, valid)
        self.labels = labels0.clone()

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


class PlainBatchTickWorkspace:
    """The plain version of ``em_tick.BatchTickWorkspace`` (same methods
    and views), one :func:`fused_map_iteration_batched` per step: the
    batched EM driver's route on the CPU, or on the card with
    ``backend="torch"``."""

    def __init__(self, shape: TickShape, batch: int, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3):
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

    def start(self, hoods, model, y, w, nall_e, valid, labels0) -> None:
        if TickShape.of(hoods, model) != self.shape or labels0.shape[0] != self.batch:
            raise ValueError(f"a stack of {labels0.shape[0]} problems of "
                             f"{TickShape.of(hoods, model)}; the workspace was built for "
                             f"{self.batch} of {self.shape}")
        self._hoods, self._model = hoods, model
        self._elements = (y, w, nall_e, valid)
        self.labels.copy_(labels0)
        self.active.zero_()

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

    def __init__(self, shape: TickShape, batch: int, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3, max_map_iters: int = 10):
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
        self.active = z(dtype=torch.bool)
        self.map_i = z(dtype=i32)
        self._flags = z(dtype=i32)
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
