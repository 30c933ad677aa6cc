"""The host-stepped drivers: the single-device EM loops as the port ran
them before the compiled programs (``core.pmrf.em._run_program``,
``em._tick_program``), in every mode.

Each MAP iteration is one ``step`` of a workspace and one wait for its
flag words; each EM boundary is the host's (``energy.params_from_stats``,
``em._degenerate_components``, ``em._total_energy``, ``em._boundary_status``:
some 58 device operations and one host read), or, in a pool, one launch
of the boundary kernel's lane form and one read of the words it wrote.
The drivers take the same arguments and give the same results, bit for
bit, as ``em.run_em``, ``em.run_em_batched`` and ``em.run_em_ticked``, so
they are what the programs are held to on the CPU, what the per-launch
checks step on the card (``chip_smoke.py``'s ``TickLockstep``, a
workspace wrapper that compares every launch with the CPU), and the route
the programs' timings are set beside.  In mode ``static-pallas`` a
workspace is a tick workspace of the solve's bucket
(``kernels.ops.tick_workspace``, with or without a program), or a wrapper
with its ``start``/``begin_em``/``step``/``flag`` methods; in the modes
``static`` and ``faithful`` the single solve is ``em._em_driver`` on the
single-device context (the sharded route's driver; it takes no
workspace) and a stack steps a ``em.DppBatchWorkspace``.
"""

from __future__ import annotations

import torch

from repro_torch.core.pmrf import collectives
from repro_torch.core.pmrf import em as em_mod
from repro_torch.core.pmrf import energy as E
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (ACTIVE, CTL_WORDS, EM_ITERS, MAP_ITERS, STATUS,
                                     BoundaryState)

__all__ = ["run_em", "run_em_batched", "run_em_ticked"]


def _workspace(hoods, model, config: em_mod.EMConfig, device, batch=None):
    return kops.tick_workspace(kops.TickShape.of(hoods, model), device=device, batch=batch,
                               max_map_iters=config.max_map_iters, precision=config.precision,
                               conv_tol=em_mod.CONV_TOL, window=em_mod.WINDOW,
                               backend=config.backend)


def run_em(hoods, model, labels0, mu0, sigma0, config: em_mod.EMConfig = em_mod.EMConfig(), *,
           workspace=None) -> em_mod.EMResult:
    """One problem, the MAP loop stepped from the host: per MAP iteration
    one launch (in the modes the paper's primitive sequence) and one flag
    read, per EM iteration the host's boundary and one read of its three
    tests."""
    if config.mode != "static-pallas":
        if workspace is not None:
            raise ValueError(f"the host-stepped mode {config.mode!r} takes no workspace")
        return em_mod._em_driver(hoods, model, labels0, mu0, sigma0, config, collectives.LOCAL)
    em_mod.validate_config(config)
    n_hoods, dev, f32 = hoods.n_hoods, labels0.device, torch.float32
    sctx = E.make_static_context(hoods, model, backend=config.backend)
    ws = workspace if workspace is not None else _workspace(hoods, model, config, dev)
    ws.start(hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)
    mu, sigma = mu0, sigma0
    hood_energy = torch.zeros((n_hoods,), dtype=f32, device=dev)
    total_hist = torch.zeros((em_mod.WINDOW + 1,), dtype=f32, device=dev)
    em_i = map_total = 0
    status, done = em_mod.STATUS_OK, False
    while em_i < config.max_em_iters and not done:
        # MAP loop: one launch and one flag read per iteration; the launch
        # that stops the loop takes the M-step sums.
        i = flag = 0
        ws.begin_em(mu, torch.maximum(sigma, model.sigma_min))
        while i < config.max_map_iters and not flag:
            i += 1
            ws.step(i > em_mod.WINDOW, i == config.max_map_iters)
            flag = ws.flag()
        if i:
            hood_energy, msums = ws.hood_e, ws.stats
        else:
            hood_energy = torch.zeros((n_hoods,), dtype=f32, device=dev)
            msums = torch.zeros((3, mu.shape[0]), dtype=f32, device=dev)
        mu, sigma, sum_w = E.params_from_stats(model, msums[0], msums[1], msums[2])
        div_t = ~torch.all(torch.isfinite(mu)) | ~torch.all(torch.isfinite(sigma))
        deg_t = em_mod._degenerate_components(model, sigma, sum_w)
        total_hist = torch.cat([em_mod._total_energy(hood_energy)[None], total_hist[:-1]])
        em_i += 1
        if em_i > em_mod.WINDOW:
            conv_t = em_mod._window_converged(total_hist)
        else:
            conv_t = torch.zeros_like(div_t)
        div, deg, em_conv = (bool(v) for v in torch.stack([div_t, deg_t, conv_t]).tolist())
        div = div or bool(flag & kops.FLAG_DIVERGED)
        map_total += i
        finished = div or not (em_i < config.max_em_iters and not em_conv)
        done = em_conv or div
        status = em_mod._boundary_status(div, deg, finished, em_conv, em_i, config.max_em_iters)
    hood_energy = hood_energy.clone()
    return em_mod.EMResult(labels=ws.labels.clone(), mu=mu, sigma=sigma, hood_energy=hood_energy,
                           total_energy=em_mod._total_energy(hood_energy), em_iters=em_i,
                           map_iters=map_total, status=status)


def run_em_batched(hoods, model, labels0, mu0, sigma0,
                   config: em_mod.EMConfig = em_mod.EMConfig(), *,
                   workspace=None) -> em_mod.BatchedEMResult:
    """A stack in lockstep, stepped from the host: per lockstep MAP
    iteration one batched launch for the running lanes (in the modes one
    flat MAP iteration of a ``em.DppBatchWorkspace``) and one read of the B
    flag words, per EM iteration the host's vectorised boundary and one
    host read."""
    em_mod.validate_config(config)
    n_hoods = hoods.n_hoods
    batch, dev, f32 = int(labels0.shape[0]), labels0.device, torch.float32
    n_labels = model.n_labels
    dpp = config.mode != "static-pallas"
    if dpp:
        ws = workspace if workspace is not None else em_mod.DppBatchWorkspace(
            kops.TickShape.of(hoods, model), batch, mode=config.mode, device=dev,
            backend=config.backend, max_map_iters=config.max_map_iters)
        ws.start(hoods, model, labels0)
    else:
        ws = workspace if workspace is not None else _workspace(hoods, model, config, dev, batch)
        sctx = E.make_static_context_batched(hoods, model, backend=config.backend)
        ws.start(hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)
    mu, sigma = mu0, sigma0
    hood_energy = torch.zeros((batch, n_hoods), dtype=f32, device=dev)
    total_hist = torch.zeros((batch, em_mod.WINDOW + 1), dtype=f32, device=dev)
    zeros_stats = torch.zeros((batch, 3, n_labels), dtype=f32, device=dev)
    em_iters, map_iters = [0] * batch, [0] * batch
    status = [em_mod.STATUS_OK] * batch
    running = [True] * batch
    em_i = steps = 0
    while em_i < config.max_em_iters and any(running):
        lanes = list(running)
        ws.begin_em(mu, torch.maximum(sigma, model.sigma_min[:, None]), lanes)
        in_map, flags, lane_map = list(lanes), [0] * batch, [0] * batch
        i = 0
        while i < config.max_map_iters and any(in_map):
            i += 1
            cap = i == config.max_map_iters
            ws.step(i > em_mod.WINDOW, cap)
            steps += 1
            words = ws.flags()
            for b in range(batch):
                if in_map[b]:
                    lane_map[b], flags[b] = i, words[b]
                    in_map[b] = not (words[b] or cap)
        if i:
            he, msums = ws.hood_e, ws.stats
        elif dpp:
            # No MAP iteration: the modes' M-step still reads the labels.
            he = hood_energy.new_zeros(hood_energy.shape)
            msums = torch.stack(
                E.m_step_sums_lanes(model, ws.labels, config.mode, backend=config.backend), dim=1)
        else:
            he, msums = hood_energy.new_zeros(hood_energy.shape), zeros_stats
        new_mu, new_sigma, sum_w = E.params_from_stats(model, msums[:, 0], msums[:, 1], msums[:, 2])
        div_t = (~torch.all(torch.isfinite(new_mu), dim=-1)
                 | ~torch.all(torch.isfinite(new_sigma), dim=-1))
        deg_t = em_mod._degenerate_components(model, new_sigma, sum_w)
        new_hist = torch.cat([em_mod._total_energy(he)[:, None], total_hist[:, :-1]], dim=1)
        em_i += 1
        if em_i > em_mod.WINDOW:
            conv_t = em_mod._window_converged(new_hist.T)
        else:
            conv_t = torch.zeros_like(div_t)
        on = torch.as_tensor(lanes, device=dev)[:, None]
        mu = torch.where(on, new_mu, mu)
        sigma = torch.where(on, new_sigma, sigma)
        hood_energy = torch.where(on, he, hood_energy)
        total_hist = torch.where(on, new_hist, total_hist)
        div_l, deg_l, conv_l = torch.stack([div_t, deg_t, conv_t]).tolist()
        for b in range(batch):
            if not lanes[b]:
                continue
            div = div_l[b] or bool(flags[b] & kops.FLAG_DIVERGED)
            em_conv = conv_l[b]
            em_iters[b] = em_i
            map_iters[b] += lane_map[b]
            finished = div or not (em_i < config.max_em_iters and not em_conv)
            running[b] = not (em_conv or div)
            status[b] = em_mod._boundary_status(div, deg_l[b], finished, em_conv, em_i,
                                                config.max_em_iters)
    labels, hood_energy = ws.labels.clone(), hood_energy.clone()
    return em_mod.BatchedEMResult(
        labels=labels, mu=mu, sigma=sigma, hood_energy=hood_energy,
        total_energy=em_mod._total_energy(hood_energy), em_iters=tuple(em_iters),
        map_iters=tuple(map_iters), status=tuple(status), steps=steps)


def _tick_boundary(state, lanes, flags, config) -> None:
    """The EM boundary of the lanes whose MAP loop just stopped: the
    boundary kernel's lane form over the pool (``kops.em_boundary_lanes``)
    with those lanes running, from one copy of their words to the device;
    then one host read of the words it wrote, and the lanes that go on
    start their next EM iteration."""
    ws, dev, batch = state.workspace, state.mu.device, state.batch
    stopped = [0] * batch
    for b in lanes:
        stopped[b] = 1
    words = torch.tensor([[0] * batch, state.map_i, flags, stopped, state.em_i, state.map_total,
                          state.status, [0] * batch], dtype=torch.int32).to(dev)
    ctl = torch.zeros((len(CTL_WORDS),), dtype=torch.int32, device=dev)
    kops.em_boundary_lanes(
        BoundaryState(ws.stats, ws.hood_e, words, ctl, state.mu, state.sigma, ws.mu, ws.sigma,
                      ws.ring, state.total_hist, state.sigma_min, state.reseed_mu,
                      state.reseed_sigma),
        max_em_iters=config.max_em_iters, max_map_iters=config.max_map_iters,
        conv_tol=em_mod.CONV_TOL, backend=config.backend)
    rows = words.tolist()
    go, em_iters, map_iters, status = (rows[r] for r in (ACTIVE, EM_ITERS, MAP_ITERS, STATUS))
    go_on = []
    for b in lanes:
        state.em_i[b], state.map_total[b], state.status[b] = em_iters[b], map_iters[b], status[b]
        state.map_i[b] = 0
        if go[b]:
            go_on.append(b)
        else:
            state.done[b] = True
    if go_on:
        state.begin(go_on)


def run_em_ticked(state, config: em_mod.EMConfig = em_mod.EMConfig(), tick_iters: int = 8):
    """One tick of a slot pool stepped from the host, in every mode: per
    micro-step one step of the pool and one read of the B flag words; the
    host mirrors each lane's stopping rule (flag word set, or the cap) and,
    where some lane's MAP loop stopped, runs those lanes' boundary
    (:func:`_tick_boundary`).  Returns ``(state, steps_executed)``, each
    lane bit for bit as ``em.run_em_ticked`` leaves it."""
    em_mod.validate_config(config)
    ws = state.workspace
    if ws.owner is None or ws.owner() is not state:
        raise ValueError("the pool workspace belongs to another TickState (blank_tick_state)")
    steps = 0
    while steps < tick_iters and not all(state.done):
        state.micro_steps += 1
        ws.step()
        words = ws.flags()
        stopped = []
        for b in range(state.batch):
            if state.done[b]:
                continue
            state.map_i[b] += 1
            if words[b] or state.map_i[b] == config.max_map_iters:
                stopped.append(b)
        if stopped:
            _tick_boundary(state, stopped, words, config)
        steps += 1
    return state, steps
