"""The op and host-read census of the EM drivers (counterpart of
``repro.analysis.jaxpr_lint``).

The reference audits a traced program; PyTorch runs eagerly, so the port
counts what a solve *does* while it runs.  :func:`take` stacks two
modes over the solve:

* a ``TorchDispatchMode`` that counts the device operations (every ATen
  call but views), the scatters and gathers among them, and notes every
  float64 result;
* a ``TorchFunctionMode`` that counts the host reads (``tolist``,
  ``item``, ``bool``/``int``/``float``/``index`` of a tensor, ``cpu``,
  ``numpy``) and the host-to-device copies (``torch.tensor`` or
  ``torch.as_tensor`` of host data onto a device, ``to``/``cuda`` of a
  host tensor onto a device).  A ``TorchDispatchMode`` sees a host read
  only as the ``_local_scalar_dense`` of ``item``, and a read of mapped
  pinned memory not at all, so the function mode is the one that counts.

Counts go to the innermost open *scope*.  The drivers mark three
(``core.pmrf.em``): ``map_iteration``, one MAP iteration of a loop,
``em_boundary``, the rest of an EM iteration (M-step, tests, the
boundary's host read, the next iteration's start), and ``solve``, what a
compiled EM program's solve does outside its loops (``em._run_program``:
the element arrays, ``start``, the program's launch, the read of its
counters, the result's copies).  On the card the program's loops run
inside its graph, where no host sees them: its census has no MAP or EM
instance, and its solve counts the one graph launch and the one read.  A marker reads
:data:`ACTIVE` once per driver call and tests a local per scope, so a
solve with no census runs no extra host work.  Each scope keeps one
count per instance; :meth:`Census.summary` gives each count's maximum
and minimum over the instances (the budgets bound the maximum).

Kernel entries are opaque.  A call of a ``kernels.ops`` entry counts one
launch, and a kernel workspace's ``step`` (or its plain version's) one
launch; ``flag``/``flags`` count one host read (the card's read of a
mapped pinned word is invisible to both modes); a workspace's other
methods write its own buffers and count one device op.  The modes' DPP
workspaces count so too: their step (the captured flat MAP iteration on
the card) and M-step one launch each.  A compiled tick's launch
(``launch_tick``) counts one launch and its read (``tick_result``) one
host read; the plain versions of the programs' control kernels
(``kernels.ref.tick_init``, ``tick_stops``, ``tick_tail``, ``map_ctl``)
one launch each and the read of a plain tick's words
(``ref.tick_publish``) one host read.  The plain versions behind them
run with both modes off, so the CPU counts what the card launches and
the two censuses agree.

Only torch, numpy and the standard library.
"""

from __future__ import annotations

import contextlib
import functools
from collections import Counter
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from .findings import Finding

__all__ = [
    "ACTIVE",
    "MAP_ITERATION",
    "EM_BOUNDARY",
    "SOLVE",
    "SCOPES",
    "COUNTERS",
    "Census",
    "take",
    "check",
]

#: The census being taken, or None: the one global the drivers' scope
#: markers read.
ACTIVE: Optional["Census"] = None

MAP_ITERATION = "map_iteration"
EM_BOUNDARY = "em_boundary"
SOLVE = "solve"
SCOPES: Tuple[str, ...] = (MAP_ITERATION, EM_BOUNDARY, SOLVE)
COUNTERS: Tuple[str, ...] = (
    "device_ops", "scatters", "gathers", "launches", "host_reads", "h2d_copies",
)

_SCATTERS = frozenset({
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_", "scatter_add",
    "scatter_add_", "scatter_reduce", "scatter_reduce_", "index_add", "index_add_",
    "index_copy", "index_copy_", "index_fill", "index_fill_", "index_reduce",
    "index_reduce_", "masked_scatter", "masked_scatter_", "put", "put_",
})
_GATHERS = frozenset({"gather", "index", "index_select", "take", "masked_select"})

_T = torch.Tensor
_HOST_READS = frozenset({
    _T.tolist, _T.item, _T.__bool__, _T.__int__, _T.__float__, _T.__index__, _T.cpu, _T.numpy,
})
_FACTORIES = frozenset({torch.tensor, torch.as_tensor})

#: The kernel entries of ``kernels.ops``: each call is one launch.
OPS_ENTRIES: Tuple[str, ...] = (
    "segment_reduce", "fused_em_tick", "fused_map_step", "mrf_min_energy", "flash_attention",
    "em_boundary", "em_boundary_lanes",
)
#: Workspace methods by what a call counts: a compiled program's graph
#: launch, and each step of its plain version (the start, a MAP iteration,
#: a boundary), one launch; the read of its counters one host read.
_WS_COUNTS = {
    "step": "launches", "flag": "host_reads", "flags": "host_reads", "start": "device_ops",
    "begin_em": "device_ops", "begin_lanes": "device_ops", "admit": "device_ops",
    "retire": "device_ops", "launch_program": "launches", "program_begin": "launches",
    "program_step": "launches", "program_boundary": "launches",
    "program_result": "host_reads", "launch_tick": "launches", "tick_result": "host_reads",
    "program_mstep": "launches",
}
#: The plain versions of the programs' control kernels (``kernels.ref``):
#: each call one launch, as on the card; the read of a tick's words one
#: host read.
_CONTROL_COUNTS = {"tick_init": "launches", "tick_stops": "launches", "tick_tail": "launches",
                   "map_ctl": "launches", "tick_publish": "host_reads"}


def kernel_workspaces() -> Tuple[type, ...]:
    """The kernel workspaces and their plain versions, whose methods the
    census treats as opaque."""
    from repro_torch.core.pmrf import em
    from repro_torch.kernels import em_tick, map_step, ref

    return (em_tick.TickWorkspace, em_tick.BatchTickWorkspace, em_tick.PoolTickWorkspace,
            map_step.MapStepWorkspace, ref.PlainTickWorkspace, ref.PlainBatchTickWorkspace,
            ref.PlainPoolTickWorkspace, ref.PlainMapStepWorkspace, em.DppBatchWorkspace,
            em.DppPoolWorkspace)


class Census:
    """Counts per scope instance (see the module docstring)."""

    def __init__(self) -> None:
        self._stack: List[Tuple[str, Counter]] = []
        self.instances: Dict[str, List[Counter]] = {s: [] for s in SCOPES}
        #: float64 results per scope: op name -> count.
        self.float64: Dict[str, Counter] = {s: Counter() for s in SCOPES}
        #: Every counted event per scope, by op or entry name (diagnostics;
        #: not part of the report).
        self.by_op: Dict[str, Counter] = {s: Counter() for s in SCOPES}
        self._opaque = 0

    # -- scope markers (called by the drivers) ---------------------------
    def enter(self, scope: str) -> None:
        """Open a new instance of ``scope``; an open instance of the same
        scope on top ends first (a marker at the top of a loop body)."""
        if self._stack and self._stack[-1][0] == scope:
            self._stack.pop()
        inst: Counter = Counter()
        self.instances[scope].append(inst)
        self._stack.append((scope, inst))

    def leave(self, scope: str) -> None:
        """Close the open instance of ``scope`` if it is on top."""
        if self._stack and self._stack[-1][0] == scope:
            self._stack.pop()

    # -- counting ------------------------------------------------------------
    def bump(self, counter: str, what: str, n: int = 1) -> None:
        if self._stack:
            scope, inst = self._stack[-1]
            inst[counter] += n
            self.by_op[scope][f"{counter}:{what}"] += n

    def note_float64(self, what: str) -> None:
        if self._stack:
            self.float64[self._stack[-1][0]][what] += 1

    @contextlib.contextmanager
    def opaque(self) -> Iterator[None]:
        """Run a block with both modes off (a kernel entry's plain
        version, a host read)."""
        self._opaque += 1
        try:
            with torch._C.DisableTorchFunction(), _disable_current_modes():
                yield
        finally:
            self._opaque -= 1

    def summary(self) -> Dict[str, Dict]:
        """Per scope: ``instances`` and each counter's ``max`` and ``min``
        over them (zeros for a scope with no instance)."""
        out = {}
        for scope in SCOPES:
            insts = self.instances[scope]
            out[scope] = {
                "instances": len(insts),
                "max": {c: max((i[c] for i in insts), default=0) for c in COUNTERS},
                "min": {c: min((i[c] for i in insts), default=0) for c in COUNTERS},
            }
            if self.float64[scope]:
                out[scope]["float64"] = sorted(self.float64[scope])
        return out


def _names_device(args, kwargs) -> bool:
    """True when a ``to`` call names a target device (a device, a device
    string or another tensor)."""
    if kwargs.get("device") is not None:
        return True
    for a in args[1:]:
        if isinstance(a, (torch.device, torch.Tensor)):
            return True
        if isinstance(a, str):
            try:
                torch.device(a)
                return True
            except RuntimeError:
                pass
    return False


class _FunctionMode(TorchFunctionMode):
    def __init__(self, census: Census):
        super().__init__()
        self.census = census

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        cen = self.census
        if cen._opaque:
            return func(*args, **kwargs)
        if func in _HOST_READS:
            cen.bump("host_reads", func.__name__)
            with cen.opaque():
                return func(*args, **kwargs)
        if func in _FACTORIES and args and not isinstance(args[0], torch.Tensor):
            if kwargs.get("device") is not None:
                cen.bump("h2d_copies", func.__name__)
            with cen.opaque():
                return func(*args, **kwargs)
        if (func is _T.to and _names_device(args, kwargs) or func is _T.cuda) and (
                isinstance(args[0], torch.Tensor) and args[0].device.type == "cpu"):
            cen.bump("h2d_copies", func.__name__)
            with cen.opaque():
                return func(*args, **kwargs)
        return func(*args, **kwargs)


class _DispatchMode(TorchDispatchMode):
    def __init__(self, census: Census):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        cen = self.census
        if cen._opaque or func.is_view:
            return out
        name = func._schema.name.split("::")[-1]
        if name == "_local_scalar_dense":
            cen.bump("host_reads", name)
            return out
        cen.bump("device_ops", name)
        if name in _SCATTERS:
            cen.bump("scatters", name)
        elif name in _GATHERS:
            cen.bump("gathers", name)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float64:
                cen.note_float64(name)
                break
        return out


def _opaque_call(census: Census, fn, counter: str, what: str):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if census._opaque:
            return fn(*args, **kwargs)
        census.bump(counter, what)
        with census.opaque():
            return fn(*args, **kwargs)

    return call


@contextlib.contextmanager
def take() -> Iterator[Census]:
    """Take a census of the block: the two modes, the opaque kernel
    entries and workspace methods, and :data:`ACTIVE` for the markers."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("a census is already being taken")
    from repro_torch.kernels import ops, ref

    cen = Census()
    undo = []
    for name in OPS_ENTRIES:
        fn = getattr(ops, name)
        undo.append((ops, name, fn))
        setattr(ops, name, _opaque_call(cen, fn, "launches", name))
    for name, counter in _CONTROL_COUNTS.items():
        fn = getattr(ref, name)
        undo.append((ref, name, fn))
        setattr(ref, name, _opaque_call(cen, fn, counter, name))
    for cls in kernel_workspaces():
        for meth, counter in _WS_COUNTS.items():
            # A method the class inherits (the program's, from its base) is
            # wrapped on the class itself and the wrapper deleted after.
            owner = next((c for c in cls.__mro__ if meth in c.__dict__), None)
            if owner is None or owner is object:
                continue
            fn = owner.__dict__[meth]
            undo.append((cls, meth, fn if owner is cls else None))
            setattr(cls, meth, _opaque_call(cen, fn, counter, f"{cls.__name__}.{meth}"))
    try:
        with _FunctionMode(cen), _DispatchMode(cen):
            ACTIVE = cen
            yield cen
    finally:
        ACTIVE = None
        for owner, name, fn in reversed(undo):
            if fn is None:
                delattr(owner, name)
            else:
                setattr(owner, name, fn)


def check(summary: Dict[str, Dict], site: str, budget: Optional[Dict[str, Dict[str, int]]]
          ) -> List[Finding]:
    """The PT detectors over one census summary.  ``budget`` is the
    registry's row (per scope, per counter; a scope it leaves out is not
    gated) or None (census only: PT001 and PT003 still apply)."""
    out: List[Finding] = []
    for scope in SCOPES:
        ops = summary[scope].get("float64")
        if ops:
            out.append(Finding("PT001", "error", f"{site}/{scope}",
                               f"float64 value(s) made by {', '.join(ops)}"))
    mx = summary[MAP_ITERATION]["max"]
    if mx["h2d_copies"]:
        out.append(Finding("PT003", "error", f"{site}/{MAP_ITERATION}",
                           f"{mx['h2d_copies']} host-to-device copie(s) per MAP iteration"))
    if budget is None:
        return out
    for scope in SCOPES:
        if budget.get(scope) is None:
            continue
        for counter in COUNTERS:
            if scope == MAP_ITERATION and counter == "h2d_copies":
                continue  # PT003
            got, cap = summary[scope]["max"][counter], budget[scope][counter]
            if got <= cap:
                continue
            if scope == MAP_ITERATION and counter == "host_reads":
                out.append(Finding("PT002", "error", f"{site}/{scope}",
                                   f"{got} host read(s) per MAP iteration; budget {cap}"))
            else:
                out.append(Finding("PT005", "error", f"{site}/{scope}",
                                   f"{counter} {got} per instance; budget {cap}"))
    return out
