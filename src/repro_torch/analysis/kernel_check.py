"""The kernel pass: races, bounds, barriers and uninitialised reads in
the port's CUDA kernels (counterpart of ``repro.analysis.pallas_check``).

Three parts:

* **Static, on any host** (:func:`audit_static`): every source under
  ``kernels/csrc`` is parsed (comments and literals blanked, functions
  found by their braces).  *Coverage*: every exported C entry that
  launches a kernel, directly (``<<<``) or through the helpers it calls,
  must be named by a case of ``registry.KERNEL_CASES`` (KC105); the
  report lists the exports that launch nothing (the waits, the host
  words, the error strings).  *Barrier lint* (KC103): a block barrier
  (``__syncthreads*``, or a device function that reaches one) inside a
  branch or loop whose condition depends on the thread, or after a
  thread-dependent ``return``.  *Broadcast lint* (KC102): a ``__shared__``
  variable written under a thread-dependent condition and read outside
  that condition with no block barrier between (``__syncwarp`` counts as
  one: warp-local indexing is assumed).  Shared memory reached through a
  pointer is not followed.
* **On the card** (:func:`audit_card`): the cases run in a subprocess
  under ``compute-sanitizer``, once per tool (``memcheck``,
  ``racecheck``, ``synccheck``, ``initcheck``), with
  ``PYTORCH_NO_CUDA_MEMORY_CACHING=1``, the kernel filter on the port's
  kernels and ``--error-exitcode``; each reported error becomes a KC
  finding for its kernel and tool.  The sanitizer is first run on the
  out-of-bounds fixture: where it cannot run (no binary, or it reports
  "Device not supported", as on a card it cannot attach to), the report
  says so and the *guard* fallback runs instead: the cases run in two
  subprocesses on a guarding allocator (``analysis/csrc/guard_alloc.cu``,
  a ``CUDAPluggableAllocator``: canaries around every allocation, the body
  filled with a poison byte), under the poison bytes 0xFF and 0x7F.  A
  changed canary is a write out of bounds (KC101, memcheck's class);
  outputs that differ between the two poisons read memory nothing wrote
  (KC104, initcheck's class); outputs that differ between two runs of a
  case from one state are KC107.  The static lints stand for racecheck
  and synccheck.
* **Known-bad fixtures** (``analysis/fixtures/*.cu``): an out-of-bounds
  write, a shared-memory race, a barrier in divergent code and a read of
  uninitialised memory.  Each must be caught exactly once by its own
  tool, or the pass is vacuous (KC106).

``python -m repro_torch.analysis.kernel_check --out FILE ...`` is the
worker subprocess that runs the cases on the card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import registry
from .findings import Finding

__all__ = [
    "CSRC",
    "FIXTURES",
    "TOOLS",
    "parse_source",
    "translation_unit",
    "exports",
    "coverage",
    "lint",
    "audit_static",
    "audit_card",
]

ANALYSIS_DIR = Path(__file__).resolve().parent
CSRC = ANALYSIS_DIR.parent / "kernels" / "csrc"
FIXTURES = ANALYSIS_DIR / "fixtures"
GUARD_SRC = ANALYSIS_DIR / "csrc"
TOOLS: Tuple[str, ...] = ("memcheck", "racecheck", "synccheck", "initcheck")
#: The code of each tool's class of fault, and the fixture that shows it.
TOOL_CODES = {"memcheck": "KC101", "racecheck": "KC102", "synccheck": "KC103",
              "initcheck": "KC104"}
FIXTURE_TOOLS = {"oob_write": "memcheck", "smem_race": "racecheck",
                 "divergent_sync": "synccheck", "uninit_read": "initcheck"}
#: The guard fallback's check standing for each tool.
FALLBACK = {"memcheck": "guard_bounds", "racecheck": "broadcast_lint",
            "synccheck": "barrier_lint", "initcheck": "guard_poison"}
POISONS = (0xFF, 0x7F)
#: The device the cases run on (the card; the CPU runs their plain paths).
DEVICE = "cuda"

# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

_LAUNCH = re.compile(r"<<<|\bcuda(LaunchKernel|LaunchKernelEx|LaunchCooperativeKernel|GraphLaunch)\b"
                     r"|\bcuLaunchKernel\b")
_BARRIER = re.compile(r"\b__syncthreads(_or|_and|_count)?\s*\(")
_WARP_BARRIER = re.compile(r"\b__syncwarp\s*\(")
_CALL = re.compile(r"\b([A-Za-z_]\w*)\s*(?:<[^;(){}]*>)?\s*\(")
_KEYWORDS = frozenset({"if", "for", "while", "switch", "return", "sizeof", "catch", "do",
                       "else", "static_cast", "reinterpret_cast", "const_cast", "decltype"})


@dataclass(frozen=True)
class Function:
    """A function definition in a CUDA source."""

    name: str
    header: str      # the text before its body
    body: str        # between its braces
    file: str
    line: int        # of the opening brace
    exported: bool   # inside extern "C"
    kernel: bool     # __global__
    body_start: int  # offset of the body in the (blanked) file text


def _blank(src: str) -> str:
    """Comments and string/char literals replaced by spaces (newlines and
    ``extern "C"`` kept), so offsets and line numbers stay."""
    out = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if src.startswith("//", i):
            j = src.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif src.startswith("/*", i):
            j = src.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r"[^\n]", " ", src[i:j]))
            i = j
        elif c in "\"'":
            if src.startswith('"C"', i) and src[max(0, i - 7):i].strip() == "extern":
                out.append('"C"')
                i += 3
                continue
            j = i + 1
            while j < n and src[j] != c:
                j += 2 if src[j] == "\\" else 1
            out.append(c + " " * (min(j, n) - i - 1) + (c if j < n else ""))
            i = j + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _header_name(header: str) -> Optional[str]:
    """The function name of a definition's header (the identifier before
    its last parameter list), or None."""
    h = re.sub(r"\b(const|noexcept|override|final)\b\s*$", "", header.rstrip()).rstrip()
    h = re.sub(r"->\s*[\w:<>\s\*&]+$", "", h).rstrip()
    if not h.endswith(")"):
        return None
    depth, i = 0, len(h) - 1
    while i >= 0:
        if h[i] == ")":
            depth += 1
        elif h[i] == "(":
            depth -= 1
            if depth == 0:
                break
        i -= 1
    m = re.search(r"([A-Za-z_]\w*)\s*(?:<[^;(){}]*>)?\s*$", h[:i])
    if m is None or m.group(1) in _KEYWORDS:
        return None
    return m.group(1)


def parse_source(path: Path) -> List[Function]:
    """Every function definition of one source file (member functions of
    types included; lambdas stay part of their function's body)."""
    text = _blank(path.read_text())
    out: List[Function] = []
    stack: List[Tuple[str, int, str, bool]] = []  # kind, body start, header, in extern "C"
    seg = 0
    for m in re.finditer(r"[{};]", text):
        ch = m.group()
        in_func = any(k == "func" for k, *_ in stack)
        if ch == ";":
            if not in_func:
                seg = m.end()
            continue
        if ch == "{":
            header = text[seg:m.start()]
            externc = bool(stack) and stack[-1][3]
            if in_func:
                kind = "block"
            elif re.search(r'\bextern\s*"C"\s*$', header):
                kind, externc = "ns", True
            elif re.search(r"\bnamespace\b", header):
                kind = "ns"
            elif _header_name(header):
                kind = "func"
            elif re.search(r"\b(struct|class|union|enum)\b", header):
                kind = "type"
            else:
                kind = "block"
            stack.append((kind, m.end(), header, externc))
            seg = m.end()
            continue
        if not stack:
            continue
        kind, start, header, externc = stack.pop()
        if kind == "func":
            out.append(Function(
                name=_header_name(header), header=header.strip(), body=text[start:m.start()],
                file=path.name, line=text.count("\n", 0, start) + 1, exported=externc,
                kernel="__global__" in header, body_start=start))
        if not any(k == "func" for k, *_ in stack):
            seg = m.end()
    return out


def translation_unit(path: Path) -> List[Function]:
    """A source's functions and those of the local headers it includes."""
    seen: Set[Path] = set()
    funcs: List[Function] = []

    def visit(p: Path) -> None:
        if p in seen or not p.exists():
            return
        seen.add(p)
        funcs.extend(parse_source(p))
        for inc in re.findall(r'#include\s+"([^"]+)"', p.read_text()):
            visit(p.parent / inc)

    visit(path)
    return funcs


def _reaching(funcs: Sequence[Function], seed) -> Set[str]:
    """Names of the functions whose body matches ``seed`` or calls such a
    function (a fixpoint over the unit's call graph, by name)."""
    names = {f.name for f in funcs if seed.search(f.body)}
    while True:
        more = {f.name for f in funcs if f.name not in names and any(
            c in names for c in _CALL.findall(f.body))}
        if not more:
            return names
        names |= more


def exports(csrc: Path = CSRC) -> Dict[str, Dict[str, bool]]:
    """``{source name: {exported entry: launches a kernel}}``."""
    out = {}
    for src in sorted(csrc.glob("*.cu")):
        funcs = translation_unit(src)
        launching = _reaching(funcs, _LAUNCH)
        out[src.stem] = {f.name: f.name in launching for f in funcs
                         if f.exported and f.file == src.name}
    return out


def coverage(cases: Sequence[registry.KernelCase] = registry.KERNEL_CASES,
             csrc: Path = CSRC) -> Tuple[List[Finding], Dict]:
    """KC105 for every launching export no case names; KC106 for a case
    naming an entry that does not exist or launches nothing."""
    found: List[Finding] = []
    table = exports(csrc)
    named: Dict[str, List[str]] = {}
    for c in cases:
        for e in c.entries:
            named.setdefault(e, []).append(c.name)
    launching = {e: k for k, ents in table.items() for e, l in ents.items() if l}
    for entry, kernel in sorted(launching.items()):
        if entry not in named:
            found.append(Finding("KC105", "error", f"kernel:{kernel}/{entry}",
                                 "exported entry launches a kernel and no case runs it"))
    for entry, names in sorted(named.items()):
        if entry not in launching:
            found.append(Finding("KC106", "error", f"case:{names[0]}",
                                 f"names {entry}, which is not a launching export"))
    entry = {
        "launching": {e: sorted(named.get(e, [])) for e in sorted(launching)},
        "no_launch": sorted(f"{k}:{e}" for k, ents in table.items() for e, l in ents.items()
                            if not l),
    }
    return found, entry


# ---------------------------------------------------------------------------
# The barrier and broadcast lints
# ---------------------------------------------------------------------------


def _thread_vars(body: str) -> Set[str]:
    """Names assigned (transitively) from ``threadIdx`` in a body."""
    assigns = re.findall(r"\b([A-Za-z_]\w*)\s*(?:\[[^\]]*\])?\s*=(?!=)([^;]*);", body)
    names: Set[str] = set()
    while True:
        pat = re.compile(r"\bthreadIdx\b|\blaneid\b" + "".join(rf"|\b{re.escape(n)}\b"
                                                              for n in names))
        more = {lhs for lhs, rhs in assigns if lhs not in names and pat.search(rhs)}
        if not more:
            return names
        names |= more


def _conditions(body: str, pos: int) -> List[Tuple[str, int]]:
    """The conditions of the branches and loops enclosing ``pos`` in a
    body, with the offset each starts at: braced blocks, and the braceless
    statement that holds ``pos``."""
    conds: List[Tuple[str, int]] = []
    stack: List[Tuple[int, str]] = []  # (block start, header)
    last_if: Dict[int, str] = {}       # depth -> condition of the last closed if
    seg = 0
    for m in re.finditer(r"[{};]", body[:pos]):
        ch = m.group()
        if ch == "{":
            stack.append((seg, body[seg:m.start()].strip()))
            seg = m.end()
        elif ch == "}":
            if stack:
                start, header = stack.pop()
                if re.match(r"(else\s+)?if\b", header):
                    last_if[len(stack)] = header
            seg = m.end()
        else:
            seg = m.end()
    for start, header in stack + [(seg, body[seg:pos].strip())]:
        if re.match(r"(else\s+if|if|while|for|switch)\b", header):
            conds.append((header, start))
        elif re.match(r"else\b", header):
            conds.append((last_if.get(len(stack), header), start))
        elif header.startswith("do"):
            conds.append((header, start))
    return conds


def _drop_calls(text: str, names: Set[str]) -> str:
    """``text`` without the calls of ``names`` (their arguments too)."""
    out, i = [], 0
    call = re.compile(r"\b(" + "|".join(re.escape(n) for n in sorted(names)) + r")\s*\(")
    for m in call.finditer(text) if names else ():
        if m.start() < i:
            continue
        out.append(text[i:m.start()])
        depth, j = 1, m.end()
        while j < len(text) and depth:
            depth += {"(": 1, ")": -1}.get(text[j], 0)
            j += 1
        i = j
    return "".join(out) + text[i:]


def _divergent(cond: str, tvars: Set[str], uniform_calls: Set[str] = frozenset()) -> bool:
    """Whether a condition depends on the thread.  The result of a call
    that reaches a block barrier (``__syncthreads_or``, or a helper built
    on one) is block-uniform: the whole block makes the call together."""
    pat = r"\bthreadIdx\b" + "".join(rf"|\b{re.escape(n)}\b" for n in tvars)
    return re.search(pat, _drop_calls(cond, uniform_calls)) is not None


def lint(funcs: Sequence[Function]) -> List[Finding]:
    """KC103 and KC102 over a translation unit's kernels and device
    functions (one finding per function and kind)."""
    out: List[Finding] = []
    barrier_fns = _reaching(funcs, _BARRIER)
    uniform = barrier_fns | {"__syncthreads_or", "__syncthreads_and", "__syncthreads_count"}
    barrier_call = re.compile(r"\b__syncthreads(_or|_and|_count)?\s*\(" + "".join(
        rf"|\b{re.escape(n)}\s*(?:<[^;(){{}}]*>)?\s*\(" for n in sorted(barrier_fns)))
    for f in funcs:
        if "__device__" not in f.header and not f.kernel:
            continue
        site = f"csrc:{f.file}/{f.name}:{f.line}"
        tvars = _thread_vars(f.body)
        sites = [m.start() for m in barrier_call.finditer(f.body)]
        bad = []
        for p in sites:
            conds = [c for c, _ in _conditions(f.body, p) if _divergent(c, tvars, uniform)]
            rets = [r.start() for r in re.finditer(r"\breturn\b", f.body[:p])
                    if any(_divergent(c, tvars, uniform) for c, s in _conditions(f.body, r.start())
                           if not re.match(r"(while|for|do)\b", c))]
            if conds or rets:
                bad.append((p, conds[0] if conds else "return"))
        if bad:
            p, cond = bad[0]
            line = f.line + f.body.count("\n", 0, p)
            out.append(Finding("KC103", "error", site,
                               f"block barrier at line {line} under thread-dependent "
                               f"{' '.join(cond.split())[:80]!r} ({len(bad)} site(s))"))
        bounds = sorted(set(sites) | {m.start() for m in _WARP_BARRIER.finditer(f.body)})
        shared = set(re.findall(r"__shared__\s+[\w:<>\s\*]*?\b([A-Za-z_]\w*)\s*(?:\[[^\]]*\])?\s*;",
                                f.body))
        races = []
        for name in sorted(shared):
            acc = list(re.finditer(rf"\b{re.escape(name)}\b(\s*\[[^\]]*\])?(\s*(?:[-+*/|&^]?=)(?!=))?",
                                   f.body))
            decl = re.search(rf"__shared__[^;]*\b{re.escape(name)}\b", f.body)
            for w in acc:
                if not w.group(2) or (decl and decl.start() <= w.start() < decl.end()):
                    continue
                wconds = {c for c, _ in _conditions(f.body, w.start())
                          if _divergent(c, tvars, uniform)}
                if not wconds:
                    continue
                nxt = min([b for b in bounds if b > w.start()], default=len(f.body))
                for r in acc:
                    if r.group(2) or not (w.end() <= r.start() < nxt):
                        continue
                    rconds = {c for c, _ in _conditions(f.body, r.start())}
                    if not wconds <= rconds:
                        races.append((name, f.line + f.body.count("\n", 0, w.start()),
                                      f.line + f.body.count("\n", 0, r.start())))
                        break
        if races:
            name, wl, rl = races[0]
            out.append(Finding("KC102", "error", site,
                               f"__shared__ {name} written under a thread-dependent branch "
                               f"at line {wl} and read at line {rl} with no barrier between "
                               f"({len(races)} site(s))"))
    return out


def lint_sources(paths: Sequence[Path]) -> List[Finding]:
    out: List[Finding] = []
    for src in paths:
        seen = set()
        for f in lint(translation_unit(src)):
            if f.site not in seen:  # a header's function once per unit
                seen.add(f.site)
                out.append(f)
    return sorted(set(out))


def audit_static() -> Tuple[List[Finding], Dict]:
    """Coverage and both lints over ``csrc``, and both lints over the
    fixtures (which must each be caught once, by their own lint)."""
    found, cov = coverage()
    kernel_lint = lint_sources(sorted(CSRC.glob("*.cu")))
    found += kernel_lint
    fixture_lint = lint_sources(sorted(FIXTURES.glob("*.cu")))
    caught = {}
    for name, tool in sorted(FIXTURE_TOOLS.items()):
        if tool not in ("racecheck", "synccheck"):
            continue
        hits = [f for f in fixture_lint if f.site.startswith(f"csrc:{name}.cu/")]
        caught[name] = [f.code for f in hits]
        if [f.code for f in hits] != [TOOL_CODES[tool]]:
            found.append(Finding("KC106", "error", f"fixture:{name}",
                                 f"the {FALLBACK[tool]} must catch it exactly once; got "
                                 f"{[f.code for f in hits]}"))
    for f in fixture_lint:
        stem = f.site.split(":", 1)[1].split(".cu/", 1)[0]
        if FIXTURE_TOOLS.get(stem) not in ("racecheck", "synccheck"):
            found.append(Finding("KC106", "error", f"fixture:{stem}",
                                 f"a lint fired on a fixture of another class: {f.code}"))
    return found, {"coverage": cov, "lint_findings": len(kernel_lint),
                   "fixtures_by_lint": caught}


# ---------------------------------------------------------------------------
# The cases (run on the card, in the worker subprocess)
# ---------------------------------------------------------------------------


def _seeded(torch, seed: int):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def _plan(torch, k: int, precision: str = "f32", *, n: int = 1):
    """A session of mode static-pallas on the card and ``n`` plans of
    32x32 synthetic slices (K = 2: two phases; else three phases, padded
    to K labels)."""
    from repro_torch import api
    from repro_torch.core import synthetic

    cfg = api.ExecutionConfig(mode="static-pallas", n_labels=k, overseg_grid=(4, 4),
                              precision=precision, max_em_iters=4, max_map_iters=6)
    seg = api.Segmenter(cfg, device=DEVICE)
    vol = (synthetic.make_synthetic_volume(seed=1, n_slices=n, shape=(32, 32), device=DEVICE)
           if k == 2 else synthetic.make_kary_volume(seed=1, n_slices=n, shape=(32, 32),
                                                     n_phases=3, device=DEVICE))
    return seg, [seg.plan(img) for img in vol.images], vol.images


def _case_tick_jax_signature(torch, k, precision):
    from repro_torch.kernels import ops
    from repro_torch.testing import tick_problems

    arrays, offsets = tick_problems.sorted_tick_problem(3, k, 64, 257, 2048)
    t = [torch.from_numpy(a).to(DEVICE) for a in arrays]
    return list(ops.fused_em_tick(*t, 0.75, n_hoods=64, n_vertices=257,
                                  offsets=torch.from_numpy(offsets).to(DEVICE), precision=precision))


def _case_tick_solve(torch, k, precision):
    from repro_torch.testing import host_loop

    seg, (plan,), _ = _plan(torch, k, precision)
    r = host_loop.run_em(*seg.lane_inputs(plan), seg.config.em_config())
    return [r.labels, r.mu, r.sigma]


def _case_tick_stack(torch, k):
    from repro_torch.testing import host_loop

    seg, plans, _ = _plan(torch, k, n=3)
    joint = tuple(max(p.bucket[d] for p in plans) for d in range(3))
    inputs = seg.stacked_inputs(plans, bucket=joint, seeds=[0, 1, 2])
    return [host_loop.run_em_batched(*inputs, seg.config.em_config()).labels]


def _case_program_solve(torch, k, precision):
    seg, (plan,), _ = _plan(torch, k, precision)
    r = seg.execute(plan)
    return [r.region_labels, r.mu, r.sigma]


def _case_program_stack(torch, k):
    seg, _, images = _plan(torch, k, n=3)
    results, _ = seg.segment_stack(images, batch="always")
    return [r.region_labels for r in results]


def _case_em_boundary(torch, lanes):
    from repro_torch.kernels import ops
    from repro_torch.testing import boundary_cases

    st = boundary_cases.clone(boundary_cases.boundary_state(7, 3, em_i=4), DEVICE)
    if not lanes:
        st = boundary_cases.lane_state(st, 0)
    run = ops.em_boundary_lanes if lanes else ops.em_boundary
    run(st, max_em_iters=boundary_cases.MAX_EM_ITERS, max_map_iters=boundary_cases.MAX_MAP_ITERS)
    return list(st)


def _case_graph_probe(torch):
    from repro_torch.kernels import em_tick

    return [torch.tensor(em_tick.graph_probe(3, 5)["counts"])]


def _pool_labels(torch, seg, plans, tick):
    """Three plans through a 3-slot pool of their joint bucket, each tick
    ``tick(exe, state)``: every lane's final labels."""
    from repro_torch.core.pmrf import em

    joint = tuple(max(p.bucket[d] for p in plans) for d in range(3))
    exe = seg.compile_ticked(joint, batch=3, tick_iters=4)
    state = seg.ticked_pool(joint, batch=3)
    for b, p in enumerate(plans):
        em.init_tick_lane(state, b, *seg.lane_state(p, bucket=joint, seed=b))
    while not all(state.done):
        state, _ = tick(exe, state)
    return [em.tick_result(state, b).labels for b in range(3)]


def _case_tick_pool(torch, k):
    """The pool entry stepped from the host (``testing.host_loop``)."""
    from repro_torch.testing import host_loop

    seg, plans, _ = _plan(torch, k, n=3)
    return _pool_labels(torch, seg, plans,
                        lambda exe, st: host_loop.run_em_ticked(st, exe.em_config, 4))


def _case_program_pool_tick(torch, k):
    """The pool's compiled tick (one graph per tick)."""
    seg, plans, _ = _plan(torch, k, n=3)
    return _pool_labels(torch, seg, plans, lambda exe, st: exe(st))


def _case_control_kernels(torch):
    """The control kernels standalone on a 5-lane block of every state."""
    from repro_torch.kernels import em_tick, ref

    g = _seeded(torch, 5)
    lane = torch.randint(0, 3, (len(ref.LANE_WORDS), 5), generator=g, dtype=torch.int32)
    lane[ref.MAP_I] = torch.tensor([0, 3, 6, 6, 2], dtype=torch.int32)
    lane, ctl = lane.to(DEVICE), torch.zeros((len(ref.CTL_WORDS),), dtype=torch.int32, device=DEVICE)
    tick = torch.zeros((len(ref.TICK_WORDS),), dtype=torch.int32, device=DEVICE)
    kernels = em_tick.ControlKernels(lane, ctl, tick, list(range(3, 19)), 6)
    kernels.launch(("tick_init", "tick_stops", "map_ctl", "tick_tail", "tick_publish"))
    return [lane, ctl, tick[:3], torch.tensor(kernels.read())]


def _case_modes_parts(torch, mode):
    """The modes' program's parts outside its graph, on a DPP stack of three
    slices (a PyTorch capture cannot take its pool from the guard's
    pluggable allocator, so the graph itself runs in no case): the plain
    start, then per MAP iteration the flat step (its ``segment_reduce``
    launches) and ``map_ctl`` on the stack's words, per EM iteration the
    M-step and the boundary kernel's lane form, to the end of the solve."""
    from repro_torch.core.pmrf import em
    from repro_torch.kernels import em_tick, ops, ref

    seg, plans, _ = _plan(torch, 2, n=3)
    joint = tuple(max(p.bucket[d] for p in plans) for d in range(3))
    hoods, model, labels0, mu0, sigma0 = seg.stacked_inputs(plans, bucket=joint, seeds=[0, 1, 2])
    cfg = seg.config.em_config()
    # Built without the EM limits, so nothing is captured; the plain start
    # then reads them.
    ws = em.DppBatchWorkspace(ops.TickShape.of(hoods, model), 3, mode=mode,
                              device=hoods.vertex.device, backend=None,
                              max_map_iters=cfg.max_map_iters, max_em_iters=None)
    ws.max_em_iters = cfg.max_em_iters
    ws.start(hoods, model, labels0, mu0, sigma0)
    ws.program_begin()
    control = em_tick.ControlKernels(ws.lane, ws.ctl, ws.tick, [0] * 10, cfg.max_map_iters)
    while True:
        while True:
            ws._lane_step()
            control.launch(("map_ctl",))
            if not bool(ws.active.any()):
                break
        ws._mstep_core()
        ops.em_boundary_lanes(ws.boundary_state(), max_em_iters=cfg.max_em_iters,
                              max_map_iters=cfg.max_map_iters)
        if not int(ws.ctl[ref.EM_COND]):
            break
    return [ws.labels, ws.em_mu, ws.em_sigma, ws.lane]


def _case_map_step_jax_signature(torch, k):
    from repro_torch.kernels import ops
    from repro_torch.testing import tick_problems

    arrays, kw = tick_problems.long_hood_map_step_problem(5, k)
    t = [torch.from_numpy(a).to(DEVICE) for a in arrays]
    return list(ops.fused_map_step(*t[:10], 0.75, **kw))


def _case_map_step_iteration(torch, k):
    from repro_torch.core.pmrf import distributed as D
    from repro_torch.core.pmrf import energy as E
    from repro_torch.core.pmrf import pipeline
    from repro_torch.kernels import ops

    seg, (plan,), _ = _plan(torch, k)
    prob = plan.problem
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, seg.config.init)
    part = D.partition_hoods(prob.hoods, 1)
    ws = ops.map_step_workspace(part, prob.model, rank=0, n_shards=1)
    sctx = E.make_static_context(part, prob.model)
    ws.start(sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)
    ws.begin_em(mu0, torch.maximum(sigma0, prob.model.sigma_min))
    for i in range(6):  # five steps past the window, then the launch that only tests
        ws.step(i > 3, step=i < 5)
        ws.flag()
    return [ws.labels, ws.hood_e, ws.votes, *ws.stats]


def _case_mrf_min_energy(torch, n):
    from repro_torch.kernels import ops

    g = _seeded(torch, n)
    y, w = torch.rand(n, generator=g) * 255, torch.rand(n, generator=g)
    n1 = torch.randint(0, 8, (n,), generator=g).float()
    nall = n1 + torch.randint(0, 8, (n,), generator=g).float()
    xf = torch.randint(0, 2, (n,), generator=g).float()
    args = [t.to(DEVICE) for t in (y, w, n1, nall, xf, torch.tensor([60.0, 140.0]),
                               torch.tensor([10.0, 14.0]))]
    return list(ops.mrf_min_energy(*args, 0.75))


def _case_segment_reduce(torch, op, ordered):
    from repro_torch.kernels import ops

    g = _seeded(torch, 7)
    values = (torch.rand(5000, generator=g) * 100).to(DEVICE)
    ids = torch.randint(-3, 303, (5000,), generator=g, dtype=torch.int32).to(DEVICE)
    return [ops.segment_reduce(values, ids, 300, op, ordered=ordered)]


def _case_flash_attention(torch, dtype, d, causal):
    from repro_torch.kernels import ops

    g = _seeded(torch, d)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.randn(1, 4, 256, d, generator=g).to(dt).to(DEVICE)
    k = torch.randn(1, 2, 256, d, generator=g).to(dt).to(DEVICE)
    v = torch.randn(1, 2, 256, d, generator=g).to(dt).to(DEVICE)
    return [ops.flash_attention(q, k, v, causal=causal)]


CASE_RUNNERS = {
    "tick_jax_signature": _case_tick_jax_signature,
    "tick_solve": _case_tick_solve,
    "tick_stack": _case_tick_stack,
    "tick_pool": _case_tick_pool,
    "program_pool_tick": _case_program_pool_tick,
    "control_kernels": _case_control_kernels,
    "modes_parts": _case_modes_parts,
    "program_solve": _case_program_solve,
    "program_stack": _case_program_stack,
    "em_boundary": _case_em_boundary,
    "graph_probe": _case_graph_probe,
    "map_step_jax_signature": _case_map_step_jax_signature,
    "map_step_iteration": _case_map_step_iteration,
    "mrf_min_energy": _case_mrf_min_energy,
    "segment_reduce": _case_segment_reduce,
    "flash_attention": _case_flash_attention,
}


def _fixture_entry(name: str):
    import ctypes

    from repro_torch.kernels import _build

    P, I = ctypes.c_void_p, ctypes.c_int
    argtypes = {"oob_write": [P, I, P], "smem_race": [P, P], "divergent_sync": [P, P],
                "uninit_read": [P, P, I, P]}[name]
    return _build.function(name, f"fixture_{name}", argtypes, src_dir=FIXTURES)


def _run_fixture(torch, name: str) -> list:
    """Launch one fixture on tensors from the current allocator."""
    fn = _fixture_entry(name)
    s = torch.cuda.current_stream().cuda_stream
    if name == "oob_write":
        out = torch.zeros(256, device=DEVICE)
        fn(out.data_ptr(), 256, s)
    elif name == "uninit_read":
        scratch = torch.empty(256, device=DEVICE)
        out = torch.empty(256, device=DEVICE)
        fn(scratch.data_ptr(), out.data_ptr(), 256, s)
    else:
        out = torch.zeros(64, device=DEVICE)
        fn(out.data_ptr(), s)
    torch.cuda.synchronize()
    return [out]


def _digest(torch, outs) -> List[str]:
    h = []
    for t in outs:
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t)
        b = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
        h.append(hashlib.sha256(b).hexdigest()[:16])
    return h


def _worker(args) -> int:
    """Run the cases (and fixtures) on the card; write what they gave."""
    import ctypes

    import torch

    guard = None
    if args.poison is not None:
        from repro_torch.kernels import _build

        path = _build._target("guard_alloc", GUARD_SRC)
        guard = _build.load("guard_alloc", GUARD_SRC)
        guard.guard_set_poison(args.poison)
        torch.cuda.memory.change_current_allocator(
            torch.cuda.memory.CUDAPluggableAllocator(str(path), "guard_malloc", "guard_free"))
        guard.guard_take_violations.argtypes = [ctypes.c_void_p, ctypes.c_int]

    def violations() -> list:
        if guard is None:
            return []
        guard.guard_check_all()
        buf = (ctypes.c_longlong * 300)()
        n = guard.guard_take_violations(ctypes.addressof(buf), 100)
        return [tuple(buf[3 * i:3 * i + 3]) for i in range(min(n, 100))]

    report: Dict[str, Dict] = {}
    for c in registry.KERNEL_CASES:
        row: Dict = {}
        try:
            for r in range(args.repeats):
                torch.manual_seed(0)
                outs = CASE_RUNNERS[c.run](torch, **dict(c.params))
                torch.cuda.synchronize()
                row.setdefault("digests", []).append(_digest(torch, outs))
                del outs
            row["violations"] = violations()
        except Exception as exc:  # reported as KC106 by the parent, never hidden
            row["error"] = f"{type(exc).__name__}: {exc}"[:400]
        report[c.name] = row
    for name in (args.fixtures.split(",") if args.fixtures else []):
        row = {}
        try:
            row["digests"] = [_digest(torch, _run_fixture(torch, name))]
            row["violations"] = violations()
        except Exception as exc:
            row["error"] = f"{type(exc).__name__}: {exc}"[:400]
        report[f"fixture:{name}"] = row
    Path(args.out).write_text(json.dumps(report, sort_keys=True))
    return 0


# ---------------------------------------------------------------------------
# The card pass
# ---------------------------------------------------------------------------


def _worker_cmd(out: Path, *, poison=None, fixtures=None, repeats=1) -> List[str]:
    cmd = [sys.executable, "-m", "repro_torch.analysis.kernel_check", "--out", str(out),
           "--repeats", str(repeats)]
    if poison is not None:
        cmd += ["--poison", str(poison)]
    if fixtures:
        cmd += ["--fixtures", ",".join(fixtures)]
    return cmd


def _env() -> Dict[str, str]:
    env = dict(os.environ)
    src = str(ANALYSIS_DIR.parents[1])
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def sanitizer_path() -> Optional[str]:
    """``compute-sanitizer`` on the PATH or under the CUDA toolkit."""
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "compute-sanitizer").exists():
            return str(Path(root, "bin", "compute-sanitizer"))
    return None


def kernel_names() -> List[str]:
    """The ``__global__`` functions of the port's sources and the
    fixtures (the sanitizer's kernel filter)."""
    names = set()
    for src in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")) + list(FIXTURES.glob("*.cu")):
        names |= {f.name for f in parse_source(src) if f.kernel}
    return sorted(names)


def _kernel_of(name: str) -> str:
    """The csrc source (or fixture) that defines a ``__global__`` name."""
    for src in sorted(CSRC.glob("*.cu")):
        if any(f.kernel and f.name == name for f in translation_unit(src)):
            return src.stem
    for src in sorted(FIXTURES.glob("*.cu")):
        if any(f.kernel and f.name == name for f in parse_source(src)):
            return f"fixture:{src.stem}"
    return name


_SAN_ERROR = re.compile(r"^========= (Invalid |Error: Race|Barrier error|Uninitialized|"
                        r"Warning: Race|Error: )", re.M)


def _sanitize(tool: str, cmd: List[str], timeout: float) -> Dict:
    """Run ``cmd`` under one sanitizer tool; errors by kernel name."""
    san = sanitizer_path()
    full = [san, "--tool", tool, "--error-exitcode", "99", "--print-limit", "1000",
            "--kernel-name", "regex=" + "|".join(re.escape(n) for n in kernel_names())]
    if tool == "racecheck":
        full += ["--racecheck-report", "analysis"]
    env = _env()
    env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    proc = subprocess.run(full + cmd, capture_output=True, text=True, timeout=timeout, env=env)
    text = proc.stdout + proc.stderr
    errors: Dict[str, int] = {}
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if not _SAN_ERROR.match(line) or "Device not supported" in line:
            continue
        kernel = "unattributed"
        for nxt in lines[i + 1:i + 6]:
            m = re.search(r"\bat\s+(?:void\s+)?(?:[\w:]*::)?([A-Za-z_]\w*)", nxt)
            if m:
                kernel = _kernel_of(m.group(1))
                break
        errors[kernel] = errors.get(kernel, 0) + 1
    return {"rc": proc.returncode, "errors": errors,
            "unsupported": "Device not supported" in text, "tail": text[-2000:]}


def sanitizer_version() -> Optional[str]:
    """The ``Version`` line of ``compute-sanitizer --version``, or None."""
    san = sanitizer_path()
    if san is None:
        return None
    out = subprocess.run([san, "--version"], capture_output=True, text=True, timeout=60).stdout
    return next((line.strip() for line in out.splitlines() if line.startswith("Version")), None)


def _sanitizer_usable(timeout: float) -> Tuple[bool, str]:
    """Whether the sanitizer runs here: it must find the out-of-bounds
    fixture's one error."""
    if sanitizer_path() is None:
        return False, "compute-sanitizer not found on PATH, under $CUDA_HOME/bin or /usr/local/cuda/bin"
    with tempfile.TemporaryDirectory() as d:
        r = _sanitize("memcheck", _worker_cmd(Path(d, "o.json"), fixtures=["oob_write"]), timeout)
    if r["unsupported"]:
        return False, "compute-sanitizer reports 'Device not supported' on this card"
    if r["errors"].get("fixture:oob_write") != 1:
        return False, f"compute-sanitizer memcheck did not catch the out-of-bounds fixture once: {r['errors']}"
    return True, "compute-sanitizer runs"


def _by_kernel(cases) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for c in cases:
        out.setdefault(c.kernel, []).append(c.name)
    return out


def audit_card(log=lambda s: None, timeout: float = 600.0) -> Tuple[List[Finding], Dict]:
    """The kernel pass on the card (see the module docstring).  Raises
    ``RuntimeError`` when there is no CUDA device: it never falls back to
    a pass that checks nothing."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the kernel pass (--kernels) needs a CUDA device")
    from repro_torch.kernels import _build

    _build.build_all(_build.CSRC, FIXTURES, GUARD_SRC)
    found: List[Finding] = []
    usable, why = _sanitizer_usable(timeout)
    log(f"  sanitizer: {why}")
    cases = registry.KERNEL_CASES
    per_kernel: Dict[str, Dict[str, int]] = {k: {t: 0 for t in TOOLS} for k in _by_kernel(cases)}
    fixtures: Dict[str, int] = {}
    entry: Dict = {"sanitizer": why, "sanitizer_version": sanitizer_version(),
                   "route": "compute-sanitizer" if usable else "guard+lint",
                   "cases": {k: v for k, v in _by_kernel(cases).items()}}
    with tempfile.TemporaryDirectory() as d:
        if usable:
            for tool in TOOLS:
                fx = [n for n, t in FIXTURE_TOOLS.items() if t == tool]
                r = _sanitize(tool, _worker_cmd(Path(d, f"{tool}.json"), fixtures=fx), timeout)
                for kernel, n in r["errors"].items():
                    if kernel.startswith("fixture:"):
                        fixtures[kernel.split(":", 1)[1]] = n
                    else:
                        per_kernel.setdefault(kernel, {t: 0 for t in TOOLS})[tool] += n
                        found.append(Finding(TOOL_CODES[tool], "error", f"kernel:{kernel}/{tool}",
                                             f"{n} {tool} error(s)"))
                log(f"  {tool}: {r['errors']}")
        else:
            procs = {}
            for poison in POISONS:
                out = Path(d, f"guard{poison}.json")
                procs[poison] = (out, subprocess.Popen(
                    _worker_cmd(out, poison=poison, repeats=2, fixtures=["oob_write", "uninit_read"]),
                    env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            runs = {}
            for poison, (out, proc) in procs.items():
                text, _ = proc.communicate(timeout=timeout)
                if proc.returncode != 0 or not out.exists():
                    raise RuntimeError(f"guard worker (poison {poison:#x}) failed:\n{text[-3000:]}")
                runs[poison] = json.loads(out.read_text())
            a, b = (runs[p] for p in POISONS)
            for c in cases:
                ra, rb = a[c.name], b[c.name]
                err = ra.get("error") or rb.get("error")
                if err:
                    found.append(Finding("KC106", "error", f"case:{c.name}", f"did not run: {err}"))
                    continue
                if ra["violations"] or rb["violations"]:
                    per_kernel[c.kernel]["memcheck"] += len(ra["violations"]) + len(rb["violations"])
                    found.append(Finding("KC101", "error", f"kernel:{c.kernel}/{c.name}",
                                         f"guard bytes changed: {ra['violations'] + rb['violations']}"))
                if ra["digests"][0] != rb["digests"][0]:
                    per_kernel[c.kernel]["initcheck"] += 1
                    found.append(Finding("KC104", "error", f"kernel:{c.kernel}/{c.name}",
                                         "outputs differ between the poison bytes: a read of "
                                         "memory nothing wrote"))
                if any(r["digests"][0] != r["digests"][-1] for r in (ra, rb)):
                    found.append(Finding("KC107", "error", f"kernel:{c.kernel}/{c.name}",
                                         "outputs differ between two runs from one state"))
            fixtures["oob_write"] = len(a["fixture:oob_write"].get("violations", []))
            fixtures["uninit_read"] = int(a["fixture:uninit_read"].get("digests")
                                          != b["fixture:uninit_read"].get("digests"))
            entry["guard_poisons"] = [f"{p:#04x}" for p in POISONS]
    lint_by_source: Dict[str, Dict[str, int]] = {}
    for f in lint_sources(sorted(CSRC.glob("*.cu"))):
        stem = f.site.split(":", 1)[1].split(".cu", 1)[0]
        tool = "racecheck" if f.code == "KC102" else "synccheck"
        lint_by_source.setdefault(stem, {}).setdefault(tool, 0)
        lint_by_source[stem][tool] += 1
    if not usable:
        for kernel, counts in lint_by_source.items():
            for tool, n in counts.items():
                per_kernel.setdefault(kernel, {t: 0 for t in TOOLS})[tool] += n
        for name in ("smem_race", "divergent_sync"):
            fixtures[name] = len(lint_sources([FIXTURES / f"{name}.cu"]))
    for name, tool in FIXTURE_TOOLS.items():
        if fixtures.get(name) != 1:
            found.append(Finding("KC106", "error", f"fixture:{name}",
                                 f"{tool if usable else FALLBACK[tool]} caught it "
                                 f"{fixtures.get(name, 0)} time(s), not exactly once"))
    entry["per_kernel"] = per_kernel
    entry["fixtures"] = fixtures
    entry["via"] = {t: (t if usable else FALLBACK[t]) for t in TOOLS}
    return found, entry


def main(argv: Optional[List[str]] = None) -> int:
    """The worker: run every case (and the named fixtures) on the card and
    write their digests and the guard's violations to ``--out``."""
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis.kernel_check")
    p.add_argument("--out", required=True)
    p.add_argument("--poison", type=int, default=None,
                   help="run on the guarding allocator, its bodies filled with this byte")
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--fixtures", default=None, help="comma-separated fixture names")
    return _worker(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
