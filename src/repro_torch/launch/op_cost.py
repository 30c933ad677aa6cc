"""Loop-aware cost of one step, counted op by op as PyTorch dispatches it.

Counterpart of ``repro.launch.hlo_cost``.  The reference parses the HLO
text of a compiled step and scales each ``while`` body by its trip count;
the port has no HLO (eager PyTorch compiles nothing), so the module is
named for what it counts instead.  :class:`OpCost` is one
``TorchDispatchMode`` that totals, over every aten op (and every ``c10d``
collective) the step dispatches:

* **flops** -- the products by ``torch.utils.flop_counter``'s formulas
  (``dot_flops``, kept by result shape in ``dot_flops_by_shape`` as the
  reference's ``dot_flops_by_shape``), plus one flop per output element
  of the elementwise ops of the reference's ``_ELEMENTWISE`` list and one
  per input element of a reduction, as the reference counts them;
* **hbm_bytes** -- operand plus result bytes of every op that is not a
  view or a metadata op.  Eager PyTorch runs each op as its own round trip
  through device memory, so this is the port's own traffic.  A write into
  a view (``copy_`` into a slice) is charged at the view's size, not its
  buffer's;
* **flash_bytes** -- the part of ``hbm_bytes`` spent inside the plain
  attention (``kernels.ref.flash_attention``, its recompute in
  ``kernels.ops.FlashAttention.backward``, ``models.attention
  .chunked_attention``, ``parallel.sp_attention._local_flash``) and the SSD
  intra-chunk step (``models.ssm._chunk_intra``), the reference's
  ``_FLASH_FUNCS`` scopes, found from the Python frames of each op;
* **collectives** by op (``all-gather``, ``reduce-scatter``,
  ``all-reduce``, ``all-to-all``, ``broadcast``): count and operand bytes
  (the local shard of an all-gather, the whole input of a reduce-scatter,
  the buffer of an all-reduce), as the reference's ``parse_collectives``
  sums operands;
* **peak_bytes** -- the highest sum of live storages during the step (the
  stand-in for ``memory_analysis``), each storage added when an op first
  returns it (or when :meth:`OpCost.track` is given it) and taken off by a
  ``weakref`` finaliser when it is freed.

Loops need no trip counts: eager Python runs every iteration, and each is
counted.  The attention that the flash kernel replaces on the card (a
forward ``flash_attention`` call; its backward recompute is plain there
too) is kept apart as ``kernel_dot_flops`` and ``kernel_bytes``, and
``peak_bytes_estimate`` leaves out the storages the plain version makes
inside those calls, all but its output: the kernel keeps them on chip.

Run a step for its cost under ``FakeTensorMode`` (``launch.dryrun``),
this mode entered inside it so that it sees the fake tensors::

    with FakeTensorMode():
        step, args = ...
        result, totals = count(step, *args)
"""

from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# Flops per element of the reference's ``_ELEMENTWISE`` HLO ops, by aten
# name (in-place forms share the name without the trailing ``_``).
_ELEMENTWISE = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "maximum": 1, "minimum": 1, "pow": 1,
    "exp": 1, "log": 1, "tanh": 1, "rsqrt": 1, "sqrt": 1, "neg": 1, "abs": 1, "sign": 1,
    "floor": 1, "ceil": 1, "round": 1, "sigmoid": 1, "cos": 1, "sin": 1, "where": 1,
    "eq": 1, "ne": 1, "lt": 1, "le": 1, "gt": 1, "ge": 1, "logical_and": 1, "logical_or": 1,
    "logical_xor": 1, "logical_not": 1, "bitwise_and": 1, "bitwise_or": 1, "bitwise_xor": 1,
    "bitwise_not": 1, "clamp": 1, "clamp_min": 1, "clamp_max": 1, "atan2": 1, "remainder": 1,
    "fmod": 1, "expm1": 1, "log1p": 1, "erf": 1, "reciprocal": 1, "square": 1, "masked_fill": 1,
    # composites, as XLA lowers them: silu = logistic * x; a softmax is a
    # max and a sum (reductions, one flop per input element), a subtract,
    # an exp and a divide
    "silu": 2, "_softmax": 5, "_log_softmax": 5,
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all", "logsumexp", "cumsum",
               "argmax", "argmin", "var", "std", "norm", "linalg_vector_norm"}
# Ops that move no bytes: views, metadata, allocation without a write.
_NO_BYTES = {"detach", "alias", "lift_fresh", "empty", "empty_like", "empty_strided", "_local_scalar_dense",
             "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "device", "is_same_size",
             "_unsafe_view", "set", "resize"}
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "broadcast_": "broadcast",
}
# In-place ops that overwrite their first argument without reading it.
_OVERWRITES = {"copy_", "fill_", "zero_", "random_", "uniform_", "normal_"}
# The schema argument that holds a collective's operand, by preference.
_OPERAND_ARGS = ("input_tensors", "input_tensor", "input", "tensors")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def state_tensors(tree) -> list:
    """Every tensor a step's state or inputs hold: nested dicts, lists and
    tuples (named tuples too), a module's parameters and buffers, a
    ``ShardedParams``' blocks and its work copy."""
    out: list = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, Mapping):
            for v in x.values():
                walk(v)
            walk(getattr(x, "model", None))
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def _attention_codes() -> Tuple[set, Any, Any]:
    """(codes of the plain-attention scopes, the plain flash version's
    code, ``FlashAttention.backward``'s code)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention, ssm
    from repro_torch.parallel import sp_attention

    backward = ops.FlashAttention.backward.__code__
    flash = ref.flash_attention.__code__
    scopes = {flash, backward, attention.chunked_attention.__code__, sp_attention._local_flash.__code__,
              ssm._chunk_intra.__code__}
    return scopes, flash, backward


def _shape_key(t: torch.Tensor) -> str:
    return f"{str(t.dtype).replace('torch.', '')}[{','.join(str(int(d)) for d in t.shape)}]"


@dataclass
class CostTotals:
    """What :class:`OpCost` counted, under the reference's names."""

    flops: float = 0.0
    dot_flops: float = 0.0
    kernel_dot_flops: float = 0.0     # products inside the forward flash calls
    hbm_bytes: float = 0.0
    flash_bytes: float = 0.0          # subset of hbm_bytes in the plain-attention scopes
    kernel_bytes: float = 0.0         # subset of flash_bytes in the forward flash calls
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_count: Dict[str, float] = field(default_factory=dict)
    coll_bytes_by_axis: Dict[str, float] = field(default_factory=dict)  # the same bytes, by mesh axis
    dot_flops_by_shape: Dict[str, float] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    peak_bytes: float = 0.0           # every live storage, the plain attention's included
    peak_bytes_estimate: float = 0.0  # the storages a forward flash call frees before it returns left out
    ops: int = 0

    @property
    def coll_total_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def non_attention_dot_flops(self) -> float:
        """The products a dispatch mode sees on the card, where the forward
        flash calls are a kernel launched through ``ctypes``."""
        return self.dot_flops - self.kernel_dot_flops


class OpCost(TorchDispatchMode):
    """Counts the cost of the ops dispatched while it is entered
    (:class:`CostTotals` in ``self.totals``).  ``track(tree)`` adds the
    storages of tensors made before it was entered (the step's state and
    inputs) to the live tally.  With a ``mesh`` (a ``DeviceMesh``) each
    collective's bytes are also booked to the axis whose group it ran on
    (``"world"`` for any other group)."""

    def __init__(self, mesh=None):
        super().__init__()
        self._axes: Dict[str, str] = {}
        if mesh is not None:
            self._axes = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
        from torch.utils.flop_counter import flop_registry

        self.totals = CostTotals()
        self._flop_registry = flop_registry
        self._scopes, self._flash, self._backward = _attention_codes()
        self._live: Dict[int, Tuple[int, bool]] = {}   # storage key -> (bytes, born in a kernel call)
        self._live_bytes = 0
        self._kernel_live = 0
        self._kernel_out: set = set()                    # storages of the last op of a forward flash call

    # -- storages ------------------------------------------------------------

    def track(self, *trees) -> None:
        for t in state_tensors(trees):
            self._add_storage(t, False)
        self._note_peak()

    def _add_storage(self, t: torch.Tensor, in_kernel: bool) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._live:
            return
        n = int(s.nbytes())
        self._live[key] = (n, in_kernel)
        self._live_bytes += n
        self._kernel_live += n if in_kernel else 0
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        n, in_kernel = self._live.pop(key, (0, False))
        self._live_bytes -= n
        self._kernel_live -= n if in_kernel else 0

    def _settle_kernel_storages(self) -> None:
        """On leaving a forward flash call: the storages of its last op (the
        call's output) count in the estimate from now on; the rest of what
        it made (intermediates a remat policy keeps, say) stays out, as the
        kernel makes no such tensors."""
        for key in self._kernel_out:
            n, in_kernel = self._live.get(key, (0, False))
            if in_kernel:
                self._live[key] = (n, False)
                self._kernel_live -= n
        self._kernel_out = set()

    def _note_peak(self) -> None:
        t = self.totals
        t.peak_bytes = max(t.peak_bytes, self._live_bytes)
        t.peak_bytes_estimate = max(t.peak_bytes_estimate, self._live_bytes - self._kernel_live)

    # -- scopes --------------------------------------------------------------

    def _scope(self) -> Tuple[bool, bool]:
        """(in a plain-attention scope, in a forward flash call) from the
        Python frames of the op being dispatched."""
        f = sys._getframe(2)
        in_scope = in_flash = in_backward = False
        while f is not None:
            code = f.f_code
            if code in self._scopes:
                in_scope = True
                if code is self._flash:
                    in_flash = True
                elif code is self._backward:
                    in_backward = True
            f = f.f_back
        return in_scope, in_flash and not in_backward

    # -- dispatch ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        t = self.totals
        t.ops += 1
        packet = func._overloadpacket
        name = packet.__name__
        namespace = func.namespace
        in_scope, in_kernel = self._scope()
        if not in_kernel and self._kernel_out:
            self._settle_kernel_storages()
        for o in _tensors(out):
            self._add_storage(o, in_kernel)
        if in_kernel:
            self._kernel_out = {o.untyped_storage()._cdata for o in _tensors(out)}
        self._note_peak()

        if namespace == "c10d":
            self._collective(func, name, args, kwargs, out)
            return
        if namespace == "prim" or func.is_view or name.rstrip("_") in _NO_BYTES:
            return

        if packet in self._flop_registry:
            f = float(self._flop_registry[packet](*args, **kwargs, out_val=out))
            t.flops += f
            t.dot_flops += f
            if in_kernel:
                t.kernel_dot_flops += f
            outs = _tensors(out)
            if outs:
                key = _shape_key(outs[0])
                t.dot_flops_by_shape[key] = t.dot_flops_by_shape.get(key, 0.0) + f
        else:
            base = name.rstrip("_") if name.endswith("_") and not name.startswith("_") else name
            if base in _ELEMENTWISE:
                t.flops += _ELEMENTWISE[base] * sum(o.numel() for o in _tensors(out)[:1])
            elif base in _REDUCTIONS:
                ins = _tensors(args)[:1]
                t.flops += sum(i.numel() for i in ins)

        reads = _tensors(args)
        if name in _OVERWRITES:
            reads = reads[1:]  # the destination is written, not read
        b = float(sum(_nbytes(x) for x in reads) + sum(_nbytes(x) for x in _tensors(kwargs))
                  + sum(_nbytes(o) for o in _tensors(out)))
        t.hbm_bytes += b
        t.bytes_by_op[name] = t.bytes_by_op.get(name, 0.0) + b
        if in_scope:
            t.flash_bytes += b
        if in_kernel:
            t.kernel_bytes += b

    def _collective(self, func, name: str, args, kwargs, out) -> None:
        kind = _COLLECTIVES.get(name, name)  # any other c10d op is booked under its own name
        values = dict(zip((a.name for a in func._schema.arguments), args))
        values.update(kwargs)
        operand = next((values[a] for a in _OPERAND_ARGS if a in values), ())
        n = float(sum(_nbytes(x) for x in _tensors(operand)))
        t = self.totals
        t.coll_bytes[kind] = t.coll_bytes.get(kind, 0.0) + n
        t.coll_count[kind] = t.coll_count.get(kind, 0.0) + 1
        axis = self._axis_of(values.get("process_group"))
        t.coll_bytes_by_axis[axis] = t.coll_bytes_by_axis.get(axis, 0.0) + n
        written = values.get("output_tensors", values.get("output", values.get("output_tensor", operand)))
        b = n + float(sum(_nbytes(x) for x in _tensors(written)))
        t.hbm_bytes += b
        t.bytes_by_op[kind] = t.bytes_by_op.get(kind, 0.0) + b


    def _axis_of(self, group) -> str:
        import torch.distributed as dist

        try:
            name = dist.ProcessGroup.unbox(group).group_name
        except (AttributeError, RuntimeError, TypeError):
            return "world"
        return self._axes.get(name, "world")


def count(fn, *args, mesh=None, **kwargs) -> Tuple[Any, CostTotals]:
    """``fn(*args, **kwargs)`` under a fresh :class:`OpCost` over ``mesh``,
    its arguments tracked as live before it runs: (its result, the
    totals)."""
    mode = OpCost(mesh)
    with mode:
        mode.track(args, kwargs)
        result = fn(*args, **kwargs)
    return result, mode.totals
