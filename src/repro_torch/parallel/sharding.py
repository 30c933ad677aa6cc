"""Parameter / batch / cache sharding rules on a ``DeviceMesh``, and the
collectives that move a parameter between its blocks and its whole.

Counterpart of ``repro.parallel.sharding``, with the reference's rule
table and choices (DESIGN.md §6):

* ``pod``   — pure data parallelism across pods (parameters replicated
  pod to pod; the gradient crosses pods once a step, optionally through
  ``training.compression``'s codecs);
* ``data``  — batch sharding + FSDP: every weight matrix shards its
  input-feature (or vocab-row) dim over ``data``;
* ``model`` — the weights' head / FFN-hidden / vocab-column dims, and the
  MoE expert dim.

A spec is the port's :class:`PartitionSpec`, a tuple with one entry per
dim: ``None``, an axis name, or a tuple of axis names (batch specs).  Its
JSON form is the reference's checkpoint spec string.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``,
used only for its process groups (``get_group``, ``get_local_rank``): a
rank holds plain local tensors, and the collectives are written out here
(no DTensor, no FSDP2 — the flash kernel takes plain tensors, and the
specs split any dim, not only dim 0).

What the ``model`` axis does in the port:

* **dense weights** (attention and MLP projections, embeddings) are
  *stored* split as their specs say and gathered whole, ``data`` and
  ``model`` splits alike, before the forward pass (:func:`gather_leaf`) —
  in effect ZeRO-3 over the data x model grid.  Their gradients are
  summed over the dp axes and cut back to the block (:func:`reduce_grad`).
  Megatron-style column/row-parallel compute for dense layers (GSPMD's
  choice in the reference, not its semantics) is a later item;
* **expert stacks** (``moe/w_gate``, ``w_up``, ``w_down``) are *computed*
  per rank along ``model`` (expert parallelism, ``models.moe``); they
  are gathered along ``data`` only (:data:`COMPUTED`);
* the **decode cache** is split along its sequence over ``model``
  (:func:`cache_specs`), consumed by ``parallel.sp_attention``.

:class:`ShardedParams` holds a model's blocks beside its work copy, the
model the forward pass runs.  Nothing here imports the models at import
time (``models.attention`` imports ``parallel.sp_attention``).

SSM note: Mamba's in_proj mixes (z|x|B|C|dt) segments in one output dim,
so SSM blocks shard over ``data`` only (the zamba2 shared block gets the
generic rules).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# (path regex, spec for trailing dims).  First match wins.  The reference's
# table, verbatim.
_RULES: Sequence[Tuple[str, Tuple]] = (
    # --- MoE expert stacks (E, D, F) / (E, F, D): EP over model ------------
    (r"moe/w_gate$",  ("model", "data", None)),
    (r"moe/w_up$",    ("model", "data", None)),
    (r"moe/w_down$",  ("model", None, "data")),
    (r"moe/router$",  ("data", None)),
    (r"moe/shared/w_gate$", ("data", "model")),
    (r"moe/shared/w_up$",   ("data", "model")),
    (r"moe/shared/w_down$", ("model", "data")),
    # --- MLA ----------------------------------------------------------------
    (r"attn/wq$",     ("data", "model")),
    (r"attn/wkv_a$",  ("data", None)),
    (r"attn/wkv_b$",  (None, "model")),
    (r"attn/kv_norm$", (None,)),
    # --- GQA / generic projections ------------------------------------------
    (r"(wq|wk|wv|w_gate|w_up)$", ("data", "model")),
    (r"(wo|w_down)$", ("model", "data")),
    (r"(bq|bk|bv)$",  ("model",)),
    # --- SSM (FSDP only; see module docstring) -------------------------------
    (r"mamba/in_proj$",  ("data", None)),
    (r"mamba/out_proj$", (None, "data")),
    (r"mamba/conv_w$",   (None, None)),
    (r"mamba/conv_b$",   (None,)),
    (r"mamba/(a_log|dt_bias|d_skip)$", (None,)),
    (r"mamba/out_norm$", (None,)),
    # --- embeddings -----------------------------------------------------------
    (r"embed$",        ("model", "data")),
    (r"unembed$",      ("data", "model")),
    (r"pos_embed$",    (None, "data")),
    (r"frontend_proj$", ("data", None)),
    # --- norms / everything small ---------------------------------------------
    (r".*", (None,)),
)

#: Leaves computed per rank along an axis instead of gathered over it:
#: the expert stacks, split over ``model`` (expert parallelism).
COMPUTED: Sequence[Tuple[str, str]] = ((r"moe/w_(gate|up|down)$", "model"),)


def _normal(entry):
    """An entry as the reference's PartitionSpec keeps it: a tuple (or
    list) of one name is the name, an empty one None."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """One entry per dim: ``None``, an axis name or a tuple of two or more
    names (normalised as the reference's ``PartitionSpec`` does)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_normal(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(e) for e in self) + ")"

    def to_json(self) -> str:
        """The reference's checkpoint spec string (tuples as lists)."""
        return json.dumps([list(e) if isinstance(e, tuple) else e for e in self])

    @classmethod
    def from_json(cls, s: str) -> Optional["PartitionSpec"]:
        if not s:
            return None
        return cls(*json.loads(s))


P = PartitionSpec


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def axis_sizes(mesh) -> Dict[str, int]:
    """The mesh's axes and their sizes, in mesh order (a ``DeviceMesh``, or
    any object with ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Sequence) -> Tuple[str, ...]:
    """Every axis a spec names, in dim order."""
    return tuple(a for e in spec for a in _entry_axes(e))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _path_str(path: Tuple[str, ...]) -> str:
    return "/".join(str(k) for k in path)


def _spec_for(path_s: str, shape: Sequence[int], mesh_axes: Sequence[str], sizes: Dict[str, int]) -> PartitionSpec:
    ndim = len(shape)
    for pattern, trailing in _RULES:
        if re.search(pattern, path_s):
            spec = list(trailing)
            break
    else:  # pragma: no cover
        spec = [None]
    # pad leading scan/stack dims with None
    if len(spec) > ndim:
        spec = spec[-ndim:] if ndim > 0 else []
    spec = [None] * (ndim - len(spec)) + spec
    # drop axes not present in this mesh (e.g. no "pod" on single-pod)
    spec = [s if (s is None or s in mesh_axes) else None for s in spec]
    # drop axes whose size does not divide the dim (e.g. vocab 50280 % 16):
    # replication is always a correct fallback.
    spec = [s if (s is None or shape[i] % sizes[s] == 0) else None for i, s in enumerate(spec)]
    return P(*spec)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in (leaf.shape if hasattr(leaf, "shape") else leaf))


def _map_leaves(tree, fn, path=()):
    """``fn(path, leaf)`` over a nested dict whose leaves are shapes (tuples
    of ints) or anything with ``.shape``."""
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(shapes: Any, mesh) -> Any:
    """Specs for a nested dict of parameter shapes under the reference's
    names (layer groups stacked on a leading axis, as
    ``models.convert.reference_shapes`` gives them), same nesting."""
    sizes = axis_sizes(mesh)
    return _map_leaves(shapes, lambda path, leaf: _spec_for(_path_str(path), _shape(leaf), tuple(sizes), sizes))


def computed_axes(path) -> Tuple[str, ...]:
    """The axes a leaf is computed along (:data:`COMPUTED`), not gathered."""
    path_s = _path_str(path)
    return tuple(axis for pattern, axis in COMPUTED if re.search(pattern, path_s))


def module_specs(model, mesh) -> Dict[str, PartitionSpec]:
    """A spec per parameter of the port's ``model`` (by its
    ``named_parameters`` name): its reference leaf's spec, less the
    leading layer entry for a stacked leaf (always None)."""
    from repro_torch.models import convert

    shapes = convert.reference_shapes(model)
    sizes = axis_sizes(mesh)
    leaf_specs = {path: _spec_for(_path_str(path), shape, tuple(sizes), sizes) for path, shape in shapes.items()}
    out = {}
    for name, (path, index) in convert.reference_layout(model).items():
        spec = leaf_specs[path]
        if index is not None:
            assert spec[0] is None, (name, spec)
            spec = P(*spec[1:])
        out[name] = spec
    return out


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def dp_axes(mesh) -> Tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in dp_axes(mesh)])) if dp_axes(mesh) else 1


def batch_specs(batch_shape: Any, mesh, *, global_batch: int) -> Any:
    """Shard the batch dim over ('pod','data') when divisible, else replicate."""
    dp = dp_axes(mesh)
    lead = dp if (dp and global_batch % _dp_size(mesh) == 0) else ()

    def one(path, leaf):
        nd = len(_shape(leaf))
        return P(lead, *([None] * (nd - 1))) if nd else P()

    return _map_leaves(batch_shape, one)


def cache_specs(cache_shape: Any, mesh, cfg=None, *, batch: int) -> Any:
    """KV/state cache sharding: batch over dp (when divisible), the long
    sequence dim over 'model' (the sequence-parallel cache that
    ``parallel.sp_attention`` consumes)."""
    dp = dp_axes(mesh)
    bspec = dp if (dp and batch % _dp_size(mesh) == 0) else None
    m = axis_sizes(mesh).get("model", 1)

    def one(path, leaf):
        name = _path_str(path)
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0:  # t counter
            return P()
        if name in ("k", "v"):          # (L|apps, B, Hkv, S, hd)
            return P(None, bspec, None, "model" if shape[3] % m == 0 else None, None)
        if name in ("xk", "xv"):        # cross-attn (L, B, H, S_enc, hd): small
            return P(None, bspec, None, None, None)
        if name == "ckv":               # (L, B, S, r)
            return P(None, bspec, "model" if shape[2] % m == 0 else None, None)
        if name == "krope":             # (L, B, 1, S, dr)
            return P(None, bspec, None, "model" if shape[3] % m == 0 else None, None)
        if name == "first_ckv":         # (B, S, r)
            return P(bspec, "model" if shape[1] % m == 0 else None, None)
        if name == "first_krope":       # (B, 1, S, dr)
            return P(bspec, None, "model" if shape[2] % m == 0 else None, None)
        if name in ("conv", "ssm"):     # SSM states: batch only
            return P(None, bspec, *([None] * (nd - 2)))
        return P(*([None] * nd))

    return _map_leaves(cache_shape, one)


def project_spec(spec: Optional[Sequence], mesh) -> PartitionSpec:
    """``spec`` with the axes the mesh lacks dropped (the reference's
    elastic restore projection); None is the replicated spec."""
    names = set(axis_sizes(mesh))

    def clean(e):
        if isinstance(e, tuple):
            return tuple(a for a in e if a in names) or None
        return e if (e is None or e in names) else None

    return P(*(clean(e) for e in (spec or ())))


# ---------------------------------------------------------------------------
# blocks <-> wholes
# ---------------------------------------------------------------------------


def _block_index(entry, mesh) -> Tuple[int, int]:
    """(index, count) of this rank's block along a dim split by ``entry``
    (axes outermost first, row-major)."""
    sizes = axis_sizes(mesh)
    index, count = 0, 1
    for a in _entry_axes(entry):
        index = index * sizes[a] + mesh.get_local_rank(a)
        count *= sizes[a]
    return index, count


def local_slice(full: Tensor, spec: Sequence, mesh, *, axes: Optional[Iterable[str]] = None) -> Tensor:
    """A view of this rank's block of ``full`` along the dims ``spec``
    splits (only over ``axes``, where given)."""
    keep = None if axes is None else set(axes)
    out = full
    for dim, entry in enumerate(spec):
        entry = tuple(a for a in _entry_axes(entry) if keep is None or a in keep)
        if entry:
            index, count = _block_index(entry, mesh)
            step = full.shape[dim] // count
            out = out.narrow(dim, index * step, step)
    return out


def shard_leaf(full: Tensor, spec: Sequence, mesh, *, axes: Optional[Iterable[str]] = None) -> Tensor:
    """This rank's block of ``full`` as a new contiguous tensor."""
    return local_slice(full, spec, mesh, axes=axes).clone(memory_format=torch.contiguous_format)


def _all_gather(local: Tensor, dim: int, group) -> Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_leaf(local: Tensor, spec: Sequence, mesh, *, skip: Iterable[str] = ()) -> Tensor:
    """The whole of a leaf from its blocks: an all-gather along each dim
    over each axis the spec names there (innermost axis first), except
    the axes in ``skip``."""
    skip = set(skip)
    out = local
    for dim, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            if a not in skip:
                out = _all_gather(out, dim, mesh.get_group(a))
    return out


def reduce_grad(full_grad: Tensor, spec: Sequence, mesh, *, over: Optional[Iterable[str]] = None,
                computed: Iterable[str] = ()) -> Tensor:
    """This rank's block of a gradient summed over the dp axes.

    ``full_grad`` is this rank's gradient of its whole leaf (already its
    block along the ``computed`` axes).  The sum runs over ``over``
    (default: :func:`dp_axes`): a reduce-scatter along the dim the spec
    splits on that axis, an all-reduce where it splits none.  The spec's
    other axes (``model``) cut the local block first."""
    import torch.distributed as dist

    over = dp_axes(mesh) if over is None else tuple(over)
    where = {a: dim for dim, e in enumerate(spec) for a in _entry_axes(e)}
    cut = set(where) - set(over) - set(computed)
    g = local_slice(full_grad, spec, mesh, axes=cut).contiguous()
    for a in over:
        group = mesh.get_group(a)
        if a in where:
            parts = [c.contiguous() for c in g.chunk(dist.get_world_size(group), dim=where[a])]
            g = torch.empty_like(parts[0])
            dist.reduce_scatter(g, parts, group=group)
        else:
            dist.all_reduce(g, group=group)
    return g


def cut_computed(model, mesh, specs: Optional[Dict[str, PartitionSpec]] = None) -> Dict[str, Tuple[str, ...]]:
    """Cut ``model``'s computed leaves (:data:`COMPUTED`: the expert stacks
    on ``model``) to this rank's block, in place, and return each
    parameter's computed axes (by name)."""
    from repro_torch.models import convert

    specs = module_specs(model, mesh) if specs is None else specs
    layout = convert.reference_layout(model)
    computed = {n: tuple(a for a in computed_axes(layout[n][0]) if a in spec_axes(specs[n])) for n in specs}
    with torch.no_grad():
        for n, p in model.named_parameters():
            if computed[n]:
                p.data = shard_leaf(p.detach(), specs[n], mesh, axes=computed[n])
    return computed


class ShardedParams(Mapping):
    """A model's parameters on a mesh.

    ``blocks`` maps each parameter name (the model's ``named_parameters``)
    to this rank's block, the state the optimizer updates and checkpoints
    save; ``specs`` to its spec; ``computed`` to the axes it is computed
    along (:data:`COMPUTED`).  ``model`` is the work copy the forward
    pass runs: each parameter whole, except along its computed axes,
    where it holds this rank's block.  As a mapping it is ``blocks``."""

    def __init__(self, model, mesh, specs: Dict[str, PartitionSpec], blocks: Dict[str, Tensor],
                 computed: Dict[str, Tuple[str, ...]]):
        self.model = model
        self.mesh = mesh
        self.specs = specs
        self.blocks = blocks
        self.computed = computed

    @classmethod
    def from_model(cls, model, mesh) -> "ShardedParams":
        """Keep this rank's blocks of ``model`` (every rank built the same
        one); the model becomes the work copy, its computed leaves cut to
        this rank's block."""
        specs = module_specs(model, mesh)
        blocks = {n: shard_leaf(p.detach(), specs[n], mesh) for n, p in model.named_parameters()}
        return cls(model, mesh, specs, blocks, cut_computed(model, mesh, specs))

    def __getitem__(self, name: str) -> Tensor:
        return self.blocks[name]

    def __iter__(self):
        return iter(self.blocks)

    def __len__(self) -> int:
        return len(self.blocks)

    def gather(self):
        """Fill the work copy from the blocks (:func:`gather_leaf`) and
        return it."""
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(gather_leaf(self.blocks[n], self.specs[n], self.mesh, skip=self.computed[n]))
        return self.model

    def reduce_grads(self, grads: Mapping[str, Tensor], over: Optional[Iterable[str]] = None) -> Dict[str, Tensor]:
        """The work copy's ``grads`` (by name) summed over ``over`` (default
        the dp axes) and cut to this rank's blocks (:func:`reduce_grad`)."""
        return {n: reduce_grad(g, self.specs[n], self.mesh, over=over, computed=self.computed[n])
                for n, g in grads.items()}

    def full_shape(self, name: str) -> Tuple[int, ...]:
        """A parameter's whole shape."""
        sizes = axis_sizes(self.mesh)
        return tuple(d * int(np.prod([sizes[a] for a in _entry_axes(e)] or [1]))
                     for d, e in zip(self.blocks[name].shape, self.specs[name]))
