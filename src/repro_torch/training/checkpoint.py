"""Atomic, elastic checkpoints in the reference's layout (no external
library).

Counterpart of ``repro.training.checkpoint``.  The layout is the
reference's, so a checkpoint of either package restores in the other::

    <dir>/step_000120/
        manifest.json      # step, extra metadata, and per leaf its name,
                           # file, dtype, shape, sha256 and spec string
        <leaf-id>.npy      # one file per leaf (full array; bf16 as uint16)
    <dir>/step_000120.COMMITTED   # atomicity marker (written last)

Leaves and their names are the reference's ``_flatten`` of its train
state ``{"params": ..., "opt": AdamWState(step, m, v, master)}``: the
path's keys joined by ``_`` (``params_layers_attn_wq``, ``opt_step``,
``opt_m_layers_attn_wq``, ``opt_master_embed``), with each layer group
stacked on a leading axis (``models.convert.reference_tree``).  A state
whose ``params`` is the port's model is laid out so; any other nested
dict of tensors or arrays is flattened as the reference flattens a dict
(keys sorted).

* **elastic re-mesh** — leaves are saved whole, with the spec strings of
  ``specs`` (the reference's JSON form; empty for a leaf ``specs`` does
  not name, or without ``specs``) and the mesh's ``mesh_shape`` (null
  without one).  A state on a mesh (``params`` a
  ``parallel.sharding.ShardedParams``) is gathered on every rank (a
  collective: every rank calls ``save``) and rank 0 writes it.  Restore
  keeps this rank's block: of a ``ShardedParams`` leaf by the target
  state's own spec on its mesh, of any other tensor leaf (with ``mesh``)
  by its saved spec projected onto the mesh's axes, as the reference
  places it.  So a save on (data=2, model=2) restores onto (data=2), or
  onto one device.

* **atomic commit** — leaves are written to a temp dir, fsync'd, renamed,
  and only then is the COMMITTED marker created; restore ignores a step
  directory without its marker.
* **integrity** — every leaf file's sha256 is in the manifest (hashed as
  the bytes are written); restore verifies it before installing.
* **retention** — ``keep_last`` commits are kept, older ones pruned.
* **async** — ``AsyncCheckpointer`` copies the state to host memory on
  the caller's thread and writes it on a worker thread; it keeps each
  save's seconds (the blocking copy, the write) and bytes.
* **parallel files** — a model's leaf files are written, read and hashed
  on up to ``WRITERS`` threads (file I/O and sha256 release the
  interpreter lock); the manifest keeps the leaves' order.

Restore writes the model's parameters and the optimizer's moments and
master in place (the reference builds new arrays) and returns the state
with a new step counter.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import convert
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import ShardedParams
from repro_torch.training.optimizer import AdamWState

Leaves = List[Tuple[str, Any]]
_MODEL_FIELDS = ("m", "v", "master")
WRITERS = min(8, os.cpu_count() or 1)


# ---------------------------------------------------------------------------
# the state <-> named leaves
# ---------------------------------------------------------------------------


def _name(path: Tuple[str, ...]) -> str:
    return "_".join(path) or "root"


def _host(x) -> Any:
    """A host copy of a leaf: a CPU tensor, or a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


class _Whole(dict):
    """Blocks by parameter name, each gathered whole when it is read."""

    def __init__(self, sp: ShardedParams, values):
        super().__init__(values)
        self.sp = sp

    def __getitem__(self, name: str) -> torch.Tensor:
        sp = self.sp
        return SH.gather_leaf(super().__getitem__(name), sp.specs[name], sp.mesh)


def _model_tree(model, values=None):
    """``convert.reference_tree`` of a model, or of a ``ShardedParams``'s
    blocks gathered whole (a collective)."""
    if isinstance(model, ShardedParams):
        return convert.reference_tree(model.model, _Whole(model, model.blocks if values is None else values))
    return convert.reference_tree(model, values)


def _params(node, model):
    """The state's model (or ``ShardedParams``), if ``node`` holds one."""
    return node["params"] if isinstance(node.get("params"), (nn.Module, ShardedParams)) else model


def state_leaves(state) -> Leaves:
    """``state``'s leaves as host copies, named and ordered as the
    reference's ``_flatten`` names and orders them.  A ``ShardedParams``
    state is gathered whole, so every rank of its mesh must call this."""
    out: Leaves = []

    def walk(node, path, model):
        if isinstance(node, (nn.Module, ShardedParams)):
            for p, t in sorted(_model_tree(node).items()):
                out.append((_name(path + p), t))
        elif isinstance(node, AdamWState):
            walk(node.step, path + ("step",), model)
            for field in _MODEL_FIELDS:
                values = getattr(node, field)
                if values is not None and model is not None:
                    for p, t in sorted(_model_tree(model, values).items()):
                        out.append((_name(path + (field,) + p), t))
                elif values is not None:
                    walk(values, path + (field,), None)
        elif isinstance(node, dict):
            model = _params(node, model)
            for key in sorted(node):
                walk(node[key], path + (str(key),), model)
        else:
            out.append((_name(path), _host(node)))

    walk(state, (), None)
    return out


def spec_strings(specs) -> Dict[str, str]:
    """Each leaf's spec string (the reference's JSON form) by leaf name,
    from a specs tree laid out like the state (``state_specs``)."""
    out: Dict[str, str] = {}

    def walk(node, path):
        if isinstance(node, SH.PartitionSpec):
            out[_name(path)] = node.to_json()
        elif isinstance(node, AdamWState):
            walk(node.step, path + ("step",))
            for field in _MODEL_FIELDS:
                if getattr(node, field) is not None:
                    walk(getattr(node, field), path + (field,))
        elif isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (str(key),))

    if specs is not None:
        walk(specs, ())
    return out


def _mesh_of(state, mesh):
    if mesh is None and isinstance(state, dict) and isinstance(state.get("params"), ShardedParams):
        return state["params"].mesh
    return mesh


def _writes(mesh) -> bool:
    """Whether this process writes: rank 0 of a mesh's job, or any process
    without one."""
    import torch.distributed as dist

    return mesh is None or not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class _HashingWriter:
    """A binary file that hashes what is written through it."""

    def __init__(self, f):
        self.f = f
        self.sha = hashlib.sha256()

    def write(self, data) -> int:
        self.sha.update(data)
        return self.f.write(data)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def save_checkpoint(
    directory: str | os.PathLike,
    step: int,
    state,
    *,
    specs=None,
    mesh=None,
    keep_last: int = 3,
    extra: Optional[Dict[str, Any]] = None,
) -> Path:
    """Atomically persist ``state`` for ``step``.  Returns the commit dir.
    ``specs`` (``state_specs``) gives the leaves' spec strings; ``mesh``
    (default: a sharded state's) its ``mesh_shape``.  On a mesh every
    rank calls this; rank 0 writes, and all return after its commit."""
    import torch.distributed as dist

    mesh = _mesh_of(state, mesh)
    leaves = state_leaves(state)
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    if _writes(mesh):
        final = _write(directory, step, leaves, keep_last, extra, spec_strings(specs), mesh)
    if mesh is not None and dist.is_initialized():
        dist.barrier()
    return final


def _write(directory, step: int, leaves: Leaves, keep_last: int, extra,
           specs: Optional[Dict[str, str]] = None, mesh=None) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    marker = directory / f"step_{step:08d}.COMMITTED"

    tmp = Path(tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory))
    manifest: Dict[str, Any] = {"step": step, "mesh_shape": SH.axis_sizes(mesh) if mesh is not None else None,
                                "extra": extra or {}, "leaves": []}
    specs = specs or {}

    def write_leaf(name: str, leaf) -> Dict[str, Any]:
        arr, dtype_name = _to_numpy(leaf)
        fname = f"{name}.npy"
        with open(tmp / fname, "wb") as f:
            w = _HashingWriter(f)
            np.save(w, arr)
            f.flush()
            os.fsync(f.fileno())
        return {"name": name, "file": fname, "dtype": dtype_name, "shape": list(arr.shape),
                "sha256": w.sha.hexdigest(), "spec": specs.get(name, "")}

    try:
        with ThreadPoolExecutor(max_workers=WRITERS) as pool:
            futures = [pool.submit(write_leaf, name, leaf) for name, leaf in leaves]
            manifest["leaves"] = [f.result() for f in futures]
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        marker.touch()
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise

    _prune(directory, keep_last)
    return final


def _prune(directory: Path, keep_last: int) -> None:
    commits = sorted(int(m.name[len("step_"):-len(".COMMITTED")]) for m in directory.glob("step_*.COMMITTED"))
    for old in commits[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(directory / f"step_{old:08d}", ignore_errors=True)
        (directory / f"step_{old:08d}.COMMITTED").unlink(missing_ok=True)


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    directory = Path(directory)
    commits = [
        int(m.name[len("step_"):-len(".COMMITTED")])
        for m in directory.glob("step_*.COMMITTED")
        if (directory / m.name[: -len(".COMMITTED")]).is_dir()
    ]
    return max(commits) if commits else None


def restore_checkpoint(
    directory: str | os.PathLike,
    like,
    *,
    step: Optional[int] = None,
    mesh=None,
    verify: bool = True,
) -> Tuple[int, Any, Dict[str, Any]]:
    """Restore the committed ``step`` (default: the latest) into the
    structure of ``like``.  Returns (step, state, extra-metadata).

    The port's model (or a ``ShardedParams``'s blocks) and the
    optimizer's moments and master in ``like`` are written in place;
    other leaves come back as new tensors (on the device of ``like``'s
    leaf; with ``mesh``, this rank's block by the saved spec projected
    onto the mesh) or numpy arrays.  ``like``'s leaves have the saved,
    whole shapes.  A missing leaf raises :class:`KeyError`, a digest that
    does not match :class:`IOError`, a shape that does not match
    :class:`ValueError`."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {directory}")
    cdir = directory / f"step_{step:08d}"
    if not (directory / f"step_{step:08d}.COMMITTED").exists():
        raise FileNotFoundError(f"checkpoint step {step} not committed")
    manifest = json.loads((cdir / "manifest.json").read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}

    def load(path: Tuple[str, ...]) -> torch.Tensor:
        name = _name(path)
        entry = by_name.get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        raw = (cdir / entry["file"]).read_bytes()
        if verify and hashlib.sha256(raw).hexdigest() != entry["sha256"]:
            raise IOError(f"hash mismatch for {name}: corrupt checkpoint")
        return _from_numpy(np.load(io.BytesIO(raw)), entry["dtype"])

    def load_model(model, path, targets=None):
        paths = list(convert.reference_shapes(model))
        with ThreadPoolExecutor(max_workers=WRITERS) as pool:
            leaves = dict(zip(paths, pool.map(lambda p: load(path + p), paths)))
        convert.load_reference_tree(model, leaves, targets)

    def load_sharded(sp: ShardedParams, path, targets):
        """This rank's blocks of the saved leaves, by the state's specs."""
        layout = convert.reference_layout(sp.model)
        paths = sorted({p for p, _ in layout.values()})
        with ThreadPoolExecutor(max_workers=WRITERS) as pool:
            leaves = dict(zip(paths, pool.map(lambda p: load(path + p), paths)))
        with torch.no_grad():
            for name, (p, index) in layout.items():
                whole = leaves[p] if index is None else leaves[p][index]
                if tuple(whole.shape) != sp.full_shape(name):
                    raise ValueError(f"leaf {_name(path + p)} holds {name} of the shape {tuple(whole.shape)}, "
                                     f"the state wants {sp.full_shape(name)}")
                targets[name].copy_(SH.local_slice(whole, sp.specs[name], sp.mesh))

    def load_params(model, path, targets=None):
        if isinstance(model, ShardedParams):
            load_sharded(model, path, model.blocks if targets is None else targets)
        else:
            load_model(model, path, targets)

    def walk(node, path, model):
        if isinstance(node, (nn.Module, ShardedParams)):
            load_params(node, path)
            return node
        if isinstance(node, AdamWState):
            fields = {"step": walk(node.step, path + ("step",), model)}
            for field in _MODEL_FIELDS:
                values = getattr(node, field)
                if values is not None and model is not None:
                    load_params(model, path + (field,), values)
                    fields[field] = values
                else:
                    fields[field] = None if values is None else walk(values, path + (field,), None)
            return AdamWState(**fields)
        if isinstance(node, dict):
            model = _params(node, model)
            return {key: walk(node[key], path + (str(key),), model) for key in node}
        got = load(path)
        want = tuple(np.shape(node))
        if tuple(got.shape) != want:
            raise ValueError(f"shape mismatch for {_name(path)}: ckpt {tuple(got.shape)} vs model {want}")
        if isinstance(node, torch.Tensor):
            if mesh is not None:
                spec = SH.project_spec(SH.PartitionSpec.from_json(by_name[_name(path)]["spec"]), mesh)
                got = SH.shard_leaf(got, spec, mesh)
            return got.to(node.device)
        return got.numpy() if got.dtype != torch.bfloat16 else got

    return step, walk(like, (), None), manifest.get("extra", {})


# ---------------------------------------------------------------------------
# async wrapper
# ---------------------------------------------------------------------------


class AsyncCheckpointer:
    """Overlaps the disk dump with training: ``save`` copies the state to
    host memory on the caller's thread (the only blocking part) and writes
    it on a worker thread.  ``wait()`` joins the in-flight write and
    raises its error, if any; ``join()`` joins it and keeps the error for
    the next ``wait()``.  ``saves`` holds, per finished save, its step,
    the seconds of the blocking copy and of the write, and its bytes."""

    def __init__(self, directory: str | os.PathLike, *, keep_last: int = 3):
        self.directory = Path(directory)
        self.keep_last = keep_last
        self.saves: List[Dict[str, Any]] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state, *, specs=None, mesh=None, extra: Optional[Dict[str, Any]] = None) -> None:
        """As ``save_checkpoint``, the write on a worker thread; on a mesh
        every rank snapshots (the gather) and rank 0 writes."""
        self.wait()
        mesh = _mesh_of(state, mesh)
        t0 = time.perf_counter()
        leaves = state_leaves(state)
        snapshot_s = time.perf_counter() - t0
        if not _writes(mesh):
            return

        def work():
            try:
                t1 = time.perf_counter()
                final = _write(self.directory, step, leaves, self.keep_last, extra, spec_strings(specs), mesh)
                self.saves.append({"step": step, "snapshot_s": snapshot_s, "write_s": time.perf_counter() - t1,
                                   "bytes": sum(f.stat().st_size for f in final.iterdir())})
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self) -> None:
        self.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
