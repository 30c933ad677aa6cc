"""Input stand-ins and step builders for every (architecture x shape) cell,
shared by the dry run (``launch.dryrun``) and the card's roofline check.

Counterpart of ``repro.launch.specs``.  The reference's stand-ins are
``jax.ShapeDtypeStruct``s and its step a jit'd function lowered from
them.  Here a stand-in is a :class:`Struct`, a ``(shape, dtype)`` record
whose ``make()`` builds the tensor, and ``build_step`` builds the state
and inputs of the step as tensors: under a ``FakeTensorMode`` the caller
owns (the dry run) they hold no memory, on the card they are real.

``input_specs(cfg, shape)`` returns, under the reference's names:

* ``train``   -- {tokens, labels, mask} (+ frames / vision_embeds)
* ``prefill`` -- {tokens} (+ the same extras)
* ``decode``  -- {tokens: (B, 1)} and the cache of ``seq_len`` positions
                 (one new token against a full KV/state cache)

``build_step(cfg, shape, mesh)`` returns a :class:`CellStep` whose
``fn(*args)`` runs one step of the port's own entry points, for rank
``mesh``'s coordinates (``mesh`` a ``DeviceMesh``, or ``None`` for one
device):

* ``train``   -- ``training.train_step.make_train_step`` on the state of
  ``make_sharded_train_state`` (its blocks on a mesh; the step gathers
  them, takes its rows of the global batch, reduces the gradients);
* ``prefill`` -- ``ModelApi.prefill`` of the rank's rows, the weights
  gathered whole first on a mesh (``ShardedParams.gather``, the port's
  ZeRO-3 over data x model; the expert stacks stay split over ``model``);
* ``decode``  -- ``ModelApi.decode_step`` against the rank's block of a
  full ``init_cache`` of ``seq_len`` positions (the new token at position
  ``seq_len - 1``), sequence-parallel where ``serve_runtime`` says.

The host scalars a step reads (AdamW's step counter, the decode clock
``t``) are made with ``torch.tensor``: under ``FakeTensorMode`` that is a
constant the mode can answer, where a fake ``torch.zeros`` would raise
``DataDependentOutputException`` when ``int()`` reads it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models.registry import get_api
from repro_torch.models.transformer import ParallelRuntime
from repro_torch.parallel import sharding as SH
from repro_torch.training.train_step import TrainStepConfig, make_sharded_train_state, make_train_step


class Struct(NamedTuple):
    """A tensor's stand-in: its shape and dtype."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def make(self, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
        """A zero tensor of this shape and dtype (fake under a
        ``FakeTensorMode``)."""
        return torch.zeros(self.shape, dtype=self.dtype, device=device)


def _struct(shape, dtype) -> Struct:
    return Struct(tuple(int(d) for d in shape), dtype)


def _shape_of(shape: Union[str, ShapeSpec]) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _map(tree, fn):
    """``fn`` over the leaves of nested dicts (a cache, a spec tree)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# input structs
# ---------------------------------------------------------------------------


def batch_structs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Struct]:
    """Model-input stand-ins for a train/prefill batch."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Struct] = {"tokens": _struct((b, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _struct((b, s), torch.int32)
        out["mask"] = _struct((b, s), torch.float32)
    if cfg.family == "encdec":
        out["frames"] = _struct((b, cfg.encoder_seq, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        out["vision_embeds"] = _struct((b, cfg.vision_patches, cfg.d_model), torch.float32)
    return out


def decode_structs(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[Dict[str, Struct], Any]:
    """(tokens, cache) stand-ins for a decode step at the cell's seq_len;
    the cache's from the family's ``init_cache`` run on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    b, s = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        cache = get_api(cfg).init_cache(cfg, b, s)
    return {"tokens": _struct((b, 1), torch.int32)}, _map(cache, lambda t: _struct(t.shape, t.dtype))


def input_specs(cfg: ModelConfig, shape_name: Union[str, ShapeSpec]) -> Dict[str, Any]:
    """All input stand-ins for the cell, keyed by role."""
    shape = _shape_of(shape_name)
    if shape.kind == "decode":
        tokens, cache = decode_structs(cfg, shape)
        return {"batch": tokens, "cache": cache}
    return {"batch": batch_structs(cfg, shape)}


# ---------------------------------------------------------------------------
# runtimes per step kind
# ---------------------------------------------------------------------------


def _runtime(mesh, **kw) -> Optional[ParallelRuntime]:
    if mesh is None:
        return None
    sizes = SH.axis_sizes(mesh)
    return ParallelRuntime(mesh=mesh, dp_axes=SH.dp_axes(mesh), tp_axis="model" if "model" in sizes else "", **kw)


def serve_runtime(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Optional[ParallelRuntime]:
    """Decode runtime: sequence-parallel cache attention when the cache's
    seq dim divides over the model axis (``parallel.sp_attention``)."""
    if mesh is None:
        return None
    m = SH.axis_sizes(mesh).get("model", 1)
    has_kv_seq = cfg.family in ("dense", "moe", "mla_moe", "vlm", "encdec", "hybrid")
    seq_ok = has_kv_seq and shape.seq_len % m == 0 and m > 1
    return _runtime(mesh, seq_axis="model" if seq_ok else "")


@dataclass
class CellStep:
    """One (arch x shape x mesh) cell's step: ``fn(*args)`` runs it."""

    fn: Callable
    args: Tuple[Any, ...]
    kind: str                         # train | prefill | decode
    n_params: int
    n_active_params: int


def _local_shape(shape: Tuple[int, ...], spec, mesh) -> Tuple[int, ...]:
    sizes = SH.axis_sizes(mesh)
    out = []
    for d, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1
        for a in SH._entry_axes(entry):
            n *= sizes[a]
        out.append(d // n)
    return tuple(out)


def _local_rows(batch: Dict[str, torch.Tensor], mesh, global_batch: int) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (all of it where the rows do not
    divide over the dp axes)."""
    if mesh is None:
        return batch
    lead = SH.spec_axes(SH.batch_specs({"x": (global_batch,)}, mesh, global_batch=global_batch)["x"])
    return {k: SH.local_slice(x, (lead,), mesh) for k, x in batch.items()}


def _host_scalar(value: int) -> torch.Tensor:
    return torch.tensor(int(value), dtype=torch.int32)


def build_step(
    cfg: ModelConfig,
    shape_name: Union[str, ShapeSpec],
    mesh=None,
    *,
    ts_cfg: Optional[TrainStepConfig] = None,
    device: Union[str, torch.device] = "cpu",
) -> CellStep:
    """The cell's step on ``device``, its weights from ``ts_cfg.seed``.
    Call it under the ``FakeTensorMode`` the step will run in, if any: the
    state and inputs are made here."""
    shape = _shape_of(shape_name)
    api = get_api(cfg)
    ts_cfg = ts_cfg or TrainStepConfig()
    counts = dict(n_params=cfg.n_params(), n_active_params=cfg.active_params())
    device = torch.device(device)

    if shape.kind == "train":
        state, _ = make_sharded_train_state(cfg, mesh, ts_cfg, device=device)
        state["opt"] = state["opt"]._replace(step=_host_scalar(0))
        batch = {k: s.make(device) for k, s in batch_structs(cfg, shape).items()}
        step = make_train_step(cfg, mesh, ts_cfg)
        return CellStep(fn=step, args=(state, batch), kind="train", **counts)

    gen = torch.Generator(device=device).manual_seed(ts_cfg.seed)
    model = api.init(gen, cfg)
    sharded = SH.ShardedParams.from_model(model, mesh) if mesh is not None else None
    params = sharded if sharded is not None else model

    def weights(p):
        return p.gather() if isinstance(p, SH.ShardedParams) else p

    if shape.kind == "prefill":
        batch = {k: s.make(device) for k, s in batch_structs(cfg, shape).items()}
        rt = _runtime(mesh)

        def prefill_step(p, b):
            return api.prefill(weights(p), _local_rows(b, mesh, shape.global_batch), cfg, rt,
                               max_seq=shape.seq_len)

        return CellStep(fn=prefill_step, args=(params, batch), kind="prefill", **counts)

    tokens, cache_structs = decode_structs(cfg, shape)
    rt = serve_runtime(cfg, shape, mesh)
    if mesh is not None:
        specs = SH.cache_specs(_map(cache_structs, lambda s: s.shape), mesh, cfg, batch=shape.global_batch)
        if not rt.seq_axis:  # a cache the model axis does not split stays whole along its sequence
            specs = {k: SH.P(*(None if e == "model" else e for e in sp)) for k, sp in specs.items()}
        cache = {k: _struct(_local_shape(s.shape, specs[k], mesh), s.dtype).make(device)
                 for k, s in cache_structs.items()}
    else:
        cache = _map(cache_structs, lambda s: s.make(device))
    cache["t"] = _host_scalar(shape.seq_len - 1)
    tok = tokens["tokens"].make(device)

    def decode_step(p, c, t):
        return api.decode_step(weights(p), c, {"tokens": _local_rows({"t": t}, mesh, shape.global_batch)["t"]},
                               cfg, rt)

    return CellStep(fn=decode_step, args=(params, cache, tok), kind="decode", **counts)


def runnable_cells(cfg: ModelConfig) -> Tuple[str, ...]:
    """Shape names this arch runs (assignment skips recorded in cfg)."""
    return tuple(s for s in SHAPES if s not in cfg.skip_shapes)
