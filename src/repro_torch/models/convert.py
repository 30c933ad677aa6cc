"""Carry LM weights across from numpy arrays: the JAX package's parameter
pytree into the port's ``Decoder``, and back.

``params_from_jax`` takes the pytree of ``repro.models.transformer
.decoder_init`` as numpy arrays, with the layer parameters stacked on a
leading ``(L, ...)`` axis (MoE experts and shared experts nested inside,
deepseek's ``first_layer`` unstacked), and builds a ``Decoder`` holding
the same numbers in ``cfg.param_dtype`` (MoE routers in float32), so that
both packages compute the same function.  ``params_to_numpy`` gives the same nested dict back.  Tests
fill the dict with ``np.asarray`` on the JAX arrays; nothing here imports
the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

NestedArrays = Dict[str, Any]


def _tensor(a, dtype: torch.dtype, device: DeviceLike) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bfloat16
        a = a.astype(np.float32)
    return torch.tensor(a).to(device=device, dtype=dtype)


def params_from_jax(params_np: NestedArrays, cfg: ModelConfig, device: DeviceLike = None) -> T.Decoder:
    """A ``Decoder`` for ``cfg`` holding the arrays of ``params_np``, on
    ``device`` (``None``: the card, through ``resolve_device``).  MoE
    routers stay float32; everything else goes to ``cfg.param_dtype``."""
    device = resolve_device(device)
    dtype = L.dtype_of(cfg.param_dtype)
    conv = lambda a, dt=dtype: _tensor(a, dt, device)
    attn_kind, ffn_kind = T._layer_kinds(cfg)
    stacked = params_np["layers"]
    n_layers = int(np.asarray(stacked["ln1"]).shape[0]) + (1 if "first_layer" in params_np else 0)
    if n_layers != cfg.n_layers:
        raise ValueError(f"params hold {n_layers} layers, {cfg.name} has {cfg.n_layers}")

    def block(tree, pick) -> nn.ParameterDict:
        return nn.ParameterDict({
            k: block(a, pick) if isinstance(a, dict)
            else L.frozen(conv(pick(a), torch.float32 if k == "router" else dtype))
            for k, a in tree.items()
        })

    def layer(tree, pick, ffn: str) -> T.DecoderLayer:
        return T.DecoderLayer(conv(pick(tree["ln1"])), conv(pick(tree["ln2"])), block(tree["attn"], pick),
                              block(tree[ffn], pick), attn_kind=attn_kind, ffn_kind=ffn)

    layers = [layer(stacked, lambda a, i=i: np.asarray(a)[i], ffn_kind)
              for i in range(int(np.asarray(stacked["ln1"]).shape[0]))]
    first = layer(params_np["first_layer"], np.asarray, "mlp") if "first_layer" in params_np else None
    unembed = None if cfg.tie_embeddings else conv(params_np["unembed"])
    return T.Decoder(cfg, conv(params_np["embed"]), layers, conv(params_np["final_norm"]), unembed,
                     first_layer=first)


def params_to_numpy(model: T.Decoder) -> NestedArrays:
    """The inverse of ``params_from_jax``: float32 numpy arrays, layers
    stacked on a leading axis, ``first_layer`` unstacked."""
    arr = lambda t: t.detach().float().cpu().numpy()

    def unstacked(lp) -> NestedArrays:
        return {"ln1": arr(lp.ln1), "ln2": arr(lp.ln2), "attn": _tree_arrays(lp.attn, arr),
                lp.ffn_kind: _tree_arrays(lp.ffn, arr)}

    per_layer = [unstacked(lp) for lp in model.layers]
    out: NestedArrays = {
        "embed": arr(model.embed),
        "final_norm": arr(model.final_norm),
        "layers": _stack(per_layer),
    }
    if model.first_layer is not None:
        out["first_layer"] = unstacked(model.first_layer)
    if model.unembed is not None:
        out["unembed"] = arr(model.unembed)
    return out


def _tree_arrays(pd: nn.ParameterDict, arr) -> NestedArrays:
    return {k: _tree_arrays(v, arr) if isinstance(v, nn.ParameterDict) else arr(v) for k, v in pd.items()}


def _stack(trees: list) -> NestedArrays:
    """Stack a list of equal nested dicts of arrays on a new leading axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict) else np.stack([t[k] for t in trees])
            for k, v in trees[0].items()}
