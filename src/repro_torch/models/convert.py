"""Carry LM weights across from numpy arrays: the JAX package's parameter
pytree into the port's ``Decoder``, and back.

``params_from_jax`` takes the pytree of ``repro.models.transformer
.decoder_init`` as numpy arrays, with the layer parameters stacked on a
leading ``(L, ...)`` axis, and builds a ``Decoder`` holding the same
numbers in ``cfg.param_dtype``, so that both packages compute the same
function.  ``params_to_numpy`` gives the same nested dict back.  Tests
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
    ``device`` (``None``: the card, through ``resolve_device``)."""
    device = resolve_device(device)
    dtype = L.dtype_of(cfg.param_dtype)
    conv = lambda a: _tensor(a, dtype, device)
    stacked = params_np["layers"]
    n_layers = int(np.asarray(stacked["ln1"]).shape[0])
    if n_layers != cfg.n_layers:
        raise ValueError(f"params hold {n_layers} layers, {cfg.name} has {cfg.n_layers}")

    def block(tree, i) -> nn.ParameterDict:
        return nn.ParameterDict({k: L.frozen(conv(np.asarray(a)[i])) for k, a in tree.items()})

    layers = [
        T.DecoderLayer(
            conv(np.asarray(stacked["ln1"])[i]), conv(np.asarray(stacked["ln2"])[i]),
            block(stacked["attn"], i), block(stacked["mlp"], i),
        )
        for i in range(n_layers)
    ]
    unembed = None if cfg.tie_embeddings else conv(params_np["unembed"])
    return T.Decoder(cfg, conv(params_np["embed"]), layers, conv(params_np["final_norm"]), unembed)


def params_to_numpy(model: T.Decoder) -> NestedArrays:
    """The inverse of ``params_from_jax``: float32 numpy arrays, layers
    stacked on a leading axis."""
    arr = lambda t: t.detach().float().cpu().numpy()
    stack = lambda get: np.stack([arr(get(lp)) for lp in model.layers])
    first = model.layers[0]
    out: NestedArrays = {
        "embed": arr(model.embed),
        "final_norm": arr(model.final_norm),
        "layers": {
            "ln1": stack(lambda lp: lp.ln1),
            "ln2": stack(lambda lp: lp.ln2),
            "attn": {k: stack(lambda lp, k=k: lp.attn[k]) for k in first.attn},
            "mlp": {k: stack(lambda lp, k=k: lp.mlp[k]) for k in first.mlp},
        },
    }
    if model.unembed is not None:
        out["unembed"] = arr(model.unembed)
    return out
