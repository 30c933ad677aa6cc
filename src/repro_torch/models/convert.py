"""Carry LM weights across from numpy arrays: the JAX package's parameter
pytree into the port's model, and back.

``params_from_jax`` takes the pytree of the reference's ``init`` for the
config's family as numpy arrays, with the layer parameters stacked on a
leading ``(L, ...)`` axis, and builds the port's model holding the same
numbers in ``cfg.param_dtype``, so that both packages compute the same
function:

* ``Decoder`` (dense, vlm, moe, mla_moe): ``layers`` stacked (MoE experts
  and shared experts nested inside), deepseek's ``first_layer`` unstacked;
* ``MambaLM`` (ssm): ``layers.{ln, mamba.*}`` stacked;
* ``Zamba`` (hybrid): ``mamba_layers`` stacked like Mamba's and the one
  ``shared`` block unstacked;
* ``Whisper`` (encdec): ``enc_layers`` and ``dec_layers`` stacked, the
  rest (``frontend_proj``, ``enc_norm``, ``embed``, ``pos_embed``,
  ``dec_norm``) unstacked.

MoE routers and Mamba's ``a_log``, ``dt_bias`` and ``d_skip`` stay
float32.  ``params_to_numpy`` gives the same nested dict back.  Tests
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
from repro_torch.models import mamba_lm as MB
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models import zamba as Z

NestedArrays = Dict[str, Any]
FLOAT32_LEAVES = ("router",) + S.FLOAT32_PARAMS


def _tensor(a, dtype: torch.dtype, device: DeviceLike) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bfloat16
        a = a.astype(np.float32)
    return torch.tensor(a).to(device=device, dtype=dtype)


def params_from_jax(params_np: NestedArrays, cfg: ModelConfig, device: DeviceLike = None) -> nn.Module:
    """The port's model for ``cfg`` (``Decoder``, ``MambaLM``, ``Zamba`` or
    ``Whisper``) holding the arrays of ``params_np``, on ``device``
    (``None``: the card, through ``resolve_device``).  The leaves named in
    ``FLOAT32_LEAVES`` stay float32; everything else goes to
    ``cfg.param_dtype``.  A layer count other than ``cfg.n_layers`` (or,
    for the encoder, ``cfg.encoder_layers``) raises :class:`ValueError`."""
    device = resolve_device(device)
    dtype = L.dtype_of(cfg.param_dtype)
    conv = lambda a: _tensor(a, dtype, device)

    def block(tree, pick=np.asarray) -> nn.ParameterDict:
        return nn.ParameterDict({
            k: block(a, pick) if isinstance(a, dict)
            else L.frozen(_tensor(pick(a), torch.float32 if k in FLOAT32_LEAVES else dtype, device))
            for k, a in tree.items()
        })

    def per_layer(stacked, n_extra: int = 0, want: int = cfg.n_layers):
        ln = stacked["ln" if "ln" in stacked else "ln1"]
        n = int(np.asarray(ln["g"] if isinstance(ln, dict) else ln).shape[0])
        if n + n_extra != want:
            raise ValueError(f"params hold {n + n_extra} layers, {cfg.name} has {want}")
        return [lambda a, i=i: np.asarray(a)[i] for i in range(n)]

    def mamba_layers(stacked):
        return [MB.MambaLayer(conv(pick(stacked["ln"])), block(stacked["mamba"], pick)) for pick in per_layer(stacked)]

    if cfg.family == "encdec":
        ln = lambda tree: W.ln_params(conv(tree["g"]), conv(tree["b"]))
        stacked = lambda name, parts, n: [nn.ParameterDict({k: block(params_np[name][k], pick) for k in parts})
                                          for pick in per_layer(params_np[name], want=n)]
        return W.Whisper(cfg, conv(params_np["frontend_proj"]),
                         stacked("enc_layers", W.ENC_PARTS, cfg.encoder_layers), ln(params_np["enc_norm"]),
                         conv(params_np["embed"]), conv(params_np["pos_embed"]),
                         stacked("dec_layers", W.DEC_PARTS, cfg.n_layers), ln(params_np["dec_norm"]))
    embed, final_norm = conv(params_np["embed"]), conv(params_np["final_norm"])
    unembed = None if cfg.tie_embeddings else conv(params_np["unembed"])
    if cfg.family == "ssm":
        return MB.MambaLM(cfg, embed, mamba_layers(params_np["layers"]), final_norm, unembed)
    if cfg.family == "hybrid":
        sh = params_np["shared"]
        shared = Z.SharedBlock(conv(sh["ln1"]), block(sh["attn"]), conv(sh["ln2"]), block(sh["mlp"]))
        return Z.Zamba(cfg, embed, mamba_layers(params_np["mamba_layers"]), shared, final_norm, unembed)

    attn_kind, ffn_kind = T._layer_kinds(cfg)

    def layer(tree, pick, ffn: str) -> T.DecoderLayer:
        return T.DecoderLayer(conv(pick(tree["ln1"])), conv(pick(tree["ln2"])), block(tree["attn"], pick),
                              block(tree[ffn], pick), attn_kind=attn_kind, ffn_kind=ffn)

    stacked = params_np["layers"]
    layers = [layer(stacked, pick, ffn_kind) for pick in per_layer(stacked, int("first_layer" in params_np))]
    first = layer(params_np["first_layer"], np.asarray, "mlp") if "first_layer" in params_np else None
    return T.Decoder(cfg, embed, layers, final_norm, unembed, first_layer=first)


def params_to_numpy(model: nn.Module) -> NestedArrays:
    """The inverse of ``params_from_jax``: float32 numpy arrays, layers
    stacked on a leading axis, ``first_layer`` and Zamba's ``shared``
    unstacked."""
    arr = lambda t: t.detach().float().cpu().numpy()
    if isinstance(model, W.Whisper):
        out = {name: _tree_arrays(getattr(model, name), arr) for name in ("enc_norm", "dec_norm")}
        out.update({name: arr(getattr(model, name)) for name in ("frontend_proj", "embed", "pos_embed")})
        out.update({name: _stack([_tree_arrays(lp, arr) for lp in getattr(model, name)])
                    for name in ("enc_layers", "dec_layers")})
        return out
    out: NestedArrays = {"embed": arr(model.embed), "final_norm": arr(model.final_norm)}
    if model.unembed is not None:
        out["unembed"] = arr(model.unembed)
    mamba = lambda layers: _stack([{"ln": arr(lp.ln), "mamba": _tree_arrays(lp.mamba, arr)} for lp in layers])
    if isinstance(model, MB.MambaLM):
        out["layers"] = mamba(model.layers)
        return out
    if isinstance(model, Z.Zamba):
        sp = model.shared
        out["mamba_layers"] = mamba(model.mamba_layers)
        out["shared"] = {"ln1": arr(sp.ln1), "attn": _tree_arrays(sp.attn, arr), "ln2": arr(sp.ln2),
                         "mlp": _tree_arrays(sp.mlp, arr)}
        return out

    def unstacked(lp) -> NestedArrays:
        return {"ln1": arr(lp.ln1), "ln2": arr(lp.ln2), "attn": _tree_arrays(lp.attn, arr),
                lp.ffn_kind: _tree_arrays(lp.ffn, arr)}

    out["layers"] = _stack([unstacked(lp) for lp in model.layers])
    if model.first_layer is not None:
        out["first_layer"] = unstacked(model.first_layer)
    return out


def _tree_arrays(pd: nn.ParameterDict, arr) -> NestedArrays:
    return {k: _tree_arrays(v, arr) if isinstance(v, nn.ParameterDict) else arr(v) for k, v in pd.items()}


def _stack(trees: list) -> NestedArrays:
    """Stack a list of equal nested dicts of arrays on a new leading axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict) else np.stack([t[k] for t in trees])
            for k, v in trees[0].items()}
