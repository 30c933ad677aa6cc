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

``reference_layout`` places each of a model's parameters in that tree (a
leaf's path and, for a stacked leaf, the layer index); ``reference_tree``
and ``load_reference_tree`` carry any tensors laid out like the
parameters (their gradients, the optimizer's moments) to and from the
tree's leaves.  The checkpoints and the optimizer's weight decay (which
reads a leaf's rank in the reference's tree) are built on them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

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
LeafPath = Tuple[str, ...]
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
    return nest({path: t.float().numpy() for path, t in reference_tree(model).items()})


def reference_layout(model: nn.Module) -> Dict[str, Tuple[LeafPath, Optional[int]]]:
    """For each parameter of ``model`` (by its ``named_parameters`` name):
    the path of the reference's leaf that holds it and its index on that
    leaf's leading layer axis, or None for a leaf that is not stacked
    (embeddings, final norms, deepseek's ``first_layer``, Zamba's
    ``shared`` block, Whisper's ``frontend_proj``).  A decoder layer's
    ``ffn`` is the reference's ``mlp`` or ``moe``."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        path, index = [], None
        for i, part in enumerate(parts):
            if part.isdigit():
                index = int(part)
                continue
            if part == "ffn":
                layer = model.get_submodule(".".join(parts[:i]))
                part = layer.ffn_kind if isinstance(layer, T.DecoderLayer) else part
            path.append(part)
        out[name] = (tuple(path), index)
    return out


def reference_tree(
    model: nn.Module, values: Optional[Mapping[str, torch.Tensor]] = None
) -> Dict[LeafPath, torch.Tensor]:
    """The reference's leaves holding ``values`` (a tensor per parameter
    name of ``model``, shaped as the parameter; default: the parameters
    themselves) as CPU tensors in their own dtype, a stacked leaf's
    layers on a new leading axis in layer order.  Each tensor is copied
    once, straight into its place."""
    values = dict(model.named_parameters()) if values is None else values
    groups: Dict[LeafPath, Dict[Optional[int], torch.Tensor]] = {}
    for name, (path, index) in reference_layout(model).items():
        groups.setdefault(path, {})[index] = values[name].detach()
    out = {}
    for path, by_index in groups.items():
        if None in by_index:
            out[path] = by_index[None].to("cpu", copy=True)
            continue
        first = by_index[0]
        leaf = torch.empty((len(by_index),) + tuple(first.shape), dtype=first.dtype)
        for i, t in by_index.items():
            leaf[i].copy_(t)
        out[path] = leaf
    return out


def load_reference_tree(
    model: nn.Module, leaves: Mapping[LeafPath, Any], targets: Optional[Mapping[str, torch.Tensor]] = None
) -> None:
    """Copy the reference's ``leaves`` (tensors or numpy arrays, by path,
    stacked as ``reference_tree`` gives them) into ``targets`` (a tensor
    per parameter name of ``model``; default: the parameters), in place,
    each cast to its target's dtype.  A missing leaf raises
    :class:`KeyError`, a leaf of another shape :class:`ValueError`."""
    targets = dict(model.named_parameters()) if targets is None else targets
    layout = reference_layout(model)
    shapes = reference_shapes(model)
    with torch.no_grad():
        for name, (path, index) in layout.items():
            if path not in leaves:
                raise KeyError(f"no leaf {'/'.join(path)} for {name}")
            leaf = leaves[path]
            leaf = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))
            if tuple(leaf.shape) != shapes[path]:
                raise ValueError(f"leaf {'/'.join(path)} has the shape {tuple(leaf.shape)}, "
                                 f"{type(model).__name__} wants {shapes[path]}")
            targets[name].copy_(leaf if index is None else leaf[index])


def reference_shapes(model: nn.Module) -> Dict[LeafPath, Tuple[int, ...]]:
    """The shape of each of the reference's leaves for ``model``: a stacked
    leaf's leading axis counts its layers."""
    dims = {name: tuple(p.shape) for name, p in model.named_parameters()}
    out: Dict[LeafPath, Tuple[int, ...]] = {}
    for name, (path, index) in reference_layout(model).items():
        if index is None:
            out[path] = dims[name]
        else:
            out[path] = (max(out.get(path, (0,))[0], index + 1),) + dims[name]
    return out


def nest(leaves: Mapping[LeafPath, Any]) -> NestedArrays:
    """A nested dict from leaves keyed by path."""
    out: NestedArrays = {}
    for path, leaf in leaves.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out

