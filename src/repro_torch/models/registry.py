"""Family registry: a uniform init/loss/prefill/decode API per architecture.

Counterpart of ``repro.models.registry``.  The port serves every family
of the reference: the decoder families ``dense``, ``vlm``, ``moe`` and
``mla_moe``, the Mamba2 family ``ssm``, the hybrid ``hybrid`` and the
encoder-decoder ``encdec`` (whose prefill and loss take
``batch["frames"]``); an unknown family raises :class:`ValueError`.
``loss(params, batch, cfg, rt=None, backend=None)`` is the family's
training loss (``batch``: ``tokens``, ``labels``, ``mask`` and the
family's extras).  Every entry takes the mesh runtime ``rt``
(``transformer.ParallelRuntime``) fourth, as the reference's lambdas do.
``loss`` and ``prefill`` take ``backend`` (where GQA attention runs); the
families that reach no kernel ignore it.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba_lm as MB
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models import zamba as Z


class ModelApi(NamedTuple):
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


def _decoder_api() -> ModelApi:
    return ModelApi(
        init=T.decoder_init,
        loss=T.lm_loss,
        prefill=lambda params, batch, cfg, rt=None, max_seq=None, backend=None: T.prefill(
            params, batch["tokens"], cfg, rt, max_seq=max_seq, backend=backend,
            vision_embeds=batch.get("vision_embeds"),
        ),
        decode_step=lambda params, cache, batch, cfg, rt=None: T.decode_step(
            params, cache, batch["tokens"], cfg, rt
        ),
        init_cache=T.init_cache,
    )


def _mamba_api() -> ModelApi:
    return ModelApi(
        init=MB.mamba_init,
        loss=MB.mamba_loss,
        prefill=lambda params, batch, cfg, rt=None, max_seq=None, backend=None: MB.mamba_prefill(
            params, batch["tokens"], cfg, rt, max_seq=max_seq
        ),
        decode_step=lambda params, cache, batch, cfg, rt=None: MB.mamba_decode_step(
            params, cache, batch["tokens"], cfg, rt
        ),
        init_cache=MB.mamba_init_cache,
    )


def _zamba_api() -> ModelApi:
    return ModelApi(
        init=Z.zamba_init,
        loss=Z.zamba_loss,
        prefill=lambda params, batch, cfg, rt=None, max_seq=None, backend=None: Z.zamba_prefill(
            params, batch["tokens"], cfg, rt, max_seq=max_seq, backend=backend
        ),
        decode_step=lambda params, cache, batch, cfg, rt=None: Z.zamba_decode_step(
            params, cache, batch["tokens"], cfg, rt
        ),
        init_cache=Z.zamba_init_cache,
    )


def _whisper_api() -> ModelApi:
    return ModelApi(
        init=W.whisper_init,
        loss=W.whisper_loss,
        prefill=lambda params, batch, cfg, rt=None, max_seq=None, backend=None: W.whisper_prefill(
            params, batch["tokens"], batch.get("frames"), cfg, rt, max_seq=max_seq, backend=backend
        ),
        decode_step=lambda params, cache, batch, cfg, rt=None: W.whisper_decode_step(
            params, cache, batch["tokens"], cfg, rt
        ),
        init_cache=W.whisper_init_cache,
    )


_FAMILY_APIS = {"ssm": _mamba_api, "hybrid": _zamba_api, "encdec": _whisper_api,
                **{f: _decoder_api for f in T.FAMILIES}}


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family in _FAMILY_APIS:
        return _FAMILY_APIS[cfg.family]()
    raise ValueError(f"unknown model family {cfg.family!r}")
