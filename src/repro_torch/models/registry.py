"""Family registry: a uniform init/prefill/decode API per architecture.

Counterpart of ``repro.models.registry``.  The port serves the decoder
families ``dense``, ``moe`` and ``mla_moe``; every other family raises
:class:`NotImplementedError` naming the ROADMAP item that ports it.  The
loss is not part of the port's API yet: it belongs to training
(ROADMAP.md Queue 1, 'LM stack, still to port').
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


class ModelApi(NamedTuple):
    init: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


_NOT_PORTED = {
    "vlm": "the VLM prefix embeddings",
    "ssm": "models/mamba_lm.py and models/ssm.py",
    "hybrid": "models/zamba.py",
    "encdec": "models/whisper.py",
}


def _decoder_api() -> ModelApi:
    return ModelApi(
        init=T.decoder_init,
        prefill=lambda params, batch, cfg, max_seq=None, backend=None: T.prefill(
            params, batch["tokens"], cfg, max_seq=max_seq, backend=backend
        ),
        decode_step=lambda params, cache, batch, cfg: T.decode_step(
            params, cache, batch["tokens"], cfg
        ),
        init_cache=T.init_cache,
    )


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family in T.FAMILIES:
        return _decoder_api()
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch yet: "
            f"{_NOT_PORTED[cfg.family]} (ROADMAP.md Queue 1, 'LM stack, still to port')"
        )
    raise ValueError(f"unknown model family {cfg.family!r}")
