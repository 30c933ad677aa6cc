"""DPP-PMRF on PyTorch and CUDA (NVIDIA Hopper).

A second implementation of the ``repro`` package, module for module at
the same relative paths: the PMRF engine, the LM serving stack of every
family (dense, vlm, moe, mla_moe, ssm, hybrid, encdec) and its trainer
(``training``, ``launch.train``).  Plain tensor code is PyTorch; the kernels
(``fused_em_tick`` and ``segment_reduce`` on the single-device path,
``fused_map_step`` on the sharded route, the binary ``mrf_min_energy``,
and ``flash_attention`` for LM prefill and the training forward) are
CUDA C++ built for ``sm_90a`` at first use (``repro_torch.kernels``).  The package imports ``torch``
and ``numpy`` only.

Every entry point takes ``device=``.  ``None`` means the card: without
CUDA it raises instead of carrying on on the CPU.  Pass ``device="cpu"``
to run the plain PyTorch versions of the kernels on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` selects ``cuda`` and raises :class:`RuntimeError` when CUDA is
    absent; anything else is taken as given (``"cpu"``, ``"cuda:1"``, ...).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)


def to_tensor(x, dtype: Optional[torch.dtype] = None, device: DeviceLike = "cpu") -> torch.Tensor:
    """``x`` (a tensor, numpy array or sequence) as a tensor on ``device``.
    Host data is copied, so read-only numpy arrays are fine."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


__all__ = ["DeviceLike", "resolve_device", "to_tensor"]
