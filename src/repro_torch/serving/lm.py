"""Slot-based batched LM generation engine (continuous batching).

Counterpart of ``repro.serving.lm``, with the same scheduler.  The engine
owns a fixed pool of ``max_batch`` slots with a shared, batched KV cache.
Requests are admitted into free slots (each prompt prefilled alone, batch
1, into its slot's cache lanes), decoded together in one batched
``decode_step`` per engine tick, and retired on EOS or length.

Position-alignment contract: the cache carries a single scalar clock
``t`` (write position and causal horizon), so all co-resident slots share
one position.  The scheduler enforces this exactly:

* when the pool is idle, the next wave admits the pending group with the
  most requests of equal prompt length;
* mid-flight, a pending request is admitted the moment its prompt length
  equals the pool's current position (length-aligned continuous batching).

PyTorch runs eagerly, so there is no compiled-function cache.  A
request's ``extras`` (the VLM family's ``vision_embeds`` (P, D), the
encdec family's ``frames`` (encoder_seq, D)) each get a leading batch
axis and go into its prefill's batch, as in the reference.  The cache
may hold any family's layout (K/V, MLA latents, Mamba's conv and SSM
states, Zamba's per-application K/V, Whisper's cross K/V):
``_write_slot`` finds each entry's batch axis.  The engine runs on
``device`` (``None``: the card, through ``resolve_device``) and takes
``backend``: ``"auto"`` puts prefill attention on the flash kernel for a
CUDA device; ``"torch"`` runs its plain version, the one way to do so on
the card.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import BACKENDS
from repro_torch.models.registry import ModelApi, get_api
from repro_torch.serving.sampler import SamplerConfig, sample_logits


@dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (S,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    extras: Dict[str, Any] = field(default_factory=dict)   # name -> array or tensor, no batch axis


@dataclass
class Completion:
    rid: int
    tokens: np.ndarray             # generated ids (prompt excluded)
    prompt_len: int
    latency_s: float
    finish_reason: str             # "eos" | "length"


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: torch.nn.Module,
        *,
        max_batch: int = 8,
        max_seq: int = 512,
        sampler: SamplerConfig = SamplerConfig(temperature=0.0),
        seed: int = 0,
        device: DeviceLike = None,
        backend: str = "auto",
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.api: ModelApi = get_api(cfg)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.sampler = sampler
        self.backend = backend
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        # batched cache for the slot pool
        self.cache = self.api.init_cache(cfg, max_batch, max_seq, device=self.device)
        self.pool_t: int = 0                  # shared position clock
        # per-slot host state
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_generated: List[List[int]] = [[] for _ in range(max_batch)]
        self.slot_t0: np.ndarray = np.zeros(max_batch, np.float64)
        self.last_token = np.zeros((max_batch, 1), np.int32)
        self.pending: List[Request] = []
        self.completions: List[Completion] = []
        self.ticks: int = 0

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_seq:
            raise ValueError(f"prompt of {len(req.prompt)} tokens exceeds engine max_seq {self.max_seq}")
        self.pending.append(req)

    def _active(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def _free(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> None:
        free = self._free()
        if not free or not self.pending:
            return
        if not self._active():
            # wave start: the largest equal-length pending group wins
            groups: Dict[int, List[Request]] = defaultdict(list)
            for r in self.pending:
                groups[len(r.prompt)].append(r)
            length = max(groups, key=lambda k: len(groups[k]))
            batch_reqs = groups[length][: len(free)]
            self.pool_t = length
        else:
            # mid-flight: only length-aligned prompts may join
            batch_reqs = [
                r for r in self.pending if len(r.prompt) == self.pool_t
            ][: len(free)]
        if not batch_reqs:
            return
        for req in batch_reqs:
            self.pending.remove(req)
        for slot, req in zip(free, batch_reqs):
            self._insert(slot, req)

    def _insert(self, slot: int, req: Request) -> None:
        batch = {"tokens": torch.as_tensor(np.asarray(req.prompt, np.int64)[None], device=self.device)}
        for name, value in req.extras.items():
            batch[name] = torch.as_tensor(value, device=self.device)[None]
        with torch.inference_mode():
            logits, cache1 = self.api.prefill(
                self.params, batch, self.cfg, max_seq=self.max_seq, backend=self.backend
            )
            _write_slot(self.cache, cache1, slot)
        self.slot_req[slot] = req
        self.slot_generated[slot] = []
        self.slot_t0[slot] = time.perf_counter()
        # first generated token comes from the prefill logits
        tok = int(sample_logits(logits[:, -1], self._gen, self.sampler)[0])
        self._push_token(slot, tok)

    def _push_token(self, slot: int, tok: int) -> None:
        req = self.slot_req[slot]
        self.slot_generated[slot].append(tok)
        self.last_token[slot, 0] = tok
        done_eos = req.eos_id is not None and tok == req.eos_id
        done_len = len(self.slot_generated[slot]) >= req.max_new_tokens
        done_seq = self.pool_t + 1 >= self.max_seq - 1
        if done_eos or done_len or done_seq:
            self.completions.append(
                Completion(
                    rid=req.rid,
                    tokens=np.asarray(self.slot_generated[slot], np.int32),
                    prompt_len=len(req.prompt),
                    latency_s=time.perf_counter() - self.slot_t0[slot],
                    finish_reason="eos" if done_eos else "length",
                )
            )
            self.slot_req[slot] = None

    # ------------------------------------------------------------------
    # decode tick
    # ------------------------------------------------------------------

    def step(self) -> int:
        """Admit pending requests then decode one token for active slots.
        Returns the number of active slots decoded."""
        self._admit()
        active = self._active()
        if not active:
            return 0

        cache = dict(self.cache)
        cache["t"] = torch.tensor(self.pool_t, dtype=torch.int32)
        tokens = torch.as_tensor(self.last_token.astype(np.int64), device=self.device)
        with torch.inference_mode():
            logits, self.cache = self.api.decode_step(self.params, cache, {"tokens": tokens}, self.cfg)
            toks = sample_logits(logits[:, -1], self._gen, self.sampler).cpu().numpy()
        self.pool_t += 1
        self.ticks += 1
        for slot in active:
            self._push_token(slot, int(toks[slot]))
        return len(active)

    def run(self, max_ticks: int = 10_000) -> List[Completion]:
        """Drive until all submitted work completes; returns completions."""
        ticks = 0
        while (self.pending or self._active()) and ticks < max_ticks:
            self.step()
            ticks += 1
        done, self.completions = self.completions, []
        return done


def _write_slot(batch_cache: Dict[str, torch.Tensor], one_cache: Dict[str, torch.Tensor], slot: int) -> None:
    """Write a single-request cache (batch dim = 1) into slot ``slot`` of
    the batched cache, in place.  The batch axis is the first axis whose
    extent differs between the pool and the single-request cache: axis 1
    of the per-layer entries (``(L, B, ...)``: K/V, Whisper's cross K/V
    ``(L, B, Hkv, encoder_seq, hd)``, Mamba's states), axis 0 of the
    unstacked ones; scalar entries (the clock ``t``) are engine-managed
    and skipped."""
    for name, pool in batch_cache.items():
        one = one_cache[name]
        if pool.dim() == 0:  # scalar t: the engine manages it separately
            continue
        for ax in range(pool.dim()):
            if pool.shape[ax] != one.shape[ax]:
                break
        else:
            # max_batch == 1: shapes coincide, the whole cache is the slot
            if slot != 0:
                raise ValueError(f"slot {slot} of a one-slot cache")
            pool.copy_(one)
            continue
        pool.select(ax, slot).copy_(one.select(ax, 0))
