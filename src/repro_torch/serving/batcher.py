"""Continuous batching for decode: a fixed-slot scheduler over prefill
and decode steps (port of ``repro.serving.batcher``).

Requests arrive with prompts of any length; the batcher keeps a fixed
decode batch of ``num_slots`` sequences, admits new requests into freed
slots and evicts finished ones every step:
  * a per-slot prefill (batch 1) builds the prompt's cache, which is then
    copied into the shared decode cache at the slot index (in place);
  * every step decodes all slots; a slot's ``pos`` advances only while it
    holds a request;
  * a request stops at max_new_tokens, at its eos id, or when its slot's
    cache is full.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.config import ArchConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.models.transformer import forward, grow_cache, make_cache
from repro_torch.serving.sampler import SamplerConfig, sample


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int
    eos_id: Optional[int] = None


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: List[int]
    prompt_len: int
    steps: int


def scatter_slot(cache: dict, pcache: dict, slot: int) -> dict:
    """Copy a batch-1 prefill cache into slot ``slot`` of a shared decode
    cache, in place (the slot dim is the second of every cache leaf)."""
    for g, sub in pcache.items():
        for name, one in sub.items():
            full = cache[g][name]
            full[:, slot] = one[:, 0].to(full.dtype)
    return cache


class ContinuousBatcher:
    """Fixed-slot continuous batching over one model on ``device`` (the
    parameters' device)."""

    def __init__(self, params: dict, cfg: ArchConfig, *, num_slots: int,
                 max_seq: int, sampler: SamplerConfig = SamplerConfig(
                     greedy=True), seed: int = 0,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.sampler = sampler
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.cache = make_cache(cfg, num_slots, max_seq, device=self.device)
        self.pos = np.zeros(num_slots, np.int64)      # next write position
        self.active: List[Optional[Request]] = [None] * num_slots
        self.generated: Dict[int, List[int]] = {}
        self.steps_taken: Dict[int, int] = {}
        self.last_token = np.zeros(num_slots, np.int64)
        self.pending: List[Request] = []
        self.done: List[Completion] = []

    # -- admission -----------------------------------------------------

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _admit(self) -> None:
        for slot in range(self.num_slots):
            if self.active[slot] is not None or not self.pending:
                continue
            req = self.pending.pop(0)
            self._prefill_into_slot(slot, req)

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                 device=self.device)
        logits, _, pcache = forward(self.params, self.cfg, prompt,
                                    build_cache=True)
        pcache = grow_cache(pcache, self.max_seq,
                            window=self.cfg.sliding_window)
        scatter_slot(self.cache, pcache, slot)
        first = int(torch.argmax(logits[0, -1]))
        self.active[slot] = req
        self.pos[slot] = len(req.prompt)
        self.last_token[slot] = first
        self.generated[req.request_id] = [first]
        self.steps_taken[req.request_id] = 1

    # -- decode loop -----------------------------------------------------

    def _evict_finished(self) -> None:
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            gen = self.generated[req.request_id]
            hit_eos = req.eos_id is not None and gen and gen[-1] == req.eos_id
            full = self.pos[slot] >= self.max_seq - 1
            if len(gen) >= req.max_new_tokens or hit_eos or full:
                self.done.append(Completion(
                    req.request_id, gen, len(req.prompt),
                    self.steps_taken[req.request_id]))
                self.active[slot] = None

    def _decode(self, tokens: torch.Tensor, pos: torch.Tensor
                ) -> torch.Tensor:
        logits, _, self.cache = forward(self.params, self.cfg, tokens,
                                        cache=self.cache, decode_pos=pos)
        return sample(logits[:, 0], self.generator, self.sampler)

    def step(self) -> int:
        """Admit + one decode step for all active slots. Returns the
        number of active sequences stepped."""
        self._admit()
        self._evict_finished()  # prefill may already satisfy eos/max_new
        live = [s for s in range(self.num_slots)
                if self.active[s] is not None]
        if not live:
            return 0
        tokens = torch.as_tensor(self.last_token[:, None],
                                 device=self.device)
        pos = torch.as_tensor(self.pos.astype(np.int32), device=self.device)
        nxt = self._decode(tokens, pos).cpu().numpy()
        for slot in live:
            req = self.active[slot]
            self.generated[req.request_id].append(int(nxt[slot]))
            self.steps_taken[req.request_id] += 1
            self.pos[slot] += 1
            self.last_token[slot] = int(nxt[slot])
        self._evict_finished()
        return len(live)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Completion]:
        steps = 0
        while (self.pending or any(a is not None for a in self.active)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.done
