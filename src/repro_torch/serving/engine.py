"""Serving engine: fixed-slot continuous batching over the model's decode
step, with BaM paged-KV spill and fetch between steps.

Port of ``repro.serving.engine``.  The engine owns ``B`` sequence slots.
Each step:

  1. admit queued requests into free slots (prefill through the decode
     path, one token at a time, exact, as the reference);
  2. ``ensure_resident``: fetch every spilled page back before decode;
  3. one ``decode_step`` for the whole batch;
  4. greedy sampling, retire finished sequences (their slot's cache goes
     back to its initial state);
  5. every 16 steps, ``maybe_spill`` cold pages to the storage tier.

Greedy sampling takes the argmax on the device and moves B token ids to
the host; the reference moves the logits and takes it there.  Both give
the first maximal index.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import ModelApi, build_model
from repro_torch.serving.kv_cache import PagedKVManager

__all__ = ["ServeEngine", "Request"]

SPILL_EVERY = 16                    # engine steps between spills


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0
    pending_prompt: List[int] = dataclasses.field(default_factory=list)


def _leaves(tree):
    """Tensor leaves of a cache (dicts, tuples and tagged entries)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "value"):
        yield from _leaves(tree.value)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, model, *, batch_slots: int = 4,
                 max_seq: int = 512, kv_manager: PagedKVManager | None = None,
                 device=None):
        self.cfg = cfg
        self.api: ModelApi = build_model(cfg, device)
        self.model = model
        self.B = batch_slots
        self.max_seq = max_seq
        self.kv = kv_manager
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: List[Request] = []
        self.cache = self.api.init_decode_cache(batch_slots, max_seq)
        # one slot's initial cache, for per-slot resets (the reference
        # snapshots the whole batch; a single slot is enough and B times
        # smaller at full size)
        self._slot0 = self.api.init_decode_cache(1, max_seq)
        self.n_steps = 0

    # ------------------------------------------------------------- admin --
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in self.slots:
            if slot.req is None and self.queue:
                req = self.queue.pop(0)
                slot.req = req
                slot.pos = 0
                slot.pending_prompt = list(req.prompt)

    def _reset_slot_cache(self, b: int):
        """Restore slot b to the initial cache state: every batch-first leaf
        (pools, page table, seq_lens) gets the initial row, in place."""
        for cur, init in zip(_leaves(self.cache), _leaves(self._slot0)):
            if cur.dim() >= 1 and cur.shape[0] == self.B:
                cur[b] = init[0]

    # -------------------------------------------------------------- step --
    def step(self) -> int:
        """One engine step; returns the number of active slots."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s.req is not None]
        if not active:
            return 0
        if self.kv is not None:
            self.cache, _ = self.kv.ensure_resident(self.cache)

        tokens = [0] * self.B
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            if slot.pending_prompt:
                tokens[i] = slot.pending_prompt.pop(0)   # prefill token
            elif slot.req.out:
                tokens[i] = slot.req.out[-1]
            else:
                tokens[i] = slot.req.prompt[-1]
        logits, self.cache = self.api.decode_step(
            self.model, self.cache,
            torch.tensor(tokens, dtype=torch.int32, device=self.api.device))
        self.n_steps += 1
        next_tok = logits.argmax(dim=-1).tolist()
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            slot.pos += 1
            if slot.pending_prompt:
                continue                                # still prefilling
            slot.req.out.append(int(next_tok[i]))
            if len(slot.req.out) >= slot.req.max_new_tokens \
                    or slot.pos >= self.max_seq - 1:
                slot.req.done = True
                slot.req = None
                self._reset_slot_cache(i)
        if self.kv is not None and self.n_steps % SPILL_EVERY == 0:
            self.cache, _ = self.kv.maybe_spill(self.cache)
        return len(active)

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(s.req is None for s in self.slots):
                break
            self.step()
