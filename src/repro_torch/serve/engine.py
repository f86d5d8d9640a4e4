"""Batched LM serving: a fixed-slot continuous-batching decode server.

A slot pool of B sequences shares one stacked KV cache on the device;
requests are prefilled into free slots (prompt tokens decoded one per
step through the same decode step — exactness over throughput) and
finished slots are recycled while other slots keep decoding.

The server casts the parameters to their bf16 compute copy once, at
construction (``transformer.compute_copy``), where the reference casts
each layer on every step; the cast is deterministic, so the steps read
the same bytes.  It keeps only that copy.  Each step sends the [B]
tokens and positions to the device and reads back only the [B] argmax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.dist.cluster import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import tree_map


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeServer:
    """Greedy decoding (the reference's ``greedy`` flag selects nothing and
    is not kept)."""

    def __init__(self, params, cfg: T.LMConfig, batch_slots: int,
                 max_len: int, device="cuda"):
        self.device = resolve_device(device)
        self.params = T.compute_copy(
            tree_map(lambda a: a.to(self.device), params))
        self.cfg = cfg
        self.B = batch_slots
        self.max_len = max_len
        self.cache = T.init_cache(T.cache_spec(cfg, batch_slots, max_len),
                                  self.device)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int64)  # next position
        self.slot_pending: list[list[int]] = [[] for _ in range(batch_slots)]

    # ------------------------------------------------------------ requests
    def add(self, req: Request) -> bool:
        for s in range(self.B):
            if self.slot_req[s] is None:
                self.slot_req[s] = req
                self.slot_pos[s] = 0
                self.slot_pending[s] = list(req.prompt)
                return True
        return False  # no free slot; caller queues

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    # ---------------------------------------------------------------- step
    def step(self):
        """One global decode step: every active slot consumes one token
        (prompt token while prefilling, else its previously generated
        token) and produces the next."""
        tokens = np.zeros((self.B, 1), np.int64)
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self.slot_pending[s]:
                tokens[s, 0] = self.slot_pending[s][0]
            elif req.out:
                tokens[s, 0] = req.out[-1]
        logits, self.cache = T.lm_decode_step(
            self.params, self.cache, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.slot_pos).to(self.device), self.cfg,
        )
        nxt = logits.argmax(dim=-1).cpu().numpy()
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.slot_pos[s] += 1
            if self.slot_pending[s]:
                self.slot_pending[s].pop(0)
                if self.slot_pending[s]:
                    continue  # still prefilling
            req.out.append(int(nxt[s]))
            if len(req.out) >= req.max_new or self.slot_pos[s] >= self.max_len - 1:
                req.done = True
                self.slot_req[s] = None  # recycle slot

    def run(self, requests: list[Request], max_steps: int = 10_000):
        queue = list(requests)
        done = []
        steps = 0
        while (queue or self.active) and steps < max_steps:
            while queue and self.add(queue[0]):
                queue.pop(0)
            self.step()
            steps += 1
            done = [r for r in requests if r.done]
        return done, steps
