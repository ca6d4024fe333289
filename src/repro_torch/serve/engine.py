"""Batched serving engine: slot-based continuous batching (port of
``repro.serve.engine``).

A fixed pool of slots serves the queue in waves: free slots are filled by
prefilling one request at a time, then every active slot decodes one token
per round until it reaches its token budget or its EOS, which frees the
slot.  Each slot keeps its own cache; the greedy pick is the first argmax
over the real vocabulary (``[:vocab_size]``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # int32 [len]
    max_new_tokens: int = 32
    eos_id: int = -1             # -1: never
    # filled by the engine:
    output: Optional[list] = None
    done: bool = False


class ServeEngine:
    """model: models.api.Model; decode batch = number of slots."""

    def __init__(self, model, params, *, n_slots: int = 4,
                 max_seq: int = 256):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq

    def run(self, requests: List[Request]) -> List[Request]:
        """Processes all requests to completion; returns them with
        ``output`` filled."""
        pending = list(requests)
        for r in pending:
            r.output = []
        active: List[Request] = []
        caches = [None] * self.n_slots
        tokens = np.zeros((self.n_slots, 1), np.int32)
        remaining = np.zeros(self.n_slots, np.int32)

        while pending or active:
            # fill free slots, prefilling one request at a time
            while pending and len(active) < self.n_slots:
                req = pending.pop(0)
                slot = len(active)
                logits, cache = self.model.prefill(
                    self.params, {"tokens": req.prompt[None]},
                    max_seq=self.max_seq)
                tok = int(self._pick(logits[:, -1])[0])
                req.output.append(tok)
                caches[slot] = cache
                tokens[slot, 0] = tok
                remaining[slot] = req.max_new_tokens - 1
                active.append(req)

            if not active:
                break
            # lockstep decode across the active slots, one slot at a time
            for slot, req in list(enumerate(active)):
                logits, caches[slot] = self.model.decode_step(
                    self.params, tokens[slot: slot + 1], caches[slot])
                tok = int(self._pick(logits[:, -1])[0])
                req.output.append(tok)
                tokens[slot, 0] = tok
                remaining[slot] -= 1
                if remaining[slot] <= 0 or tok == req.eos_id:
                    req.done = True
            # compact finished slots
            keep = [i for i, r in enumerate(active) if not r.done]
            active = [active[i] for i in keep]
            caches = [caches[i] for i in keep] + \
                [None] * (self.n_slots - len(keep))
            tokens = np.concatenate(
                [tokens[keep], np.zeros((self.n_slots - len(keep), 1),
                                        np.int32)])
            remaining = np.concatenate(
                [remaining[keep],
                 np.zeros(self.n_slots - len(keep), np.int32)])
        return requests

    def _pick(self, logits: torch.Tensor) -> np.ndarray:
        v = self.model.cfg.vocab_size
        return torch.argmax(logits[..., :v], dim=-1).to(
            torch.int32).cpu().numpy()
