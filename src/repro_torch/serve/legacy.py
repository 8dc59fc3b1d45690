"""The serving engine from before the device-resident hot path, kept as
the plain baseline and the greedy equivalence oracle of
:class:`repro_torch.serve.ServeEngine`.  Port of ``repro.serve.legacy``,
with the reference's deliberate costs, which ``ServeEngine`` removes:

  * one prefill per request, at the request's own prompt length (no pad
    buckets, no batching of admissions);
  * every decode step takes the whole (slots, vocab) logits to the host
    and samples there (numpy, from ``np.random.default_rng(seed)``);
  * the decode state is copied every step (the reference's step returns
    a new state, no donation), and each admission copies the whole state
    to set one slot (the reference's ``at[:, slot].set``).

Runs on ``cuda`` unless ``device`` says otherwise; its prefills run the
model's prefill, so on a card every attention layer launches the
flash-attention forward kernel K1 (and every SSD layer the scan K4) once
a request.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import decode_step, init_decode_state, prefill
from repro_torch.serve.engine import Request, validate_request


class LegacyServeEngine:
    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 cache_len: int = 256, greedy: bool = True, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.greedy = greedy
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

        self.state = init_decode_state(cfg, slots, cache_len,
                                       device=self.device)
        self.positions = np.zeros(slots, np.int64)   # next position to write
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.last_token = np.zeros(slots, np.int64)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        # the same input contract as the engine under test (the oracle
        # must see the same trace it accepted)
        validate_request(req, self.cache_len)
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            plen = len(req.prompt)
            toks = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :],
                                   device=self.device)
            logits, st = prefill(self.params, self.cfg, {"tokens": toks},
                                 cache_len=self.cache_len)
            # the whole state copied, this request's row-0 state set in
            # its slot
            state = {k: v.clone() for k, v in self.state.items()}
            for name, t in state.items():
                t[:, slot] = st[name][:, 0]
            self.state = state
            tok = self._pick(logits.float().cpu().numpy()[0])
            self.active[slot] = req
            req.generated.append(int(tok))
            self.positions[slot] = plen
            self.last_token[slot] = tok

    def _pick(self, logits: np.ndarray) -> int:
        if self.greedy:
            return int(np.argmax(logits))
        p = np.exp(logits - logits.max())
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    # ------------------------------------------------------------------
    def step(self):
        """One decode step across all active slots."""
        self._admit()
        if not any(r is not None for r in self.active):
            return
        toks = torch.as_tensor(self.last_token.astype(np.int32)[:, None],
                               device=self.device)
        pos = torch.as_tensor(self.positions.astype(np.int32),
                              device=self.device)
        # a step on a copy of the state (the reference's functional step)
        state = {k: v.clone() for k, v in self.state.items()}
        logits, self.state = decode_step(self.params, self.cfg, state, toks,
                                         pos)
        logits = logits.float().cpu().numpy()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = self._pick(logits[slot])
            req.generated.append(tok)
            self.positions[slot] += 1
            self.last_token[slot] = tok
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.generated) >= req.max_tokens
                    or self.positions[slot] >= self.cache_len - 1):
                req.done = True
                self.completed.append(req)
                self.active[slot] = None

    def run(self, max_steps: int = 1000) -> List[Request]:
        for _ in range(max_steps):
            self.step()
            if not self.queue and all(r is None for r in self.active):
                break
        return self.completed
