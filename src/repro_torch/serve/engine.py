"""Batched LM serving engine: continuous batching over a fixed-slot KV cache
(counterpart of ``repro.serve.engine``).

  * fixed ``n_slots`` decode slots, each holding one request's KV state
    inside a shared [L, slots, max_len, Hkv, D] cache;
  * admission: new requests prefill into a free slot;
  * every engine step decodes ONE token for ALL slots (continuous batching:
    finished requests retire immediately and their slot is reusable on the
    next step);
  * deterministic greedy sampling (argmax); the sampler is a pluggable
    fn(logits) -> token.

The reference vmaps a B=1 decode over the slot dimension.  Here the slots
are one batch of ``decode_step``, each row at its own ``cur_len`` (its own
mask and RoPE position), which gives what a per-slot decode gives.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.graph.edgelist import Device, resolve_device
from repro_torch.models.transformer import TransformerConfig, decode_step, prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # int32[P]
    max_new: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False  # shed at admission (bounded queue full)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


class ServeEngine:
    """``params`` live on ``device`` (default: the card; ``device='cpu'``
    must be asked for), where the engine keeps its cache."""

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        n_slots: int = 4,
        max_len: int = 256,
        sampler: Optional[Callable] = None,
        max_queue: Optional[int] = None,
        device: Device = None,
    ):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        # Rolling caches must match the prefill buffer layout exactly (slot
        # s holds position p with p % window == s).
        self.max_len = max_len if cfg.window is None else cfg.window
        self.sampler = sampler or greedy
        shape = (cfg.n_layers, n_slots, self.max_len, cfg.n_kv_heads, cfg.d_head)
        self.cache = {
            "k": torch.zeros(shape, dtype=torch.bfloat16, device=self.device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=self.device),
        }
        self.cur_len = np.zeros(n_slots, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: Deque[Request] = collections.deque()
        self.max_queue = max_queue
        self.rejected = 0  # requests shed at admission

    # --- public API ---

    def submit(self, req: Request) -> bool:
        """Enqueues ``req``; with ``max_queue`` set, a full queue SHEDS the
        request instead of queueing unboundedly: ``req.rejected`` is set and
        False returned."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.rejected = True
            self.rejected += 1
            return False
        self.queue.append(req)
        return True

    def step(self) -> List[Request]:
        """Admit + decode one token for all active slots; returns finished."""
        self._admit()
        finished = []
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if active:
            self._decode_active(active)
            for i in active:
                r = self.slot_req[i]
                tok = r.tokens[-1]
                if (r.eos_id is not None and tok == r.eos_id) or len(r.tokens) >= r.max_new:
                    r.done = True
                    finished.append(r)
                    self.slot_req[i] = None
        return finished

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.queue and all(r is None for r in self.slot_req):
                break
        return out

    # --- internals ---

    def _admit(self):
        for i in range(self.n_slots):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.popleft()
                self._prefill_into(i, req)
                self.slot_req[i] = req

    def _prefill_into(self, slot: int, req: Request):
        p = len(req.prompt)
        if self.cfg.window is None and p + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {p} + max_new {req.max_new} "
                f"exceeds cache {self.max_len}"
            )
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                 device=self.device)[None]
        logits, cache, _ = prefill(self.params, self.cfg, tokens)
        keep = min(p, self.max_len)
        # Copy the request's prefill cache into the shared slot.
        for key in ("k", "v"):
            self.cache[key][:, slot, :keep] = cache[key][:, 0, :keep]
        self.cur_len[slot] = p
        req.tokens.append(int(self.sampler(logits)[0]))

    def _decode_active(self, active: List[int]):
        """Every slot decodes (the idle ones too, as in the reference), each
        at its own length."""
        toks = np.zeros((self.n_slots, 1), np.int64)
        for i in active:
            toks[i, 0] = self.slot_req[i].tokens[-1]
        cur = torch.as_tensor(self.cur_len, device=self.device)
        logits, self.cache, _ = decode_step(
            self.params, self.cfg, self.cache, torch.as_tensor(toks, device=self.device), cur
        )
        nxt = self.sampler(logits).cpu().numpy()
        for i in active:
            self.slot_req[i].tokens.append(int(nxt[i]))
            self.cur_len[i] += 1
