"""Deterministic, resumable input pipelines (counterpart of
``repro.data.pipeline``).

Every pipeline keys batch generation off (seed, step), not off mutable
iterator state, so a restart at step k reproduces the batch stream from
step k exactly (a checkpoint stores only the integer cursor), and any
worker can regenerate any batch.  The numbers are numpy's, drawn as the
reference draws them, so both packages see the same tokens bit for bit;
the batch's tensors are then put on the stream's device (default: the
card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.graph.edgelist import Device, resolve_device


@dataclasses.dataclass
class SyntheticStream:
    """Resumable iterator over ``make_fn(rng, step)`` batches, the rng
    seeded by ``(seed << 20) ^ step``."""

    make_fn: Callable[[np.random.Generator, int], Any]
    seed: int = 0
    step: int = 0

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        rng = np.random.default_rng((self.seed << 20) ^ self.step)
        batch = self.make_fn(rng, self.step)
        self.step += 1
        return batch

    def checkpoint_state(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: Dict[str, int]):
        self.seed = int(state["seed"])
        self.step = int(state["step"])


def lm_token_stream(vocab: int, batch: int, seq: int, seed: int = 0,
                    device: Device = None) -> SyntheticStream:
    """Deterministic Zipfian token stream (power-law unigram, exponent 1.1,
    like text): ``{"tokens", "labels"}`` int32 ``[batch, seq]`` on
    ``device`` (default: the card), labels the tokens shifted by one."""
    dev = resolve_device(device)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    cum = np.cumsum(probs)

    def make(rng: np.random.Generator, step: int):
        u = rng.random((batch, seq + 1))
        toks = np.searchsorted(cum, u).astype(np.int32)
        return {
            "tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev),
        }

    return SyntheticStream(make, seed=seed)


def recsys_stream(cfg, batch: int, seed: int = 0, device: Device = None) -> SyntheticStream:
    """``recsys_train_batch(rng, cfg, batch)`` per step, on ``device``
    (default: the card)."""
    from repro_torch.data.synthetic import recsys_train_batch

    dev = resolve_device(device)

    def make(rng, step):
        return recsys_train_batch(rng, cfg, batch, dev)

    return SyntheticStream(make, seed=seed)
