"""Fault-tolerant training loop (counterpart of ``repro.train.trainer``).

  * checkpoint/restart: restores the latest complete checkpoint (the state,
    the data cursor) and continues at the step it stored; the data
    pipeline's cursor is part of the checkpoint, so a restart re-reads no
    batch twice;
  * preemption: SIGTERM/SIGINT trigger a final synchronous save before the
    loop returns;
  * step watchdog: a wall-clock budget per step; a step over it is
    checkpointed and raises :class:`StepTimeout`, so a scheduler can
    restart from the checkpoint;
  * metrics: loss, grad norm and step time appended to a JSONL log.

A step's scalar metrics are read to the host after it (that read is the
step's end for the watchdog).  Checkpoints store the NEXT step to run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager, restore_latest


class StepTimeout(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    step_timeout_s: Optional[float] = None  # watchdog budget
    metrics_path: Optional[str] = None


class Trainer:
    """Drives ``state, metrics = step_fn(state, batch)`` with restart safety.

    ``state`` is any tree of tensors (params and optimizer state); ``data``
    has ``__next__`` and, to be resumable, ``checkpoint_state() -> dict``
    and ``restore(dict)``.
    """

    def __init__(self, cfg: TrainerConfig, step_fn: Callable[[Any, Any], tuple],
                 init_state: Any, data: Iterator):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = init_state
        self.data = data
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.step = 0
        self._preempted = False
        self.metrics_log: list = []

    # ---- fault-tolerance hooks ----

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread (tests)

    def try_restore(self) -> bool:
        state, meta, step = restore_latest(self.cfg.ckpt_dir, self.state)
        if step < 0:
            return False
        self.state = state
        # Checkpoints store the NEXT step to execute (uniform for mid-run,
        # watchdog, preemption and final saves).
        self.step = int(meta.get("step", step))
        if meta.get("data") is not None and hasattr(self.data, "restore"):
            self.data.restore(meta["data"])
        return True

    def _metadata(self) -> Dict[str, Any]:
        data_state = (self.data.checkpoint_state()
                      if hasattr(self.data, "checkpoint_state") else None)
        return {"step": self.step, "data": data_state}  # step == next step

    def save(self, sync: bool = True):
        if sync:
            self.ckpt.save(self.step, self.state, self._metadata())
        else:
            self.ckpt.save_async(self.step, self.state, self._metadata())

    # ---- main loop ----

    def run(self) -> Dict[str, Any]:
        self._install_signal_handlers()
        cfg = self.cfg
        t_start = time.time()
        last_metrics: Dict[str, Any] = {}
        while self.step < cfg.total_steps:
            if self._preempted:
                self.ckpt.join()
                self.save(sync=True)
                return {"status": "preempted", "step": self.step, **last_metrics}
            batch = next(self.data)
            t0 = time.time()
            out = self.step_fn(self.state, batch)
            self.state, metrics = out[0], out[1]
            # The host read of the scalars ends the step for the watchdog.
            metrics = {k: float(v) for k, v in metrics.items()
                       if isinstance(v, torch.Tensor) and v.dim() == 0}
            dt = time.time() - t0
            metrics["step_time_s"] = dt
            last_metrics = metrics
            executed = self.step
            self.step += 1  # from here on, self.step == next step to run
            if cfg.step_timeout_s is not None and dt > cfg.step_timeout_s:
                # A hung or straggling step: checkpoint and abort so the
                # scheduler can reschedule (restartability over retry).
                self.ckpt.join()
                self.save(sync=True)
                raise StepTimeout(f"step {executed} took {dt:.1f}s")
            if cfg.metrics_path and executed % cfg.log_every == 0:
                os.makedirs(os.path.dirname(cfg.metrics_path) or ".", exist_ok=True)
                # repro: allow(atomic-io) append-only JSONL metrics log; readers tolerate a torn final line
                with open(cfg.metrics_path, "a") as f:
                    f.write(json.dumps({"step": executed, **metrics}) + "\n")
            self.metrics_log.append({"step": executed, **metrics})
            if cfg.ckpt_every and self.step % cfg.ckpt_every == 0:
                self.save(sync=False)
        self.ckpt.join()
        self.save(sync=True)
        return {"status": "done", "step": self.step, "wall_s": time.time() - t_start,
                **last_metrics}
