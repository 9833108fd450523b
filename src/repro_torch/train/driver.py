"""Fault-tolerant training driver: checkpoint/restart, failure injection,
straggler mitigation.

The port of `repro.train.driver`. The driver owns the loop: data pipeline
-> train_step -> periodic atomic checkpoint. Failures (real or injected)
abort the process state; `TrainDriver.resume()` restores the latest
complete checkpoint — params, optimizer state, data cursor and step — and
continues bit-identically (tests/test_torch_fault_tolerance.py proves
equality against an uninterrupted run).

Straggler mitigation (single-process simulation of the fleet policy): the
driver tracks a robust step-time estimate; steps slower than
`straggler_factor` x median are logged and counted, and the configured
callback fires (on a real fleet: re-shard away from / hot-swap the slow
host; here: the hook + accounting, unit-tested).

The batch goes to `device` (the card unless the caller names one), and
the step time includes reading the loss back, so it is the device's time.
"""
from __future__ import annotations

import dataclasses
import pathlib
import shutil
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core import resolve_device
from .checkpoint import latest_step, load_checkpoint, save_checkpoint

__all__ = ["DriverConfig", "TrainDriver", "FailureInjector"]


@dataclasses.dataclass
class DriverConfig:
    checkpoint_dir: str
    checkpoint_every: int = 50
    max_steps: int = 200
    straggler_factor: float = 3.0
    keep_checkpoints: int = 3


class FailureInjector:
    """Deterministic failure schedule for tests: raises at given steps."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class TrainDriver:
    def __init__(self, cfg: DriverConfig, train_step: Callable,
                 params, opt_state, pipeline,
                 failure: Optional[FailureInjector] = None,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 device=None):
        self.cfg = cfg
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.failure = failure
        self.on_straggler = on_straggler
        self.device = resolve_device(device)
        self.step = 0
        self.losses: list[float] = []
        self.step_times: list[float] = []
        self.straggler_steps: list[int] = []

    # ------------------------------------------------------------------
    def _checkpoint(self):
        save_checkpoint(self.cfg.checkpoint_dir, self.step,
                        {"params": self.params, "opt": self.opt_state},
                        extra={"pipeline": self.pipeline.state(),
                               "losses": self.losses[-5:]})
        # retention
        d = pathlib.Path(self.cfg.checkpoint_dir)
        steps = sorted(int(p.name[5:]) for p in d.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        for s in steps[:-self.cfg.keep_checkpoints]:
            shutil.rmtree(d / f"step_{s:08d}")

    def resume(self) -> bool:
        """Restore the latest complete checkpoint. True if one was found."""
        s = latest_step(self.cfg.checkpoint_dir)
        if s is None:
            return False
        tree, extra = load_checkpoint(
            self.cfg.checkpoint_dir, s,
            {"params": self.params, "opt": self.opt_state},
            device=self.device)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.pipeline.restore(extra["pipeline"])
        self.step = s
        return True

    # ------------------------------------------------------------------
    def run(self) -> dict:
        while self.step < self.cfg.max_steps:
            if self.failure is not None:
                self.failure.maybe_fail(self.step)
            batch = self.pipeline.next_batch()
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch.items()}
            # perf_counter: monotonic — wall-clock (NTP) skew would corrupt
            # the straggler detector's step-time medians
            t0 = time.perf_counter()
            loss, self.params, self.opt_state = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(loss)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-20:]))
            if len(self.step_times) > 5 and dt > self.cfg.straggler_factor * med:
                self.straggler_steps.append(self.step)
                if self.on_straggler:
                    self.on_straggler(self.step, dt / med)
            self.losses.append(loss)
            self.step += 1
            if self.step % self.cfg.checkpoint_every == 0:
                self._checkpoint()
        self._checkpoint()
        return {"final_loss": self.losses[-1] if self.losses else None,
                "steps": self.step, "stragglers": self.straggler_steps}
