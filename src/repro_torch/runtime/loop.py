"""Fault-tolerant training loop, the port's copy of ``repro.runtime.loop``.

* **restart-from-latest**: the loop begins by probing the checkpoint
  directory; a committed step resumes bit-exactly (the data order is a pure
  function of the step — :mod:`repro_torch.data.pipeline`).
* **preemption handling**: SIGTERM/SIGINT set a flag; the loop finishes the
  step in flight, writes a synchronous checkpoint, and exits cleanly.
* **straggler watchdog**: per-step wall times feed a rolling window; a step
  slower than ``straggler_factor`` x the window's median is counted and
  logged.
* **async checkpointing** every ``ckpt_every`` steps off the critical path.

The step's sync point is ``float(loss)``: the host reads the loss, so the
step's device work has finished when its wall time is taken.
"""

from __future__ import annotations

import os
import signal
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.checkpoint import ckpt as ckpt_lib


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_ckpts: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 32
    log_every: int = 10


@dataclass
class LoopStats:
    steps_run: int = 0
    resumed_from: int | None = None
    straggler_steps: int = 0
    preempted: bool = False
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)


class TrainLoop:
    """Runs ``train_step(state, batch_fn(step))`` from the latest committed
    step (or the state's own) to ``cfg.total_steps``. ``abstract_state``
    (the state's tree as ``meta`` tensors) enables the resume; a restored
    state is placed on ``device``, by default the device of the state's
    step counter. ``shardings`` (a tree of ``NamedSharding`` matching
    the state) restores a mesh run's state as DTensor shards; under a mesh
    every rank runs the loop, and rank 0 alone writes and prunes the
    checkpoints."""

    def __init__(self, train_step, state, batch_fn, cfg: LoopConfig,
                 abstract_state=None, device=None, install_signals=True,
                 shardings=None):
        self.train_step = train_step
        self.state = state
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.abstract_state = abstract_state
        self.device = device if device is not None else state["step"].device
        self.shardings = shardings
        self.stats = LoopStats()
        self._stop = False
        self.ckpt = ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir)
        if install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    signal.signal(sig, self._on_preempt)
                except ValueError:
                    pass  # not on the main thread (tests)

    def _on_preempt(self, signum, frame):
        self._stop = True
        self.stats.preempted = True

    def maybe_resume(self) -> int:
        step = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if step is not None and self.abstract_state is not None:
            self.state, step = ckpt_lib.restore(
                self.cfg.ckpt_dir, self.abstract_state, step, device=self.device,
                shardings=self.shardings)
            self.stats.resumed_from = step
            return step
        return int(self.state["step"])

    def run(self, log=print) -> LoopStats:
        step = self.maybe_resume()
        window: deque[float] = deque(maxlen=self.cfg.straggler_window)
        while step < self.cfg.total_steps and not self._stop:
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            loss = float(metrics["loss"])  # sync point
            dt = time.perf_counter() - t0
            if window and dt > self.cfg.straggler_factor * float(np.median(window)):
                self.stats.straggler_steps += 1
                log(f"[watchdog] step {step}: {dt:.3f}s vs median "
                    f"{float(np.median(window)):.3f}s — straggler suspected")
            window.append(dt)
            self.stats.losses.append(loss)
            self.stats.step_times.append(dt)
            self.stats.steps_run += 1
            step += 1
            if step % self.cfg.log_every == 0:
                log(f"step {step}: loss={loss:.4f} ({dt*1e3:.0f} ms)")
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save(self.state, step)
                if ckpt_lib.is_writer(self.state):
                    ckpt_lib.gc(self.cfg.ckpt_dir, self.cfg.keep_ckpts)
        if self._stop:
            # preemption: synchronous final save so no work is lost
            self.ckpt.wait()
            ckpt_lib.save(self.state, step, self.cfg.ckpt_dir)
            log(f"[preempt] saved step {step} and exiting")
        self.ckpt.wait()
        return self.stats
