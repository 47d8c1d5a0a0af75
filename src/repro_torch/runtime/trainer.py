"""Fault-tolerant training loop (the counterpart of ``repro.runtime.trainer``).

The reference's control-plane behaviours:
  * checkpoint/restart — atomic snapshots every N steps; on (re)start the
    trainer resumes from the newest complete snapshot.
  * failure injection — ``inject_failure_at`` raises ``SimulatedFailure``
    mid-run; the caller builds a new Trainer, which resumes.
  * straggler mitigation — per-step times feed a rolling median; a step
    slower than ``straggler_factor`` x the median is recorded and the
    ``on_straggler`` callback fires.

The port's model holds its parameters: ``init_state() -> (model,
opt_state)`` and ``train_step(opt_state, batch) -> (opt_state, metrics)``
(``launch.steps.make_train_step``), run eagerly. A snapshot is
``{"params", "opt"}`` in the reference's tree layout (``models/convert.py``)
through the port's ``CheckpointStore``, so either package's Trainer resumes
from the other's snapshots. A step's time is read on ``clock`` (the host's
``time.perf_counter`` unless a test scripts it) after the loss has been
read back, which waits for the device to finish the step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from ..checkpoint import CheckpointStore
from ..models.convert import params_from_jax, params_to_jax, state_from_jax, state_to_jax


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    straggler_factor: float = 3.0
    straggler_window: int = 20
    log_every: int = 10


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    """A snapshot's ``/``-joined keys as nested dicts."""
    tree: dict = {}
    for key, arr in flat.items():
        *path, last = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = arr
    return tree


class Trainer:
    def __init__(
        self,
        train_step: Callable,  # (opt_state, batch) -> (opt_state, metrics)
        init_state: Callable,  # () -> (model, opt_state)
        data: Iterator[Dict[str, np.ndarray]],
        cfg: TrainerConfig,
        on_straggler: Optional[Callable[[int, float], None]] = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.step_fn = train_step
        self.data = data
        self.cfg = cfg
        self.store = CheckpointStore(cfg.ckpt_dir)
        self.on_straggler = on_straggler
        self.clock = clock
        self.history: List[Dict[str, float]] = []
        self.straggler_events: List[Dict[str, float]] = []

        self.model, self.opt_state = init_state()
        self.names = [name for name, _ in self.model.named_parameters()]
        self.step = 0
        latest = self.store.latest_step()
        if latest is not None:
            self.restore(latest)

    def run(self, n_steps: int, inject_failure_at: int | None = None):
        times: List[float] = []
        target = self.step + n_steps
        while self.step < target:
            batch = next(self.data)
            t0 = self.clock()
            self.opt_state, metrics = self.step_fn(self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = self.clock() - t0
            self.step += 1
            times.append(dt)

            window = times[-self.cfg.straggler_window:]
            med = float(np.median(window))
            if len(window) >= 5 and dt > self.cfg.straggler_factor * med:
                self.straggler_events.append({"step": self.step, "dt": dt, "median": med})
                if self.on_straggler:
                    self.on_straggler(self.step, dt)

            self.history.append({"step": self.step, "loss": loss, "dt": dt})

            if self.step % self.cfg.ckpt_every == 0:
                self.save()
            if inject_failure_at is not None and self.step == inject_failure_at:
                raise SimulatedFailure(f"injected failure at step {self.step}")
        return self.history

    def save(self):
        """Snapshot the trained state in the reference's layout."""
        cfg = self.model.cfg
        state = {"params": params_to_jax(cfg, self.model), "opt": state_to_jax(cfg, self.opt_state, self.names)}
        self.store.save(self.step, state, extra={"time": time.time()})

    def restore(self, step: int):
        """Load snapshot ``step`` (either package's) into the model and the
        optimizer state, on their devices."""
        flat, _ = self.store.load_raw(step)
        tree = _unflatten(flat)
        cfg = self.model.cfg
        self.model.load_state_dict(params_from_jax(cfg, tree["params"]))
        self.opt_state = state_from_jax(cfg, tree["opt"], self.opt_state, self.names)
        self.step = step
