"""Fault tolerance: checkpoint/restart and failure injection.

Port of ``repro.training.fault_tolerance``: ``FailureInjector``,
``TrainRunResult`` and ``run_training``, the fail-stop loop.  Any exception
from a step (a device fault, an injected failure) restores ``LATEST`` and
replays from there, up to ``max_restarts`` times; with no checkpoint it
starts fresh.  The data is a pure function of the step index
(``repro_torch.data.Loader.batch_for_step``), so a replay reads the same
batches.  Under a mesh every rank runs the loop: ``shardings``
(``train_loop.state_shardings``) lay out a restored state, and
``elastic_restore`` restores a checkpoint onto another mesh than the one
that wrote it.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Optional

from repro_torch.training import checkpoint as ckpt

__all__ = ["FailureInjector", "TrainRunResult", "elastic_restore",
           "run_training"]

log = logging.getLogger(__name__)


class FailureInjector:
    """Deterministically raise at given step numbers (tests and drills),
    once each."""

    def __init__(self, fail_at=(), exc=RuntimeError):
        self.fail_at = set(fail_at)
        self.exc = exc
        self.tripped = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.tripped:
            self.tripped.add(step)
            raise self.exc(f"injected failure at step {step}")


@dataclasses.dataclass
class TrainRunResult:
    state: Any
    step: int
    metrics_history: list
    restarts: int


def run_training(
    train_step: Callable,            # (state, batch) -> (state, metrics)
    init_state: Callable,            # () -> state (fresh start)
    batch_for_step: Callable,        # (step) -> batch  (pure => resumable)
    n_steps: int,
    *,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    keep: int = 3,
    max_restarts: int = 3,
    failure_injector: Optional[FailureInjector] = None,
    on_metrics: Optional[Callable] = None,
    shardings: Any = None,
) -> TrainRunResult:
    """The fault-tolerant step loop: run, checkpoint, crash, restore,
    resume.  Each step's metrics are read back as floats (a host sync a
    step) into the history; ``on_metrics(step, metrics)`` sees them after
    each step.  Ends with a checkpoint of the last step when ``ckpt_dir``
    is set.  ``shardings`` go to every restore."""
    restarts = 0
    history = []

    def fresh():
        return init_state(), 0

    state, step = fresh()
    if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
        state, step, _ = ckpt.restore_checkpoint(ckpt_dir, state,
                                                 shardings=shardings)

    while step < n_steps:
        try:
            if failure_injector is not None:
                failure_injector.maybe_fail(step)
            batch = batch_for_step(step)
            state, metrics = train_step(state, batch)
            step += 1
            history.append({k: float(v) for k, v in metrics.items()})
            if on_metrics:
                on_metrics(step, history[-1])
            if ckpt_dir is not None and step % ckpt_every == 0:
                ckpt.save_checkpoint(ckpt_dir, step, state, keep=keep)
        except Exception:
            log.exception("step %d failed (restart %d)", step, restarts + 1)
            restarts += 1
            if restarts > max_restarts:
                raise
            if ckpt_dir is None or ckpt.latest_step(ckpt_dir) is None:
                state = None            # free it before the fresh one is made
                state, step = fresh()
            else:
                state, step, _ = ckpt.restore_checkpoint(
                    ckpt_dir, state, shardings=shardings)
    if ckpt_dir is not None:
        ckpt.save_checkpoint(ckpt_dir, step, state, keep=keep)
    return TrainRunResult(state=state, step=step, metrics_history=history,
                          restarts=restarts)


def elastic_restore(ckpt_dir, template, make_shardings: Callable,
                    mesh) -> Any:
    """Restore a checkpoint onto a *different* mesh: shardings are computed
    for the new mesh (``make_shardings(mesh)``) and every leaf is cut to
    this rank's slice there.  Returns (state, step, extra)."""
    return ckpt.restore_checkpoint(ckpt_dir, template,
                                   shardings=make_shardings(mesh))
