"""Training loop: data -> step -> periodic checkpoint.

Port of `walkai_nos_tpu/models/trainer.py`: initialize (or restore) the
TrainState, iterate prefetched batches through the step, checkpoint on
an interval (the write overlaps subsequent steps), and always cut a final
synchronous checkpoint so a rescheduled job resumes exactly where this
one stopped. The profile window uses `torch.profiler` where the JAX loop
uses `jax.profiler`.
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import torch

from walkai_nos_tpu_torch.models.checkpoint import CheckpointManager
from walkai_nos_tpu_torch.models.train import TrainState

__all__ = ["FitResult", "evaluate", "fit"]

logger = logging.getLogger(__name__)


@dataclass
class FitResult:
    state: TrainState
    losses: list[float] = field(default_factory=list)
    steps_run: int = 0
    resumed_from: int | None = None
    # (step, mean val loss) pairs when fit() ran with an eval_fn.
    eval_losses: list[tuple[int, float]] = field(default_factory=list)


def evaluate(
    state: TrainState,
    loss_fn: Callable[[object, object], torch.Tensor],
    batches: Iterator,
    *,
    max_batches: int | None = None,
) -> float:
    """Mean loss of `loss_fn(params, batch)` over `batches`, without
    gradients; losses stay on the device until the one fetch at the
    end."""
    if max_batches is not None:
        # islice consumes exactly max_batches: a manual break after
        # next() would pull (and discard) one extra batch from a shared
        # training iterator.
        batches = itertools.islice(batches, max_batches)
    with torch.no_grad():
        losses = [loss_fn(state.params, batch) for batch in batches]
    if not losses:
        raise ValueError("evaluate() received no batches")
    return float(sum(losses)) / len(losses)


def _start_profile() -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # close the traced window on the device
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def fit(
    state: TrainState,
    step_fn: Callable[[TrainState, object], tuple[TrainState, torch.Tensor]],
    batches: Iterator,
    *,
    num_steps: int,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 100,
    log_every: int = 10,
    profile_dir: str | None = None,
    profile_steps: tuple[int, int] = (3, 6),
    eval_fn: Callable[[TrainState], float] | None = None,
    eval_every: int = 100,
) -> FitResult:
    """Run `num_steps` optimizer steps (counted from state.step).

    With `checkpoint_dir`, restores the newest checkpoint into `state`
    before training and saves every `checkpoint_every` steps plus a final
    synchronous save. Loss is only synced to host on the logging interval:
    fetching it every step would serialize dispatch.

    With `profile_dir`, records a `torch.profiler` trace (Chrome trace
    format, `profile_dir/trace.json`) over `profile_steps`, a [start,
    stop) window of THIS RUN's step ordinals.

    With `eval_fn`, runs it every `eval_every` steps and records
    (step, value) pairs in the result.
    """
    if profile_dir is not None and profile_steps[1] <= profile_steps[0]:
        raise ValueError(
            f"profile_steps must be a [start, stop) window with "
            f"stop > start, got {profile_steps}"
        )
    manager = resumed = None
    if checkpoint_dir is not None:
        manager = CheckpointManager(checkpoint_dir)
        restored = manager.restore(state)
        if restored is not None:
            state = restored
            resumed = int(state.step)
            logger.info("resumed from checkpoint step %d", resumed)

    result = FitResult(state=state, resumed_from=resumed)
    target = int(state.step) + num_steps
    t0 = time.monotonic()
    loss = None
    prof = None
    try:
        while int(result.state.step) < target:
            try:
                batch = next(batches)
            except StopIteration:
                logger.info("data iterator exhausted; stopping early")
                break
            if profile_dir is not None:
                if result.steps_run == profile_steps[0] and prof is None:
                    prof = _start_profile()
                elif result.steps_run >= profile_steps[1] and prof is not None:
                    _stop_profile(prof, profile_dir)
                    prof = None
            result.state, loss = step_fn(result.state, batch)
            result.steps_run += 1
            step = int(result.state.step)
            if log_every and result.steps_run % log_every == 0:
                # The only step-loop sync.
                value = float(loss)
                result.losses.append(value)
                rate = result.steps_run / max(time.monotonic() - t0, 1e-9)
                logger.info("step %d loss %.4f (%.1f steps/s)", step, value, rate)
            if eval_fn and eval_every and result.steps_run % eval_every == 0:
                value = float(eval_fn(result.state))
                result.eval_losses.append((step, value))
                logger.info("step %d val loss %.4f", step, value)
            if manager and checkpoint_every and (
                result.steps_run % checkpoint_every == 0
            ):
                manager.save(result.state)
        if loss is not None and (
            not result.losses or result.steps_run % max(log_every, 1) != 0
        ):
            result.losses.append(float(loss))
    finally:
        if prof is not None:
            # Run ended inside the window (iterator exhausted or error).
            _stop_profile(prof, profile_dir)
            logger.warning(
                "profiler window %s closed early at step %d",
                profile_steps, result.steps_run,
            )
        if manager:
            # Skip when the interval save (or the restore source) already
            # wrote this exact step.
            if manager.latest_step() != int(result.state.step):
                manager.save(result.state, force=True, wait=True)
            manager.close()
    return result
