"""Checkpoint/resume for training state, on `torch.save`.

Port of `walkai_nos_tpu/models/checkpoint.py` (orbax there). A training
job rescheduled onto another card resumes where it stopped:

- each save writes `<directory>/<step>/state.pt` (model and optimizer
  state dicts and the step) into a temporary directory and renames it
  into place, so a step directory is either whole or absent (orbax's
  atomicity);
- a save snapshots the state to host memory at once (a device-to-host
  copy that waits for the step in flight) and writes the file on a
  background thread, so the write overlaps the next steps; `wait=True`
  returns only once the step is on disk;
- the newest `max_to_keep` steps are kept, older ones deleted;
- `restore(template)` loads the newest step into a freshly initialised
  `TrainState` in place (on the template's device) and returns it.

The LoRA adapter npz helpers of the JAX module belong to the LoRA slice
and are not here.
"""

from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path

import torch

from walkai_nos_tpu_torch.models.train import TrainState

__all__ = ["CheckpointManager"]

_FILE = "state.pt"


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._keep = max_to_keep
        self._writer: threading.Thread | None = None
        self._error: Exception | None = None

    def _steps(self) -> list[int]:
        return sorted(
            int(p.name) for p in self._dir.iterdir()
            if p.is_dir() and p.name.isdigit() and (p / _FILE).exists()
        )

    def _write(self, step: int, payload: dict) -> None:
        tmp = self._dir / f".{step}.tmp-{os.getpid()}"
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            torch.save(payload, tmp / _FILE)
            os.replace(tmp, self._dir / str(step))
            for old in self._steps()[: -self._keep]:
                shutil.rmtree(self._dir / str(old), ignore_errors=True)
        except Exception as exc:  # re-raised by the next wait()
            self._error = exc
            shutil.rmtree(tmp, ignore_errors=True)

    def wait(self) -> None:
        """Block until the save in flight is on disk; re-raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(
        self, state: TrainState, *, force: bool = False, wait: bool = False
    ) -> bool:
        """Save `state` at its step; returns False (and writes nothing)
        when that step is already on disk, unless `force`. The write
        overlaps subsequent steps; pass `wait=True` only when durability
        matters now (the final save before exit)."""
        self.wait()
        step = int(state.step)
        if (self._dir / str(step) / _FILE).exists():
            if not force:
                return False
            shutil.rmtree(self._dir / str(step))
        payload = {
            "params": _to_host(state.params.state_dict()),
            "opt_state": _to_host(state.opt_state.state_dict()),
            "step": step,
        }
        self._writer = threading.Thread(
            target=self._write, args=(step, payload), daemon=True
        )
        self._writer.start()
        if wait:
            self.wait()
        return True

    def latest_step(self) -> int | None:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: TrainState) -> TrainState | None:
        """Load the newest checkpoint into `template` (a freshly
        initialised TrainState on the target device) in place; None when
        the directory holds no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        # Loaded to the host: load_state_dict copies into the template's
        # parameters and moves the moments to their device, and AdamW's
        # step counters stay host tensors as it keeps them.
        payload = torch.load(
            self._dir / str(step) / _FILE, map_location="cpu", weights_only=True
        )
        template.params.load_state_dict(payload["params"])
        template.opt_state.load_state_dict(payload["opt_state"])
        template.step = int(payload["step"])
        return template

    def close(self) -> None:
        self.wait()
