"""Flight recorder: a bounded on-disk ring of JSON bundles.

Port of `FlightRecorder` from `walkai_nos_tpu/obs/anomaly.py` (its
`AnomalyDetector`, the fleet's straggler scoring, comes with the obs
planes). A bundle holds what an operator needs to debug an event after
the fact, when the state that caused it is gone: replay triage
(`sim/replay.triage_divergence`) dumps both configs' fingerprints, the
divergent record, the divergence coordinates and the replay engine's
`debug_state()`. Bounded both ways: at most `keep` bundles on disk
(oldest pruned), at most one dump per `min_interval_s`. The file names
and the bundle layout are the JAX package's.

Stdlib only.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time

__all__ = ["FlightRecorder"]


_SAFE = re.compile(r"[^A-Za-z0-9._-]+")


class FlightRecorder:
    """Bounded on-disk ring of JSON flight bundles."""

    def __init__(
        self,
        directory: str | None = None,
        *,
        keep: int = 8,
        min_interval_s: float = 5.0,
    ):
        if keep <= 0:
            raise ValueError(f"keep must be > 0; got {keep}")
        self.dir = directory or os.environ.get(
            "WALKAI_FLIGHT_DIR"
        ) or os.path.join(
            tempfile.gettempdir(), f"walkai-flight-{os.getpid()}"
        )
        self.keep = keep
        self.min_interval_s = min_interval_s
        self._last_at: float | None = None
        self._seq = self._max_existing_seq() + 1

    def _files(self) -> list[str]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(
            n for n in names
            if n.startswith("flight-") and n.endswith(".json")
        )

    def _max_existing_seq(self) -> int:
        best = 0
        for name in self._files():
            m = re.match(r"flight-(\d+)-", name)
            if m:
                best = max(best, int(m.group(1)))
        return best

    def dump(
        self, trigger: str, payload: dict, *, now: float | None = None
    ) -> str | None:
        """Write one bundle; returns its path, or None when throttled
        (inside `min_interval_s` of the last dump) or the write
        failed — the recorder is telemetry and must never take the
        engine down."""
        now = time.monotonic() if now is None else now
        if (
            self._last_at is not None
            and now - self._last_at < self.min_interval_s
        ):
            return None
        name = (
            f"flight-{self._seq:06d}-"
            f"{_SAFE.sub('_', trigger)[:32] or 'event'}.json"
        )
        path = os.path.join(self.dir, name)
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(
                    {"trigger": trigger, **payload}, f, default=str
                )
        except (OSError, TypeError, ValueError):
            return None
        self._seq += 1
        self._last_at = now
        files = self._files()
        while len(files) > self.keep:
            try:
                os.remove(os.path.join(self.dir, files.pop(0)))
            except OSError:
                break
        return path

    def bundles(self) -> list[dict]:
        """Every retained bundle, oldest first, each with its file
        name under `_file`. Unreadable files are skipped (a crash
        mid-write must not break the endpoint)."""
        out = []
        for name in self._files():
            try:
                with open(os.path.join(self.dir, name)) as f:
                    bundle = json.load(f)
            except (OSError, ValueError):
                continue
            bundle["_file"] = name
            out.append(bundle)
        return out
