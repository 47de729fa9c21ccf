"""Straggler detection and the flight recorder for the router fleet.

Port of `walkai_nos_tpu/obs/anomaly.py`, whole:

- `AnomalyDetector` scores each replica against the rest of the fleet:
  for each windowed signal a replica exports (`SIGNALS`: the SLO
  window's dispatch p99, `cb_device_step_ms`,
  `cb_device_roofline_fraction`), the replica's value against the
  median of its peers (leave-one-out, so a two-replica fleet still
  separates a straggler from the healthy one), in the signal's own unit
  (relative to the peer median for latencies, absolute for bounded
  fractions). The worst signal wins, an EWMA smooths it, and flagging
  is hysteretic (flag at `threshold`, clear at `clear`). The router
  exports the score and the flag, adds the score to a flagged replica's
  routing load, and hands the flag to the reconciler as its
  drain-victim hint.
- `FlightRecorder` keeps a bounded on-disk ring of JSON bundles: what an
  operator needs to debug an event after the fact, when the state that
  caused it is gone (the router dumps one at an anomaly flip and at an
  SLO-breach edge; replay triage, `sim/replay.triage_divergence`, at a
  divergence). Bounded both ways: at most `keep` bundles on disk
  (oldest pruned), at most one dump per `min_interval_s`. The file
  names and the bundle layout are the JAX package's.

Stdlib only.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time

__all__ = ["AnomalyDetector", "FlightRecorder", "SIGNALS"]

# signal key -> (direction, rel_scale, abs_scale).
#
# direction: +1.0 = higher-is-worse (latencies), -1.0 =
# lower-is-worse (roofline fraction: a degraded shard runs FURTHER
# from its memory roofline, not closer). The deviation unit is
# max(rel_scale x |peer median|, abs_scale): latencies scale
# RELATIVE to the fleet (a straggler is "2.5x its peers", whatever
# the absolute pace), while the [0, 1]-bounded roofline fraction
# needs an ABSOLUTE unit — a bounded signal can never sit multiple
# relative units below its median, so a relative scale could never
# flag it.
SIGNALS: dict[str, tuple[float, float, float]] = {
    "dispatch_p99_s": (1.0, 0.5, 0.0),
    "device_step_ms": (1.0, 0.5, 0.0),
    "roofline_fraction": (-1.0, 0.0, 0.15),
}

# Raw per-tick scores are clamped here before the EWMA: a zero-ish
# peer median would otherwise make one wild sample arbitrarily large
# and the EWMA's memory meaningless. The bound is deliberately low
# enough that ONE tick can never carry the default EWMA (alpha 0.3)
# past the default flag threshold (0.3 x 6 = 1.8 < 3) — flagging a
# straggler takes sustained deviation, never a single noisy window.
_CLAMP = 6.0


def _median(values: list[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


class AnomalyDetector:
    """EWMA z-score of each replica's windowed signals against the
    peer median. Deterministic and jax-free: a scripted straggler
    trace through fakes exercises it exactly as production load
    does."""

    def __init__(
        self,
        *,
        threshold: float = 3.0,
        clear: float | None = None,
        alpha: float = 0.3,
        signals: dict[str, tuple[float, float, float]] | None = None,
    ):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1]; got {alpha}")
        if threshold <= 0:
            raise ValueError(
                f"threshold must be > 0; got {threshold}"
            )
        self.threshold = threshold
        self.clear = threshold / 2.0 if clear is None else clear
        if self.clear >= threshold:
            raise ValueError(
                f"clear ({self.clear}) must sit below threshold "
                f"({threshold}) for hysteresis"
            )
        self.alpha = alpha
        self.signals = dict(signals or SIGNALS)
        self._score: dict[str, float] = {}
        self._flag: dict[str, bool] = {}

    def score(self, name: str) -> float:
        return self._score.get(name, 0.0)

    def flagged(self, name: str) -> bool:
        return self._flag.get(name, False)

    def forget(self, name: str) -> None:
        """Drop a retired replica's state (its score must not haunt a
        future replica that reuses the name)."""
        self._score.pop(name, None)
        self._flag.pop(name, None)

    def update(
        self, fleet_signals: dict[str, dict | None]
    ) -> dict[str, dict]:
        """One scoring tick over `{replica: {signal: value|None}}`.
        Returns `{replica: {"score", "flagged", "signals"}}` where
        `signals` holds the per-signal raw deviations that fed the
        worst-signal score (the flight bundle's evidence). A signal
        fewer than two replicas report contributes nothing — a
        1-replica fleet has no peers to be a straggler of."""
        per_signal: dict[str, dict[str, float]] = {}
        for sig, (direction, rel, floor) in self.signals.items():
            values = {}
            for name, sigs in fleet_signals.items():
                v = (sigs or {}).get(sig)
                if isinstance(v, (int, float)) and v == v:
                    values[name] = float(v)
            if len(values) < 2:
                continue
            for name, x in values.items():
                peers = [
                    v for other, v in values.items() if other != name
                ]
                med = _median(peers)
                scale = max(rel * abs(med), floor, 1e-12)
                z = direction * (x - med) / scale
                per_signal.setdefault(name, {})[sig] = round(
                    max(-_CLAMP, min(_CLAMP, z)), 4
                )
        out: dict[str, dict] = {}
        for name in fleet_signals:
            deviations = per_signal.get(name, {})
            raw = max(deviations.values()) if deviations else 0.0
            prev = self._score.get(name, 0.0)
            score = prev + self.alpha * (raw - prev)
            self._score[name] = score
            flagged = self._flag.get(name, False)
            if not flagged and score >= self.threshold:
                flagged = True
            elif flagged and score <= self.clear:
                flagged = False
            self._flag[name] = flagged
            out[name] = {
                "score": round(score, 4),
                "flagged": flagged,
                "signals": deviations,
            }
        for name in list(self._score):
            if name not in fleet_signals:
                self.forget(name)
        return out


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
