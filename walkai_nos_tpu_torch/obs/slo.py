"""Sliding-window SLO views and the composed saturation signal.

Port of `walkai_nos_tpu/obs/slo.py`, whole. The registry's histograms
are cumulative over the process; this layer windows the same
histograms with no second observation path:

- `BucketRing`: a ring of cumulative-bucket-count snapshots of one
  `Histogram`, one per `window_s / buckets` seconds. `window_counts(now)`
  differences the live counts against the snapshot taken ~`window_s`
  ago; quantiles over that delta keep the registry's one-bucket-width
  accuracy. Before a full window has elapsed a read covers everything
  since start (a partial window, its true span reported); an engine idle
  past the window reads empty; an empty window reads None, never 0.
- `SloTracker`: the engine-facing bundle. `on_sync(now, ...)` at every
  dispatch sync advances the TTFT / TPOT / dispatch-latency rings and,
  at most once per `refresh_s`, recomputes the windowed quantile gauges,
  the per-objective compliance bits and burn rates (the fraction of
  window samples over the objective divided by the quantile's error
  budget), and `cb_saturation`: the max of the busy-slot fraction, the
  queue depth, the queue-depth trend over the window and the paged
  pool's occupancy. The fleet router reads it as its scale signal.

Every clock is the caller's (the engine's `time.monotonic()`), so a
scripted clock gives the JAX package's values exactly. Stdlib only.
"""

from __future__ import annotations

import math
from collections import deque

__all__ = ["BucketRing", "SloTracker", "SATURATION_SIGNALS"]

# Every value the `signal` label can take, in documentation order.
SATURATION_SIGNALS = ("busy", "queue", "queue_trend", "pool")

# Objective key -> (window name, quantile). The error budget of a
# q-quantile objective is (1 - q): samples allowed over the threshold.
OBJECTIVES = {
    "ttft_p99_s": ("ttft", 0.99),
    "tpot_p99_s": ("tpot", 0.99),
}


class BucketRing:
    """Ring-of-buckets windowed view over one cumulative Histogram."""

    def __init__(self, hist, *, window_s: float = 30.0, buckets: int = 15):
        if window_s <= 0 or buckets <= 0:
            raise ValueError(
                f"need window_s > 0 and buckets > 0; got "
                f"{window_s}, {buckets}"
            )
        self._hist = hist
        self.window_s = float(window_s)
        self.bucket_s = self.window_s / buckets
        # (t, cumulative per-bucket counts, cumulative total) — newest
        # last; the head doubles as the window baseline once old
        # enough.
        self._snaps: deque[tuple] = deque()
        self._start_t: float | None = None
        self._last_advance: float | None = None

    @property
    def bounds(self):
        return self._hist.bounds

    def advance(self, now: float) -> None:
        """Rotate the ring: snapshot the cumulative counts when a
        bucket interval has passed, expire snapshots that fell out of
        the window (keeping the newest too-old one as the baseline).
        O(1) amortized; between boundaries it is one float compare."""
        if self._start_t is None:
            self._start_t = now
        self._last_advance = now
        if (
            not self._snaps
            or now - self._snaps[-1][0] >= self.bucket_s
        ):
            counts, total = self._hist.snapshot_counts()
            self._snaps.append((now, counts, total))
        cutoff = now - self.window_s
        while len(self._snaps) >= 2 and self._snaps[1][0] <= cutoff:
            self._snaps.popleft()

    def window_counts(self, now: float) -> tuple[list[int], int, float]:
        """(per-bucket counts, total, span_s) of the samples inside
        the trailing window: live counts minus the baseline snapshot
        — the NEWEST snapshot at or before the window cutoff, scanned
        here rather than relying on `advance()`'s expiry, because
        reads are wall-clock probes while rotation only happens on
        dispatch: an engine idle past the window must read EMPTY, not
        replay its last burst forever (samples can only land at
        dispatches, which rotate the ring, so the baseline is never
        staler than one bucket interval behind the cutoff). When NO
        rotation happened inside the window at all, the window is
        empty by construction — samples only land at dispatches, and
        every dispatch advances the ring — which also covers samples
        recorded after the final pre-idle snapshot. Before a full
        window has elapsed the span is the PARTIAL time since start
        (baseline zero)."""
        if (
            self._last_advance is not None
            and now - self._last_advance > self.window_s
        ):
            return [0] * len(self._hist.bounds), 0, self.window_s
        counts, total = self._hist.snapshot_counts()
        cutoff = now - self.window_s
        for t, base_counts, base_total in reversed(self._snaps):
            if t <= cutoff:
                delta = [
                    c - b for c, b in zip(counts, base_counts)
                ]
                return delta, total - base_total, self.window_s
        start = self._start_t if self._start_t is not None else now
        return counts, total, max(0.0, min(now - start, self.window_s))

    def quantile(self, q: float, now: float) -> float | None:
        """Nearest-rank quantile over the window — upper bound of the
        sample's bucket (one-bucket-width accuracy, +Inf overflow
        clamped to the last finite bound, both as the cumulative
        `Histogram.quantile` does). None on an empty window — "no
        samples" must never read as "zero latency"."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1]; got {q}")
        delta, total, _ = self.window_counts(now)
        if total <= 0:
            return None
        rank = max(1, math.ceil(q * total))
        cum = 0
        for bound, c in zip(self._hist.bounds, delta):
            cum += c
            if cum >= rank:
                return bound
        return self._hist.bounds[-1]

    def frac_over(self, threshold: float, now: float) -> float | None:
        """Fraction of window samples ABOVE `threshold` (bucket
        resolution: a sample counts as within-threshold iff its
        bucket's upper bound is <= threshold). None on an empty
        window."""
        delta, total, _ = self.window_counts(now)
        if total <= 0:
            return None
        ok = sum(
            c for bound, c in zip(self._hist.bounds, delta)
            if bound <= threshold
        )
        return max(0.0, (total - ok) / total)


class SloTracker:
    """Windowed SLO + saturation layer over a `ServingObs` bundle.

    `objectives` maps objective keys (see `OBJECTIVES`) to threshold
    seconds; unset objectives produce no `cb_slo_ok`/burn series and
    leave overall `ok` vacuously True once refreshed. The engine calls
    `on_sync` at every dispatch sync; gauge refresh is throttled to
    `refresh_s` so the per-sync cost stays at ring rotation.
    """

    def __init__(
        self,
        obs,
        *,
        slots: int,
        window_s: float = 30.0,
        buckets: int = 15,
        objectives: dict | None = None,
        refresh_s: float = 1.0,
    ):
        self.enabled = obs.enabled
        self._obs = obs
        self.window_s = float(window_s)
        self.refresh_s = float(refresh_s)
        self.objectives = {
            k: float(v)
            for k, v in (objectives or {}).items()
            if v is not None
        }
        unknown = set(self.objectives) - set(OBJECTIVES)
        if unknown:
            raise ValueError(
                f"unknown SLO objective(s) {sorted(unknown)}; "
                f"known: {sorted(OBJECTIVES)}"
            )
        self._slots = max(1, slots)
        self._rings = {
            "ttft": BucketRing(
                obs.ttft, window_s=window_s, buckets=buckets
            ),
            "tpot": BucketRing(
                obs.tpot, window_s=window_s, buckets=buckets
            ),
            "dispatch": BucketRing(
                obs.dispatch_latency, window_s=window_s, buckets=buckets
            ),
        }
        self._queue_samples: deque[tuple] = deque()
        self._last_refresh: float | None = None
        self._saturation: float | None = None
        self._components: dict = {
            s: None for s in SATURATION_SIGNALS
        }
        self._ok: bool | None = None
        self._ok_by: dict = {k: None for k in self.objectives}
        self._burn: dict = {k: None for k in self.objectives}

    # -- recording (engine driver thread) ------------------------------

    def on_sync(
        self,
        now: float,
        *,
        queue_depth: int,
        busy_slots: int,
        headroom_frac: float | None,
    ) -> None:
        """Per-dispatch hook at the host sync. `headroom_frac` is the
        paged pool's reclaimable fraction ((free + parked) /
        allocatable), None for the dense engine."""
        if not self.enabled:
            return
        for ring in self._rings.values():
            ring.advance(now)
        q = self._queue_samples
        q.append((now, queue_depth))
        cutoff = now - self.window_s
        while len(q) >= 2 and q[1][0] <= cutoff:
            q.popleft()
        if (
            self._last_refresh is not None
            and now - self._last_refresh < self.refresh_s
        ):
            return
        self._last_refresh = now
        self._refresh(now, queue_depth, busy_slots, headroom_frac)

    def _compliance(self, now: float) -> tuple[dict, dict]:
        """(ok_by_objective, burn_by_objective) over the current
        window. A window with no samples yields None for both — no
        evidence of breach; compliance unknown, never "violated by
        silence"."""
        ok_by: dict = {}
        burn_by: dict = {}
        for key, threshold in self.objectives.items():
            window, q = OBJECTIVES[key]
            over = self._rings[window].frac_over(threshold, now)
            if over is None:
                ok_by[key] = None
                burn_by[key] = None
                continue
            budget = 1.0 - q
            ok_by[key] = over <= budget
            burn_by[key] = round(over / budget, 4)
        return ok_by, burn_by

    def ok_at(self, now: float) -> bool | None:
        """Overall compliance computed LIVE over the current window
        (the `/healthz` `slo_ok` field): False iff any configured
        objective measurably breached its budget; None before the
        first dispatch or with telemetry off. Live, not last-refresh:
        a short request burst can end inside one refresh interval,
        and the probe must still see its breaches."""
        if not self.enabled or self._last_refresh is None:
            return None
        ok_by, _ = self._compliance(now)
        return not any(v is False for v in ok_by.values())

    def _refresh(
        self, now, queue_depth, busy_slots, headroom_frac
    ) -> None:
        obs = self._obs
        ttft_p50 = self._rings["ttft"].quantile(0.50, now)
        ttft_p99 = self._rings["ttft"].quantile(0.99, now)
        tpot_p99 = self._rings["tpot"].quantile(0.99, now)
        disp_p99 = self._rings["dispatch"].quantile(0.99, now)
        for gauge, value in (
            (obs.slo_ttft_p50, ttft_p50),
            (obs.slo_ttft_p99, ttft_p99),
            (obs.slo_tpot_p99, tpot_p99),
            (obs.slo_dispatch_p99, disp_p99),
        ):
            if value is not None:  # empty window: leave unset, not 0
                gauge.set(value)
        self._ok_by, self._burn = self._compliance(now)
        for key, ok in self._ok_by.items():
            if ok is None:
                continue
            obs.slo_ok_gauge.set(
                1.0 if ok else 0.0, labels={"objective": key}
            )
            obs.slo_burn.set(
                self._burn[key], labels={"objective": key}
            )
        # Overall compliance: any measured breach flips it; unknowns
        # don't (an idle engine is not out of SLO).
        self._ok = not any(v is False for v in self._ok_by.values())
        # Saturation components, each normalized to [0, 1].
        depth0 = self._queue_samples[0][1] if self._queue_samples else 0
        components = {
            "busy": min(1.0, busy_slots / self._slots),
            "queue": min(1.0, queue_depth / (2.0 * self._slots)),
            "queue_trend": min(
                1.0, max(0.0, (queue_depth - depth0) / self._slots)
            ),
            "pool": (
                None if headroom_frac is None
                else min(1.0, max(0.0, 1.0 - headroom_frac))
            ),
        }
        self._components = {
            k: None if v is None else round(v, 4)
            for k, v in components.items()
        }
        present = [v for v in components.values() if v is not None]
        self._saturation = round(max(present), 4) if present else None
        for signal, value in self._components.items():
            if value is not None:
                obs.saturation_component.set(
                    value, labels={"signal": signal}
                )
        if self._saturation is not None:
            obs.saturation.set(self._saturation)

    # -- reading (any thread) ------------------------------------------

    @property
    def saturation(self) -> float | None:
        """Composed scale signal from the last refresh (None before
        the first dispatch, or with telemetry off)."""
        return self._saturation

    @property
    def ok(self) -> bool | None:
        """Overall SLO compliance from the last refresh: False iff a
        configured objective measurably breached its budget."""
        return self._ok

    def stats(self, now: float) -> dict:
        """Windowed-SLO view — the `/debug/slo` payload and the
        `/stats` `cb_slo` section. Quantiles AND compliance/burn are
        computed live at call time over the current window (the
        gauges refresh throttled; a reader must never see staler
        compliance than the window it is shown beside); saturation is
        the last refresh's (its inputs are sync-time engine state).
        Same dict shape with telemetry off, flagged `obs_disabled`
        (the views' convention)."""
        windows = {}
        for name, ring in self._rings.items():
            if self.enabled:
                _, total, span = ring.window_counts(now)
                windows[name] = {
                    "count": total,
                    "p50": ring.quantile(0.50, now),
                    "p99": ring.quantile(0.99, now),
                    "span_s": round(span, 3),
                }
            else:
                windows[name] = {
                    "count": 0, "p50": None, "p99": None,
                    "span_s": 0.0,
                }
        if self.enabled:
            ok_by, burn_by = self._compliance(now)
            # Overall bit derived from the map already in hand (one
            # _compliance pass per read, and no second code path for
            # ok_at to drift from).
            overall = (
                None if self._last_refresh is None
                else not any(v is False for v in ok_by.values())
            )
        else:
            ok_by = {k: None for k in self.objectives}
            burn_by = {k: None for k in self.objectives}
            overall = None
        return {
            **({} if self.enabled else {"obs_disabled": True}),
            "window_s": self.window_s,
            "objectives": dict(self.objectives),
            "windows": windows,
            "slo_ok": ok_by,
            "ok": overall,
            "burn_rate": burn_by,
            "saturation": {
                "value": self._saturation,
                "components": dict(self._components),
            },
        }
