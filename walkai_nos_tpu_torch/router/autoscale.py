"""Slice autoscaling for the fleet router: the reconciler and a provider.

Port of `walkai_nos_tpu/router/autoscale.py`. The engines export the
scale signals (`cb_saturation`, the windowed `slo_ok`, queue depth);
the reconciler turns them into scale events. Each `tick()`:

1. completes drains: a draining replica whose `has_work` went False is
   retired and its slice returned to the provider (the router's step
   already collected its records, so nothing is dropped);
2. reads fleet pressure: a tick is pressured when any active replica's
   windowed SLO is breached (`slo_ok is False`) or the mean load
   (saturation, a queue-based fallback before the first dispatch)
   reaches `up_saturation`, idle when every load is at most
   `down_saturation` with empty queues;
3. applies hysteresis and a cooldown: pressure must hold `breach_ticks`
   consecutive ticks before a scale-up, idleness `idle_ticks` before a
   scale-down, and any event opens `cooldown_ticks` without another.

Between the two, a replica the fleet's `AnomalyDetector` flagged is
drained at once (migrate-first, `fleet.start_drain`), gated by the
cooldown, `min_replicas` and any drain in flight. Every action lands in
the router's trace ring with its reason and the signals it read.

`StaticSliceProvider` hands out pre-built replicas (one card shared by
several engines, the tests). The JAX package's
`PartitionerSliceProvider`, which carves TPU slices through the
partitioner, waits for the port's control plane.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

logger = logging.getLogger(__name__)

__all__ = [
    "Reconciler",
    "ScalePolicy",
    "StaticSliceProvider",
    "replica_load",
]


def replica_load(replica) -> float:
    """Normalized [0, 1] load of one replica: the engine's composed
    saturation when it has refreshed, else a queue-pressure fallback
    (the same queue/(2*slots) normalization the saturation signal
    itself uses) so a replica that never dispatched reads as idle,
    not unknown. A replica whose health probe FAILED (HttpReplica
    `unreachable`) reads as maximum load: its empty signals would
    otherwise score a dead pod 0.0 — the fleet's most attractive
    routing target."""
    if getattr(replica, "unreachable", False):
        return 1.0
    sat = replica.saturation
    if sat is not None:
        return float(sat)
    slots = max(1, getattr(replica, "slots", 1))
    return min(1.0, replica.queue_depth / (2.0 * slots))


@dataclass
class ScalePolicy:
    """Thresholds + hysteresis for the reconciler, in reconcile ticks
    (one tick per router step): deliberately unitless so the same
    policy drives a real-time serving loop and a deterministic
    scripted test."""

    min_replicas: int = 1
    max_replicas: int = 8
    up_saturation: float = 0.85   # mean active load triggering pressure
    down_saturation: float = 0.30  # max active load counting as idle
    breach_ticks: int = 3          # consecutive pressured ticks -> up
    idle_ticks: int = 8            # consecutive idle ticks -> down
    cooldown_ticks: int = 20       # no further event inside this window


class Reconciler:
    """The scale state machine. `tick(fleet)` is called once per
    router step with the fleet facade (`FleetRouter` or any object
    exposing `active_handles()` / `draining_handles()` /
    `add_replica()` / `retire()`); all state lives here, so a
    scripted saturation trace through fake replicas exercises the
    hysteresis exactly as production load does."""

    def __init__(self, provider, policy: ScalePolicy | None = None,
                 obs=None, trace=None):
        self._provider = provider
        self.policy = policy or ScalePolicy()
        self._obs = obs
        # Router trace ring (obs/trace.RouterTrace): every scale
        # action lands there as a structured event with its reason
        # and a signal snapshot, so the fleet /debug/trace shows
        # autoscaler decisions on the same timeline as the traffic
        # that caused them (scale counters alone say WHAT happened,
        # never WHY or WHEN relative to the surge).
        self._trace = trace
        self._tick = 0
        self._over = 0
        self._under = 0
        self._cooldown_until = 0

    def _trace_event(self, name: str, **args) -> None:
        if self._trace is not None:
            self._trace.event(name, time.monotonic(), **args)

    @staticmethod
    def _signal_snapshot(active) -> dict:
        """The evidence a scale decision was made on, JSON-shaped for
        the trace event: per-replica load and SLO bit plus total
        queue depth at the decision tick."""
        return {
            "loads": {
                h.name: round(replica_load(h.replica), 4)
                for h in active
            },
            "slo_ok": {h.name: h.replica.slo_ok for h in active},
            "queue": sum(h.replica.queue_depth for h in active),
        }

    # -- signals -------------------------------------------------------

    def _pressured(self, active) -> bool:
        if not active:
            return True  # traffic with zero active replicas IS pressure
        if any(h.replica.slo_ok is False for h in active):
            return True
        loads = [replica_load(h.replica) for h in active]
        return sum(loads) / len(loads) >= self.policy.up_saturation

    def _idle(self, active) -> bool:
        if not active:
            return False
        return all(
            replica_load(h.replica) <= self.policy.down_saturation
            and h.replica.queue_depth == 0
            for h in active
        )

    def _event(self, direction: str) -> None:
        self._cooldown_until = self._tick + self.policy.cooldown_ticks
        self._over = 0
        self._under = 0
        if self._obs is not None:
            self._obs.scale_events.inc(
                labels={"direction": direction}
            )

    # -- the loop ------------------------------------------------------

    def tick(self, fleet) -> None:
        self._tick += 1
        # 1. Complete drains: retirement drops nothing — the router's
        # step loop already collected every record, and has_work False
        # means queue, lanes, slots, and in-flight chunks are all
        # empty.
        for handle in list(fleet.draining_handles()):
            if not handle.replica.has_work:
                fleet.retire(handle)
                self._provider.release(handle.replica)
                self._trace_event(
                    "release", replica=handle.name,
                    reason="drained",
                    signals=self._signal_snapshot(
                        fleet.active_handles()
                    ),
                )
                logger.info(
                    "router: replica %s drained and released",
                    handle.name,
                )
        active = fleet.active_handles()
        flagged_names: set[str] = set()
        flagged_of = getattr(fleet, "anomaly_flagged_names", None)
        if flagged_of is not None:
            flagged_names = set(flagged_of())
        # 2. Consecutive-tick hysteresis counters.
        pressured = self._pressured(active)
        self._over = self._over + 1 if pressured else 0
        self._under = self._under + 1 if self._idle(active) else 0
        if self._tick < self._cooldown_until:
            return
        # 2b. Anomaly evacuation: a replica the fleet's AnomalyDetector
        # flagged is rotated out NOW — `start_drain` is migrate-first,
        # so its resident KV ships to healthy peers instead of
        # finishing on the sick device. No hysteresis (the detector's own
        # window IS the debounce), but the cooldown gate above still
        # rate-limits to one evacuation per window, min_replicas is
        # respected, and an in-flight drain defers the next victim.
        if (
            flagged_names
            and len(active) > self.policy.min_replicas
            and not fleet.draining_handles()
        ):
            flagged = [h for h in active if h.name in flagged_names]
            if flagged:
                victim = max(
                    flagged, key=lambda h: replica_load(h.replica)
                )
                fleet.start_drain(victim)
                self._event("down")
                self._trace_event(
                    "drain_start", replica=victim.name,
                    reason="anomaly",
                    signals=self._signal_snapshot(active),
                )
                logger.info(
                    "router: anomaly evacuation draining replica %s",
                    victim.name,
                )
                return
        # 3a. Scale up.
        if (
            self._over >= self.policy.breach_ticks
            and len(active) < self.policy.max_replicas
        ):
            replica = self._provider.acquire()
            if replica is None:
                # No capacity: note it, re-accumulate a full breach
                # window before asking again (a dry provider must not
                # be hammered every tick).
                self._over = 0
                if self._obs is not None:
                    self._obs.scale_events.inc(
                        labels={"direction": "denied"}
                    )
                self._trace_event(
                    "scale_denied",
                    reason="provider_dry",
                    signals=self._signal_snapshot(active),
                )
                return
            fleet.add_replica(replica)
            self._event("up")
            self._trace_event(
                "scale_up", replica=replica.name,
                reason=(
                    "slo_breach"
                    if any(h.replica.slo_ok is False for h in active)
                    else "saturation"
                ),
                signals=self._signal_snapshot(active),
            )
            logger.info(
                "router: scale-up admitted replica %s", replica.name
            )
            return
        # 3b. Scale down: drain a flagged straggler if the fleet's
        # anomaly detector singled one out (the drain hint — an idle
        # window is exactly when rotating a sick replica out is
        # free), else the least-loaded active replica.
        if (
            self._under >= self.policy.idle_ticks
            and len(active) > self.policy.min_replicas
        ):
            pool = [
                h for h in active if h.name in flagged_names
            ] or active
            victim = min(
                pool, key=lambda h: replica_load(h.replica)
            )
            fleet.start_drain(victim)
            self._event("down")
            self._trace_event(
                "drain_start", replica=victim.name,
                reason=(
                    "anomaly" if victim.name in flagged_names
                    else "idle"
                ),
                signals=self._signal_snapshot(active),
            )
            logger.info(
                "router: scale-down draining replica %s", victim.name
            )


class StaticSliceProvider:
    """Pre-built replicas handed out in order — the CI / harness
    provider. Released replicas are NOT recycled (a drained engine's
    drain is one-way); they land in `released` for assertions."""

    def __init__(self, replicas=()):
        self._pool = list(replicas)
        self.released: list = []

    def acquire(self):
        return self._pool.pop(0) if self._pool else None

    def release(self, replica) -> None:
        self.released.append(replica)
