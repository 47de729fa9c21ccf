"""The serving engine's counters: the series `occupancy()`, `kv_stats()`,
`prefix_stats()`, `spec_stats()` and `loop_stats()` read, under the JAX
engine's names.

The JAX engine keeps these in its `obs/` telemetry planes (registry,
trace, SLO and attribution layers); those planes are not ported yet, so
this module holds plain in-process counters and gauges with the same
`inc` / `set` / `set_min` / `value` surface the block pool
and the engine call.
"""

from __future__ import annotations

__all__ = ["Counter", "EngineStats", "Gauge"]


def _key(labels: dict | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


class Counter:
    def __init__(self) -> None:
        self._v: dict[tuple, float] = {}

    def inc(self, value: float = 1.0, labels: dict | None = None) -> None:
        k = _key(labels)
        self._v[k] = self._v.get(k, 0.0) + value

    def value(self, labels: dict | None = None) -> float:
        return self._v.get(_key(labels), 0.0)


class Gauge:
    def __init__(self) -> None:
        self._v: dict[tuple, float] = {}

    def set(self, value: float, labels: dict | None = None) -> None:
        self._v[_key(labels)] = value

    def set_min(self, value: float, labels: dict | None = None) -> None:
        k = _key(labels)
        if k not in self._v or value < self._v[k]:
            self._v[k] = value

    def value(self, labels: dict | None = None) -> float | None:
        return self._v.get(_key(labels))


class EngineStats:
    """Counters and gauges of one engine (names as in the JAX engine's
    `ServingObs`)."""

    def __init__(self) -> None:
        self.errors = Counter()            # labels: reason
        self.dispatches = Counter()
        self.busy_steps = Counter()
        self.total_steps = Counter()
        self.stall = Counter()             # admission host seconds
        self.kv_ratio = Gauge()
        self.kv_bytes = Counter()
        self.kv_resident = Counter()
        self.prefix_hits = Counter()
        self.prefix_misses = Counter()
        self.prefix_saved = Counter()
        self.prefix_prompt_tokens = Counter()
        self.prefix_evictions = Counter()
        self.prefix_cached_tokens = Gauge()
        self.pool_blocks = Gauge()         # labels: state
        self.pool_min_free = Gauge()
        # Speculative rounds (cb_spec_*).
        self.spec_draft = Counter()        # draft forwards
        self.spec_verify = Counter()       # target verify forwards
        self.spec_rounds = Counter()       # (live slot, round) pairs
        self.spec_proposed = Counter()
        self.spec_accepted = Counter()
        self.spec_emitted = Counter()      # tokens committed by rounds
        self.spec_k_gauge = Gauge()
        self.spec_disabled = Gauge()
        # The device-resident loop (cb_loop_*).
        self.loop_dispatches = Counter()
        self.loop_chunks = Counter()
        self.loop_exits = Counter()        # labels: reason
        self.loop_steps_per_sync = Gauge()
