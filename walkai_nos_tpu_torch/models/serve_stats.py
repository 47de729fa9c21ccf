"""The serving engine's counters: the series `occupancy()`, `kv_stats()`,
`prefix_stats()`, `spec_stats()`, `loop_stats()`, `lora_stats()` and
`sp_stats()` read, under the JAX engine's names
(`walkai_nos_tpu/obs/catalog.py`). The exceptions are the block-transfer
series (`xfer_*`) and the capture plane's (`capture_records{kind}`,
`capture_bytes`, `capture_dropped{reason}`, which `obs/capture.CaptureLog`
increments; `capture_stats()` reads the log's own tallies, as JAX's
does): no view of the engine reads them, and they are kept, with the
JAX engine's names and labels, for the reader the obs slice ports (its
metrics registry).

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
        # Multi-LoRA serving (cb_lora_*).
        self.lora_requests = Counter()     # labels: adapter
        self.lora_gather = Counter()       # armed dispatches (and folds)
        self.lora_load_seconds = Counter()
        self.lora_resident = Gauge()
        # The sequence-parallel prefill lane (cb_prefill_sp_*).
        self.sp_requests = Counter()       # long prompts admitted
        self.sp_rows = Counter()           # lane rows of fanned dispatches
        self.sp_holds = Counter()          # admission turns a long waited
        self.sp_active = Gauge()           # long entries prefilling
        # KV block transfer and live migration (cb_xfer_*).
        self.xfer_exported = Counter()     # blocks
        self.xfer_imported = Counter()     # blocks
        self.xfer_rejected = Counter()     # labels: reason
        self.xfer_bytes = Counter()        # labels: dir (in | out)
        self.xfer_migrated = Counter()     # requests; labels: dir
        # The capture plane (cb_capture_*), written by obs/capture.py.
        self.capture_records = Counter()   # labels: kind (submit | done)
        self.capture_bytes = Counter()
        self.capture_dropped = Counter()   # labels: reason
