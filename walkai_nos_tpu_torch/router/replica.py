"""Replica adapter: the surface the fleet router needs from an engine.

Port of `EngineReplica` from `walkai_nos_tpu/router/replica.py`. The
router (`router/core.py`) owns N replicas and needs the same surface
from each: submit a request (with the router's trace id), advance it,
collect finished records, read its scale signals (saturation, SLO
compliance, queue depth), drain it, move its blocks and live requests,
and read its telemetry: prefix tallies for the fleet hit rate, the
rendered `cb_*` exposition the router federates under a `replica`
label, the windowed straggler signals `obs/anomaly.AnomalyDetector`
scores, and the Chrome trace the fleet trace merges.

`EngineReplica` wraps a `models/serve.ContinuousBatcher` in process;
several of them share one card, each with its own block pool, and may
share one `DecoderLM`. `step()` advances the engine one turn; its clock
is the router's, so `clock_offset_s()` is 0. The JAX package's
`HttpReplica`, which fronts a demo-server pod over HTTP, waits for the
port's demo server.
"""

from __future__ import annotations

__all__ = ["EngineReplica"]


class EngineReplica:
    """In-process replica over a `ContinuousBatcher`."""

    # In-process work only advances when step() is called, so a driver
    # loop must spin while this replica has work. HttpReplica's work
    # advances remotely — its driver can sleep between collection
    # ticks instead of burning a core.
    steps_locally = True

    def __init__(self, engine, *, name: str = "engine"):
        self.name = name
        self.engine = engine

    def warm(self) -> None:
        """Run the engine's warm-up before traffic (kernel builds and
        library handles, off the request path)."""
        self.engine.warm()

    # -- request path --------------------------------------------------

    def submit(self, prompt, **kwargs) -> int:
        return self.engine.submit(prompt, **kwargs)

    def step(self) -> None:
        if self.engine.has_work:
            self.engine.step()

    def drain_done_records(self) -> dict[int, dict]:
        return self.engine.drain_done_records()

    # -- KV block transfer / live migration ----------------------------

    # In-process engines carry the full transfer plane: prefix blocks
    # ship between tries, and resident requests (KV + sampler state)
    # migrate wholesale. HTTP replicas ship blocks over /blocks but
    # never migrate requests — the response socket lives on the
    # source pod.
    supports_migration = True

    def export_blocks(self, hashes) -> dict:
        return self.engine.export_blocks(hashes)

    def import_blocks(self, payload) -> dict:
        return self.engine.import_blocks(payload)

    def export_resident(self, only=None) -> dict:
        return self.engine.export_resident(only=only)

    def import_resident(self, payload) -> list[dict]:
        return self.engine.import_resident(payload)

    def decode_ready_rids(self) -> list[int]:
        return self.engine.decode_ready_rids()

    def drain_stats(self) -> dict:
        return self.engine.drain_stats()

    # -- scale signals -------------------------------------------------

    @property
    def saturation(self):
        return self.engine.saturation

    @property
    def slo_ok(self):
        return self.engine.slo_ok

    @property
    def queue_depth(self) -> int:
        return self.engine.queue_depth

    @property
    def has_work(self) -> bool:
        return self.engine.has_work

    @property
    def slots(self) -> int:
        return self.engine.slots

    # -- drain lifecycle -----------------------------------------------

    def drain(self) -> None:
        self.engine.drain()

    @property
    def draining(self) -> bool:
        return self.engine.draining

    # -- fleet telemetry -----------------------------------------------

    def prefix_stats(self) -> dict:
        return self.engine.prefix_stats()

    def metrics_text(self) -> str:
        """The engine's own Prometheus exposition — the source the
        serverouter's federated `/metrics` re-labels per replica."""
        return self.engine.obs.render()

    def obs_signals(self) -> dict:
        """The straggler signals `obs/anomaly.py` scores against the
        fleet: windowed dispatch p99 (SLO window), device-attributed
        step ms, and the live roofline fraction (None on the CPU)."""
        slo = self.engine.slo_stats()
        attrib = self.engine.attrib_stats()
        dispatch = (slo.get("windows") or {}).get("dispatch") or {}
        return {
            "dispatch_p99_s": dispatch.get("p99"),
            "device_step_ms": attrib.get("device_step_ms"),
            "roofline_fraction": attrib.get("roofline_fraction"),
        }

    def chrome_trace(self) -> dict:
        """The engine's Chrome trace export (carries its clock origin
        for the fleet merge)."""
        return self.engine.obs.trace.chrome_trace()

    def clock_offset_s(self) -> float:
        """In-process: same monotonic clock as the router."""
        return 0.0

    def debug_state(self) -> dict:
        return self.engine.debug_state()
