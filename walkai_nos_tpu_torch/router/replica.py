"""Replica adapters: the surface the fleet router needs from an engine.

Port of `walkai_nos_tpu/router/replica.py`. The router
(`router/core.py`) owns N replicas and needs the same surface from each:
submit a request (with the router's trace id), advance it, collect
finished records, read its scale signals (saturation, SLO compliance,
queue depth), drain it, move its blocks and live requests, and read its
telemetry: prefix tallies for the fleet hit rate, the rendered `cb_*`
exposition the router federates under a `replica` label, the windowed
straggler signals `obs/anomaly.AnomalyDetector` scores, and the Chrome
trace the fleet trace merges.

Two adapters implement that surface:

- `EngineReplica` wraps a `models/serve.ContinuousBatcher` in process;
  several of them share one card, each with its own block pool, and may
  share one `DecoderLM`. `step()` advances the engine one turn; its
  clock is the router's, so `clock_offset_s()` is 0.
- `HttpReplica` fronts a demo-server pod (the port's `app/main.py`, or
  the JAX demo's: the surface is the same) over its endpoints: `POST
  /generate` per request from a small worker pool (the trace id rides
  the `X-Walkai-Trace` header), `GET /healthz` for the engine block's
  scale signals, cached for `refresh_s` and doubling as the NTP-style
  clock-offset estimate (the payload's `monotonic_s` minus the probe's
  RTT midpoint), `GET /stats` for the `cb_prefix` tallies, `GET
  /metrics` for the federated exposition and the straggler signals,
  `GET /debug/trace` and `/debug/state` on demand, and `POST /blocks`
  for block shipping. Scrape failures are counted per endpoint kind
  (`scrape_error_stats()`); a pod whose health probe fails reads as
  `unreachable`, which `autoscale.replica_load` scores as full load.
  `drain()` is router-side: the remote process keeps its own lifecycle.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.request

from walkai_nos_tpu_torch.obs.federation import first_value

__all__ = ["EngineReplica", "HttpReplica"]


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


class HttpReplica:
    """Remote replica over the demo server's HTTP surface.

    `submit()` enqueues; a small worker pool POSTs `/generate` and
    parks each response as a finished record, so the router's submit
    path never blocks on a remote generation. Records carry the same
    keys the engine's `drain_done_records()` produces ("tokens",
    "ttft_s", "wall_s", "truncated", "trace_id", "fingerprint") plus
    "error" on failure, so the router's completion path is
    adapter-agnostic.
    """

    # The remote server drives its own engine; a driver fronting only
    # HTTP replicas sleeps between ticks (see EngineReplica).
    steps_locally = False

    def __init__(
        self,
        base_url: str,
        *,
        name: str | None = None,
        workers: int = 8,
        timeout_s: float = 120.0,
        refresh_s: float = 1.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.name = name or self.base_url
        self._timeout_s = timeout_s
        self._refresh_s = refresh_s
        self._next_rid = 0
        self._lock = threading.Lock()
        self._queue: queue.Queue = queue.Queue()
        self._inflight = 0
        self._done: dict[int, dict] = {}
        self._draining = False
        self._health: dict | None = None
        self._health_at: float | None = None
        self._unreachable = False
        self._prefix: dict = {}
        self._prefix_at: float | None = None
        self._metrics_text = ""
        self._metrics_at: float | None = None
        self._clock_offset_s: float | None = None
        # Scrape-failure accounting (satellite of the fleet plane): a
        # flapping pod must show up as a counted, dated error stream,
        # not just as "unreachable right now".
        self._scrape_errors = {"healthz": 0, "stats": 0, "metrics": 0}
        self.last_error: str | None = None
        self._last_ok_at: float | None = None
        self._workers = [
            threading.Thread(
                target=self._worker, daemon=True,
                name=f"router-replica-{self.name}-{i}",
            )
            for i in range(max(1, workers))
        ]
        for t in self._workers:
            t.start()

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker pool once the queued requests are posted (the
        port's addition: a process that builds replicas can reap their
        threads). Raises if a worker outlives `timeout`."""
        for _ in self._workers:
            self._queue.put(None)
        for t in self._workers:
            t.join(timeout)
        alive = [t.name for t in self._workers if t.is_alive()]
        self._workers = []
        if alive:
            raise RuntimeError(f"replica workers did not stop: {alive}")

    def _scrape_failed(self, kind: str, error: Exception) -> None:
        with self._lock:
            self._scrape_errors[kind] += 1
            self.last_error = f"{kind}: {error}"

    def _scrape_ok(self) -> None:
        with self._lock:
            self._last_ok_at = time.monotonic()

    def scrape_error_stats(self) -> dict:
        """Per-handle scrape health for `router.stats()` and the
        `router_replica_scrape_errors_total{replica,kind}` counter:
        cumulative failure counts by endpoint kind, the last error
        string, and how long ago ANY scrape last succeeded."""
        with self._lock:
            last_ok = self._last_ok_at
            return {
                "counts": dict(self._scrape_errors),
                "last_error": self.last_error,
                "last_ok_age_s": (
                    None if last_ok is None
                    else round(time.monotonic() - last_ok, 3)
                ),
            }

    # -- request path --------------------------------------------------

    def submit(self, prompt, **kwargs) -> int:
        trace_id = kwargs.pop("trace_id", None)
        body = {"prompt": [int(t) for t in prompt]}
        for key in (
            "max_new_tokens", "eos_id", "temperature", "top_k",
            "top_p", "seed", "adapter",
        ):
            if kwargs.get(key) is not None:
                body[key] = kwargs[key]
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._inflight += 1
        self._queue.put((rid, body, trace_id))
        return rid

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            rid, body, trace_id = item
            t0 = time.monotonic()
            try:
                headers = {"Content-Type": "application/json"}
                if trace_id is not None:
                    # The cross-process propagation contract: the demo
                    # server stores the id on the engine submit and
                    # echoes it on the response, so this request's
                    # engine spans and the router's spans share it.
                    headers["X-Walkai-Trace"] = str(trace_id)
                req = urllib.request.Request(
                    f"{self.base_url}/generate",
                    data=json.dumps(body).encode(),
                    headers=headers,
                )
                with urllib.request.urlopen(
                    req, timeout=self._timeout_s
                ) as resp:
                    out = json.loads(resp.read())
                record = {
                    "tokens": out.get("tokens", []),
                    "ttft_s": out.get(
                        "ttft_seconds",
                        out.get("generate_time_seconds", 0.0),
                    ),
                    "wall_s": out.get(
                        "engine_wall_seconds",
                        time.monotonic() - t0,
                    ),
                    "truncated": out.get("truncated", False),
                    "trace_id": out.get("trace_id", trace_id),
                    # The replica engine's config-fingerprint id
                    # (capture-armed pods only): matches this
                    # completion to the replica capture that can
                    # replay it.
                    "fingerprint": out.get("fingerprint"),
                    # Which LoRA adapter served it (0/absent = base)
                    # — the per-tenant attribution seam (item 2(b)).
                    "adapter": out.get("adapter"),
                }
            except Exception as e:  # noqa: BLE001 — per-request failure
                record = {
                    "tokens": None,
                    "ttft_s": None,
                    "wall_s": time.monotonic() - t0,
                    "truncated": False,
                    "trace_id": trace_id,
                    "error": str(e),
                }
            with self._lock:
                self._done[rid] = record
                self._inflight -= 1

    def warm(self) -> None:
        """No-op: the remote server warms its own engine at startup."""

    def step(self) -> None:
        """No-op: the remote server drives its own engine."""

    # -- KV block transfer (POST /blocks) ------------------------------

    # Prefix blocks ship fine over HTTP (content-addressed, b64 tiles)
    # but resident-request migration stays in-process only: the
    # response socket for an in-flight /generate lives on the source
    # pod, so moving its stream would orphan the client.
    supports_migration = False

    def _post_blocks(self, body: dict) -> dict:
        req = urllib.request.Request(
            f"{self.base_url}/blocks",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(
            req, timeout=self._timeout_s
        ) as resp:
            return json.loads(resp.read())

    def export_blocks(self, hashes) -> dict:
        """Ask the pod to serialize the named prefix blocks (the
        engine's `export_blocks` payload, JSON-clean by
        construction)."""
        return self._post_blocks(
            {"action": "export", "hashes": list(hashes)}
        )

    def import_blocks(self, payload) -> dict:
        """Land an exported payload in the pod's pool + trie; returns
        the engine's `{"imported": n, "rejected": {...}}` result."""
        return self._post_blocks(
            {"action": "import", "payload": payload}
        )

    def drain_done_records(self) -> dict[int, dict]:
        with self._lock:
            done, self._done = self._done, {}
        return done

    # -- scale signals (cached /healthz engine block) ------------------

    def _engine_block(self) -> dict:
        now = time.monotonic()
        if (
            self._health_at is None
            or now - self._health_at >= self._refresh_s
        ):
            try:
                # Short probe timeout: this runs on the ROUTER's
                # driver thread (load reads inside routing picks) — a
                # blackholed pod must not stall the whole fleet's
                # request path for long per refresh interval.
                t_send = time.monotonic()
                with urllib.request.urlopen(
                    f"{self.base_url}/healthz", timeout=2.0
                ) as resp:
                    payload = json.loads(resp.read())
                t_recv = time.monotonic()
                self._health = payload.get("engine") or {}
                self._unreachable = False
                self._scrape_ok()
                # NTP-style clock offset (replica monotonic minus the
                # router's), estimated at the probe's RTT midpoint —
                # the alignment the fleet /debug/trace merge uses.
                remote = payload.get("monotonic_s")
                if isinstance(remote, (int, float)):
                    self._clock_offset_s = (
                        float(remote) - (t_send + t_recv) / 2.0
                    )
            except Exception as e:  # noqa: BLE001 — probe failed
                self._health = None
                self._unreachable = True
                self._scrape_failed("healthz", e)
            self._health_at = now
        return self._health or {}

    @property
    def unreachable(self) -> bool:
        """True while the last health probe FAILED (distinct from
        'not yet probed'). `autoscale.replica_load` reads this as
        maximum load, so routing prefers any replica that answers —
        an empty engine block would otherwise score a DEAD pod as
        load 0.0, the fleet's most attractive target."""
        self._engine_block()  # refresh if the cache expired
        return self._unreachable

    @property
    def saturation(self):
        return self._engine_block().get("saturation")

    @property
    def slo_ok(self):
        return self._engine_block().get("slo_ok")

    @property
    def queue_depth(self) -> int:
        return int(self._engine_block().get("queue_depth") or 0)

    @property
    def has_work(self) -> bool:
        with self._lock:
            if self._inflight > 0:
                return True
        return bool(self._engine_block().get("has_work"))

    @property
    def slots(self) -> int:
        return int(self._engine_block().get("slots") or 1)

    # -- drain lifecycle -----------------------------------------------

    def drain(self) -> None:
        """Router-side drain: stop routing here; `has_work` (local
        in-flight requests OR the remote engine block) reports when
        the replica can be retired. The remote process's own drain is
        its operator's call — the router only stops feeding it."""
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    # -- fleet telemetry -----------------------------------------------

    def prefix_stats(self) -> dict:
        """Cached for `refresh_s`, like the /healthz probe: the
        router reads prefix tallies every step (the fleet hit-rate
        gauge), and an uncached synchronous GET per step per replica
        would let one slow replica stall the whole driver loop."""
        now = time.monotonic()
        if (
            self._prefix_at is not None
            and now - self._prefix_at < self._refresh_s
        ):
            return self._prefix
        try:
            with urllib.request.urlopen(
                f"{self.base_url}/stats", timeout=5.0
            ) as resp:
                payload = json.loads(resp.read())
            self._prefix = payload.get("cb_prefix") or {}
            self._scrape_ok()
        except Exception as e:  # noqa: BLE001 — telemetry must not gate routing
            self._scrape_failed("stats", e)
            # keep the last good tallies
        self._prefix_at = now
        return self._prefix

    def metrics_text(self) -> str:
        """The pod's `/metrics` text, cached for `refresh_s` (the
        federation source AND the straggler-signal source). Failures
        keep the last good payload — a blip must not blank the whole
        fleet exposition — and count under kind="metrics"."""
        now = time.monotonic()
        if (
            self._metrics_at is not None
            and now - self._metrics_at < self._refresh_s
        ):
            return self._metrics_text
        try:
            # Same short-timeout discipline as the /healthz probe:
            # this runs on the ROUTER's driver thread (the straggler
            # signals are read inside the fleet refresh) — a
            # blackholed pod must not stall the whole fleet's request
            # path for long per refresh interval.
            with urllib.request.urlopen(
                f"{self.base_url}/metrics", timeout=2.0
            ) as resp:
                self._metrics_text = resp.read().decode()
            self._scrape_ok()
        except Exception as e:  # noqa: BLE001 — telemetry must not gate routing
            self._scrape_failed("metrics", e)
        self._metrics_at = now
        return self._metrics_text

    def obs_signals(self) -> dict:
        """Straggler signals parsed from the cached `/metrics` text
        (the same scrape the federation serves — no extra request)."""
        text = self.metrics_text()
        return {
            "dispatch_p99_s": first_value(text, "cb_slo_dispatch_p99"),
            "device_step_ms": first_value(text, "cb_device_step_ms"),
            "roofline_fraction": first_value(
                text, "cb_device_roofline_fraction"
            ),
        }

    def chrome_trace(self) -> dict | None:
        """The pod's `/debug/trace` export, fetched on demand (only
        the fleet `/debug/trace` endpoint asks). None on failure —
        the merge lists the replica under `skipped` instead of
        failing the whole timeline."""
        try:
            with urllib.request.urlopen(
                f"{self.base_url}/debug/trace", timeout=5.0
            ) as resp:
                return json.loads(resp.read())
        except Exception:  # noqa: BLE001 — debug read, best-effort
            return None

    def clock_offset_s(self) -> float:
        """Replica monotonic clock minus the router's, from the last
        successful health probe (0.0 until one lands)."""
        self._engine_block()
        return self._clock_offset_s or 0.0

    def debug_state(self) -> dict | None:
        """One `/debug/state` snapshot for the flight recorder;
        best-effort with a short timeout (a dump must never hang the
        driver on a sick pod — the sick pod is exactly when dumps
        fire)."""
        try:
            with urllib.request.urlopen(
                f"{self.base_url}/debug/state", timeout=2.0
            ) as resp:
                return json.loads(resp.read())
        except Exception:  # noqa: BLE001 — debug read, best-effort
            return None
