"""FleetRouter: prefix-affinity request routing over N engine replicas.

Port of `walkai_nos_tpu/router/core.py`. A fleet of `ContinuousBatcher`
replicas (`router/replica.EngineReplica`; several engines may share one
card) behind one `submit()` / `step()` / `drain_done_records()` surface
shaped like a single engine's.

Routing is cache-aware and load-bounded:

- Prefix affinity: the routing key is a hash of the prompt's first
  128-token block (`models/block_key.route_key`, the prefix trie's own
  block identity), so same-template traffic goes to the replica whose
  trie already holds the template's blocks, and each template's prefix
  is prefilled once per fleet (`prefix_hit_rate`). Prompts shorter than
  a block skip to load balancing.
- Power-of-two-choices fallback: when the affinity target's load
  (`router/autoscale.replica_load`: the engine's saturation, a queue
  fallback, plus a flagged straggler's anomaly penalty) reaches
  `affinity_overload`, two candidates are sampled from the router's
  `random.Random(seed)` and the template re-points to the less loaded
  one only if it is at least `affinity_imbalance` cooler. Unknown keys
  take the same two-choice sample.
- Draining replicas receive nothing.

`policy="round_robin"` is the rotation baseline. When placement moves a
template off the replica holding its blocks, the router ships the
prompt's ready blocks first (`export_blocks` / `import_blocks`).
`add_replica(role="prefill" | "decode")` makes placement two-stage:
prefill by load, decode prefix-affine, each stream handed off at its
first token through `export_resident` / `import_resident`. A drain with
`migrate=True` moves the victim's residents to the least-loaded peer
(back to itself if none can take them); router rids stay stable.

`step()` advances every replica one turn, collects finished records,
runs the hand-off, ticks the reconciler (`router/autoscale.py`) and
refreshes the fleet's telemetry (`obs/router.RouterObs`): per-request
trace ids and `RouterTrace` spans, `federated_metrics()` (every
replica's `cb_*` series under `replica`), `fleet_trace()`, straggler
scoring (`obs/anomaly.AnomalyDetector`; the score is a load penalty and
the reconciler's drain hint) and flight bundles at anomaly flips and
SLO-breach edges. `capture=` records routed traffic at the router's
submit and collect seams.

The JAX router's shadow/canary role is not ported: `add_replica(role=
"canary")` raises NotImplementedError, `canary_mirror` / `canary_opts`
are validated and have no effect (as in JAX without a canary), and
`canary_stats()` is None.
"""

from __future__ import annotations

import random
import time

import numpy as np

from walkai_nos_tpu_torch.models.block_key import chain_hashes, route_key
from walkai_nos_tpu_torch.models.serve import _not_ported
from walkai_nos_tpu_torch.obs.anomaly import AnomalyDetector, FlightRecorder
from walkai_nos_tpu_torch.obs.capture import (
    CaptureLog,
    fingerprint_id,
    token_digest,
)
from walkai_nos_tpu_torch.obs.federation import federate, merge_fleet_trace
from walkai_nos_tpu_torch.obs.router import RouterObs
from walkai_nos_tpu_torch.obs.trace import RouterTrace
from walkai_nos_tpu_torch.router.autoscale import Reconciler, replica_load

__all__ = ["FleetRouter", "prefix_key"]


def prefix_key(prompt) -> int | None:
    """Routing key: CRC-32 of the prompt's first full 128-token block
    (PAGE_ROWS — the prefix trie's share granularity), None when the
    prompt has no full block to share. Delegates to
    `models/block_key.route_key` so the router's affinity key and the
    trie's block identity derive from ONE serialization of the same
    tokens (`block_key`) — the key a block ships under is the key
    traffic routes under. Stable across processes (no PYTHONHASHSEED
    dependence), so a router restart re-derives the same template
    keys."""
    return route_key(prompt)


class _Handle:
    """One fleet member: the replica plus the router's bookkeeping
    (request count, the final prefix tallies captured at retirement,
    the fleet plane's per-replica state: last anomaly verdict, scrape
    error counts already reflected into the counter, and the
    SLO-breach edge detector the flight recorder triggers on)."""

    def __init__(self, replica, name: str, role: str = "both"):
        self.replica = replica
        self.name = name
        self.role = role
        self.routed = 0
        self.anomaly: dict = {"score": 0.0, "flagged": False}
        self.scrape_seen: dict[str, int] = {}
        self.slo_was_false = False

    def can_prefill(self) -> bool:
        return self.role in ("both", "prefill")

    def can_decode(self) -> bool:
        return self.role in ("both", "decode")

    def prefix_tallies(self) -> tuple[int, int]:
        stats = self.replica.prefix_stats() or {}
        return (
            int(stats.get("block_hits") or 0),
            int(stats.get("block_hits") or 0)
            + int(stats.get("block_misses") or 0),
        )


class FleetRouter:
    def __init__(
        self,
        replicas=(),
        *,
        provider=None,
        scale_policy=None,
        policy: str = "affinity",
        affinity_overload: float = 0.9,
        affinity_imbalance: float = 0.25,
        ship_blocks: bool = True,
        seed: int = 0,
        obs: RouterObs | bool = True,
        trace: RouterTrace | None = None,
        anomaly: AnomalyDetector | bool | None = None,
        anomaly_penalty: float = 0.5,
        fleet_refresh_s: float = 1.0,
        flight: FlightRecorder | None = None,
        flight_dir: str | None = None,
        capture: CaptureLog | str | None = None,
        canary_mirror: float = 1.0,
        canary_opts: dict | None = None,
    ):
        if policy not in ("affinity", "round_robin"):
            raise ValueError(
                f"policy must be 'affinity' or 'round_robin'; "
                f"got {policy!r}"
            )
        self.policy = policy
        self.affinity_overload = affinity_overload
        self.affinity_imbalance = affinity_imbalance
        # Block shipping on placement moves (the fleet-global prefix
        # cache). ship_blocks=False reverts to per-replica caches —
        # the bench's baseline arm for the fleet-hit-rate comparison.
        self.ship_blocks = ship_blocks
        if isinstance(obs, RouterObs):
            self.obs = obs
        else:
            self.obs = RouterObs(enabled=bool(obs))
        # The fleet observability plane: router-side request spans
        # (merged with replica traces by fleet_trace()), the straggler
        # detector, and the flight recorder. All keyed off the obs
        # enable flag so the obs=False arm of the bench's
        # router_obs_overhead_pct A/B disables the WHOLE plane.
        self.trace = trace if trace is not None else RouterTrace(
            enabled=self.obs.enabled
        )
        if isinstance(anomaly, AnomalyDetector):
            self._anomaly = anomaly
        elif anomaly is False or not self.obs.enabled:
            self._anomaly = None
        else:
            self._anomaly = AnomalyDetector()
        self.anomaly_penalty = anomaly_penalty
        self.fleet_refresh_s = fleet_refresh_s
        if flight is not None:
            self.flight = flight
        elif self.obs.enabled:
            self.flight = FlightRecorder(flight_dir)
        else:
            self.flight = None
        self._penalty: dict[str, float] = {}
        self._fleet_refresh_at = 0.0
        self._rng = random.Random(seed)
        # Trace-id prefix: stable per router instance, drawn from the
        # seeded rng so replays are deterministic while two routers'
        # ids stay distinguishable.
        self._trace_prefix = f"w{self._rng.randrange(16 ** 6):06x}"
        self._handles: list[_Handle] = []
        self._seq = 0
        for replica in replicas:
            self.add_replica(replica)
        # template key -> handle (affinity map); entries for retired
        # handles are dropped lazily at lookup.
        self._affinity: dict[int, _Handle] = {}
        # template key -> handle whose trie last received the
        # template's blocks (by local prefill OR by an import): the
        # fleet-global prefix-cache directory the block-shipping plane
        # consults. In colocated mode it shadows the affinity map and
        # only diverges on a re-point (where the ship happens); in
        # disaggregated mode it is the only record of block locality.
        self._block_home: dict[int, _Handle] = {}
        # template key -> decode-stage handle (disaggregated mode):
        # decode placement is prefix-affine even though prefill
        # placement is pure load, so a template's shipped blocks pool
        # on one decode replica instead of spraying the fleet.
        self._decode_affinity: dict[int, _Handle] = {}
        self._rr_next = 0
        self._next_rid = 0
        # router rid -> (handle, local rid, trace id); completed
        # records land in _done keyed by router rid.
        self._routes: dict[int, tuple[_Handle, int, str]] = {}
        self._local: dict[tuple[int, int], int] = {}
        self._done: dict[int, dict] = {}
        # Wire bytes shipped through block transfers, keyed by tile
        # dtype — the router-side ledger behind
        # `router_xfer_bytes_total{dtype}`.
        self._xfer_bytes: dict[str, int] = {}
        # router rid -> affinity key, held while the request is in
        # flight: the disaggregated decode stage places a stream by
        # its template key at handoff time.
        self._decode_key: dict[int, int | None] = {}
        # Prefix tallies of replicas already retired, so the fleet hit
        # rate never loses history when a slice is returned.
        self._retired_hits = 0
        self._retired_lookups = 0
        # The shadow/canary plane's options, validated as in the JAX
        # router; with no canary replica (the role is not ported) they
        # have no effect there either.
        self.canary_mirror = float(canary_mirror)
        if not 0.0 <= self.canary_mirror <= 1.0:
            raise ValueError(
                f"canary_mirror must be in [0, 1]; "
                f"got {canary_mirror}"
            )
        self._canary_opts = dict(canary_opts or {})
        self._reconciler = (
            Reconciler(
                provider, scale_policy, obs=self.obs,
                trace=self.trace,
            )
            if provider is not None else None
        )
        # Fleet-level capture plane (obs/capture.py): records routed
        # traffic at the router's own submit/collect seams — done
        # records add the routed replica. The fleet capture's header
        # has no engine fingerprint (replicas own those; an engine
        # capture is the token-exact replay artifact) — its records
        # pin WHAT arrived and WHERE it went, the incident timeline
        # the per-replica captures are replayed against. Caveat: an
        # unseeded sampled request's effective seed is assigned
        # replica-side (the local rid), so only the replica's own
        # capture pins it.
        self._capture = CaptureLog.coerce(capture)
        if self._capture is not None:
            fp = {
                "version": 1,
                "router": {
                    "policy": policy,
                    "replicas": [h.name for h in self._handles],
                },
            }
            fp["id"] = fingerprint_id(fp)
            self._capture.attach(fp)
        self._set_replica_gauges()

    # -- fleet membership ----------------------------------------------

    def add_replica(self, replica, role: str = "both") -> None:
        """Admit a replica. `role` splits the fleet into serving
        stages: "both" (the colocated default), "prefill" (takes new
        requests, hands streams off at first token), or "decode"
        (receives migrated streams only, never a cold submit). Any
        prefill/decode member flips the router into disaggregated
        two-stage placement. "canary", the JAX router's shadow
        replica, raises NotImplementedError: the shadow plane
        (`obs/canary.py`) is not ported."""
        if role not in ("both", "prefill", "decode", "canary"):
            raise ValueError(
                f"role must be 'both', 'prefill', 'decode' or "
                f"'canary'; got {role!r}"
            )
        if role == "canary":
            raise _not_ported("the canary role (obs/canary.py)", "fleet")
        name = getattr(replica, "name", None) or f"r{self._seq}"
        self._seq += 1
        self._handles.append(_Handle(replica, name, role=role))
        self._set_replica_gauges()

    @property
    def disaggregated(self) -> bool:
        return any(
            h.role in ("prefill", "decode") for h in self._handles
        )

    def start_drain(self, handle: _Handle, migrate: bool = True) -> None:
        """Stop routing to `handle` and ask its replica to drain
        (resident work finishes; the reconciler retires it once
        `has_work` goes False). When the replica supports live
        migration (in-process engines), its resident requests — mid-
        decode slots, mid-prefill entries, queued work — are
        evacuated to a peer immediately instead of running the drain
        down, so a scale-down stops paying for the victim the moment
        the decision lands; streams continue token-identically on the
        destination. Replicas without the seam (HTTP pods, fakes)
        keep the classic finish-resident-work drain."""
        handle.replica.drain()
        self._set_replica_gauges()
        if migrate and getattr(
            handle.replica, "supports_migration", False
        ):
            self._migrate_residents(handle)

    def retire(self, handle: _Handle) -> None:
        """Remove a fully drained handle from the fleet, folding its
        prefix tallies into the retired accumulators first so the
        fleet-level hit rate keeps its history."""
        self._collect(handle)  # final records, before the handle goes
        hits, lookups = handle.prefix_tallies()
        self._retired_hits += hits
        self._retired_lookups += lookups
        self._handles.remove(handle)
        self._affinity = {
            k: h for k, h in self._affinity.items() if h is not handle
        }
        self._block_home = {
            k: h for k, h in self._block_home.items()
            if h is not handle
        }
        self._decode_affinity = {
            k: h for k, h in self._decode_affinity.items()
            if h is not handle
        }
        # Drop EVERY per-replica series of the retired member (and
        # its federated cb_* series vanish with the handle): the last
        # values would otherwise export a dead member as live forever.
        for instrument in (
            self.obs.replica_saturation,
            self.obs.replica_anomaly,
            self.obs.replica_anomaly_score,
            self.obs.scrape_errors,
        ):
            for labels in instrument.labelsets():
                if labels.get("replica") == handle.name:
                    instrument.remove(labels)
        if self._anomaly is not None:
            self._anomaly.forget(handle.name)
        self._penalty.pop(handle.name, None)
        self.trace.event(
            "retire", time.monotonic(), replica=handle.name
        )
        self._set_replica_gauges()

    def active_handles(self) -> list[_Handle]:
        """Serving members: the non-draining ones — the ONE candidate
        set behind routing picks, reconciler pressure/idle signals, and
        fleet-capacity accounting."""
        return [h for h in self._handles if not h.replica.draining]

    def draining_handles(self) -> list[_Handle]:
        return [h for h in self._handles if h.replica.draining]

    @property
    def replicas(self) -> list:
        return [h.replica for h in self._handles]

    # -- routing -------------------------------------------------------

    def _load(self, handle: _Handle) -> float:
        """Routing load: the replica's normalized load plus the
        anomaly penalty — a flagged straggler reads as proportionally
        hotter, so p2c and the affinity overload check both steer
        traffic away from it before its queue ever shows the damage
        (`router_replica_anomaly_score` scaled into
        [0, anomaly_penalty])."""
        return replica_load(handle.replica) + self._penalty.get(
            handle.name, 0.0
        )

    def _pick(self, key: int | None) -> tuple[_Handle, str]:
        candidates = self.active_handles()
        if self.disaggregated:
            # Two-stage placement, stage one: new requests land on
            # prefill-capable members by pure load — affinity is the
            # DECODE stage's concern (the stream follows its blocks
            # there at first token); pinning prefill too would
            # serialize a hot template's prefills on one replica for
            # no cache gain the block-shipping plane doesn't already
            # provide.
            candidates = [h for h in candidates if h.can_prefill()]
        if not candidates:
            self.obs.failed.inc(labels={"reason": "no_replica"})
            raise RuntimeError(
                "fleet has no active replica to route to"
            )
        if self.policy == "round_robin":
            handle = candidates[self._rr_next % len(candidates)]
            self._rr_next += 1
            return handle, "round_robin"
        if key is not None and not self.disaggregated:
            handle = self._affinity.get(key)
            if handle is not None and handle in candidates:
                load = self._load(handle)
                # Affinity yields only when the target is HOT *and*
                # the sampled alternative is meaningfully less loaded
                # THAN THE TARGET: a uniformly saturated fleet (every
                # engine's busy component pinned at 1.0 under full
                # load) gains nothing from moving and would pay a
                # cold prefill per migration. The gap is checked
                # against the actual migration destination, not the
                # fleet minimum — a lucky global minimum must not
                # green-light re-pointing to whatever two replicas
                # the sample happened to draw (possibly hotter than
                # the target itself).
                if load < self.affinity_overload:
                    return handle, "affinity"
                alt = self._two_choices(candidates)
                if (
                    load - self._load(alt)
                    >= self.affinity_imbalance
                ):
                    self._affinity[key] = alt
                    return alt, "p2c"
                return handle, "affinity"
        # Unknown key (or no affinity yet): two-choice placement; the
        # key (if any) points here so the template's stream follows
        # the blocks it is about to warm.
        handle = self._two_choices(candidates)
        if key is not None and not self.disaggregated:
            self._affinity[key] = handle
        return handle, "p2c"

    def _two_choices(self, candidates: list[_Handle]) -> _Handle:
        """Power-of-two-choices: two distinct candidates when the
        fleet has them, least loaded wins (Mitzenmacher's d=2 bound:
        near-best-of-all balance at O(1) probes)."""
        if len(candidates) == 1:
            return candidates[0]
        a, b = self._rng.sample(candidates, 2)
        return min((a, b), key=self._load)

    def submit(
        self,
        prompt,
        *,
        trace_id: str | None = None,
        enqueued_at: float | None = None,
        **kwargs,
    ) -> int:
        """Route one request; returns a ROUTER request id (replica
        rids are namespaced per replica and never leak). Replica-side
        validation errors (bad knobs, oversize) propagate to the
        caller after landing in `router_requests_failed_total` —
        client errors stay client errors whatever replica they hit.

        The router mints a `trace_id` per request (or adopts the
        caller's) and propagates it to the replica — the
        `X-Walkai-Trace` header over HTTP, a submit field in process
        — so the replica's engine spans and the router's
        route/queue/round-trip spans merge under one id in the fleet
        trace. `enqueued_at` is the front end's enqueue time, rendered
        as the queue-wait span."""
        t_submit = time.monotonic()
        key = prefix_key(prompt)
        handle, arm = self._pick(key)
        if (
            key is not None
            and self.ship_blocks
            and self.policy != "round_robin"
        ):
            # Ship KV blocks, not requests: when placement moves a
            # template off the replica whose trie holds its blocks
            # (an affinity re-point in colocated mode; any load-pick
            # divergence in disaggregated mode), the router brokers
            # an export/import of the prompt's READY prefix blocks
            # BEFORE the submit lands — the destination admits the
            # request against a warm trie and skips the cold
            # prefill.
            home = self._block_home.get(key)
            if (
                home is not None
                and home is not handle
                and home in self._handles
            ):
                self._ship(home, handle, prompt)
            self._block_home[key] = handle
        rid = self._next_rid
        if trace_id is None:
            trace_id = f"{self._trace_prefix}-{rid:08x}"
        try:
            local = handle.replica.submit(
                prompt, trace_id=trace_id, **kwargs
            )
        except ValueError:
            self.obs.failed.inc(labels={"reason": "bad_request"})
            raise
        t_routed = time.monotonic()
        self._next_rid += 1
        self._routes[rid] = (handle, local, trace_id)
        self._local[(id(handle), local)] = rid
        self._decode_key[rid] = key
        handle.routed += 1
        self.obs.submitted.inc()
        self.obs.routed.inc(labels={"policy": arm})
        self.trace.submit(
            rid, trace_id=trace_id, t_submit=t_submit,
            t_routed=t_routed, replica=handle.name, policy=arm,
            t_enqueue=enqueued_at, affinity_key=key,
        )
        if self._capture is not None:
            self._capture.record_submit(
                rid=rid,
                trace_id=trace_id,
                prompt=np.asarray(prompt).reshape(-1).tolist(),
                replica=handle.name,
                policy=arm,
                arrival_s=round(
                    self._capture.arrival_offset(t_submit), 6
                ),
                **{
                    k: kwargs.get(k)
                    for k in (
                        "max_new_tokens", "eos_id", "temperature",
                        "top_k", "top_p", "seed", "adapter",
                    )
                },
            )
        return rid

    # -- block shipping & live migration -------------------------------

    @staticmethod
    def _supports_blocks(handle: _Handle) -> bool:
        return (
            getattr(handle.replica, "export_blocks", None) is not None
            and getattr(handle.replica, "import_blocks", None)
            is not None
        )

    def _count_xfer_bytes(self, payload: dict) -> None:
        """Wire-byte accounting for one brokered transfer payload:
        decoded tile bytes per storage dtype (b64 carries 4 chars per
        3 bytes), into `router_xfer_bytes_total{dtype}` and the
        `stats()` tally — the measurement behind the int8 pools'
        claimed ~2x wire saving (scale-f32 tiles count under their
        own `float32` dtype, the honest denominator)."""
        per_dtype: dict[str, int] = {}
        for t in payload.get("tiles", []) + payload.get(
            "draft_tiles", []
        ):
            dtype_name = str(t.get("dtype", "unknown"))
            per_dtype[dtype_name] = (
                per_dtype.get(dtype_name, 0)
                + len(t.get("data", "")) * 3 // 4
            )
        for dtype_name, nbytes in per_dtype.items():
            if nbytes:
                self.obs.xfer_bytes.inc(
                    nbytes, labels={"dtype": dtype_name}
                )
                self._xfer_bytes[dtype_name] = (
                    self._xfer_bytes.get(dtype_name, 0) + nbytes
                )

    def _ship(self, src: _Handle, dst: _Handle, prompt) -> None:
        """Broker one prefix-block transfer: export the prompt's
        chain of block hashes from `src`, import into `dst`. Best
        effort — a replica pair without the seam (fakes, old pods) or
        a source whose blocks were evicted ships nothing, and a
        transport error never fails the request the ship was
        for (the destination just pays the cold prefill the ship
        would have saved)."""
        if not (
            self._supports_blocks(src) and self._supports_blocks(dst)
        ):
            return
        t0 = time.monotonic()
        try:
            payload = src.replica.export_blocks(chain_hashes(prompt))
            if not payload.get("blocks"):
                self.obs.xfer_ships.inc(labels={"outcome": "empty"})
                return
            # Bytes count at the export/import seam: the payload has
            # left the source whatever the import's fate.
            self._count_xfer_bytes(payload)
            result = dst.replica.import_blocks(payload)
        except Exception as err:  # noqa: BLE001 — transport seam
            self.obs.xfer_ships.inc(labels={"outcome": "error"})
            self.obs.xfer_failures.inc(labels={"kind": "ship"})
            self.trace.event(
                "ship_failed", time.monotonic(), src=src.name,
                dst=dst.name, error=str(err),
            )
            return
        imported = int(result.get("imported", 0))
        self.obs.xfer_ships.inc(labels={"outcome": "ok"})
        self.obs.xfer_blocks_shipped.inc(imported)
        self.trace.event(
            "ship_blocks", t0, src=src.name, dst=dst.name,
            offered=len(payload["blocks"]), imported=imported,
        )

    def _remap(self, src: _Handle, dst: _Handle, landed) -> None:
        """Re-point in-flight routes after a migration: each landed
        entry (the destination's `import_resident` return) is matched
        to its router rid by the trace id the router minted at
        submit, then the route and the reverse local-rid map move to
        the destination. Records, capture rows and `/generate`
        responses keep flowing under the SAME router rid — the caller
        never learns the stream moved."""
        by_trace = {
            tid: rid
            for rid, (h, _local, tid) in self._routes.items()
            if h is src
        }
        for entry in landed:
            rid = by_trace.get(entry.get("trace_id"))
            if rid is None:
                continue
            _old_handle, old_local, tid = self._routes[rid]
            self._local.pop((id(src), old_local), None)
            self._routes[rid] = (dst, entry["rid"], tid)
            self._local[(id(dst), entry["rid"])] = rid

    def _migrate_residents(self, handle: _Handle) -> None:
        """Drain-down evacuation: export EVERYTHING the draining
        replica owns (queued, mid-prefill, mid-decode) and land it on
        the least-loaded migration-capable peer. If no peer can take
        the payload (capacity precheck raises), it re-imports into
        the SOURCE — `import_resident` bypasses the drain gate — so a
        failed migration degrades to the classic finish-resident-work
        drain with zero dropped requests."""
        replica = handle.replica
        try:
            payload = replica.export_resident()
        except Exception:  # noqa: BLE001
            self.obs.xfer_failures.inc(labels={"kind": "migrate"})
            return
        moved = len(payload.get("migrate", ())) + len(
            payload.get("resubmit", ())
        )
        if not moved:
            return
        self._count_xfer_bytes(payload)
        targets = sorted(
            (
                h for h in self._handles
                if h is not handle
                and not h.replica.draining
                and getattr(h.replica, "supports_migration", False)
            ),
            key=self._load,
        )
        for dst in targets:
            try:
                landed = dst.replica.import_resident(payload)
            except RuntimeError:
                continue
            self._remap(handle, dst, landed)
            self.obs.xfer_migrations.inc(
                len(landed), labels={"outcome": "moved"}
            )
            self.trace.event(
                "migrate_residents", time.monotonic(),
                src=handle.name, dst=dst.name, requests=len(landed),
            )
            return
        # No peer could take it: put the work back where it was.
        landed = replica.import_resident(payload)
        self._remap(handle, handle, landed)
        self.obs.xfer_migrations.inc(
            len(landed), labels={"outcome": "returned"}
        )
        self.trace.event(
            "migrate_returned", time.monotonic(), src=handle.name,
            requests=len(landed),
        )

    def _pick_decode(self, key: int | None) -> _Handle | None:
        """Stage-two placement: decode-capable, non-draining,
        migration-capable members, prefix-affine with the same
        overload/imbalance yield as stage-agnostic affinity — a hot
        decode replica sheds templates to a meaningfully cooler one
        and the map re-points."""
        candidates = [
            h for h in self._handles
            if h.can_decode()
            and not h.replica.draining
            and getattr(h.replica, "supports_migration", False)
        ]
        if not candidates:
            return None
        if key is not None:
            handle = self._decode_affinity.get(key)
            if handle is not None and handle in candidates:
                load = self._load(handle)
                if load < self.affinity_overload:
                    return handle
                alt = self._two_choices(candidates)
                if load - self._load(alt) >= self.affinity_imbalance:
                    self._decode_affinity[key] = alt
                    return alt
                return handle
        handle = self._two_choices(candidates)
        if key is not None:
            self._decode_affinity[key] = handle
        return handle

    def _decode_handoff(self) -> None:
        """Stage boundary of the disaggregated fleet, run every
        step: each prefill-only replica's decode-ready streams (first
        token committed — prefill work done) are exported one request
        at a time and imported into their decode placement, KV blocks
        and sampler state riding the payload; the route re-points so
        the stream's record flows from the decode replica under the
        original router rid. A failed import leaves the stream
        decoding on the prefill replica — correctness never depends
        on the handoff."""
        for handle in self._handles:
            if handle.role != "prefill":
                continue
            replica = handle.replica
            if not getattr(replica, "supports_migration", False):
                continue
            for local in replica.decode_ready_rids():
                rid = self._local.get((id(handle), local))
                if rid is None:
                    continue  # submitted around the router
                dst = self._pick_decode(self._decode_key.get(rid))
                if dst is None or dst is handle:
                    continue
                payload = replica.export_resident(only=[local])
                if not payload.get("migrate"):
                    continue
                self._count_xfer_bytes(payload)
                try:
                    landed = dst.replica.import_resident(payload)
                except RuntimeError:
                    # Destination had no capacity: the stream is
                    # already off the source's slots, so it goes
                    # straight back (import_resident bypasses any
                    # drain gate) and finishes where it started.
                    self.obs.xfer_failures.inc(
                        labels={"kind": "migrate"}
                    )
                    landed = replica.import_resident(payload)
                    self._remap(handle, handle, landed)
                    continue
                self._remap(handle, dst, landed)
                self.obs.xfer_migrations.inc(
                    len(landed), labels={"outcome": "decode"}
                )
                self.trace.event(
                    "decode_handoff", time.monotonic(),
                    src=handle.name, dst=dst.name,
                    trace_id=self._routes[rid][2],
                )

    # -- the drive loop ------------------------------------------------

    def _collect(self, handle: _Handle) -> None:
        for local, record in handle.replica.drain_done_records().items():
            rid = self._local.pop((id(handle), local), None)
            if rid is None:
                continue  # a request submitted around the router
            route = self._routes.pop(rid, None)
            self._decode_key.pop(rid, None)
            record = dict(record)
            record["replica"] = handle.name
            # The router's minted id is authoritative (a replica that
            # echoes one echoes this same value; one that doesn't —
            # a bare fake, an old pod — still yields a correlatable
            # record).
            if route is not None:
                record["trace_id"] = route[2]
            self.trace.collected(rid, time.monotonic())
            if self._capture is not None:
                # A FAILED replica request (tokens None + error) must
                # not masquerade as a clean zero-token completion:
                # tokens/digest stay null and the error rides along —
                # the incident timeline is what this capture is FOR.
                tokens = record.get("tokens")
                self._capture.record_done(
                    rid=rid,
                    trace_id=record.get("trace_id"),
                    replica=handle.name,
                    tokens=list(tokens) if tokens is not None else None,
                    n_tokens=len(tokens) if tokens is not None else 0,
                    digest=(
                        token_digest(tokens)
                        if tokens is not None else None
                    ),
                    ttft_s=record.get("ttft_s"),
                    wall_s=record.get("wall_s"),
                    truncated=record.get("truncated", False),
                    fingerprint=record.get("fingerprint"),
                    adapter=record.get("adapter"),
                    error=record.get("error"),
                )
            self._done[rid] = record

    def step(self) -> bool:
        """One fleet turn: advance every replica (draining ones
        included — their resident work is what a drain waits for),
        collect finished records, tick the reconciler, refresh the
        fleet gauges. True while any replica still has work."""
        for handle in list(self._handles):
            handle.replica.step()
            self._collect(handle)
        if self.disaggregated:
            self._decode_handoff()
        if self._reconciler is not None:
            self._reconciler.tick(self)
        self._refresh_gauges()
        return self.has_work

    def run(self) -> dict[int, list[int]]:
        """Drive until every routed request finishes."""
        out: dict[int, list[int]] = {}
        while self.has_work:
            self.step()
            out.update(self.drain_done())
        out.update(self.drain_done())
        return out

    @property
    def has_work(self) -> bool:
        return bool(self._routes) or any(
            h.replica.has_work for h in self._handles
        )

    def drain_done_records(self) -> dict[int, dict]:
        done, self._done = self._done, {}
        return done

    def drain_done(self) -> dict[int, list[int]]:
        return {
            rid: rec["tokens"]
            for rid, rec in self.drain_done_records().items()
        }

    # -- telemetry -----------------------------------------------------

    def _set_replica_gauges(self) -> None:
        active = self.active_handles()
        draining = [
            h for h in self._handles if h.replica.draining
        ]
        self.obs.replicas_gauge.set(
            len(active), labels={"state": "active"}
        )
        self.obs.replicas_gauge.set(
            len(draining), labels={"state": "draining"},
        )

    def _refresh_gauges(self) -> None:
        self._set_replica_gauges()
        self.obs.queue_depth.set(
            sum(h.replica.queue_depth for h in self._handles)
        )
        for handle in self._handles:
            sat = handle.replica.saturation
            if sat is not None:
                self.obs.replica_saturation.set(
                    sat, labels={"replica": handle.name}
                )
        rate = self.prefix_hit_rate
        if rate is not None:
            self.obs.prefix_hit_rate.set(round(rate, 4))
        # The fleet plane's heavier pass (per-replica signal reads,
        # anomaly scoring, scrape-error deltas, SLO-breach edges) is
        # throttled like the engine's SLO gauge refresh — its inputs
        # are windowed quantities that move on ~second scales, and
        # computing them per step would tax the driver loop for no
        # added signal.
        if not self.obs.enabled and self._anomaly is None:
            return
        now = time.monotonic()
        if now >= self._fleet_refresh_at:
            self._fleet_refresh_at = now + self.fleet_refresh_s
            self._refresh_fleet(now)

    def _refresh_fleet(self, now: float) -> None:
        handles = list(self._handles)
        # The anomaly/signal half of the plane reads ACTIVE replicas
        # only: a draining member serves no traffic, so its skewed
        # tail windows must neither flag it (a flight bundle per
        # scale-down) nor contaminate the leave-one-out peer median
        # the healthy replicas are judged against. Scrape-error
        # accounting below still covers every handle — a flapping
        # pod's history matters through its drain.
        active = [h for h in handles if not h.replica.draining]
        self.obs.fleet_capacity.set(sum(
            int(getattr(h.replica, "slots", 0) or 0) for h in active
        ))
        signals: dict[str, dict] = {}
        for handle in active:
            read = getattr(handle.replica, "obs_signals", None)
            sig = None
            if read is not None:
                try:
                    sig = read()
                except Exception:  # noqa: BLE001 — telemetry read
                    sig = None
            signals[handle.name] = sig or {}
        rooflines = [
            signals[h.name].get("roofline_fraction")
            for h in active
            if signals[h.name].get("roofline_fraction") is not None
        ]
        if len(rooflines) >= 2:
            self.obs.roofline_spread.set(
                round(max(rooflines) - min(rooflines), 4)
            )
        else:
            # Under two reporters the spread is undefined: drop the
            # series rather than exporting the last two-replica value
            # as a live "degraded shard" signal forever.
            self.obs.roofline_spread.remove()
        # Scrape-error deltas -> the labeled counter (the adapter
        # counts locally; the router reflects growth since its last
        # look, so counter semantics survive the polling shape).
        for handle in handles:
            read = getattr(
                handle.replica, "scrape_error_stats", None
            )
            if read is None:
                continue
            counts = (read() or {}).get("counts") or {}
            for kind, count in counts.items():
                seen = handle.scrape_seen.get(kind, 0)
                if count > seen:
                    self.obs.scrape_errors.inc(
                        count - seen,
                        labels={"replica": handle.name, "kind": kind},
                    )
                    handle.scrape_seen[kind] = count
        # Straggler scoring + flight-recorder triggers.
        if self._anomaly is not None:
            verdicts = self._anomaly.update(signals)
            for handle in handles:
                verdict = verdicts.get(handle.name) or {
                    "score": 0.0, "flagged": False,
                }
                was_flagged = handle.anomaly.get("flagged", False)
                handle.anomaly = verdict
                self.obs.replica_anomaly.set(
                    1.0 if verdict["flagged"] else 0.0,
                    labels={"replica": handle.name},
                )
                self.obs.replica_anomaly_score.set(
                    verdict["score"],
                    labels={"replica": handle.name},
                )
                # The load penalty is gated on the FLAG, then scaled
                # by the score: routing for a healthy fleet is
                # byte-identical to the pre-plane router (sub-flag
                # scores are expected timing spread, and a continuous
                # penalty would let CPU noise push an affinity target
                # over the overload check and migrate templates for
                # nothing), while a flagged straggler sheds share in
                # proportion to how sick it looks.
                self._penalty[handle.name] = (
                    self.anomaly_penalty
                    * min(
                        1.0,
                        max(0.0, verdict["score"])
                        / self._anomaly.threshold,
                    )
                ) if verdict["flagged"] else 0.0
                if verdict["flagged"] and not was_flagged:
                    self.trace.event(
                        "anomaly_flagged", now,
                        replica=handle.name,
                        score=verdict["score"],
                        signals=verdict.get("signals", {}),
                    )
                    self._flight_dump(
                        "anomaly", handle, now, signals,
                        extra={"anomaly": verdicts},
                    )
                elif was_flagged and not verdict["flagged"]:
                    self.trace.event(
                        "anomaly_cleared", now,
                        replica=handle.name,
                        score=verdict["score"],
                    )
        # Windowed SLO breach edges: dump once per False transition,
        # not once per breached tick (active members only — a
        # draining replica's tail breach is the drain, not news).
        for handle in active:
            ok = handle.replica.slo_ok
            if ok is False and not handle.slo_was_false:
                handle.slo_was_false = True
                self._flight_dump("slo_breach", handle, now, signals)
            elif ok is not False:
                handle.slo_was_false = False

    def _flight_dump(
        self,
        trigger: str,
        handle: _Handle,
        now: float,
        signals: dict,
        extra: dict | None = None,
    ) -> None:
        """One flight-recorder bundle: the suspect replica's
        debug_state, the fleet snapshot, every replica's windowed
        signals, and the recent router trace ring — captured AT the
        flip, because the state is gone by the time a human looks."""
        if self.flight is None:
            return
        debug_state = None
        read = getattr(handle.replica, "debug_state", None)
        if read is not None:
            try:
                debug_state = read()
            except Exception as e:  # noqa: BLE001 — best-effort capture
                debug_state = {"error": str(e)}
        payload = {
            "replica": handle.name,
            "at_unix_s": time.time(),
            "fleet": self.stats(),
            "window_signals": signals,
            "debug_state": debug_state,
            "trace_ring": self.trace.ring.snapshot()[-256:],
            **(extra or {}),
        }
        path = self.flight.dump(trigger, payload, now=now)
        if path is not None:
            self.obs.flight_dumps.inc(labels={"trigger": trigger})
            self.trace.event(
                "flight_dump", now, trigger=trigger,
                replica=handle.name, path=path,
            )

    def anomaly_flagged_names(self) -> list[str]:
        """Currently flagged replicas — the reconciler's drain-victim
        hint (a straggler is the first candidate to rotate out when
        the fleet scales down)."""
        return [
            h.name for h in self._handles
            if h.anomaly.get("flagged")
        ]

    def federated_metrics(self) -> str:
        """The fleet's `/metrics` text: the router's own `router_*`
        registry followed by every current replica's engine series
        re-exported under a `replica` label
        (`obs/federation.federate`). Retired replicas stop being
        sources, so their series drop from the very next render, as
        the per-replica gauges do. Reads only registries
        (lock-guarded), so another thread may call it beside the
        driver."""
        own = self.obs.render()
        if not self.obs.enabled:
            return own
        sources: dict[str, str] = {}
        for handle in list(self._handles):
            read = getattr(handle.replica, "metrics_text", None)
            if read is None:
                continue
            try:
                text = read()
            except Exception:  # noqa: BLE001 — telemetry read
                continue
            if text:
                sources[handle.name] = text
        return own + federate(sources)

    def fleet_trace(self) -> dict:
        """The fleet's Chrome trace: the router's spans merged with
        every current replica's export into one clock-aligned
        timeline (`obs/federation.merge_fleet_trace`; per-replica
        offsets come from each adapter's `clock_offset_s()`, exactly
        0 in process)."""
        replicas = []
        for handle in list(self._handles):
            read = getattr(handle.replica, "chrome_trace", None)
            if read is None:
                continue
            try:
                trace = read()
            except Exception:  # noqa: BLE001 — debug read
                trace = None
            if not trace:
                continue
            offset = getattr(
                handle.replica, "clock_offset_s", None
            )
            replicas.append({
                "name": handle.name,
                "trace": trace,
                "offset_s": offset() if offset is not None else 0.0,
            })
        return merge_fleet_trace(self.trace.chrome_trace(), replicas)

    @property
    def prefix_hit_rate(self) -> float | None:
        """Fleet-level prefix-cache block hit rate: hits over
        lookupable blocks summed across live AND retired replicas —
        the metric prefix-affinity routing exists to raise."""
        hits, lookups = self._retired_hits, self._retired_lookups
        for handle in self._handles:
            h, lk = handle.prefix_tallies()
            hits += h
            lookups += lk
        return hits / lookups if lookups else None

    @property
    def capture(self) -> CaptureLog | None:
        """The fleet capture log (None when not armed)."""
        return self._capture

    def capture_stats(self) -> dict:
        """Fleet capture status (same shape as the engine's `capture_stats()`; the
        fleet header fingerprint id stands in for the engine's)."""
        if self._capture is None:
            return {"enabled": False, "fingerprint": None}
        fp = self._capture.fingerprint or {}
        return {
            "enabled": True,
            "fingerprint": fp.get("id"),
            **self._capture.stats(),
        }

    def scale_events(self) -> dict[str, int]:
        return {
            d: int(self.obs.scale_events.value(
                labels={"direction": d}
            ))
            for d in ("up", "down", "denied")
        }

    def stats(self) -> dict:
        """One fleet snapshot: membership, per-replica signals and
        routed counts, affinity-map size, fleet prefix hit rate, and
        the scale-event tallies."""
        rate = self.prefix_hit_rate

        def scrape(h: _Handle):
            read = getattr(h.replica, "scrape_error_stats", None)
            return read() if read is not None else None

        return {
            **({} if self.obs.enabled else {"obs_disabled": True}),
            "policy": self.policy,
            "replicas": [
                {
                    "name": h.name,
                    "role": h.role,
                    "draining": h.replica.draining,
                    "saturation": h.replica.saturation,
                    "slo_ok": h.replica.slo_ok,
                    "queue_depth": h.replica.queue_depth,
                    "has_work": h.replica.has_work,
                    "routed": h.routed,
                    # Fleet plane: straggler verdict + (HTTP) scrape
                    # health — None for adapters without scrapes.
                    "anomaly": (
                        dict(h.anomaly)
                        if self._anomaly is not None else None
                    ),
                    "scrape": scrape(h),
                }
                for h in self._handles
            ],
            "active": len(self.active_handles()),
            "draining": len(self.draining_handles()),
            "affinity_keys": len(self._affinity),
            "prefix_hit_rate": (
                round(rate, 4) if rate is not None else None
            ),
            "scale_events": self.scale_events(),
            "in_flight": len(self._routes),
            "xfer_bytes": dict(self._xfer_bytes),
            "anomaly_flagged": self.anomaly_flagged_names(),
            "flight_dir": (
                self.flight.dir if self.flight is not None else None
            ),
            "canary": self.canary_stats(),
        }

    def canary_stats(self) -> dict | None:
        """The shadow plane's status: None, as the JAX router's reads
        when no canary was ever armed (the canary role is not
        ported)."""
        return None
