"""Request-lifecycle tracing: bounded event ring + per-request spans.

Port of `walkai_nos_tpu/obs/trace.py`, whole and stdlib only: the
engine's `RequestTrace` and the fleet router's `RouterTrace` export the
same Chrome JSON as the JAX package's for the same events.

Two complementary views of the serving engine, both host-side and
bounded (a long-running server must never grow telemetry without
limit):

- **Event ring** (`Ring`): a fixed-capacity circular buffer of raw
  engine events (submits, admissions, prefill chunks, dispatches,
  errors). Wraparound overwrites the oldest entry; `snapshot()`
  returns survivors oldest-first. This is the "what just happened"
  flight recorder — cheap enough to leave on in production.
- **Lifecycle spans** (`RequestTrace`): per-request timelines
  (submit -> queued -> prefill chunk(s) -> first token -> decode ->
  done/error) keyed by request id, retained for the last
  `keep_done` finished requests. The span clock is the CALLER's
  timestamp, not a second `time.monotonic()` read: the engine passes
  the exact floats it stores on the request record, so
  `ttft_s`/`wall_s` reconstructed here equal `drain_done_records()`
  values EXACTLY (pinned by tests/test_torch_serve_obs.py) — the trace is the
  same truth, not a parallel approximation.

`chrome_trace()` exports both as Chrome trace-event JSON (the
`chrome://tracing` / Perfetto format: one process, one track per
request, duration events for the queued/prefill/decode phases,
instant events for chunks and ring entries) — load the
`/debug/trace` payload straight into a trace viewer.
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict, deque

__all__ = ["Ring", "RequestTrace", "RouterTrace", "valid_trace_id"]

# The cross-process trace-id charset contract, in ONE place: the
# router (adopting a client's X-Walkai-Trace) and the demo server
# (adopting the router's) must agree EXACTLY, or an id minted on one
# side gets rejected and re-minted on the other and the correlation
# silently breaks. An id is a label in traces, headers, and JSON —
# it must never carry arbitrary bytes.
_TRACE_ID = re.compile(r"[A-Za-z0-9._:-]{1,64}")


def valid_trace_id(value) -> str | None:
    """`value` when it is a well-formed trace id, else None (caller
    mints its own)."""
    if isinstance(value, str) and _TRACE_ID.fullmatch(value):
        return value
    return None

# Lifecycle phase names (span event keys, also the Chrome track names).
SUBMIT = "submit"
ADMITTED = "admitted"
PREFILL_CHUNK = "prefill_chunk"
FIRST_TOKEN = "first_token"
DONE = "done"
ERROR = "error"
# Speculative-serving round phases (engine-level ring events — the
# draft scan and the target verify run fused in one device dispatch,
# so the phases are markers at the round's host sync, not separately
# timed sub-spans).
SPEC_DRAFT = "spec_draft"
SPEC_VERIFY = "spec_verify"
# Per-dispatch attribution event: host-assembly vs blocked-device-sync
# durations, recorded at the dispatch's host sync (obs/attrib.py is
# the registry side; this is the trace side, rendered as duration
# events on the engine track so /debug/trace shows device vs host
# time per dispatch).
DISPATCH = "dispatch"


class Ring:
    """Fixed-capacity circular buffer. Appends are O(1); once full,
    each append overwrites the oldest entry (`dropped` counts how
    many were lost). `snapshot()` returns entries oldest-first."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0; got {capacity}")
        self.capacity = capacity
        self._buf: list = [None] * capacity
        self._next = 0  # next write position
        self._count = 0  # lifetime appends
        self._lock = threading.Lock()

    def append(self, item) -> None:
        with self._lock:
            self._buf[self._next] = item
            self._next = (self._next + 1) % self.capacity
            self._count += 1

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._count - self.capacity)

    def __len__(self) -> int:
        with self._lock:
            return min(self._count, self.capacity)

    def snapshot(self) -> list:
        with self._lock:
            if self._count <= self.capacity:
                return [x for x in self._buf[: self._count]]
            # Full: oldest sits at the write cursor.
            return self._buf[self._next:] + self._buf[: self._next]


class RequestTrace:
    """Per-request lifecycle spans + the raw event ring.

    All record methods take the event time `t` (the engine's
    `time.monotonic()` read) explicitly — see the module docstring
    for why. Completed spans are retained newest-last up to
    `keep_done`; live spans are never evicted (their count is bounded
    by the engine's slots + queue)."""

    def __init__(
        self,
        capacity: int = 4096,
        keep_done: int = 1024,
        enabled: bool = True,
    ):
        self.enabled = enabled
        self.ring = Ring(capacity)
        self._keep_done = keep_done
        self._lock = threading.Lock()
        self._spans: "OrderedDict[int, dict]" = OrderedDict()
        self._done_rids: deque[int] = deque()

    # -- recording -----------------------------------------------------

    def event(self, name: str, t: float, rid=None, **args) -> None:
        """Raw ring event (no span bookkeeping)."""
        if not self.enabled:
            return
        ev = {"name": name, "t": t}
        if rid is not None:
            ev["rid"] = rid
        if args:
            ev["args"] = args
        self.ring.append(ev)

    def submit(
        self, rid: int, t: float, prompt_len: int, max_new: int,
        trace_id: str | None = None,
    ) -> None:
        """`trace_id` is the cross-process correlation id minted by
        whatever front-end routed the request here (the fleet
        router's `X-Walkai-Trace`); the span carries it so the
        engine's lifecycle events and the router's route/queue spans
        merge under one id in the fleet `/debug/trace`."""
        if not self.enabled:
            return
        with self._lock:
            span = {
                "rid": rid,
                SUBMIT: t,
                "prompt_len": prompt_len,
                "max_new": max_new,
                "chunks": [],
            }
            if trace_id is not None:
                span["trace_id"] = trace_id
            self._spans[rid] = span
        self.event(
            SUBMIT, t, rid=rid, prompt_len=prompt_len, max_new=max_new
        )

    def admitted(
        self, rid: int, t: float, slot: int, blocks: int,
        cached: int = 0,
    ) -> None:
        """`cached` = prompt tokens served from the shared prefix
        cache at admission (0 when the cache is off or cold)."""
        if not self.enabled:
            return
        with self._lock:
            span = self._spans.get(rid)
            if span is not None:
                span[ADMITTED] = t
                span["slot"] = slot
                span["blocks"] = blocks
                span["cached"] = cached
        self.event(
            ADMITTED, t, rid=rid, slot=slot, blocks=blocks,
            cached=cached,
        )

    def prefill_chunk(
        self, rid: int, t: float, consumed: int, total: int
    ) -> None:
        if not self.enabled:
            return
        with self._lock:
            span = self._spans.get(rid)
            if span is not None:
                span["chunks"].append((t, consumed))
        self.event(
            PREFILL_CHUNK, t, rid=rid, consumed=consumed, total=total
        )

    def spec_round(
        self, t: float, k: int, live_slots: int, accepted: int
    ) -> None:
        """One speculative draft-and-verify round: a draft-phase and a
        verify-phase marker on the engine track (tid 0 in the Chrome
        export). `accepted` is the round's total accepted draft
        tokens across the `live_slots` slots that carried a request —
        the per-round acceptance story a trace viewer can scrub."""
        if not self.enabled:
            return
        self.event(SPEC_DRAFT, t, k=k, live_slots=live_slots)
        self.event(
            SPEC_VERIFY, t, k=k, live_slots=live_slots,
            accepted=accepted,
        )

    def dispatch(
        self, t_sync: float, kind: str, steps: int,
        host_s: float, device_s: float,
    ) -> None:
        """One dispatch's attribution: `t_sync` is its host sync (the
        engine clock read every record in the chunk shares), `kind`
        its composition class (obs/attrib.py), `host_s` the measured
        assembly time and `device_s` the blocked device sync that
        ended at `t_sync`. The Chrome export renders these as
        back-to-back duration events on the engine track."""
        if not self.enabled:
            return
        self.event(
            DISPATCH, t_sync, kind=kind, steps=steps,
            host_ms=round(host_s * 1e3, 3),
            device_ms=round(device_s * 1e3, 3),
        )

    def first_token(self, rid: int, t: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            span = self._spans.get(rid)
            if span is not None and FIRST_TOKEN not in span:
                span[FIRST_TOKEN] = t

    def _finish_locked(self, span: dict, t: float, reason: str) -> None:
        """Close a span and evict beyond the retention bound — the ONE
        retention rule both terminal paths share. Caller holds the
        lock."""
        span[DONE] = t
        span["reason"] = reason
        self._done_rids.append(span["rid"])
        while len(self._done_rids) > self._keep_done:
            self._spans.pop(self._done_rids.popleft(), None)

    def done(
        self, rid: int, t: float, reason: str, n_tokens: int
    ) -> None:
        if not self.enabled:
            return
        with self._lock:
            span = self._spans.get(rid)
            if span is not None:
                span["n_tokens"] = n_tokens
                self._finish_locked(span, t, reason)
        self.event(DONE, t, rid=rid, reason=reason, n_tokens=n_tokens)

    def error(self, t: float, reason: str, rid=None, **args) -> None:
        """Errors may predate a request id (submit-time rejects)."""
        if not self.enabled:
            return
        if rid is not None:
            with self._lock:
                span = self._spans.get(rid)
                if span is not None:
                    self._finish_locked(span, t, f"error:{reason}")
        self.event(ERROR, t, rid=rid, reason=reason, **args)

    # -- reading -------------------------------------------------------

    def timeline(self, rid: int) -> dict | None:
        with self._lock:
            span = self._spans.get(rid)
            if span is None:
                return None
            out = dict(span)
            out["chunks"] = list(span["chunks"])
            return out

    def ttft_s(self, rid: int) -> float | None:
        """submit -> first token, from the span clock — equals the
        engine's `drain_done_records()["ttft_s"]` exactly."""
        with self._lock:
            span = self._spans.get(rid)
            if span is None or FIRST_TOKEN not in span:
                return None
            return span[FIRST_TOKEN] - span[SUBMIT]

    def wall_s(self, rid: int) -> float | None:
        with self._lock:
            span = self._spans.get(rid)
            if span is None or DONE not in span:
                return None
            return span[DONE] - span[SUBMIT]

    def spans(self) -> list[dict]:
        with self._lock:
            return [
                {**s, "chunks": list(s["chunks"])}
                for s in self._spans.values()
            ]

    # -- export --------------------------------------------------------

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (`chrome://tracing` / Perfetto).

        One process ("cb-engine"), one track (tid) per request id.
        Phases become duration events ("ph": "X"): queued
        (submit -> admitted, or -> first token when admission isn't
        traced), prefill (admitted -> first token), decode
        (first token -> done). Prefill chunks and raw ring events are
        instants ("ph": "i"). Timestamps are microseconds relative to
        the earliest event, per the format; that origin is exported
        as `otherData.clock_origin_monotonic_s` so the fleet merger
        (`obs/federation.merge_fleet_trace`) can re-base this
        process's events onto the router's clock. Span args carry the
        trace id (when the submit had one) plus the EXACT span-clock
        `ttft_s`/`wall_s` floats, so the merged timeline never
        degrades the span = record equality guarantee to microsecond
        rounding."""
        spans = self.spans()
        events = self.ring.snapshot()
        times = [s[SUBMIT] for s in spans] + [e["t"] for e in events]
        if not times:
            return {
                "traceEvents": [],
                "displayTimeUnit": "ms",
                "otherData": {"clock_origin_monotonic_s": None},
            }
        t0 = min(times)

        def us(t: float) -> int:
            return int(round((t - t0) * 1e6))

        out = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 1,
                "args": {"name": "cb-engine"},
            }
        ]
        for s in spans:
            rid = s["rid"]
            meta = {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": rid,
                "args": {"name": f"request {rid}"},
            }
            out.append(meta)
            submit = s[SUBMIT]
            admitted = s.get(ADMITTED)
            first = s.get(FIRST_TOKEN)
            done = s.get(DONE)
            trace_id = s.get("trace_id")
            id_args = (
                {} if trace_id is None else {"trace_id": trace_id}
            )
            queued_end = admitted or first or done
            if queued_end is not None:
                out.append({
                    "name": "queued",
                    "ph": "X",
                    "pid": 1,
                    "tid": rid,
                    "ts": us(submit),
                    "dur": max(0, us(queued_end) - us(submit)),
                    "args": {
                        "prompt_len": s.get("prompt_len"),
                        "max_new": s.get("max_new"),
                        **id_args,
                    },
                })
            if admitted is not None and first is not None:
                out.append({
                    "name": "prefill",
                    "ph": "X",
                    "pid": 1,
                    "tid": rid,
                    "ts": us(admitted),
                    "dur": max(0, us(first) - us(admitted)),
                    "args": {
                        "slot": s.get("slot"),
                        "blocks": s.get("blocks"),
                        "cached": s.get("cached"),
                        "chunks": len(s["chunks"]),
                        **id_args,
                    },
                })
            for t, consumed in s["chunks"]:
                out.append({
                    "name": "prefill_chunk",
                    "ph": "i",
                    "s": "t",
                    "pid": 1,
                    "tid": rid,
                    "ts": us(t),
                    "args": {"consumed": consumed},
                })
            if first is not None and done is not None:
                out.append({
                    "name": "decode",
                    "ph": "X",
                    "pid": 1,
                    "tid": rid,
                    "ts": us(first),
                    "dur": max(0, us(done) - us(first)),
                    "args": {
                        "reason": s.get("reason"),
                        "n_tokens": s.get("n_tokens"),
                        # Exact span-clock floats (== the request
                        # record's), rounding-proof through the
                        # fleet merge.
                        "ttft_s": first - submit,
                        "wall_s": done - submit,
                        **id_args,
                    },
                })
        engine_track_named = False
        for e in events:
            if e["name"] in (SUBMIT, ADMITTED, PREFILL_CHUNK, DONE):
                continue  # already represented as span structure
            if e["name"] == DISPATCH:
                # Device-vs-host attribution phases on the engine
                # track (tid 0): the blocked device sync ended at the
                # event time, the host assembly directly preceded the
                # dispatch. Rendered back to back ending at the sync —
                # under pipelining the host work actually overlapped
                # the previous chunk's device time, so the layout is
                # the attribution, not a wall-clock gantt.
                if not engine_track_named:
                    engine_track_named = True
                    out.append({
                        "name": "thread_name",
                        "ph": "M",
                        "pid": 1,
                        "tid": 0,
                        "args": {"name": "engine dispatches"},
                    })
                args = e.get("args", {})
                device_s = args.get("device_ms", 0.0) / 1e3
                host_s = args.get("host_ms", 0.0) / 1e3
                kind = args.get("kind", "?")
                out.append({
                    "name": f"host:{kind}",
                    "ph": "X",
                    "pid": 1,
                    "tid": 0,
                    "ts": max(0, us(e["t"] - device_s - host_s)),
                    "dur": max(0, us(e["t"] - device_s))
                    - max(0, us(e["t"] - device_s - host_s)),
                    "args": args,
                })
                out.append({
                    "name": f"device:{kind}",
                    "ph": "X",
                    "pid": 1,
                    "tid": 0,
                    "ts": max(0, us(e["t"] - device_s)),
                    "dur": us(e["t"]) - max(0, us(e["t"] - device_s)),
                    "args": args,
                })
                continue
            out.append({
                "name": e["name"],
                "ph": "i",
                "s": "g",
                "pid": 1,
                "tid": e.get("rid", 0),
                "ts": us(e["t"]),
                "args": e.get("args", {}),
            })
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "dropped_ring_events": self.ring.dropped,
                "clock_origin_monotonic_s": t0,
            },
        }


class RouterTrace:
    """The fleet router's side of a request's cross-process timeline:
    per-request route/queue/round-trip spans plus a bounded event ring
    the reconciler's scale events and the anomaly detector's flips
    land on — so `/debug/trace` shows autoscaler actions on the same
    timeline as the traffic that caused them.

    Mirrors `RequestTrace`'s conventions exactly: the caller passes
    every timestamp (the router's own `time.monotonic()` reads, so
    span math equals the router's bookkeeping), completed spans are
    retained newest-last up to `keep_done`, and `chrome_trace()`
    exports with the clock origin the fleet merger needs."""

    def __init__(
        self,
        capacity: int = 4096,
        keep_done: int = 1024,
        enabled: bool = True,
    ):
        self.enabled = enabled
        self.ring = Ring(capacity)
        self._keep_done = keep_done
        self._lock = threading.Lock()
        self._spans: "OrderedDict[int, dict]" = OrderedDict()
        self._done_rids: deque[int] = deque()

    def event(self, name: str, t: float, rid=None, **args) -> None:
        """Raw ring event (scale_up / drain_start / release /
        anomaly_flagged / flight_dump ... — the fleet-plane flight
        recorder's recent-history feed)."""
        if not self.enabled:
            return
        ev = {"name": name, "t": t}
        if rid is not None:
            ev["rid"] = rid
        if args:
            ev["args"] = args
        self.ring.append(ev)

    def submit(
        self,
        rid: int,
        *,
        trace_id: str,
        t_submit: float,
        t_routed: float,
        replica: str,
        policy: str,
        t_enqueue: float | None = None,
        affinity_key: int | None = None,
    ) -> None:
        """One routed request: `t_enqueue` (when the front-end queued
        it, None for direct submits) -> `t_submit` (the router picked
        it up) -> `t_routed` (the replica accepted it)."""
        if not self.enabled:
            return
        with self._lock:
            self._spans[rid] = {
                "rid": rid,
                "trace_id": trace_id,
                "enqueue": t_enqueue,
                "submit": t_submit,
                "routed": t_routed,
                "replica": replica,
                "policy": policy,
                "affinity_key": affinity_key,
            }
        self.event(
            "route", t_routed, rid=rid, trace_id=trace_id,
            replica=replica, policy=policy,
        )

    def collected(self, rid: int, t: float) -> None:
        """The replica's finished record reached the router — closes
        the round-trip span."""
        if not self.enabled:
            return
        with self._lock:
            span = self._spans.get(rid)
            if span is None or "collected" in span:
                return
            span["collected"] = t
            self._done_rids.append(rid)
            while len(self._done_rids) > self._keep_done:
                self._spans.pop(self._done_rids.popleft(), None)

    def spans(self) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self._spans.values()]

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON of the router process: one track
        per router rid (queue wait -> route decision -> replica
        round-trip duration events, each carrying the trace id and
        chosen replica in args), plus ring events as instants on a
        tid-0 "fleet events" track. Same clock-origin contract as
        `RequestTrace.chrome_trace`."""
        spans = self.spans()
        events = self.ring.snapshot()
        times = [s["submit"] for s in spans] + [
            e["t"] for e in events
        ]
        times += [
            s["enqueue"] for s in spans if s.get("enqueue") is not None
        ]
        if not times:
            return {
                "traceEvents": [],
                "displayTimeUnit": "ms",
                "otherData": {"clock_origin_monotonic_s": None},
            }
        t0 = min(times)

        def us(t: float) -> int:
            return int(round((t - t0) * 1e6))

        out: list[dict] = [{
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "args": {"name": "router"},
        }]
        for s in spans:
            rid = s["rid"]
            args = {
                "trace_id": s["trace_id"],
                "replica": s["replica"],
                "policy": s["policy"],
            }
            if s.get("affinity_key") is not None:
                args["affinity_key"] = f"{s['affinity_key']:08x}"
            out.append({
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": rid,
                "args": {"name": f"request {rid}"},
            })
            enqueue = s.get("enqueue")
            if enqueue is not None:
                out.append({
                    "name": "queue_wait",
                    "ph": "X",
                    "pid": 1,
                    "tid": rid,
                    "ts": us(enqueue),
                    "dur": max(0, us(s["submit"]) - us(enqueue)),
                    "args": args,
                })
            out.append({
                "name": "route",
                "ph": "X",
                "pid": 1,
                "tid": rid,
                "ts": us(s["submit"]),
                "dur": max(0, us(s["routed"]) - us(s["submit"])),
                "args": args,
            })
            collected = s.get("collected")
            if collected is not None:
                out.append({
                    "name": "replica_roundtrip",
                    "ph": "X",
                    "pid": 1,
                    "tid": rid,
                    "ts": us(s["routed"]),
                    "dur": max(0, us(collected) - us(s["routed"])),
                    "args": args,
                })
        if events:
            out.append({
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": 0,
                "args": {"name": "fleet events"},
            })
        for e in events:
            if e["name"] == "route":
                continue  # already represented as span structure
            out.append({
                "name": e["name"],
                "ph": "i",
                "s": "g",
                "pid": 1,
                "tid": 0,
                "ts": us(e["t"]),
                "args": e.get("args", {}),
            })
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "dropped_ring_events": self.ring.dropped,
                "clock_origin_monotonic_s": t0,
            },
        }
