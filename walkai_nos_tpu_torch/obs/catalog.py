"""The metric catalog: every metric the system exports, declared once.

Port of `walkai_nos_tpu/obs/catalog.py`, spec for spec (name, kind, help,
labels, component, buckets, attr): `obs/serving.py` builds the engine's
instruments from the `component="serving"` specs, so `models/` holds no
literal metric name, and the `router` specs wait here for the fleet
router's bundle. `tests/test_torch_obs.py` holds the catalog equal to the
JAX package's and scans the port for registrations outside it.

Dependency-free on purpose: no torch, no numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

from walkai_nos_tpu_torch.obs.metrics import log_buckets

__all__ = ["CATALOG", "MetricSpec", "router_specs", "serving_specs"]


@dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str  # counter | gauge | histogram
    help: str
    labels: tuple[str, ...] = ()
    component: str = "serving"  # serving | router | kube | install | client
    buckets: tuple[float, ...] | None = None
    attr: str = ""  # bundle attribute name (serving/router specs only)


# Sub-ms floor for decode-pace style latencies (TPOT on a fast chip is
# ~0.1-0.5 ms/token); the engine's own dispatch sync sits in the ms
# range; request walls run to the 120 s server timeout.
_FAST = log_buckets(1e-4, 10.0)
_MID = log_buckets(1e-4, 100.0)
_SLOW = log_buckets(1e-3, 100.0)

CATALOG: tuple[MetricSpec, ...] = (
    # -- serving engine (models/serve.py via obs/serving.py) -----------
    MetricSpec(
        "cb_requests_submitted_total", "counter",
        "Requests accepted by ContinuousBatcher.submit()",
        attr="submitted",
    ),
    MetricSpec(
        "cb_requests_completed_total", "counter",
        "Finished requests by termination reason",
        labels=("reason",),  # eos | budget | pool_overflow (truncated)
        attr="completed",
    ),
    MetricSpec(
        "cb_request_errors_total", "counter",
        "Failed or rejected requests by reason",
        # oversize_reject | pool_overflow | bad_request | draining |
        # generation_timeout | client_disconnect | engine_failure
        labels=("reason",),
        attr="errors",
    ),
    MetricSpec(
        "cb_tokens_emitted_total", "counter",
        "Generated tokens handed to the host across all requests",
        attr="tokens",
    ),
    MetricSpec(
        "cb_queue_depth", "gauge",
        "Requests submitted but not yet admitted to a slot",
        attr="queue_depth",
    ),
    MetricSpec(
        "cb_slots_active", "gauge",
        "Slots holding a live decoding request at the last dispatch",
        attr="slots_active",
    ),
    MetricSpec(
        "cb_prefill_lane_active", "gauge",
        "Requests mid-prefill on the chunked prefill lane",
        attr="lane_active",
    ),
    MetricSpec(
        "cb_prefill_lane_rows_total", "counter",
        "Prefill-lane rows carrying a real admission, summed over "
        "lane dispatches",
        attr="lane_rows",
    ),
    MetricSpec(
        "cb_prefill_lane_row_capacity_total", "counter",
        "Configured prefill-lane rows available, summed over lane "
        "dispatches (utilization denominator)",
        attr="lane_capacity",
    ),
    # -- sequence-parallel prefill lane (models/serve.py sp mode) ------
    MetricSpec(
        "cb_prefill_sp_requests_total", "counter",
        "Long prompts (>= sp_min_tokens) admitted onto the dedicated "
        "sequence-parallel prefill lane",
        attr="sp_requests",
    ),
    MetricSpec(
        "cb_prefill_sp_rows_total", "counter",
        "Lane rows claimed by sequence-parallel fan-out (each row one "
        "chunk window of a long prompt), summed over lane dispatches "
        "in which a long entry fanned wider than one row",
        attr="sp_rows",
    ),
    MetricSpec(
        "cb_prefill_sp_active", "gauge",
        "Sequence-parallel (long-prompt) entries currently "
        "prefilling — 0 or 1 under the dedicated-long-lane policy",
        attr="sp_active",
    ),
    MetricSpec(
        "cb_prefill_sp_holds_total", "counter",
        "Admission turns in which a long prompt waited for the "
        "dedicated long lane while shorter prompts admitted around "
        "it (the length-aware starvation protection firing)",
        attr="sp_holds",
    ),
    # -- batched multi-LoRA serving (models/lora.py via serve.py) ------
    MetricSpec(
        "cb_lora_requests_total", "counter",
        "Requests accepted by a LoRA-armed engine, by serving "
        "adapter id (0 = the base model) — the multi-tenant traffic "
        "mix; only written on armed engines",
        labels=("adapter",),
        attr="lora_requests",
    ),
    MetricSpec(
        "cb_lora_resident_adapters", "gauge",
        "Adapters resident in the engine's stacked device arrays, "
        "the base identity (id 0) included; moves on hot load/unload",
        attr="lora_resident",
    ),
    MetricSpec(
        "cb_lora_gather_dispatches_total", "counter",
        "Step-program dispatches that carried the batched "
        "adapter-gather einsums (one count per armed dispatch, "
        "whatever the batch's adapter mix — the flat-overhead "
        "denominator behind the bench's cb_lora_overhead_pct)",
        attr="lora_gather",
    ),
    MetricSpec(
        "cb_lora_adapter_load_seconds_total", "counter",
        "Cumulative host seconds spent hot-loading adapter weights "
        "(validate + fold alpha into B + re-upload of the stacked "
        "tree)",
        attr="lora_load_seconds",
    ),
    MetricSpec(
        "cb_kv_pool_blocks", "gauge",
        "Paged KV pool blocks by state (scratch block excluded)",
        labels=("state",),  # free | used | parked
        attr="pool_blocks",
    ),
    MetricSpec(
        "cb_kv_pool_blocks_min_free", "gauge",
        "Low watermark of reclaimable pool blocks (free + evictable "
        "parked) since engine start",
        attr="pool_min_free",
    ),
    MetricSpec(
        "cb_prefix_blocks_hit_total", "counter",
        "Full prompt blocks served from the shared prefix cache at "
        "admission (zero prefill compute, zero HBM writes)",
        attr="prefix_hits",
    ),
    MetricSpec(
        "cb_prefix_blocks_miss_total", "counter",
        "Full prompt blocks prefilled fresh despite being lookupable "
        "(hit-rate denominator together with hits)",
        attr="prefix_misses",
    ),
    MetricSpec(
        "cb_prefix_evictions_total", "counter",
        "Parked prefix-cache blocks evicted (LRU, leaf-first) to "
        "back new allocations",
        attr="prefix_evictions",
    ),
    MetricSpec(
        "cb_prefix_cached_tokens", "gauge",
        "Prompt tokens resident in the prefix index (shared + parked "
        "blocks x 128)",
        attr="prefix_cached_tokens",
    ),
    MetricSpec(
        "cb_prefix_prefill_tokens_saved_total", "counter",
        "Prompt tokens the chunked prefill lane skipped thanks to "
        "prefix-cache hits",
        attr="prefix_saved",
    ),
    MetricSpec(
        "cb_prefix_prompt_tokens_total", "counter",
        "Prompt tokens of requests admitted while the prefix cache "
        "is enabled (saved-fraction denominator)",
        attr="prefix_prompt_tokens",
    ),
    MetricSpec(
        "cb_spec_draft_dispatches_total", "counter",
        "Draft-model forwards dispatched by speculative serving "
        "rounds (k scan steps + 1 lookahead K/V write per round)",
        attr="spec_draft",
    ),
    MetricSpec(
        "cb_spec_verify_dispatches_total", "counter",
        "Target multi-step verify dispatches (one per speculative "
        "round)",
        attr="spec_verify",
    ),
    MetricSpec(
        "cb_spec_slot_rounds_total", "counter",
        "(live slot, speculative round) pairs — the per-slot-round "
        "denominator for acceptance and commit averages",
        attr="spec_rounds",
    ),
    MetricSpec(
        "cb_spec_proposed_tokens_total", "counter",
        "Draft tokens proposed to live slots (acceptance-rate "
        "denominator)",
        attr="spec_proposed",
    ),
    MetricSpec(
        "cb_spec_accepted_tokens_total", "counter",
        "Draft tokens the target verify accepted (acceptance-rate "
        "numerator)",
        attr="spec_accepted",
    ),
    MetricSpec(
        "cb_spec_commit_tokens_per_round", "histogram",
        "Tokens the verify committed per live slot per speculative "
        "round (accepted drafts + the bonus token, 1..k+1) — "
        "device-side counts, like every cb_spec_* acceptance metric: "
        "a round that ends its request mid-window (EOS or budget) "
        "still counts the full verified window; realized emission is "
        "cb_tokens_total",
        buckets=(1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0),
        attr="spec_emitted",
    ),
    MetricSpec(
        "cb_spec_k", "gauge",
        "Current draft length k chosen by the acceptance-adaptive "
        "controller",
        attr="spec_k_gauge",
    ),
    MetricSpec(
        "cb_spec_drafting_disabled", "gauge",
        "1 once the acceptance-adaptive controller has disabled "
        "drafting for this engine (0 while drafting)",
        attr="spec_disabled",
    ),
    MetricSpec(
        "cb_loop_dispatches_total", "counter",
        "Device-resident multi-step loop dispatches (one host sync "
        "folding up to loop_steps decode chunks or spec rounds)",
        attr="loop_dispatches",
    ),
    MetricSpec(
        "cb_loop_chunks_total", "counter",
        "Decode chunks / speculative rounds folded into "
        "device-resident loop dispatches (fold-depth numerator; "
        "denominator cb_loop_dispatches_total)",
        attr="loop_chunks",
    ),
    MetricSpec(
        "cb_loop_exits_total", "counter",
        "Device-resident loop exits by first-hit condition",
        # slot_done (EOS or budget) | unbacked (write head would
        # cross into an unbacked block) | horizon (loop_steps)
        labels=("reason",),
        attr="loop_exits",
    ),
    MetricSpec(
        "cb_loop_steps_per_sync", "gauge",
        "Per-slot device steps surfaced per device-resident loop "
        "sync, averaged over the run (the host-dispatch amortization "
        "factor the loop buys)",
        attr="loop_steps_per_sync",
    ),
    MetricSpec(
        "cb_admission_stall_seconds_total", "counter",
        "Cumulative host seconds inside admission work (dense mode: "
        "blocking prefill+admit dispatches; paged: bookkeeping only)",
        attr="stall",
    ),
    MetricSpec(
        "cb_dispatches_total", "counter",
        "Step-program dispatches issued",
        attr="dispatches",
    ),
    MetricSpec(
        "cb_dispatch_latency_seconds", "histogram",
        "Dispatch issue to host sync of its chunk (includes one "
        "chunk of pipelining overlap by design)",
        buckets=_MID,
        attr="dispatch_latency",
    ),
    MetricSpec(
        "cb_ttft_seconds", "histogram",
        "Submit to first token known to the host (its chunk sync)",
        buckets=_SLOW,
        attr="ttft",
    ),
    MetricSpec(
        "cb_tpot_seconds", "histogram",
        "Per-request mean time per output token after the first "
        "(decode pace)",
        buckets=_FAST,
        attr="tpot",
    ),
    MetricSpec(
        "cb_request_wall_seconds", "histogram",
        "Submit to completion wall time per finished request",
        buckets=_SLOW,
        attr="wall",
    ),
    MetricSpec(
        "cb_busy_slot_steps_total", "counter",
        "Slot-steps dispatched with a live request in the slot",
        attr="busy_steps",
    ),
    MetricSpec(
        "cb_slot_steps_total", "counter",
        "Slot-steps dispatched in total (occupancy denominator)",
        attr="total_steps",
    ),
    MetricSpec(
        "cb_kv_dispatch_bytes_total", "counter",
        "Sum over dispatches of KV cache bytes backing resident "
        "tokens (dispatch-weighted-average numerator)",
        attr="kv_bytes",
    ),
    MetricSpec(
        "cb_kv_dispatch_resident_tokens_total", "counter",
        "Sum over dispatches of resident tokens "
        "(dispatch-weighted-average denominator)",
        attr="kv_resident",
    ),
    MetricSpec(
        "cb_kv_bytes_per_resident_token", "gauge",
        "Latest per-dispatch snapshot of KV cache HBM bytes backing "
        "each resident token",
        attr="kv_ratio",
    ),
    MetricSpec(
        "cb_kv_cache_bytes_total", "counter",
        "KV pool backing bytes allocated at engine build, by storage "
        "dtype (quantized pools split into int8 data and their "
        "parallel f32 scale tiles; a second engine on the registry "
        "adds its own)",
        labels=("dtype",),  # int8 | bfloat16 | float32 | scale-f32
        attr="kv_cache_bytes",
    ),
    MetricSpec(
        "cb_quant_dequant_seconds_total", "counter",
        "Host seconds in quantization work (the one-time weight-tree "
        "quantization at engine build; device-side dequant is fused "
        "into the kernels and is attributed to "
        "cb_device_time_seconds_total, not here)",
        attr="quant_seconds",
    ),
    # -- capture/replay plane (obs/capture.py) -------------------------
    MetricSpec(
        "cb_capture_records_total", "counter",
        "Capture-log records written to the on-disk ring, by record "
        "kind (submit = accepted request inputs, done = completion "
        "token stream + digest)",
        labels=("kind",),  # submit | done
        attr="capture_records",
    ),
    MetricSpec(
        "cb_capture_bytes_total", "counter",
        "Capture-log bytes written (headers included; rotation may "
        "later prune whole files — this counts what was written, "
        "cb_capture_dropped_total counts what rotation lost)",
        attr="capture_bytes",
    ),
    MetricSpec(
        "cb_capture_dropped_total", "counter",
        "Capture records lost, by reason: a capture that silently "
        "lost records would masquerade as a complete incident record",
        labels=("reason",),  # rotated (pruned with an expired file) |
        # write_error (disk write failed; serving continues)
        attr="capture_dropped",
    ),
    MetricSpec(
        "cb_last_dispatch_unixtime_seconds", "gauge",
        "Unix time of the most recent engine dispatch (scrape-side "
        "staleness = now - value)",
        attr="last_dispatch",
    ),
    # -- tensor-parallel serving (models/serve.py, cfg.tp_devices) -----
    MetricSpec(
        "cb_tp_devices", "gauge",
        "Tensor-parallel shard count of the serving mesh (1 = "
        "single-chip engine; set once at engine build)",
        attr="tp_devices_gauge",
    ),
    MetricSpec(
        "cb_ici_bytes_per_step", "gauge",
        "Analytic ICI bytes one batch step moves through the "
        "tensor-parallel psums (2 per layer, ring all-reduce cost "
        "per live slot; only written on tp > 1 engines)",
        attr="ici_step_bytes",
    ),
    # -- device-time attribution (obs/attrib.py) -----------------------
    MetricSpec(
        "cb_dispatch_kind_total", "counter",
        "Dispatches by composition class",
        # decode | prefill | mixed | spec | spec_prefill
        labels=("kind",),
        attr="dispatch_kind",
    ),
    MetricSpec(
        "cb_device_time_seconds_total", "counter",
        "Cumulative blocked-device-sync seconds by dispatch "
        "composition (the device time the host could not overlap)",
        labels=("kind",),
        attr="device_time",
    ),
    MetricSpec(
        "cb_host_time_seconds_total", "counter",
        "Cumulative host dispatch-assembly seconds by dispatch "
        "composition (prologue, lane packing, program issue, "
        "epilogue bookkeeping)",
        labels=("kind",),
        attr="host_time",
    ),
    MetricSpec(
        "cb_device_sync_seconds", "histogram",
        "Blocked host time in one dispatch's device sync (the token "
        "fetch; pipelined chunks overlap part of the device time, "
        "speculative rounds are fully synchronous)",
        buckets=_MID,
        attr="device_sync",
    ),
    MetricSpec(
        "cb_device_step_ms", "gauge",
        "Device-attributed milliseconds per batch step over the "
        "trailing attribution window (device sync seconds / per-slot "
        "step window, averaged)",
        attr="device_step_ms",
    ),
    MetricSpec(
        "cb_host_overhead_frac", "gauge",
        "Host assembly fraction of total step time over the trailing "
        "attribution window (host / (host + device))",
        attr="host_overhead",
    ),
    MetricSpec(
        "cb_device_roofline_fraction", "gauge",
        "Analytic HBM-streaming floor over measured device time, "
        "trailing window (1.0 = decode runs at the memory roofline; "
        "unset on hosts with no published bandwidth)",
        attr="device_roofline",
    ),
    MetricSpec(
        "cb_device_hbm_bytes_per_step", "gauge",
        "Latest analytic HBM bytes one decode step must stream "
        "(weights + resident KV — the roofline fraction's numerator "
        "input)",
        attr="hbm_step_bytes",
    ),
    # -- sliding-window SLO / saturation (obs/slo.py) ------------------
    MetricSpec(
        "cb_slo_ttft_p50", "gauge",
        "TTFT p50 over the trailing SLO window (seconds, one "
        "log-bucket accuracy)",
        attr="slo_ttft_p50",
    ),
    MetricSpec(
        "cb_slo_ttft_p99", "gauge",
        "TTFT p99 over the trailing SLO window (seconds, one "
        "log-bucket accuracy)",
        attr="slo_ttft_p99",
    ),
    MetricSpec(
        "cb_slo_tpot_p99", "gauge",
        "Per-request decode pace p99 over the trailing SLO window "
        "(seconds per output token)",
        attr="slo_tpot_p99",
    ),
    MetricSpec(
        "cb_slo_dispatch_p99", "gauge",
        "Dispatch latency p99 over the trailing SLO window (seconds)",
        attr="slo_dispatch_p99",
    ),
    MetricSpec(
        "cb_slo_ok", "gauge",
        "1 when the labeled objective met its error budget over the "
        "window, 0 on breach (absent until the window has samples)",
        labels=("objective",),  # ttft_p99_s | tpot_p99_s
        attr="slo_ok_gauge",
    ),
    MetricSpec(
        "cb_slo_burn_rate", "gauge",
        "Error-budget burn of the labeled objective: fraction of "
        "window samples over the threshold divided by the quantile's "
        "budget (1.0 = burning exactly at budget)",
        labels=("objective",),
        attr="slo_burn",
    ),
    MetricSpec(
        "cb_saturation", "gauge",
        "Composed engine saturation in [0, 1]: max of the normalized "
        "pressure components (the router/autoscaler scale signal)",
        attr="saturation",
    ),
    MetricSpec(
        "cb_saturation_component", "gauge",
        "Normalized pressure component of cb_saturation",
        # busy | queue | queue_trend | pool
        labels=("signal",),
        attr="saturation_component",
    ),
    # -- KV block transfer plane (models/serve.py export/import) -------
    MetricSpec(
        "cb_xfer_exported_blocks_total", "counter",
        "Prefix blocks serialized out of this engine by "
        "export_blocks (ready trie nodes only; unknown or unready "
        "hashes are omitted, not counted)",
        attr="xfer_exported",
    ),
    MetricSpec(
        "cb_xfer_imported_blocks_total", "counter",
        "Prefix blocks landed in this engine's pool + trie by "
        "import_blocks (each grafted, tile-written, then parked — "
        "matchable exactly like a locally-prefilled block)",
        attr="xfer_imported",
    ),
    MetricSpec(
        "cb_xfer_import_rejected_total", "counter",
        "Imported blocks not landed, by reason",
        # dup (already resident) | orphan (parent block not resident)
        # | dry (pool exhausted even after LRU eviction) | a header
        # field name / shape / dtype / draft (incompatible payload,
        # rejects whole)
        labels=("reason",),
        attr="xfer_rejected",
    ),
    MetricSpec(
        "cb_xfer_bytes_total", "counter",
        "Decoded K/V tile bytes moved by the block-transfer plane, "
        "by direction",
        labels=("dir",),  # in | out
        attr="xfer_bytes",
    ),
    MetricSpec(
        "cb_xfer_migrated_requests_total", "counter",
        "Resident requests evacuated (dir=out, export_resident) or "
        "restored (dir=in, import_resident) by live migration — "
        "resubmitted and slot-restored requests both count",
        labels=("dir",),  # in | out
        attr="xfer_migrated",
    ),
    # -- fleet router (walkai_nos_tpu/router via obs/router.py) --------
    MetricSpec(
        "router_requests_total", "counter",
        "Requests accepted and routed by the fleet router",
        component="router",
        attr="submitted",
    ),
    MetricSpec(
        "router_routed_total", "counter",
        "Routing decisions by policy arm",
        # affinity (prefix-affinity map hit) | p2c (power-of-two-
        # choices fallback) | round_robin (baseline policy)
        labels=("policy",),
        component="router",
        attr="routed",
    ),
    MetricSpec(
        "router_requests_failed_total", "counter",
        "Requests the router could not place, by reason",
        # no_replica (fleet empty or all draining) | bad_request
        # (replica-side submit validation rejected it)
        labels=("reason",),
        component="router",
        attr="failed",
    ),
    MetricSpec(
        "router_replicas", "gauge",
        "Fleet replicas by lifecycle state",
        labels=("state",),  # active | draining
        component="router",
        attr="replicas_gauge",
    ),
    MetricSpec(
        "router_replica_saturation", "gauge",
        "Last observed composed saturation per replica (the engine's "
        "cb_saturation, read through the replica interface)",
        labels=("replica",),
        component="router",
        attr="replica_saturation",
    ),
    MetricSpec(
        "router_queue_depth", "gauge",
        "Requests submitted but not yet admitted, summed over the "
        "fleet's replicas",
        component="router",
        attr="queue_depth",
    ),
    MetricSpec(
        "router_prefix_hit_rate", "gauge",
        "Fleet-level shared-prefix block hit rate: prefix-cache hits "
        "over lookupable blocks summed across every replica that ever "
        "served (retired replicas' tallies included)",
        component="router",
        attr="prefix_hit_rate",
    ),
    MetricSpec(
        "router_scale_events_total", "counter",
        "Autoscaling reconciler actions by direction",
        # up (slice acquired, replica joined) | down (drain initiated)
        # | denied (scale-up wanted, provider had no capacity)
        labels=("direction",),
        component="router",
        attr="scale_events",
    ),
    # -- fleet observability plane (obs/anomaly.py, obs/federation.py) -
    MetricSpec(
        "router_fleet_capacity_slots", "gauge",
        "Decode slots summed over active (non-draining) replicas — "
        "the fleet's aggregate admission capacity",
        component="router",
        attr="fleet_capacity",
    ),
    MetricSpec(
        "router_roofline_fraction_spread", "gauge",
        "Max minus min of per-replica cb_device_roofline_fraction "
        "across active replicas (absent until two replicas report; a "
        "wide spread singles out one degraded replica or TP shard "
        "where the fleet mean dilutes it)",
        component="router",
        attr="roofline_spread",
    ),
    MetricSpec(
        "router_replica_anomaly", "gauge",
        "1 while the replica is flagged as a fleet straggler by the "
        "EWMA z-score detector (obs/anomaly.py), else 0; dropped at "
        "retirement like every per-replica series",
        labels=("replica",),
        component="router",
        attr="replica_anomaly",
    ),
    MetricSpec(
        "router_replica_anomaly_score", "gauge",
        "EWMA z-score of the replica's windowed dispatch p99 / "
        "device step ms / roofline fraction against the peer median "
        "(higher = worse; the routing load penalty's input)",
        labels=("replica",),
        component="router",
        attr="replica_anomaly_score",
    ),
    MetricSpec(
        "router_replica_scrape_errors_total", "counter",
        "Failed HTTP replica telemetry scrapes by endpoint kind — a "
        "flapping pod shows up here instead of silently reading as "
        "unreachable",
        labels=("replica", "kind"),  # healthz | stats | metrics
        component="router",
        attr="scrape_errors",
    ),
    MetricSpec(
        "router_flight_dumps_total", "counter",
        "Flight-recorder bundles written to the on-disk ring, by "
        "trigger",
        labels=("trigger",),  # anomaly | slo_breach
        component="router",
        attr="flight_dumps",
    ),
    # -- router block-shipping / migration (router/core.py) ------------
    MetricSpec(
        "router_xfer_ships_total", "counter",
        "Block-shipping transfers the router brokered (one source "
        "export landed in one destination import), by outcome",
        labels=("outcome",),  # ok | empty (nothing to ship) | error
        component="router",
        attr="xfer_ships",
    ),
    MetricSpec(
        "router_xfer_blocks_shipped_total", "counter",
        "Prefix blocks the destination replica reported imported "
        "across all router-brokered ships",
        component="router",
        attr="xfer_blocks_shipped",
    ),
    MetricSpec(
        "router_xfer_bytes_total", "counter",
        "Decoded K/V tile payload bytes moved by router-brokered "
        "block ships, by tile storage dtype (int8 pools ship their "
        "data tiles at ~2x fewer bytes than bf16; their f32 scale "
        "tiles count under their own dtype) — the wire-saving "
        "measurement for quantized shipping",
        labels=("dtype",),
        component="router",
        attr="xfer_bytes",
    ),
    MetricSpec(
        "router_xfer_failures_total", "counter",
        "Router-brokered transfers that raised on either side, by "
        "kind",
        labels=("kind",),  # ship (prefix blocks) | migrate (resident)
        component="router",
        attr="xfer_failures",
    ),
    MetricSpec(
        "router_xfer_migrations_total", "counter",
        "Resident requests the router moved between replicas via "
        "export_resident/import_resident, by outcome",
        # moved (drain evacuation landed on a peer) | returned (no
        # peer could take them; re-imported into the draining
        # source) | decode (two-stage handoff: a prefill replica's
        # first-token stream moved to its decode placement)
        labels=("outcome",),
        component="router",
        attr="xfer_migrations",
    ),
    # -- shadow/canary plane (router/core.py via obs/canary.py) --------
    MetricSpec(
        "router_canary_mirrored_total", "counter",
        "Live submits mirrored to the canary replica (the sampled "
        "shadow copies; the primary's response serves the user)",
        component="router",
        attr="canary_mirrored",
    ),
    MetricSpec(
        "router_canary_compared_total", "counter",
        "Primary/mirror completion pairs compared at the completion "
        "seam, by result",
        # match (digest-identical streams) | divergent (token values
        # differ inside the common prefix) | latency_only (config
        # delta declares the serving function moved; no digest gate)
        # | mirror_error (the canary side failed — operational, not a
        # divergence)
        labels=("result",),
        component="router",
        attr="canary_compared",
    ),
    MetricSpec(
        "router_canary_divergence_total", "counter",
        "Mirrored completions whose token stream diverged from the "
        "primary's under an armed digest-exact gate — each one dumps "
        "a flight bundle and rejects the canary",
        component="router",
        attr="canary_divergence",
    ),
    MetricSpec(
        "router_canary_mirror_errors_total", "counter",
        "Mirror submits or completions that failed on the canary "
        "side (submit rejected, replica error) — counted apart from "
        "divergences because a sick canary is operational news, not "
        "a correctness verdict",
        component="router",
        attr="canary_mirror_errors",
    ),
    MetricSpec(
        "router_canary_verdict", "gauge",
        "Canary verdict machine state (1 on the current state, 0 on "
        "the rest)",
        labels=("state",),  # warming | observing | promote | reject
        component="router",
        attr="canary_verdict",
    ),
    MetricSpec(
        "router_canary_latency_delta_pct", "gauge",
        "Windowed canary-minus-primary latency delta as a percent of "
        "the primary's quantile (positive = canary slower), per "
        "latency metric",
        labels=("metric",),  # ttft_p99 | tpot_p99
        component="router",
        attr="canary_latency_delta",
    ),
    # -- kube binaries (kube/runtime.py via health.Metrics) ------------
    MetricSpec(
        "nos_reconcile_total", "counter",
        "Reconciliations per controller and outcome",
        labels=("controller", "result"),
        component="kube",
    ),
    MetricSpec(
        "nos_reconcile_seconds_sum", "counter",
        "Cumulative reconcile wall time",
        labels=("controller",),
        component="kube",
    ),
    # -- demo bench client (demos/tpu-sharing-comparison/client) -------
    MetricSpec(
        "inference_time_seconds_sum", "counter",
        "Cumulative inference seconds per target (summary numerator; "
        "reference-repo comparison query shape)",
        labels=("target",),
        component="client",
    ),
    MetricSpec(
        "inference_time_seconds_count", "counter",
        "Completed inference requests per target (summary denominator)",
        labels=("target",),
        component="client",
    ),
    MetricSpec(
        "inference_errors_total", "counter",
        "Failed inference requests per target",
        labels=("target",),
        component="client",
    ),
    # -- install exporter (cmd/metricsexporter.py) ---------------------
    MetricSpec(
        "nos_install_info", "gauge",
        "Install identity (value is always 1)",
        labels=("installation_uuid",),
        component="install",
    ),
    MetricSpec(
        "nos_install_component_enabled", "gauge",
        "1 if the chart component is enabled, else 0",
        labels=("component",),
        component="install",
    ),
    MetricSpec(
        "nos_install_node_capacity", "gauge",
        "Node capacity by resource, parsed from the Kube quantity",
        labels=("node", "resource"),
        component="install",
    ),
    MetricSpec(
        "nos_install_nodes", "gauge",
        "Nodes in the install inventory",
        component="install",
    ),
)


def serving_specs() -> tuple[MetricSpec, ...]:
    return tuple(s for s in CATALOG if s.component == "serving")


def router_specs() -> tuple[MetricSpec, ...]:
    return tuple(s for s in CATALOG if s.component == "router")


def _check() -> None:
    names = [s.name for s in CATALOG]
    if len(names) != len(set(names)):
        raise ValueError("duplicate metric names in CATALOG")
    for component, specs in (
        ("serving", serving_specs()),
        ("router", router_specs()),
    ):
        attrs = [s.attr for s in specs]
        if "" in attrs or len(attrs) != len(set(attrs)):
            raise ValueError(
                f"{component} specs need unique non-empty attrs"
            )


_check()
