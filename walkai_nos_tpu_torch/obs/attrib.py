"""Per-dispatch device-time attribution for the serving engine.

Port of `walkai_nos_tpu/obs/attrib.py`. The engine's step time has three
owners: the device program, the host's dispatch assembly, and whatever
the pipelining hides. This layer separates them live, host-side at the
sync the engine already makes:

- `classify_dispatch`: each dispatch is labelled by what its step
  program carried (decode, prefill, mixed, spec, spec_prefill);
- host against device: the engine measures the host seconds it spent
  assembling the dispatch and the seconds it then blocked at the sync.
  Under the pipelined chunk the blocked wait is the residual device
  time the host could not overlap; a speculative round or a fold is
  synchronous, so there it is the whole device run;
- the cost model: each dispatch's device time is paired with its
  analytic HBM floor, every step re-reading the weights and the
  resident KV once at the card's published bandwidth
  (`utils/flops.hbm_bytes_per_s`; 3.35e12 B/s on the H100). Both inputs
  follow the storage dtypes: `params_hbm_bytes` counts the bytes of the
  tree the engine serves (int8 kernels with their f32 scale rows),
  `kv_hbm_bytes_per_token` the pool's storage dtype plus its scale
  rows. On the CPU there is no bandwidth, and the roofline gauge is
  never set.

The live gauges (`cb_device_step_ms`, `cb_host_overhead_frac`,
`cb_device_roofline_fraction`, `cb_device_hbm_bytes_per_step`) cover a
trailing window of dispatches; the per-kind counters and the
`cb_device_sync_seconds` histogram keep the whole history. Everything
is a no-op when the obs bundle is disabled.
"""

from __future__ import annotations

from collections import deque

__all__ = [
    "DISPATCH_KINDS",
    "DispatchAttribution",
    "classify_dispatch",
    "kv_hbm_bytes_per_token",
    "params_hbm_bytes",
    "tp_ici_bytes_per_token",
]


def params_hbm_bytes(model) -> int:
    """HBM bytes one decode step streams for the weights: the storage
    bytes of the parameters the model serves, each once (the JAX
    function sums the leaves of the same tree: an int8 model counts its
    int8 kernels and f32 scale rows). The serving `DecoderLM` holds no
    buffer besides its parameters, so nothing is counted twice."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def kv_hbm_bytes_per_token(cfg) -> int:
    """KV-cache bytes backing one resident token, from the pool's
    storage dtype: per layer, K and V each store `head_dim` elements per
    kv head at the storage item size, plus one f32 scale per row and
    head in a quantized pool ("int8-sim" too: its scale pools are
    resident). The one per-token cost the cost model, `kv_stats()` and
    `cb_kv_hbm_bytes_per_resident_token` derive from."""
    head_dim = cfg.hidden_dim // cfg.num_heads
    item = cfg.kv_storage_dtype.itemsize
    scale_bytes = 4 if cfg.kv_quant else 0
    return cfg.num_layers * 2 * cfg.kv_heads * (
        head_dim * item + scale_bytes
    )


def tp_ici_bytes_per_token(cfg) -> int:
    """Interconnect bytes one slot-token moves through the tensor-
    parallel collectives: two all-reduces per layer (out_proj and fc2),
    a ring all-reduce of an N-byte activation moving 2 (tp - 1) / tp x N
    bytes through each device. 0 at tp <= 1, the only width the port
    serves so far."""
    tp = getattr(cfg, "tp_devices", 1)
    if tp <= 1:
        return 0
    act_bytes = cfg.hidden_dim * cfg.compute_dtype.itemsize
    per_psum = 2 * (tp - 1) * act_bytes // tp
    return cfg.num_layers * 2 * per_psum


# Every value the `kind` label can take, in documentation order.
DISPATCH_KINDS = ("decode", "prefill", "mixed", "spec", "spec_prefill")


def classify_dispatch(
    busy_slots: int, lane_rows: int, spec: bool
) -> str:
    """Composition class of one dispatch: what the step program
    actually carried. `busy_slots` = slots holding a live request,
    `lane_rows` = prefill-lane rows carrying a real admission, `spec`
    = the dispatch was a speculative draft+verify round."""
    if spec:
        return "spec_prefill" if lane_rows else "spec"
    if lane_rows and busy_slots:
        return "mixed"
    if lane_rows:
        return "prefill"
    return "decode"


class DispatchAttribution:
    """Attribution recorder over a `ServingObs` bundle.

    One `record()` per dispatch, at its host sync (the only place both
    the host and device times are known). The cost model inputs are
    fixed at construction — weights are served once, KV bytes per
    token is a config constant — so the per-dispatch work is a handful
    of registry writes plus O(1) window-sum updates.
    """

    def __init__(
        self,
        obs,
        *,
        param_bytes: int = 0,
        kv_bytes_per_token: int = 0,
        hbm_bytes_per_s: float | None = None,
        ici_bytes_per_token: float = 0.0,
        window: int = 128,
    ):
        self.enabled = obs.enabled
        self._obs = obs
        # TP-aware inputs: on a tensor-parallel engine the caller
        # passes per-shard weight and KV bytes plus the per-token
        # interconnect bytes of the two per-layer all-reduces, so the
        # floor stays that of what one device does.
        self._param_bytes = float(param_bytes)
        self._kv_per_tok = float(kv_bytes_per_token)
        self._ici_per_tok = float(ici_bytes_per_token)
        self._bw = hbm_bytes_per_s or None
        if window <= 0:
            raise ValueError(f"window must be > 0; got {window}")
        self._window = window
        # Trailing window of (device_s, host_s, steps, ideal_s|None):
        # running sums maintained incrementally so a record is O(1).
        self._recent: deque[tuple] = deque()
        self._sum_device = 0.0
        self._sum_host = 0.0
        self._sum_steps = 0
        self._sum_ideal = 0.0
        self._last_bytes_per_step: float | None = None

    def record(
        self,
        *,
        kind: str,
        steps: int,
        host_s: float,
        device_s: float,
        resident_tokens: int,
        busy_slots: int = 0,
    ) -> None:
        """One dispatch: `steps` = its per-slot step window (chunk
        size for a plain chunk, k+1 for a speculative round), `host_s`
        = measured host assembly + bookkeeping, `device_s` = the
        blocked device sync, `resident_tokens` = KV-resident tokens
        at dispatch (the cost model's cache-read term), `busy_slots`
        = slots carrying a live request (the interconnect term's token
        count: each live slot moves one activation through the
        all-reduces per step)."""
        if not self.enabled:
            return
        obs = self._obs
        obs.dispatch_kind.inc(labels={"kind": kind})
        obs.device_time.inc(max(0.0, device_s), {"kind": kind})
        obs.host_time.inc(max(0.0, host_s), {"kind": kind})
        obs.device_sync.observe(device_s)
        if self._ici_per_tok:
            # Interconnect bytes one batch step moves through the TP
            # all-reduces (written on TP engines only).
            obs.ici_step_bytes.set(
                float(busy_slots) * self._ici_per_tok
            )
        ideal_s = None
        bytes_per_step = None
        if self._bw:
            # Analytic HBM floor of this dispatch: every decode step
            # re-reads the (per-shard) weights and resident KV once.
            bytes_per_step = (
                self._param_bytes + resident_tokens * self._kv_per_tok
            )
            ideal_s = steps * bytes_per_step / self._bw
            self._last_bytes_per_step = bytes_per_step
        self._recent.append((device_s, host_s, steps, ideal_s))
        self._sum_device += device_s
        self._sum_host += host_s
        self._sum_steps += steps
        self._sum_ideal += ideal_s or 0.0
        if len(self._recent) > self._window:
            d, h, st, ideal = self._recent.popleft()
            self._sum_device -= d
            self._sum_host -= h
            self._sum_steps -= st
            self._sum_ideal -= ideal or 0.0
        if self._sum_steps > 0:
            obs.device_step_ms.set(
                round(1e3 * self._sum_device / self._sum_steps, 4)
            )
        total = self._sum_device + self._sum_host
        if total > 0:
            obs.host_overhead.set(round(self._sum_host / total, 4))
        if bytes_per_step is not None:
            obs.hbm_step_bytes.set(bytes_per_step)
            if self._sum_ideal > 0 and self._sum_device > 0:
                obs.device_roofline.set(
                    round(
                        min(1.0, self._sum_ideal / self._sum_device), 4
                    )
                )

    def stats(self) -> dict:
        """Attribution view of the registry — the `/stats` `cb_attrib`
        section and the `/debug/state` `attrib` block. Same dict shape
        with telemetry off, flagged `obs_disabled`, so zeros read as
        "not recorded"."""
        obs = self._obs
        kinds = {
            kind: {
                "dispatches": int(
                    obs.dispatch_kind.value({"kind": kind})
                ),
                "device_s": round(
                    obs.device_time.value({"kind": kind}), 6
                ),
                "host_s": round(
                    obs.host_time.value({"kind": kind}), 6
                ),
            }
            for kind in DISPATCH_KINDS
        }
        return {
            **({} if self.enabled else {"obs_disabled": True}),
            "device_step_ms": obs.device_step_ms.value(),
            "host_overhead_frac": obs.host_overhead.value(),
            "roofline_fraction": obs.device_roofline.value(),
            "hbm_bytes_per_step": self._last_bytes_per_step,
            "window_dispatches": len(self._recent),
            "kinds": kinds,
        }
