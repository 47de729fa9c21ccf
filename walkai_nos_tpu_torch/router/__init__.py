"""The fleet router and its slice autoscaler: several engines behind one
surface (port of `walkai_nos_tpu/router/`).

- `router.core`: `FleetRouter`, prefix-affinity routing with a
  power-of-two-choices load fallback behind a single-engine-shaped
  `submit()` / `step()` / `drain_done_records()`; block shipping,
  disaggregated prefill / decode roles, migrate-first drains, the fleet
  capture and the fleet telemetry plane;
- `router.replica`: `EngineReplica`, an in-process `ContinuousBatcher`,
  and `HttpReplica`, a demo-server pod (`app/main.py`) over HTTP;
- `router.autoscale`: the reconciler (hysteresis and cooldown over
  `cb_saturation` / `slo_ok` / queue depth; drain-then-release
  scale-down) and `StaticSliceProvider`.

Not ported yet: the canary role and `PartitionerSliceProvider`
(ROADMAP).
"""

from walkai_nos_tpu_torch.router.autoscale import (  # noqa: F401
    Reconciler,
    ScalePolicy,
    StaticSliceProvider,
    replica_load,
)
from walkai_nos_tpu_torch.router.core import FleetRouter, prefix_key  # noqa: F401
from walkai_nos_tpu_torch.router.replica import (  # noqa: F401
    EngineReplica,
    HttpReplica,
)
