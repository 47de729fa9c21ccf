"""The port's observability planes (the JAX package's
`walkai_nos_tpu/obs/`), host-side and jax-free:

- `obs.metrics`: counters, gauges and log-bucketed histograms with
  Prometheus text exposition (`Registry`);
- `obs.catalog`: every exported metric, declared once (`CATALOG`);
- `obs.trace`: the bounded event ring and per-request lifecycle spans
  with Chrome trace-event export (`RequestTrace`), and the fleet
  router's `RouterTrace`;
- `obs.profile`: the `torch.profiler` capture window gated on the
  engine's dispatches (`ProfileHook`);
- `obs.attrib`: dispatch composition classes and `DispatchAttribution`,
  the host / device split of every dispatch against its analytic HBM
  floor (`params_hbm_bytes`, `kv_hbm_bytes_per_token`);
- `obs.slo`: the sliding-window SLO views, burn rates and the composed
  saturation signal (`BucketRing`, `SloTracker`);
- `obs.serving`: `ServingObs`, the bundle `models/serve.py` writes;
- `obs.router`: `RouterObs`, the fleet router's bundle;
- `obs.federation`: per-replica metrics federated under a `replica`
  label and the fleet's merged Chrome trace;
- `obs.capture`: the deterministic capture plane, a bounded rotating
  on-disk recorder of request inputs and completion digests behind an
  engine config fingerprint, replayed token for token by `sim/replay.py`;
- `obs.anomaly`: the fleet's straggler scoring (`AnomalyDetector`) and
  `FlightRecorder`, the bounded ring of JSON bundles.

Not ported yet: the shadow / canary plane (`obs/canary.py`).
"""

from walkai_nos_tpu_torch.obs.anomaly import (  # noqa: F401
    AnomalyDetector,
    FlightRecorder,
)
from walkai_nos_tpu_torch.obs.attrib import (  # noqa: F401
    DISPATCH_KINDS,
    DispatchAttribution,
    classify_dispatch,
    kv_hbm_bytes_per_token,
    params_hbm_bytes,
)
from walkai_nos_tpu_torch.obs.capture import (  # noqa: F401
    CaptureLog,
    fingerprint_id,
    token_digest,
    tree_crc32,
)
from walkai_nos_tpu_torch.obs.federation import (  # noqa: F401
    FEDERATED_PREFIXES,
    federate,
    merge_fleet_trace,
    parse_exposition,
)
from walkai_nos_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    log_buckets,
)
from walkai_nos_tpu_torch.obs.profile import ProfileHook  # noqa: F401
from walkai_nos_tpu_torch.obs.router import RouterObs  # noqa: F401
from walkai_nos_tpu_torch.obs.serving import ServingObs  # noqa: F401
from walkai_nos_tpu_torch.obs.slo import BucketRing, SloTracker  # noqa: F401
from walkai_nos_tpu_torch.obs.trace import (  # noqa: F401
    RequestTrace,
    Ring,
    RouterTrace,
)
