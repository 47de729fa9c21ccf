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
- `obs.attrib`: the dispatch composition classes (`classify_dispatch`);
- `obs.serving`: `ServingObs`, the bundle `models/serve.py` writes;
- `obs.capture`: the deterministic capture plane, a bounded rotating
  on-disk recorder of request inputs and completion digests behind an
  engine config fingerprint, replayed token for token by `sim/replay.py`;
- `obs.anomaly`: `FlightRecorder`, the bounded ring of JSON bundles that
  replay triage writes.

Not ported yet: the SLO windows (`obs/slo.py`), `DispatchAttribution`
and its roofline gauges, the router's bundle and the fleet federation.
"""

from walkai_nos_tpu_torch.obs.anomaly import FlightRecorder  # noqa: F401
from walkai_nos_tpu_torch.obs.attrib import (  # noqa: F401
    DISPATCH_KINDS,
    classify_dispatch,
)
from walkai_nos_tpu_torch.obs.capture import (  # noqa: F401
    CaptureLog,
    fingerprint_id,
    token_digest,
    tree_crc32,
)
from walkai_nos_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    log_buckets,
)
from walkai_nos_tpu_torch.obs.profile import ProfileHook  # noqa: F401
from walkai_nos_tpu_torch.obs.serving import ServingObs  # noqa: F401
from walkai_nos_tpu_torch.obs.trace import (  # noqa: F401
    RequestTrace,
    Ring,
    RouterTrace,
)
