"""The port's observability planes, so far the ones the capture plane
needs (the JAX package's `walkai_nos_tpu/obs/`):

- `obs.capture`: the deterministic capture plane, a bounded rotating
  on-disk recorder of request inputs and completion digests behind an
  engine config fingerprint, replayed token for token by `sim/replay.py`;
- `obs.anomaly`: `FlightRecorder`, the bounded ring of JSON bundles that
  replay triage writes.

The telemetry planes (metrics registry, trace, SLO, attribution) are not
ported yet; the engine keeps the counters its views read in
`models/serve_stats.py`.
"""

from walkai_nos_tpu_torch.obs.anomaly import FlightRecorder  # noqa: F401
from walkai_nos_tpu_torch.obs.capture import (  # noqa: F401
    CaptureLog,
    fingerprint_id,
    token_digest,
    tree_crc32,
)
