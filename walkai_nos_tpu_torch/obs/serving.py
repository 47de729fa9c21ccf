"""ServingObs: the serving engine's telemetry bundle.

Port of `walkai_nos_tpu/obs/serving.py`. One object carrying the three
planes the continuous batcher writes, all host-side at its sync points:

- `registry` + one instrument attribute per `component="serving"`
  catalog spec (`obs.submitted.inc()`, `obs.ttft.observe(...)`, ...),
  built from `obs/catalog.py`, so `models/` holds no literal metric
  name;
- `trace`: the request-lifecycle span recorder and event ring
  (`obs/trace.RequestTrace`, Chrome export);
- `profile`: the `torch.profiler` capture-window hook
  (`obs/profile.ProfileHook`, armed by env or by `arm`), ticked once per
  engine dispatch.

`enabled=False` builds the whole bundle in no-op mode: every write
short-circuits on one flag check, reads return zeros or None, and the
profile hook never arms from the environment. The engine's `obs=False`
builds it; its views then flag their zeros `obs_disabled`.
"""

from __future__ import annotations

from walkai_nos_tpu_torch.obs.catalog import serving_specs
from walkai_nos_tpu_torch.obs.metrics import Registry
from walkai_nos_tpu_torch.obs.profile import ProfileHook
from walkai_nos_tpu_torch.obs.trace import RequestTrace

__all__ = ["ServingObs", "bind_catalog_instruments"]


def bind_catalog_instruments(target, specs, registry: Registry) -> None:
    """Build one registry instrument per catalog spec and set it as an
    attribute on `target` (spec.attr): the one instruments-from-catalog
    path every obs bundle uses, so a name that is not in
    `obs/catalog.py` does not exist."""
    for spec in specs:
        if spec.kind == "counter":
            inst = registry.counter(spec.name, spec.help)
        elif spec.kind == "gauge":
            inst = registry.gauge(spec.name, spec.help)
        else:
            inst = registry.histogram(
                spec.name, spec.help, buckets=spec.buckets
            )
        setattr(target, spec.attr, inst)


class ServingObs:
    def __init__(
        self,
        *,
        enabled: bool = True,
        registry: Registry | None = None,
        trace_events: int = 4096,
        trace_requests: int = 1024,
        profile: ProfileHook | None = None,
    ):
        self.enabled = enabled
        self.registry = registry or Registry(enabled=enabled)
        self.trace = RequestTrace(
            capacity=trace_events,
            keep_done=trace_requests,
            enabled=enabled,
        )
        if profile is not None:
            self.profile = profile
        elif enabled:
            self.profile = ProfileHook.from_env()
        else:
            # The no-op bundle is a real no-op: ambient WALKAI_PROFILE_*
            # never arms a capture on a telemetry-disabled engine.
            self.profile = ProfileHook()
        bind_catalog_instruments(self, serving_specs(), self.registry)

    def render(self) -> str:
        return self.registry.render()
