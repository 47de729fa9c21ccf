"""RouterObs: the fleet router's telemetry bundle.

Port of `walkai_nos_tpu/obs/router.py`: one registry and one instrument
attribute per `component="router"` catalog spec
(`obs.submitted.inc()`, `obs.scale_events.inc(labels=...)`, ...), built
through `obs/serving.bind_catalog_instruments`, so the router holds no
literal metric name. Its registry stays apart from every replica's:
fleet series aggregate across replicas, engine series stay per engine
(and `federated_metrics()` re-exports them under `replica`).

`enabled=False` builds the bundle in no-op mode, as `ServingObs` does.
"""

from __future__ import annotations

from walkai_nos_tpu_torch.obs.catalog import router_specs
from walkai_nos_tpu_torch.obs.metrics import Registry
from walkai_nos_tpu_torch.obs.serving import bind_catalog_instruments

__all__ = ["RouterObs"]


class RouterObs:
    def __init__(
        self,
        *,
        enabled: bool = True,
        registry: Registry | None = None,
    ):
        self.enabled = enabled
        self.registry = registry or Registry(enabled=enabled)
        bind_catalog_instruments(self, router_specs(), self.registry)

    def render(self) -> str:
        return self.registry.render()
