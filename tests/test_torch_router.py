"""The port's fleet router (`walkai_nos_tpu_torch/router/`) against the JAX
package's (`walkai_nos_tpu/router/`), over scripted replicas, no engine.

- JAX's own routing, reconciler, straggler, federation and trace-event
  cases (`tests/test_router.py`: `TestPrefixKey`, `TestRoutingPolicy`,
  `TestReconcilerHysteresis`, `TestStragglerDetection`,
  `TestReconcilerTraceEvents`, `TestMetricsFederation`), run unchanged
  against the port's router; the one case that needs `HttpReplica` is
  left out with it;
- both routers over identical scripted fleets driven by one seeded
  script (affinity, overload and power-of-two-choices re-points,
  round-robin, drains with and without the reconciler, scale-ups,
  scale-downs, a dry provider, stragglers that flag and recover, SLO
  breaches, retirement): the same replica and arm per request, the same
  trace events (times aside), scale events, `stats()`, federated text,
  anomaly verdicts and flight bundles, step for step (exact: the two
  draw from `random.Random(seed)` in the same order);
- what the port leaves out raises or reads as stated: the canary role,
  `canary_stats()`, the canary options' validation.
"""

import os

import numpy as np
import pytest

from jax_cases import cases, port_copy, run_case
from walkai_nos_tpu import router as jrouter
from walkai_nos_tpu.obs.anomaly import FlightRecorder as JaxRecorder
from walkai_nos_tpu_torch import router as trouter
from walkai_nos_tpu_torch.obs.anomaly import FlightRecorder
from walkai_nos_tpu_torch.router import autoscale as tautoscale

JAX_TESTS = port_copy("test_router")
CLASSES = ("TestPrefixKey", "TestRoutingPolicy", "TestReconcilerHysteresis",
           "TestStragglerDetection", "TestReconcilerTraceEvents",
           "TestMetricsFederation")
CASES = cases(JAX_TESTS, CLASSES, exclude=(
    "TestRoutingPolicy.test_unreachable_replica_reads_as_max_load",
))


def test_the_copy_runs_the_port():
    assert JAX_TESTS["FleetRouter"] is trouter.FleetRouter
    assert JAX_TESTS["ScalePolicy"] is trouter.ScalePolicy
    assert JAX_TESTS["StaticSliceProvider"] is trouter.StaticSliceProvider
    assert JAX_TESTS["FlightRecorder"] is FlightRecorder
    assert len(CASES) == 19


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c}.{n}" for c, n in CASES])
def test_jax_case_on_the_port(cls, name, request):
    run_case(JAX_TESTS, cls, name, request)


def test_surface_equals_jax_less_the_unported():
    assert set(trouter.__dict__) >= {
        "FleetRouter", "prefix_key", "EngineReplica", "Reconciler",
        "ScalePolicy", "StaticSliceProvider", "replica_load",
    }
    assert not hasattr(trouter, "PartitionerSliceProvider")
    assert not hasattr(trouter, "HttpReplica")
    assert tautoscale.__all__ == [
        n for n in jrouter.autoscale.__all__ if n != "PartitionerSliceProvider"
    ]
    assert (tautoscale.ScalePolicy.__dataclass_fields__.keys()
            == jrouter.ScalePolicy.__dataclass_fields__.keys())
    assert tautoscale.ScalePolicy() == tautoscale.ScalePolicy(
        **vars(jrouter.ScalePolicy()))


def test_canary_role_and_options():
    fake = JAX_TESTS["FleetFake"]
    with pytest.raises(NotImplementedError, match="canary role"):
        trouter.FleetRouter([fake("a")]).add_replica(fake("c"), role="canary")
    for mod in (jrouter, trouter):
        with pytest.raises(ValueError, match="role must be"):
            mod.FleetRouter([fake("a")]).add_replica(fake("c"), role="x")
        with pytest.raises(ValueError, match=r"canary_mirror must be in \[0, 1\]"):
            mod.FleetRouter([fake("a")], canary_mirror=1.5)
    router = trouter.FleetRouter([fake("a")], canary_mirror=0.5,
                                 canary_opts={"min_compared": 4})
    assert router.canary_stats() is None
    assert router.stats()["canary"] is None
    assert router.canary_mirror == 0.5


# -- both routers on one script ------------------------------------------------

FleetFake = JAX_TESTS["FleetFake"]


class ScriptFake(FleetFake):
    """`tests/test_router.py`'s fleet fake with a scripted SLO bit, queue
    and roofline, and prefix tallies that grow with its submits."""

    def __init__(self, name, **kw):
        super().__init__(name, **kw)
        self.slo = None
        self.queue = 0
        self.roofline = None

    @property
    def slo_ok(self):
        return self.slo

    @property
    def queue_depth(self):
        return self.queue

    def obs_signals(self):
        return dict(super().obs_signals(), roofline_fraction=self.roofline)

    def prefix_stats(self):
        return {"block_hits": self.submits // 2,
                "block_misses": (self.submits + 1) // 2}

    def debug_state(self):
        return {"name": self.name, "submits": self.submits}


def _template(rng, templates):
    t = templates[min(int(rng.zipf(1.1)) - 1, len(templates) - 1)]
    return np.concatenate([t, rng.integers(0, 64, int(rng.integers(1, 9)))])


def _scrub(x, tmp):
    """A transcript item with wall times dropped and paths made relative."""
    if isinstance(x, dict):
        return {k: _scrub(v, tmp) for k, v in x.items()
                if k not in ("t", "ts", "dur", "at_unix_s")}
    if isinstance(x, list):
        return [_scrub(v, tmp) for v in x]
    if isinstance(x, str) and tmp in x:
        return os.path.relpath(x, tmp)
    return x


def _run(mod, recorder_cls, tmp, seed, policy, spares, scale):
    rng = np.random.default_rng(seed)
    templates = [rng.integers(0, 64, 128).astype(np.int32) for _ in range(4)]
    names = ["r0", "r1", "r2"][:2 + seed % 2]
    fakes = {n: ScriptFake(n, dispatch_p99=0.01) for n in names}
    spare = [ScriptFake(f"s{i}", dispatch_p99=0.01) for i in range(spares)]
    fakes.update({s.name: s for s in spare})
    kw = dict(seed=seed, policy=policy, fleet_refresh_s=0.0,
              flight=recorder_cls(tmp, keep=64, min_interval_s=0.0))
    if scale:
        kw.update(provider=mod.StaticSliceProvider(spare),
                  scale_policy=mod.ScalePolicy(
                      min_replicas=1, max_replicas=4, up_saturation=0.8,
                      down_saturation=0.3, breach_ticks=2, idle_ticks=4,
                      cooldown_ticks=5))
    router = mod.FleetRouter([fakes[n] for n in names], **kw)
    log = []
    for step in range(60):
        phase = step // 15
        for f in fakes.values():
            f.sat = float(rng.choice([0.0, 0.2, 0.5, 0.85, 0.95, 0.97]))
            if phase == 3:
                f.sat = 0.05
            f.queue = int(rng.integers(0, 3)) if phase == 1 else 0
            f.roofline = float(rng.random()) if phase == 2 else None
            f.dispatch_p99 = 0.01 + 1e-4 * int(rng.integers(3))
            f.slo = False if (phase == 1 and f.name == "r1") else None
        if 5 <= step < 20:
            fakes["r0"].dispatch_p99 = 0.2  # a straggler, then recovered
        for _ in range(int(rng.integers(0, 5))):
            prompt = (_template(rng, templates) if rng.random() < 0.8
                      else rng.integers(0, 64, 20))
            try:
                rid = router.submit(prompt, max_new_tokens=4)
            except RuntimeError:
                log.append(("no_replica",))
                continue
            log.append(("route", rid, router._routes[rid][0].name))
        if step == 30 and not scale:
            victim = router.active_handles()[0]
            victim.replica.busy = True
            router.start_drain(victim)
        if step == 40 and not scale:
            for h in router.draining_handles():
                h.replica.busy = False
                router.retire(h)
        router.step()
        log.append(("done", sorted(router.drain_done_records())))
        log.append(("verdicts", [(h.name, h.anomaly) for h in router._handles]))
        log.append(("stats", _scrub(router.stats(), tmp)))
    return {
        "log": log,
        "ring": _scrub(router.trace.ring.snapshot(), tmp),
        "metrics": router.federated_metrics(),
        "scale": router.scale_events(),
        "bundles": _scrub(router.flight.bundles(), tmp),
        "hit_rate": router.prefix_hit_rate,
    }


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
@pytest.mark.parametrize("scale", [True, False], ids=["reconciler", "manual"])
def test_scripted_fleet_decides_as_jax(tmp_path, seed, policy, scale):
    runs = {}
    for pkg, mod, rec in (("jax", jrouter, JaxRecorder),
                          ("port", trouter, FlightRecorder)):
        tmp = str(tmp_path / pkg)
        runs[pkg] = _run(mod, rec, tmp, seed, policy, spares=2, scale=scale)
    port, want = runs["port"], runs["jax"]
    for i, (got, exp) in enumerate(zip(port["log"], want["log"])):
        assert got == exp, i
    assert len(port["log"]) == len(want["log"])
    assert port["ring"] == want["ring"]
    assert port["metrics"] == want["metrics"]
    assert port["scale"] == want["scale"]
    assert port["bundles"] == want["bundles"]
    assert port["hit_rate"] == want["hit_rate"]
    routed = [e for e in port["log"] if e[0] == "route"]
    assert len(routed) > 50
    if policy == "affinity":
        assert {b["trigger"] for b in port["bundles"]} >= {"anomaly"}
    if scale:
        assert port["scale"]["up"] >= 1


def test_random_routes_equal_jax():
    """Many p2c placements over moving loads: the router's rng draws
    equal JAX's, draw for draw."""
    picks = {}
    for pkg, mod in (("jax", jrouter), ("port", trouter)):
        rng = np.random.default_rng(11)
        fakes = [ScriptFake(f"r{i}") for i in range(5)]
        router = mod.FleetRouter(fakes, seed=3, anomaly=False)
        out = [router._trace_prefix]
        for _ in range(400):
            for f in fakes:
                f.sat = float(rng.random())
            out.append(router.submit([int(rng.integers(64))], max_new_tokens=1))
            out.append(router._routes[out[-1]][0].name)
        picks[pkg] = out
    assert picks["port"] == picks["jax"]
    assert len(set(picks["port"][2::2])) == 5


def test_engine_replica_surface_equals_jax():
    from walkai_nos_tpu.router.replica import EngineReplica as JaxReplica

    public = {n for n in dir(JaxReplica) if not n.startswith("_")}
    assert {n for n in dir(trouter.EngineReplica)
            if not n.startswith("_")} == public
    for attr in ("steps_locally", "supports_migration"):
        assert getattr(trouter.EngineReplica, attr) is getattr(JaxReplica, attr)
