"""The port's fleet telemetry (`obs/anomaly.AnomalyDetector`,
`obs/federation.py`, `obs/router.RouterObs`) against the JAX package's,
on the CPU, no engine.

- JAX's own `TestExpositionRoundTrip`, `TestAnomalyDetector`,
  `TestFlightRecorder` and `TestFleetTraceMerge` cases
  (`tests/test_obs.py`), run unchanged against the port's modules;
- the same inputs through both packages: federated text byte for byte,
  the merged fleet trace, and the detector's scores and flags tick for
  tick over seeded random fleets (exact);
- `RouterObs` builds the catalog's router series, as JAX's does.
"""

import json

import numpy as np
import pytest

from jax_cases import cases, port_copy, run_case
from walkai_nos_tpu.obs import anomaly as janomaly
from walkai_nos_tpu.obs import federation as jfed
from walkai_nos_tpu.obs import metrics as jmetrics
from walkai_nos_tpu.obs import router as jrouter
from walkai_nos_tpu.obs import trace as jtrace
from walkai_nos_tpu_torch.obs import anomaly as tanomaly
from walkai_nos_tpu_torch.obs import federation as tfed
from walkai_nos_tpu_torch.obs import metrics as tmetrics
from walkai_nos_tpu_torch.obs import router as trouter
from walkai_nos_tpu_torch.obs import trace as ttrace

JAX_TESTS = port_copy("test_obs")
CLASSES = ("TestExpositionRoundTrip", "TestAnomalyDetector",
           "TestFlightRecorder", "TestFleetTraceMerge")
CASES = cases(JAX_TESTS, CLASSES)


def test_the_copy_runs_the_port():
    assert JAX_TESTS["AnomalyDetector"] is tanomaly.AnomalyDetector
    assert JAX_TESTS["federate"] is tfed.federate
    assert JAX_TESTS["merge_fleet_trace"] is tfed.merge_fleet_trace
    assert JAX_TESTS["Registry"] is tmetrics.Registry
    assert len(CASES) == 18


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c}.{n}" for c, n in CASES])
def test_jax_case_on_the_port(cls, name, request):
    run_case(JAX_TESTS, cls, name, request)


def test_surfaces_equal_jax():
    assert tfed.__all__ == jfed.__all__
    assert tfed.FEDERATED_PREFIXES == jfed.FEDERATED_PREFIXES
    assert tanomaly.__all__ == janomaly.__all__
    assert tanomaly.SIGNALS == janomaly.SIGNALS
    assert tanomaly._CLAMP == janomaly._CLAMP


def _exposition(metrics, seed):
    rng = np.random.default_rng(seed)
    reg = metrics.Registry()
    reg.counter("cb_requests_submitted_total", "n").inc(int(rng.integers(9)))
    g = reg.gauge("cb_saturation_component", "c")
    for sig in ("busy", "pool"):
        g.set(float(rng.random()), labels={"signal": sig})
    reg.gauge("cb_slo_dispatch_p99", "p").set(float(rng.random()) * 1e-5)
    h = reg.histogram("cb_ttft_seconds", "t", buckets=(0.01, 0.1, 1.0))
    for v in rng.exponential(0.1, 5):
        h.observe(float(v))
    reg.counter("cb_request_errors_total", "e").inc(
        labels={"reason": 'x"y\\z'})
    reg.counter("router_requests_total", "own").inc()
    return reg.render()


@pytest.mark.parametrize("seed", range(4))
def test_federation_equals_jax(seed):
    jsrc = {f"r{i}": _exposition(jmetrics, seed + i) for i in range(3)}
    tsrc = {f"r{i}": _exposition(tmetrics, seed + i) for i in range(3)}
    assert tsrc == jsrc
    assert tfed.federate(tsrc) == jfed.federate(jsrc)
    for text in tsrc.values():
        assert tfed.parse_exposition(text) == jfed.parse_exposition(text)
        assert (tfed.first_value(text, "cb_slo_dispatch_p99")
                == jfed.first_value(text, "cb_slo_dispatch_p99"))


def test_fleet_trace_merge_equals_jax():
    def traces(trace_mod):
        router = trace_mod.RouterTrace()
        router.submit(0, trace_id="t0", t_submit=10.0, t_routed=10.001,
                      replica="a", policy="p2c", t_enqueue=9.99,
                      affinity_key=7)
        router.collected(0, 10.5)
        router.event("scale_up", 10.2, replica="b", reason="saturation")
        eng = trace_mod.RequestTrace()
        eng.submit(0, 10.002, prompt_len=5, max_new=2, trace_id="t0")
        eng.admitted(0, 10.01, 0, 1)
        eng.first_token(0, 10.1)
        eng.done(0, 10.4, n_tokens=2, reason="length")
        return router.chrome_trace(), eng.chrome_trace()

    (jr, je), (tr, te) = traces(jtrace), traces(ttrace)
    assert json.dumps(tr, sort_keys=True) == json.dumps(jr, sort_keys=True)
    reps = [{"name": "a", "trace": je, "offset_s": 0.25},
            {"name": "b", "trace": None}, {"name": "c", "trace": {}}]
    treps = [dict(r, trace=te if r["name"] == "a" else r["trace"])
             for r in reps]
    assert tfed.merge_fleet_trace(tr, treps) == jfed.merge_fleet_trace(jr, reps)


@pytest.mark.parametrize("seed", range(3))
def test_detector_ticks_equal_jax(seed):
    rng = np.random.default_rng(seed)
    dets = (janomaly.AnomalyDetector(alpha=0.5),
            tanomaly.AnomalyDetector(alpha=0.5))
    names = ["a", "b", "c", "d"]
    for tick in range(40):
        if tick == 25:
            names = names[:3]  # a retired replica is forgotten
        fleet = {}
        for n in names:
            slow = 4.0 if (n == "c" and 5 <= tick < 20) else 1.0
            fleet[n] = {
                "dispatch_p99_s": (None if rng.random() < 0.1
                                   else float(rng.normal(0.01, 1e-3)) * slow),
                "device_step_ms": float(rng.normal(4.0, 0.2)) * slow,
                "roofline_fraction": (float(rng.random()) if n != "d"
                                      else float("nan")),
            }
        want, got = (d.update(fleet) for d in dets)
        assert got == want, tick
        for n in names:
            assert dets[1].score(n) == dets[0].score(n)
            assert dets[1].flagged(n) == dets[0].flagged(n)


def test_router_obs_builds_the_catalog_router_series():
    jobs, tobs = jrouter.RouterObs(), trouter.RouterObs()
    for obs in (jobs, tobs):
        obs.submitted.inc()
        obs.scale_events.inc(labels={"direction": "up"})
        obs.replica_saturation.set(0.5, labels={"replica": "r0"})
    assert tobs.render() == jobs.render()
    assert trouter.RouterObs(enabled=False).render() == "\n"
