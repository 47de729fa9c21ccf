"""The port's `HttpReplica` (`walkai_nos_tpu_torch/router/replica.py`) over
the port's demo server, against the JAX package's engine, on the CPU.

- JAX's own dead-pod cases (`tests/test_router.py`: an unreachable pod
  reads as full load; every failed scrape is counted per endpoint kind
  and shown in `router.stats()`; HTTP replicas do not step locally), run
  unchanged against the port's router and replica;
- the port's `FleetRouter` over one `HttpReplica` of an in-process
  `DemoServer` on bridged f32 weights: the tokens of JAX's
  `ContinuousBatcher` on the same weights, a trace id per request, no
  scrape error; the probes (load
  signals, clock offset, prefix tallies, metrics, trace, state) read the
  live pod;
- block shipping over `/blocks`: a template served on one pod, its
  affinity re-pointed to a second, is shipped there first and hits, with
  the same tokens;
- the replica's public surface is JAX's, plus `close()`.

Every server binds a port the OS picks and is stopped in a finalizer, as
is every replica's worker pool.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_cases import port_copy, run_case
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu.router.replica import HttpReplica as JaxHttpReplica
from walkai_nos_tpu_torch import router as trouter
from walkai_nos_tpu_torch.app.main import DemoServer
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.block_key import chain_hashes
from walkai_nos_tpu_torch.router import replica as treplica

torch.set_num_threads(1)

JAX_TESTS = port_copy("test_router")
DEAD_POD_CASES = [
    ("TestRoutingPolicy", "test_unreachable_replica_reads_as_max_load"),
    ("TestScrapeErrorAccounting", "test_dead_pod_errors_counted_not_swallowed"),
    ("TestServerouterEndpoints", "test_replica_stepping_contract"),
]
NEW = 6
FIELDS = dict(dtype="float32", max_seq_len=256)
ENV = {
    "WALKAI_DEMO_MODEL": "tiny",
    "WALKAI_DEMO_LM": "1",
    "WALKAI_LM_MAX_NEW": str(NEW),
    "WALKAI_CB_SLOTS": "2",
    "WALKAI_CB_CHUNK": "2",
    "WALKAI_CB_BUCKET": "128",
    "WALKAI_MAX_BATCH": "8",
    "WALKAI_WARM_BUCKETS": "1",
    "WALKAI_CALIB_WINDOW_S": "0.2",
}
ENGINE = dict(slots=2, cache_len=256, prompt_bucket=128, chunk_steps=2)


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, n).tolist() for n in (5, 3, 7, 4)]


def _template():
    """One shareable 128-token block and an 8-token suffix."""
    return np.random.default_rng(3).integers(0, 256, 136).tolist()


def _jax_dev(self, a):
    return jnp.asarray(np.array(a, copy=True))


@pytest.fixture
def closed_replicas(monkeypatch):
    """Every port `HttpReplica` a test builds, its worker pool stopped
    when the test ends."""
    made = []

    class Tracked(treplica.HttpReplica):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(treplica, "HttpReplica", Tracked)
    monkeypatch.setattr(trouter, "HttpReplica", Tracked)
    yield Tracked
    for replica in made:
        replica.close(timeout=30.0)


@pytest.fixture(scope="module")
def params():
    cfg = dataclasses.replace(jlm.LM_TINY, **FIELDS)
    return jax.device_get(jax.jit(jlm.DecoderLM(cfg).init_params)(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_tokens(params):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        engine = JaxBatcher(dataclasses.replace(jlm.LM_TINY, **FIELDS), params,
                            **ENGINE)
        prompts = _prompts() + [_template()]
        rids = [engine.submit(np.asarray(p, np.int32), max_new_tokens=NEW)
                for p in prompts]
        out = engine.run()
    return [[int(t) for t in out[r]] for r in rids]


@pytest.fixture(scope="module")
def servers(params):
    made = []
    try:
        for _ in range(2):
            made.append(DemoServer(
                ENV, device="cpu", lm_cfg=dataclasses.replace(tlm.LM_TINY, **FIELDS),
                lm_params=params, log=lambda line: None,
            ).start(port=0))
        yield made
    finally:
        for app in made:
            app.stop(timeout=30.0)


@pytest.mark.parametrize("cls,name", DEAD_POD_CASES,
                         ids=[f"{c}.{n}" for c, n in DEAD_POD_CASES])
def test_jax_dead_pod_case_on_the_port(cls, name, request, closed_replicas):
    assert JAX_TESTS["FleetRouter"] is trouter.FleetRouter
    run_case(JAX_TESTS, cls, name, request)


def test_fleet_over_http_equals_jax(servers, jax_tokens, closed_replicas):
    replica = closed_replicas(servers[0].url, name="pod0", workers=4, refresh_s=0.0)
    router = trouter.FleetRouter([replica], seed=0, fleet_refresh_s=0.0)
    prompts = _prompts()
    rids = [router.submit(p, max_new_tokens=NEW) for p in prompts]
    records = {}
    while len(records) < len(rids):
        router.step()
        records.update(router.drain_done_records())
    got = [records[r] for r in rids]
    assert [r["tokens"] for r in got] == jax_tokens[:len(prompts)]
    assert all(r["replica"] == "pod0" for r in got)
    traces = {r["trace_id"] for r in got}
    assert len(traces) == len(rids) and None not in traces
    assert replica.scrape_error_stats()["counts"] == {
        "healthz": 0, "stats": 0, "metrics": 0}
    assert replica.last_error is None


def test_probes_read_the_live_pod(servers, closed_replicas):
    app = servers[0]
    replica = closed_replicas(app.url, workers=1, refresh_s=0.0)
    assert replica.unreachable is False
    assert replica.slots == 2 and replica.queue_depth == 0
    assert replica.draining is False and replica.steps_locally is False
    # Same process, same monotonic clock: the offset is the probe's
    # half round trip at most.
    assert abs(replica.clock_offset_s()) < 1.0
    assert replica.prefix_stats() == app.cb_engine.prefix_stats()
    assert "cb_requests_submitted_total" in replica.metrics_text()
    assert set(replica.obs_signals()) == {
        "dispatch_p99_s", "device_step_ms", "roofline_fraction"}
    assert "traceEvents" in replica.chrome_trace()
    assert replica.debug_state()["engine"]["paged"] is True
    replica.drain()
    assert replica.draining is True
    assert replica.scrape_error_stats()["last_ok_age_s"] is not None


def test_blocks_ship_over_http(servers, jax_tokens, closed_replicas):
    home_app, cold_app = servers
    home = closed_replicas(home_app.url, name="home", workers=2, refresh_s=0.0)
    cold = closed_replicas(cold_app.url, name="cold", workers=2, refresh_s=0.0)
    # Affinity never yields to load here: the pods' saturation carries
    # the earlier tests' traffic.
    router = trouter.FleetRouter([home, cold], seed=0, affinity_overload=2.0)
    p = _template()
    key = trouter.prefix_key(np.asarray(p, np.int32))
    first = router.submit(p, max_new_tokens=NEW)
    out0 = router.run()
    owner = router._block_home[key]
    other = next(h for h in router.active_handles() if h is not owner)
    other_app = cold_app if other.replica is cold else home_app
    hits0 = other_app.cb_engine.prefix_stats()["block_hits"]
    router._affinity[key] = other  # forced re-point
    second = router.submit(p, max_new_tokens=NEW)
    out1 = router.run()
    assert out0[first] == out1[second] == jax_tokens[-1]
    assert int(router.obs.xfer_ships.value(labels={"outcome": "ok"})) == 1
    assert other_app.cb_engine.prefix_stats()["block_hits"] == hits0 + 1
    # The export itself, by hash, over the replica.
    payload = owner.replica.export_blocks(chain_hashes(np.asarray(p, np.int32)))
    assert payload["tiles"]


def test_surface_equals_jax():
    public = {n for n in dir(JaxHttpReplica) if not n.startswith("_")}
    assert {n for n in dir(treplica.HttpReplica)
            if not n.startswith("_")} == public | {"close"}
    for attr in ("steps_locally", "supports_migration"):
        assert getattr(treplica.HttpReplica, attr) is getattr(JaxHttpReplica, attr)
