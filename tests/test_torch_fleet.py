"""The port's fleet end to end: `FleetRouter` over `EngineReplica`s of tiny
port engines on the CPU, every replica serving one shared `DecoderLM`.

- JAX's own engine-backed fleet cases (`tests/test_router.py`: the drain
  seam, `TestFleetEndToEnd`, `TestDisaggregatedFleet`,
  `TestFleetTraceEndToEnd`'s merged trace, the engine replica's scrape
  block), run unchanged against the port's router, replicas and
  engines: greedy tokens identical to one engine's through a mid-run
  scale-up and a drain-based scale-down with zero drops, affinity
  beating round-robin on the prefix hit rate, block shipping, the
  disaggregated two-stage hand-off, migrating drains, the fleet
  capture's digests disaggregated equal to colocated, and the merged
  fleet trace with exact TTFT;
- an MoE fleet under capacity drops (ROADMAP's standing rule for MoE):
  each replica's tokens equal a solo engine's serving that replica's
  requests on the same schedule, and tokens do drop;
- the reconciler scaling a fleet of engines up, a migrating drain
  scaling it down, zero drops; the replicas' weights shared, and the
  engines' SLO and attribution signals reaching the router.

The engine cases of the JAX file that need the demo server, the
traffic harness or `cmd/serverouter.py` wait with them.
"""

import numpy as np
import pytest
import torch

from jax_cases import cases, port_copy, run_case
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.moe import MoEMlp
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.ops.decode_attention import PAGE_ROWS
from walkai_nos_tpu_torch.router import (
    EngineReplica,
    FleetRouter,
    ScalePolicy,
    StaticSliceProvider,
)

torch.set_num_threads(1)

JAX_TESTS = port_copy("test_router")
CASES = cases(
    JAX_TESTS,
    ("TestDrainSeam", "TestFleetEndToEnd", "TestDisaggregatedFleet",
     "TestFleetTraceEndToEnd", "TestScrapeErrorAccounting"),
    exclude=(
        "TestDrainSeam.test_healthz_block_surfaces_draining",
        "TestFleetTraceEndToEnd.test_serverouter_merged_endpoints",
        "TestScrapeErrorAccounting.test_dead_pod_errors_counted_not_swallowed",
    ),
)
# `tests/test_router.py`'s engine config (`sim/trafficbench`'s factory),
# in f32.
FIELDS = dict(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2,
              max_seq_len=512, dtype="float32")
SLOTS, CACHE_LEN = 2, 256


def _engines(cfg, model, **kw):
    pool_blocks = SLOTS * -(-CACHE_LEN // PAGE_ROWS) + 1 + 8

    def make(name: str) -> EngineReplica:
        return EngineReplica(ContinuousBatcher(
            cfg, model, slots=SLOTS, cache_len=CACHE_LEN, chunk_steps=4,
            pool_blocks=pool_blocks, prefill_lanes=1, device="cpu", **kw,
        ), name=name)

    return make


@pytest.fixture(scope="module")
def fleet():
    """(model, replica factory): tiny port engines sharing one model, as
    the JAX file's fixture shares one weight set."""
    cfg = tlm.LMConfig(**FIELDS)
    model = tlm.DecoderLM(cfg, device="cpu", seed=0)
    return model, _engines(cfg, model)


def test_the_copy_runs_the_port():
    assert JAX_TESTS["FleetRouter"] is FleetRouter
    assert len(CASES) == 11


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c}.{n}" for c, n in CASES])
def test_jax_case_on_the_port(cls, name, request):
    run_case(JAX_TESTS, cls, name, request)


def _template(seed, n=PAGE_ROWS + 8):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int32)


def test_replicas_share_one_model_and_report_signals(fleet):
    model, make = fleet
    a, b = make("a"), make("b")
    assert a.engine.model is model and b.engine.model is model
    assert a.engine._state is not b.engine._state
    router = FleetRouter([a, b], seed=0, fleet_refresh_s=0.0)
    rids = [router.submit(_template(s), max_new_tokens=6) for s in range(4)]
    out = router.run()
    assert sorted(out) == sorted(rids)
    for rep in (a, b):
        sig = rep.obs_signals()
        assert sig["roofline_fraction"] is None  # no bandwidth on the CPU
        assert sig["dispatch_p99_s"] is not None
        assert sig["device_step_ms"] is not None
        assert 0.0 <= rep.saturation <= 1.0
        assert rep.slo_ok is True  # no objectives: vacuously met
        kinds = rep.engine.attrib_stats()["kinds"]
        assert (sum(k["dispatches"] for k in kinds.values())
                == rep.engine.obs.dispatches.value())
    stats = router.stats()
    assert all(r["saturation"] is not None for r in stats["replicas"])
    text = router.federated_metrics()
    for name in ("a", "b"):
        assert f'cb_dispatch_kind_total{{kind="prefill",replica="{name}"}}' in text
        assert f'cb_saturation{{replica="{name}"}}' in text


def test_reconciler_scales_up_and_a_migrating_drain_scales_down(fleet):
    """A first wave presses the one replica (its queue past the
    threshold) and the reconciler admits the spare; the second wave is
    balanced over both. Then a migrating drain of the first replica,
    with requests resident, moves them to the spare, and the reconciler
    retires and releases it: zero drops, every token a solo engine's.
    (An engine's saturation is read at its syncs, so a fleet gone idle
    keeps its last reading: the JAX router's idle scale-down needs
    traffic that keeps dispatching.)"""
    model, make = fleet
    single = make("ref").engine
    prompts = [_template(300 + i % 3, PAGE_ROWS + 4 + i) for i in range(10)]
    rid_of = [single.submit(p, max_new_tokens=12) for p in prompts]
    got = single.run()
    want = [got[r] for r in rid_of]
    base, spare = make("base"), make("spare")
    provider = StaticSliceProvider([spare])
    router = FleetRouter(
        [base], seed=0, fleet_refresh_s=0.0, provider=provider,
        scale_policy=ScalePolicy(min_replicas=1, max_replicas=2,
                                 up_saturation=0.5, breach_ticks=1,
                                 cooldown_ticks=2),
    )
    submitted = {router.submit(p, max_new_tokens=12): i
                 for i, p in enumerate(prompts[:5])}
    records = {}
    for _ in range(2):
        router.step()
        records.update(router.drain_done_records())
    assert router.scale_events()["up"] == 1
    submitted.update({router.submit(p, max_new_tokens=12): i + 5
                      for i, p in enumerate(prompts[5:])})
    router.step()
    records.update(router.drain_done_records())
    assert base.engine.drain_stats()["resident_slots"] > 0
    router.start_drain(router.active_handles()[0], migrate=True)
    assert not base.has_work
    while router.has_work:
        router.step()
        records.update(router.drain_done_records())
    router.step()
    assert sorted(records) == sorted(submitted)
    for rid, rec in records.items():
        assert rec["tokens"] == want[submitted[rid]]
    assert [r.name for r in provider.released] == ["base"]
    assert router.replicas == [spare]
    assert int(router.obs.xfer_migrations.value(
        labels={"outcome": "moved"})) > 0
    assert {e["name"] for e in router.trace.ring.snapshot()} >= {
        "scale_up", "migrate_residents", "retire", "release"}


MOE_FIELDS = dict(
    vocab_size=64, hidden_dim=64, num_layers=3, num_heads=4,
    num_kv_heads=2, mlp_dim=96, max_seq_len=512, dtype="float32",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False, layer_norm_eps=1e-5, num_experts=4, moe_every=2,
    expert_top_k=2,
)


def test_moe_fleet_under_drops_serves_each_replica_as_alone():
    """Under capacity drops a row's output depends on its batch, in the
    port as in JAX: the fleet must hand each replica exactly the batches
    a solo engine would see for the same requests on the same schedule
    (routing changes where a request runs, not how its replica batches
    it)."""
    cfg = tlm.LMConfig(**MOE_FIELDS)
    model = tlm.DecoderLM(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    drops = [0]
    for m in model.modules():
        if isinstance(m, MoEMlp):
            with torch.no_grad():  # a skewed router: capacity 1.25 drops
                m.router.bias.copy_(torch.randn(m.num_experts, generator=gen))

            def hook(moe, args):
                h = args[0].reshape(-1, args[0].shape[-1])
                chosen = torch.topk(torch.softmax(moe.router(h), -1),
                                    moe.top_k, dim=-1).indices
                load = torch.bincount(chosen.reshape(-1),
                                      minlength=moe.num_experts)
                drops[0] += int(torch.clamp(
                    load - moe.capacity(h.shape[0]), min=0).sum())

            m.register_forward_pre_hook(hook)
    make = _engines(cfg, model)
    prompts = [np.concatenate([_template(40 + i % 2),
                               _template(50 + i, 3 + 2 * i)])
               for i in range(6)]
    router = FleetRouter([make("m0"), make("m1")], seed=0)
    rids = [router.submit(p, max_new_tokens=8) for p in prompts]
    routed = {rid: router._routes[rid][0].name for rid in rids}
    recs = {}
    while router.has_work:
        router.step()
        recs.update(router.drain_done_records())
    assert drops[0] > 0
    for name in ("m0", "m1"):
        mine = [i for i, rid in enumerate(rids) if routed[rid] == name]
        assert mine
        solo = make(f"{name}-solo").engine
        local = [solo.submit(prompts[i], max_new_tokens=8) for i in mine]
        out = solo.run()
        for i, lr in zip(mine, local):
            assert recs[rids[i]]["tokens"] == out[lr], (name, i)
