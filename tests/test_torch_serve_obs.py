"""The port's engine telemetry (`ContinuousBatcher.obs`, a `ServingObs`)
against the JAX engine's, on the CPU.

Both engines get the same bridged f32 weights (1 layer, d 32, vocab 64)
and the same requests, stepped turn by turn (two of them share a
128-token prefix block). Per case — plain, `loop_steps=4`, `spec=True`
(the target as its own draft, the controller walking k 3 -> 1 -> off),
an armed LoRA engine, `export_resident` / `import_resident` with
`export_blocks` / `import_blocks`, a capture-armed engine and the dense
engine — these agree:

- greedy tokens;
- the trace's event ring, event for event (name, request id and
  arguments; times aside), which holds each request's phases and every
  dispatch's composition class and step window;
- the values of the non-time series, the counts of the latency
  histograms, and the set of series and labels `render()` prints, less
  the series only JAX's `DispatchAttribution`, SLO layer and TP engine
  write (not ported yet: registered, never written).

Then JAX's `TestEngineObsIntegration` cases (`tests/test_obs.py`, its
`tiny_engine_run` config) against the port's engine, the `obs=False`
views against JAX's key for key, and one `ServingObs` shared by two
engines. The JAX engines get a private copy of every upload (`_dev`).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import block_key as jbk
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models import lora as jlora
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch.models import block_key as tbk
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models import lora as tlora
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.obs.catalog import serving_specs
from walkai_nos_tpu_torch.obs.serving import ServingObs

torch.set_num_threads(1)

FIELDS = dict(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2,
              max_seq_len=320, dtype="float32")
ENGINE = dict(slots=2, cache_len=256, chunk_steps=2, prefill_chunk=32,
              prefill_lanes=2)
# (prompt length, new tokens); prompts 0 and 2 share their first block.
REQS = [(140, 6), (5, 9), (131, 4), (20, 7)]
CASES = {
    "plain": {},
    "loop": dict(loop_steps=4),
    "spec": dict(spec=True, spec_k=3, spec_min_accept=5.0,
                 spec_warmup_rounds=3),
    "lora": dict(adapters=True),
    "xfer": {},
    "capture": dict(capture=True),
    "dense": dict(paged=False, prompt_bucket=16),
}
# Series only a TP engine writes (`cb_tp_devices` reads 1 on one device,
# as JAX's). The attribution and SLO layers' series are written, as in
# JAX (the roofline and HBM gauges by neither package on the CPU, where
# there is no bandwidth).
UNWRITTEN = ("ici_step_bytes",)
# The non-time series whose values must agree.
VALUES = (
    "submitted", "completed", "tokens", "errors", "dispatches",
    "busy_steps", "total_steps", "lane_rows", "lane_capacity",
    "prefix_hits", "prefix_misses", "prefix_saved", "prefix_prompt_tokens",
    "prefix_evictions", "prefix_cached_tokens", "pool_blocks",
    "pool_min_free", "kv_bytes", "kv_resident", "kv_cache_bytes",
    "kv_ratio", "queue_depth", "lane_active", "slots_active",
    "spec_draft", "spec_verify", "spec_rounds", "spec_proposed",
    "spec_accepted", "spec_k_gauge", "spec_disabled", "loop_dispatches",
    "loop_chunks", "loop_exits", "loop_steps_per_sync", "lora_requests",
    "lora_gather", "lora_resident", "xfer_exported", "xfer_imported",
    "xfer_rejected", "xfer_bytes", "xfer_migrated", "capture_records",
    "capture_dropped", "dispatch_kind",
)
HISTOGRAMS = ("ttft", "tpot", "wall", "dispatch_latency", "spec_emitted",
              "device_sync")
# Ring arguments that are times.
TIMES = ("host_ms", "device_ms")


def _jax_dev(self, a):
    return jnp.asarray(np.array(a, copy=True))


@pytest.fixture(scope="module", autouse=True)
def _jax_copies():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        yield


@pytest.fixture(scope="module")
def params():
    cfg = jlm.LMConfig(**FIELDS)
    return jax.device_get(jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(0)))


def _prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 64, 128)
    out = []
    for i, (n, _) in enumerate(REQS):
        head = shared if i in (0, 2) else rng.integers(0, 64, 0)
        out.append(np.concatenate([head, rng.integers(0, 64, n - len(head))])
                   .astype(np.int32))
    return out


def _engine(pkg, params, tmp, **kw):
    lm, lora, batcher = ((jlm, jlora, JaxBatcher) if pkg == "jax"
                         else (tlm, tlora, ContinuousBatcher))
    cfg = lm.LMConfig(**FIELDS)
    kw = {**ENGINE, **kw}
    if kw.pop("adapters", None):
        kw["adapters"] = lora.AdapterSet.synthetic(cfg, k=3, rank=4, seed=0,
                                                   scale=0.5)
    if kw.get("spec"):
        kw.update(draft_cfg=cfg, draft_params=params)
    if kw.pop("capture", None):
        kw["capture"] = str(tmp / pkg)
    if pkg == "port":
        kw["device"] = "cpu"
    engine = batcher(cfg, params, **kw)
    # The SLO gauges refresh at every sync, not once a second of wall
    # time, so which of them a run sets does not depend on its speed.
    engine._slo.refresh_s = 0.0
    return engine


def _submit(engine, armed):
    return [
        engine.submit(p, max_new_tokens=m, trace_id=f"r{i}",
                      adapter=(i % 3) if armed else 0)
        for i, (p, (_, m)) in enumerate(zip(_prompts(), REQS))
    ]


def _done(engine, tokens):
    """Collect finished requests' tokens by trace id (request ids are
    per engine)."""
    for rec in engine.drain_done_records().values():
        tokens[rec["trace_id"]] = rec["tokens"]


def _drive(engine, tokens):
    while engine.has_work:
        engine.step()
        _done(engine, tokens)
    _done(engine, tokens)


def _serve(pkg, params, tmp, case):
    """Serve REQS through one engine of `pkg` (two for "xfer"); returns
    ([engines], tokens by trace id)."""
    kw = dict(CASES[case])
    engine = _engine(pkg, params, tmp, **kw)
    _submit(engine, bool(kw.get("adapters")))
    tokens = {}
    engines = [engine]
    if case == "xfer":
        for _ in range(6):
            engine.step()
            _done(engine, tokens)
        chain = (jbk if pkg == "jax" else tbk).chain_hashes(_prompts()[0])
        blocks = engine.export_blocks(chain)
        resident = engine.export_resident()
        # Requests the export's sync finished stay with the source.
        _done(engine, tokens)
        dst = _engine(pkg, params, tmp)
        dst.import_blocks(blocks)
        dst.import_resident(resident)
        engines.append(dst)
        engine = dst
    _drive(engine, tokens)
    # The taxonomy: one of each submit-time rejection.
    first = engines[0]
    for bad in (dict(prompt=[1] * 300, max_new_tokens=4),
                dict(prompt=[1, 2], max_new_tokens=4, temperature=-1.0)):
        with pytest.raises(ValueError):
            first.submit(bad.pop("prompt"), **bad)
    return engines, tokens


def _ring(engine):
    out = []
    for e in engine.obs.trace.ring.snapshot():
        args = {k: v for k, v in e.get("args", {}).items() if k not in TIMES}
        out.append((e["name"], e.get("rid"), args))
    return out


def _series(engine):
    obs = engine.obs
    out = {}
    for attr in VALUES:
        inst = getattr(obs, attr)
        for labels in inst.labelsets():
            out[attr, tuple(sorted(labels.items()))] = inst.value(labels)
    return out


def _hist_counts(engine):
    obs = engine.obs
    return {a: (getattr(obs, a).count(), getattr(obs, a).snapshot_counts()[0]
                if a == "spec_emitted" else None) for a in HISTOGRAMS}


_UNWRITTEN_NAMES = {s.name for s in serving_specs() if s.attr in UNWRITTEN}


def _rendered(engine):
    """(sample name, labels) of every line `render()` prints, less the
    series no ported layer writes."""
    out = set()
    for line in engine.obs.render().splitlines():
        if line.startswith("#"):
            continue
        name, _, rest = line.partition("{")
        labels = rest.rpartition("}")[0] if rest else ""
        name = name.split(" ")[0]
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name in _UNWRITTEN_NAMES or base in _UNWRITTEN_NAMES:
            continue
        out.add((name, labels))
    return out


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    memo = {}

    def run(case):
        if case not in memo:
            tmp = tmp_path_factory.mktemp(case)
            memo[case] = {pkg: _serve(pkg, params, tmp, case)
                          for pkg in ("jax", "port")}
        return memo[case]

    return run


@pytest.mark.parametrize("case", sorted(CASES))
def test_tokens_and_trace_ring_match_jax(runs, case):
    out = runs(case)
    (jengs, jtok), (pengs, ptok) = out["jax"], out["port"]
    assert ptok == jtok and len(ptok) == len(REQS)
    for jeng, peng in zip(jengs, pengs):
        ring = _ring(peng)
        assert ring == _ring(jeng)
        # One dispatch event per dispatch, each with its class.
        kinds = [a["kind"] for n, _, a in ring if n == "dispatch"]
        assert len(kinds) == peng.obs.dispatches.value()
    names = {n for eng in pengs for n, _, _ in _ring(eng)}
    assert {"submit", "prefill_chunk" if case != "dense" else "admitted",
            "done", "dispatch", "error"} <= names
    if case == "spec":
        assert {"spec_draft", "spec_verify", "spec_k_drop",
                "spec_disabled"} <= names
    if case == "xfer":
        assert {"export_blocks", "export_resident", "import_blocks",
                "import_resident"} <= names


@pytest.mark.parametrize("case", sorted(CASES))
def test_series_values_match_jax(runs, case):
    out = runs(case)
    for jeng, peng in zip(out["jax"][0], out["port"][0]):
        assert _series(peng) == _series(jeng)
        assert _hist_counts(peng) == _hist_counts(jeng)
    peng = out["port"][0][0]
    assert peng.obs.errors.value({"reason": "oversize_reject"}) == 1
    assert peng.obs.errors.value({"reason": "bad_request"}) == 1
    if case == "capture":
        jeng = out["jax"][0][0]
        # Byte tallies differ by the header's creation time only.
        assert peng.obs.capture_bytes.value() > 0 < jeng.obs.capture_bytes.value()
        assert peng.obs.capture_records.value({"kind": "done"}) == len(REQS)
    if case == "lora":
        assert peng.obs.lora_requests.value({"adapter": "2"}) == 1
    if case == "loop":
        assert peng.obs.loop_dispatches.value() >= 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_rendered_series_match_jax(runs, case):
    out = runs(case)
    for jeng, peng in zip(out["jax"][0], out["port"][0]):
        assert _rendered(peng) == _rendered(jeng)
        for line in peng.obs.render().strip().splitlines():
            assert line.startswith("#") or SAMPLE.match(line), line


# -- JAX's TestEngineObsIntegration, against the port -------------------------

TINY = dict(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2,
            max_seq_len=64, dtype="float32")
TINY_ENGINE = dict(slots=2, cache_len=64, prompt_bucket=16, chunk_steps=2)
SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_+][a-zA-Z0-9_]*="[^"]*")*\})?'
    r" -?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?$"
)


@pytest.fixture(scope="module")
def tiny_params():
    cfg = jlm.LMConfig(**TINY)
    return jax.device_get(jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(0)))


def _tiny(params, **kw):
    return ContinuousBatcher(tlm.LMConfig(**TINY), params, device="cpu",
                             **{**TINY_ENGINE, **kw})


@pytest.fixture(scope="module")
def tiny_engine_run(tiny_params):
    engine = _tiny(tiny_params)
    rng = np.random.default_rng(0)
    rids = [engine.submit(rng.integers(0, 64, n).astype(np.int32),
                          max_new_tokens=m)
            for n, m in ((3, 5), (6, 3), (4, 4))]
    while engine.has_work:
        engine.step()
    return engine, rids, engine.drain_done_records()


def test_span_timeline_parity_is_exact(tiny_engine_run):
    engine, rids, records = tiny_engine_run
    assert set(records) == set(rids)
    for rid, rec in records.items():
        assert engine.obs.trace.ttft_s(rid) == rec["ttft_s"]
        assert engine.obs.trace.wall_s(rid) == rec["wall_s"]
        tl = engine.obs.trace.timeline(rid)
        assert tl["n_tokens"] == len(rec["tokens"]) and tl["reason"] == "budget"


def test_histograms_agree_with_records_within_one_bucket(tiny_engine_run):
    engine, _, records = tiny_engine_run
    obs = engine.obs
    assert obs.ttft.count() == obs.wall.count() == len(records)
    max_ttft = max(r["ttft_s"] for r in records.values())
    assert obs.ttft.quantile(1.0) == next(b for b in obs.ttft.bounds if b >= max_ttft)


def test_occupancy_and_kv_stats_are_registry_views(tiny_engine_run):
    engine, _, _ = tiny_engine_run
    obs = engine.obs
    occ = engine.occupancy()
    assert occ["busy_slot_steps"] == int(obs.busy_steps.value())
    assert occ["total_slot_steps"] == int(obs.total_steps.value()) == (
        int(obs.dispatches.value()) * engine.slots * engine.chunk_steps)
    kv = engine.kv_stats()
    assert kv["kv_bytes_dispatch_acc"] == obs.kv_bytes.value()
    assert kv["kv_resident_dispatch_acc"] == int(obs.kv_resident.value())
    assert kv["admission_stall_s"] == round(obs.stall.value(), 6)
    assert kv["kv_hbm_bytes_per_resident_token"] == obs.kv_ratio.value()
    assert engine.admission_stall_s == obs.stall.value()
    assert "obs_disabled" not in occ and "obs_disabled" not in kv


def test_counters_and_gauges_after_drain(tiny_engine_run):
    engine, rids, records = tiny_engine_run
    obs = engine.obs
    assert obs.submitted.value() == len(rids)
    assert obs.completed.value({"reason": "budget"}) == len(rids)
    assert obs.tokens.value() == sum(len(r["tokens"]) for r in records.values())
    assert obs.queue_depth.value() == 0 == engine.queue_depth
    assert obs.dispatch_latency.count() == int(obs.dispatches.value())
    free = engine.pool_blocks - 1
    assert obs.pool_blocks.value({"state": "free"}) == free
    assert obs.pool_blocks.value({"state": "used"}) == 0
    assert obs.pool_min_free.value() < free
    assert engine.seconds_since_last_dispatch is not None


def test_metrics_render_parses(tiny_engine_run):
    engine, _, _ = tiny_engine_run
    text = engine.obs.render()
    assert "# TYPE cb_ttft_seconds histogram" in text
    assert "cb_requests_submitted_total 3" in text
    for line in text.strip().splitlines():
        assert line.startswith("#") or SAMPLE.match(line), line


def test_error_taxonomy_labels(tiny_params):
    engine = _tiny(tiny_params)
    obs = engine.obs
    with pytest.raises(ValueError):
        engine.submit([1] * 70, max_new_tokens=5)
    assert obs.errors.value({"reason": "oversize_reject"}) == 1
    with pytest.raises(ValueError):
        engine.submit([1, 2], max_new_tokens=5, temperature=-1.0)
    assert obs.errors.value({"reason": "bad_request"}) == 1
    engine.drain()
    engine.drain()  # one-way and idempotent: one ring event
    with pytest.raises(ValueError):
        engine.submit([1, 2], max_new_tokens=5)
    assert obs.errors.value({"reason": "draining"}) == 1
    ring = [(e["name"], e.get("args")) for e in obs.trace.ring.snapshot()]
    assert ring == [("error", {"reason": "oversize_reject"}),
                    ("error", {"reason": "bad_request"}), ("drain", None),
                    ("error", {"reason": "draining"})]


def test_pool_overflow_label(tiny_params):
    cfg = dict(TINY, max_seq_len=256)
    engine = ContinuousBatcher(tlm.LMConfig(**cfg), jax.device_get(
        jlm.DecoderLM(jlm.LMConfig(**cfg)).init_params(jax.random.PRNGKey(0))),
        device="cpu", **{**TINY_ENGINE, "cache_len": 256, "pool_blocks": 2})
    with pytest.raises(ValueError, match="pool"):
        engine.submit([1] * 4, max_new_tokens=200)
    assert engine.obs.errors.value({"reason": "pool_overflow"}) == 1


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_disabled_obs_views_equal_jax(tiny_params, paged):
    """obs=False: nothing recorded, the views keep JAX's keys with
    `obs_disabled` where JAX puts it, and equal JAX's dicts."""
    views = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            engine = JaxBatcher(jlm.LMConfig(**TINY), tiny_params, obs=False,
                                paged=paged, **TINY_ENGINE)
        else:
            engine = _tiny(tiny_params, obs=False, paged=paged)
        rid = engine.submit([1, 2, 3], max_new_tokens=4)
        out = engine.run()
        assert len(out[rid]) == 4
        assert engine.obs.trace.timeline(rid) is None
        assert engine.obs.trace.ring.snapshot() == []
        assert engine.obs.render() == "\n"
        views[pkg] = dict(
            occupancy=engine.occupancy(), kv=engine.kv_stats(),
            prefix=engine.prefix_stats(), spec=engine.spec_stats(),
            loop=engine.loop_stats(), sp=engine.sp_stats(),
            lora=engine.lora_stats(), quant=engine.quant_stats(),
            attrib=engine.attrib_stats(), slo=engine.slo_stats(),
            signals=(engine.saturation, engine.slo_ok),
            tp=engine.tp_stats(), state=engine.debug_state(),
        )
    port, want = views["port"], views["jax"]
    assert port == want
    assert port["occupancy"] == {"busy_slot_steps": 0, "total_slot_steps": 0,
                                 "occupancy": 0.0, "obs_disabled": True}
    for view in ("kv", "prefix", "loop", "sp", "quant", "tp", "attrib", "slo"):
        assert port[view]["obs_disabled"] is True, view
    assert port["signals"] == (None, None)
    assert port["kv"]["kv_hbm_bytes_per_resident_token"] is None
    pool = port["state"]["pool"]
    assert pool["free"] + pool["parked"] + pool["in_use"] == (
        pool["blocks_total"] - pool["scratch_blocks"] if paged else 0)


def test_disabled_obs_spec_and_lora_views_flagged(tiny_params):
    cfg = tlm.LMConfig(**TINY)
    engine = _tiny(tiny_params, obs=False, spec=True, draft_cfg=cfg,
                   draft_params=tiny_params,
                   adapters=tlora.AdapterSet.synthetic(cfg, k=2, rank=2))
    engine.submit([1, 2, 3], max_new_tokens=4, adapter=1)
    engine.run()
    assert engine.spec_stats()["obs_disabled"] is True
    assert engine.spec_stats()["verify_dispatches"] == 0
    assert engine.lora_stats()["obs_disabled"] is True
    assert not any(engine.lora_stats()["requests_total"].values())


def test_shared_serving_obs_between_two_engines(tiny_params):
    """`obs=<a ServingObs>` is shared, as in JAX: two engines write one
    registry and one trace."""
    obs = ServingObs()
    a, b = _tiny(tiny_params, obs=obs), _tiny(tiny_params, obs=obs)
    assert a.obs is b.obs is obs
    ra = a.submit([1, 2, 3], max_new_tokens=3)
    rb = b.submit([4, 5], max_new_tokens=2)
    a.run()
    b.run()
    assert obs.submitted.value() == 2 and obs.tokens.value() == 5
    assert obs.completed.value({"reason": "budget"}) == 2
    # Request ids are per engine: both spans are rid 0.
    assert ra == rb == 0 and obs.trace.timeline(0)["n_tokens"] == 2
    # Both engines' views read the one registry.
    assert a.occupancy() == b.occupancy()
    assert a.occupancy()["total_slot_steps"] == obs.dispatches.value() * 2 * 2
