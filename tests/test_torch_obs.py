"""The port's telemetry planes (`walkai_nos_tpu_torch/obs/`) against the
JAX package's (`walkai_nos_tpu/obs/`), on the CPU, no engine.

- JAX's unit cases of `tests/test_obs.py` (log buckets, histograms, the
  ring, exposition, the registry, request and router traces, the
  serving bundle, the profile hook), each parametrised over the two
  packages' modules;
- the same writes into both registries render the same text byte for
  byte, and the same events into both traces export the same Chrome
  JSON;
- the port's catalog equals JAX's spec by spec, and no metric name is
  registered in the port outside it (the rule `hack/metrics_lint.py`
  holds the JAX package to);
- `classify_dispatch` equals JAX's for every composition;
- one real `torch.profiler` window through the port's `ProfileHook`.
"""

import dataclasses
import json
import re
import threading
import types
from pathlib import Path

import pytest
import torch

from walkai_nos_tpu.obs import attrib as jattrib
from walkai_nos_tpu.obs import catalog as jcatalog
from walkai_nos_tpu.obs import metrics as jmetrics
from walkai_nos_tpu.obs import profile as jprofile
from walkai_nos_tpu.obs import serving as jserving
from walkai_nos_tpu.obs import trace as jtrace
from walkai_nos_tpu_torch.obs import attrib as tattrib
from walkai_nos_tpu_torch.obs import catalog as tcatalog
from walkai_nos_tpu_torch.obs import metrics as tmetrics
from walkai_nos_tpu_torch.obs import profile as tprofile
from walkai_nos_tpu_torch.obs import serving as tserving
from walkai_nos_tpu_torch.obs import trace as ttrace

PACKAGES = {
    "jax": types.SimpleNamespace(
        metrics=jmetrics, catalog=jcatalog, trace=jtrace, profile=jprofile,
        serving=jserving, attrib=jattrib,
    ),
    "port": types.SimpleNamespace(
        metrics=tmetrics, catalog=tcatalog, trace=ttrace, profile=tprofile,
        serving=tserving, attrib=tattrib,
    ),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# -- log buckets, histograms, the ring (JAX's cases) ---------------------------

def test_log_buckets_geometric_and_covering(pkg):
    b = pkg.metrics.log_buckets(1e-3, 100.0, per_decade=3)
    assert b[0] == 1e-3 and b[-1] >= 100.0 and list(b) == sorted(b)
    for i in range(len(b) - 1):
        r = b[i + 1] / b[i]
        assert abs(r - 10 ** (1 / 3)) / 10 ** (1 / 3) < 0.1


@pytest.mark.parametrize("args", [(0, 1.0), (1.0, 0.5), (1.0, 2.0, 0)])
def test_log_buckets_invalid_args_raise(pkg, args):
    with pytest.raises(ValueError):
        pkg.metrics.log_buckets(*args)


def _hist(pkg, bounds=(1.0, 2.0, 4.0, 8.0)):
    reg = pkg.metrics.Registry()
    return reg, reg.histogram("h_seconds", "t", buckets=bounds)


def test_histogram_bucket_boundaries_le_inclusive(pkg):
    reg, h = _hist(pkg)
    for v in (2.0, 2.001, 0.0):
        h.observe(v)
    text = reg.render()
    for le, n in (("1", 1), ("2", 2), ("4", 3), ("8", 3), ("+Inf", 3)):
        assert f'h_seconds_bucket{{le="{le}"}} {n}' in text


def test_histogram_overflow_counts_only_inf(pkg):
    reg, h = _hist(pkg)
    h.observe(9.5)
    assert h.count() == 1 and h.sum() == 9.5
    text = reg.render()
    assert 'h_seconds_bucket{le="8"} 0' in text
    assert 'h_seconds_bucket{le="+Inf"} 1' in text
    assert "h_seconds_count 1" in text


def test_histogram_quantile_within_one_bucket(pkg):
    _, h = _hist(pkg)
    for v in (0.5, 1.5, 3.0, 7.0):
        h.observe(v)
    assert [h.quantile(q) for q in (0.0, 0.25, 0.5, 1.0)] == [1.0, 1.0, 2.0, 8.0]


def test_histogram_quantile_overflow_clamps(pkg):
    _, h = _hist(pkg)
    h.observe(100.0)
    assert h.quantile(0.99) == 8.0


def test_histogram_quantile_empty_and_invalid(pkg):
    _, h = _hist(pkg)
    assert h.quantile(0.5) is None
    h.observe(1.0)
    with pytest.raises(ValueError):
        h.quantile(1.5)


def test_histogram_unsorted_buckets_rejected(pkg):
    with pytest.raises(ValueError):
        pkg.metrics.Registry().histogram("bad_seconds", "t", buckets=(2.0, 1.0))


def test_histogram_snapshot_counts(pkg):
    _, h = _hist(pkg)
    assert h.snapshot_counts() == ([0, 0, 0, 0], 0)
    for v in (0.5, 3.0, 30.0):
        h.observe(v)
    assert h.snapshot_counts() == ([1, 0, 1, 0], 3)


def test_ring_wraparound_keeps_newest_in_order(pkg):
    r = pkg.trace.Ring(4)
    for i in range(10):
        r.append(i)
    assert r.snapshot() == [6, 7, 8, 9] and r.dropped == 6 and len(r) == 4


def test_ring_underfill_in_order(pkg):
    r = pkg.trace.Ring(8)
    for i in range(3):
        r.append(i)
    assert r.snapshot() == [0, 1, 2] and r.dropped == 0 and len(r) == 3


def test_ring_exact_capacity_boundary(pkg):
    r = pkg.trace.Ring(3)
    for i in range(3):
        r.append(i)
    assert r.snapshot() == [0, 1, 2] and r.dropped == 0
    r.append(3)
    assert r.snapshot() == [1, 2, 3] and r.dropped == 1


def test_ring_zero_capacity_rejected(pkg):
    with pytest.raises(ValueError):
        pkg.trace.Ring(0)


# -- exposition and the registry (JAX's cases) ----------------------------------

# One Prometheus text-format sample line (tests/test_obs.py's `_SAMPLE`).
SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_+][a-zA-Z0-9_]*="[^"]*")*\})?'
    r" -?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?$"
)


def test_exposition_every_line_is_valid(pkg):
    reg = pkg.metrics.Registry()
    reg.counter("a_total", "help a").inc(2, {"x": "1"})
    reg.gauge("b", "help b").set(1.5)
    h = reg.histogram("c_seconds", "help c", buckets=(0.1, 1.0))
    h.observe(0.05, {"op": "q"})
    h.observe(50.0, {"op": "q"})
    text = reg.render()
    assert text.endswith("\n")
    for line in text.strip().splitlines():
        if not line.startswith(("# HELP ", "# TYPE ")):
            assert SAMPLE.match(line), line


def test_exposition_help_and_type_lines(pkg):
    reg = pkg.metrics.Registry()
    reg.counter("x_total", "counts xs").inc()
    text = reg.render()
    assert "# HELP x_total counts xs" in text and "# TYPE x_total counter" in text


def test_exposition_histogram_contract(pkg):
    reg = pkg.metrics.Registry()
    h = reg.histogram("d_seconds", "t", buckets=(1.0, 2.0))
    for v in (0.5, 0.6, 1.5, 9.0):
        h.observe(v)
    text = reg.render()
    for line in ('d_seconds_bucket{le="1"} 2', 'd_seconds_bucket{le="2"} 3',
                 'd_seconds_bucket{le="+Inf"} 4', "d_seconds_count 4",
                 "d_seconds_sum 11.6"):
        assert line in text


def test_exposition_label_escaping(pkg):
    reg = pkg.metrics.Registry()
    reg.counter("e_total", "t").inc(1, {"r": 'bad "q"\nline'})
    assert 'r="bad \\"q\\"\\nline"' in reg.render()


def test_exposition_unobserved_metrics_omitted(pkg):
    reg = pkg.metrics.Registry()
    reg.counter("never_total", "t")
    assert "never_total" not in reg.render()


def test_exposition_nonfinite_values(pkg):
    reg = pkg.metrics.Registry()
    for name, v in (("ratio", float("inf")), ("neg", float("-inf")),
                    ("nan", float("nan")), ("ok", 1.0)):
        reg.gauge(name, "t").set(v)
    text = reg.render()
    for line in ("ratio +Inf", "neg -Inf", "nan NaN", "ok 1"):
        assert line in text


def test_registry_get_or_create_and_kind_conflict(pkg):
    reg = pkg.metrics.Registry()
    c1 = reg.counter("x_total", "first help")
    assert reg.counter("x_total", "different help") is c1
    assert c1.help == "first help"
    with pytest.raises(ValueError):
        reg.gauge("x_total", "now a gauge?")


def test_registry_concurrent_registration_single_winner(pkg):
    reg = pkg.metrics.Registry()
    out = []
    threads = [threading.Thread(target=lambda: out.append(reg.counter("race_total", "t")))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == 8 and all(m is out[0] for m in out)


def test_registry_disabled_noops(pkg):
    reg = pkg.metrics.Registry(enabled=False)
    c, g = reg.counter("x_total", "t"), reg.gauge("g", "t")
    h = reg.histogram("h_seconds", "t", buckets=(1.0,))
    c.inc(5)
    g.set(2)
    g.set_min(1)
    h.observe(0.5)
    assert c.value() == 0.0 and g.value() is None and h.count() == 0
    assert reg.render() == "\n"


def test_registry_counter_rejects_decrease(pkg):
    with pytest.raises(ValueError):
        pkg.metrics.Registry().counter("x_total", "t").inc(-1)


def test_registry_gauge_set_min_is_low_watermark(pkg):
    g = pkg.metrics.Registry().gauge("w", "t")
    for v in (5, 3, 9):
        g.set_min(v)
    assert g.value() == 3


def test_registry_gauge_remove_drops_one_series(pkg):
    reg = pkg.metrics.Registry()
    g = reg.gauge("members", "t")
    g.set(0.7, labels={"replica": "a"})
    g.set(0.2, labels={"replica": "b"})
    g.remove(labels={"replica": "a"})
    assert g.value(labels={"replica": "a"}) is None
    assert g.value(labels={"replica": "b"}) == 0.2
    assert 'members{replica="a"}' not in reg.render()
    assert 'members{replica="b"} 0.2' in reg.render()
    g.remove(labels={"replica": "a"})


def _write_everything(reg, metrics):
    """A fixed script of writes: labels, escapes, watermarks, removals,
    non-finite gauges, default and custom buckets, the overflow."""
    reg.counter("z_requests_total", "reqs").inc(3, {"reason": "eos"})
    reg.counter("z_requests_total", "reqs").inc(0.25, {"reason": 'a"b\\c\nd'})
    reg.counter("a_plain_total", "").inc()
    g = reg.gauge("m_gauge", "a gauge")
    g.set(1e-7, {"state": "free"})
    g.set(12345678901.5, {"state": "used"})
    g.set(2, {"state": "gone"})
    g.remove({"state": "gone"})
    reg.gauge("m_low", "low").set_min(4)
    reg.gauge("m_low", "low").set_min(7)
    reg.gauge("m_inf", "inf").set(float("-inf"))
    h = reg.histogram("t_seconds", "default buckets")
    for v in (0.0, 1e-3, 0.0215, 3.3, 99.0, 1e9):
        h.observe(v, {"kind": "decode"})
    h.observe(0.5)
    reg.histogram("u_tokens", "custom", buckets=metrics.log_buckets(1, 64, 2)).observe(9)
    reg.histogram("v_unobserved_seconds", "never")


def test_render_byte_for_byte_equal_to_jax():
    texts = []
    for p in (PACKAGES["jax"], PACKAGES["port"]):
        reg = p.metrics.Registry()
        _write_everything(reg, p.metrics)
        texts.append((reg.render(), reg.describe()))
    assert texts[0] == texts[1]
    assert "v_unobserved_seconds" not in texts[1][0]


def test_serving_bundle_render_equal_to_jax():
    """Every serving series written the same way in both bundles."""
    texts = []
    for p in (PACKAGES["jax"], PACKAGES["port"]):
        obs = p.serving.ServingObs()
        for i, spec in enumerate(p.catalog.serving_specs()):
            inst = getattr(obs, spec.attr)
            labels = {k: f"v{i}" for k in spec.labels} or None
            if spec.kind == "counter":
                inst.inc(i + 0.5, labels)
            elif spec.kind == "gauge":
                inst.set(i / 7, labels)
            else:
                for v in (1e-5, i * 1e-3, i, 1e6):
                    inst.observe(v, labels)
        texts.append(obs.render())
    assert texts[0] == texts[1]
    assert texts[1].count("# TYPE ") == 77


def test_serving_bundle_catalog_attrs_built(pkg):
    obs = pkg.serving.ServingObs()
    for spec in pkg.catalog.serving_specs():
        inst = getattr(obs, spec.attr)
        assert inst.name == spec.name and inst.kind == spec.kind
        if spec.kind == "histogram":
            assert inst.bounds == tuple(spec.buckets or jmetrics.DEFAULT_TIME_BUCKETS)


def test_serving_bundle_disabled_is_a_noop(pkg):
    obs = pkg.serving.ServingObs(enabled=False)
    obs.submitted.inc()
    obs.ttft.observe(0.1)
    obs.trace.submit(1, 0.0, 3, 4)
    assert obs.submitted.value() == 0 and obs.ttft.count() == 0
    assert obs.trace.timeline(1) is None and obs.render() == "\n"


def test_serving_bundle_shared_registry(pkg):
    reg = pkg.metrics.Registry()
    a = pkg.serving.ServingObs(registry=reg)
    b = pkg.serving.ServingObs(registry=reg)
    a.submitted.inc()
    b.submitted.inc(2)
    assert a.submitted is b.submitted and a.submitted.value() == 3


# -- the catalog ----------------------------------------------------------------

def test_catalog_equals_jax_spec_by_spec():
    got = [dataclasses.asdict(s) for s in tcatalog.CATALOG]
    want = [dataclasses.asdict(s) for s in jcatalog.CATALOG]
    assert got == want
    assert (len(tcatalog.CATALOG), len(tcatalog.serving_specs()),
            len(tcatalog.router_specs())) == (111, 77, 25)
    for fn in ("serving_specs", "router_specs"):
        assert ([s.name for s in getattr(tcatalog, fn)()]
                == [s.name for s in getattr(jcatalog, fn)()])


def test_catalog_check_rejects_duplicates(monkeypatch):
    spec = tcatalog.CATALOG[0]
    monkeypatch.setattr(tcatalog, "CATALOG", tcatalog.CATALOG + (spec,))
    with pytest.raises(ValueError, match="duplicate"):
        tcatalog._check()


# `hack/metrics_lint.py`'s registration patterns: a literal name handed to
# a registry outside the catalog is a metric nobody declared.
REGISTRATIONS = (
    re.compile(r'\.counter\(\s*"([^"]+)"'),
    re.compile(r'\.gauge\(\s*"([^"]+)"'),
    re.compile(r'\.histogram\(\s*"([^"]+)"'),
    re.compile(r'\bcounter_add\(\s*"([^"]+)"'),
    re.compile(r'\bgauge_set\(\s*"([^"]+)"'),
)
PORT = Path(__file__).resolve().parent.parent / "walkai_nos_tpu_torch"


def _registered_literals(root: Path) -> dict:
    out = {}
    for path in sorted(root.rglob("*.py")):
        if "_kernels_build" in path.relative_to(root).parts:
            continue  # build outputs, not sources
        if path.name == "metrics.py" and path.parent.name == "obs":
            continue  # the registry itself passes variables
        text = path.read_text()
        for pattern in REGISTRATIONS:
            for name in pattern.findall(text):
                out.setdefault(name, []).append(str(path.relative_to(root)))
    return out


def test_no_metric_registered_outside_the_catalog(tmp_path):
    names = {s.name for s in tcatalog.CATALOG}
    stray = {n: f for n, f in _registered_literals(PORT).items() if n not in names}
    assert stray == {}
    # The scan finds what it looks for.
    (tmp_path / "m.py").write_text('reg.counter("cb_undeclared_total", "x")\n')
    assert _registered_literals(tmp_path) == {"cb_undeclared_total": ["m.py"]}


def test_models_hold_no_literal_metric_name():
    """The engine writes through the bundle's attributes only."""
    for path in sorted((PORT / "models").rglob("*.py")):
        text = path.read_text()
        for spec in tcatalog.serving_specs():
            assert f'"{spec.name}"' not in text, (path.name, spec.name)


# -- traces ---------------------------------------------------------------------

def test_request_trace_span_math_uses_caller_clock(pkg):
    tr = pkg.trace.RequestTrace()
    tr.submit(7, 100.0, prompt_len=4, max_new=8)
    tr.admitted(7, 100.5, slot=1, blocks=2)
    tr.first_token(7, 101.25)
    tr.done(7, 103.0, "eos", 5)
    assert tr.ttft_s(7) == 1.25 and tr.wall_s(7) == 3.0
    tl = tr.timeline(7)
    assert tl["reason"] == "eos" and tl["slot"] == 1


def test_request_trace_done_retention_bounded(pkg):
    tr = pkg.trace.RequestTrace(keep_done=2)
    for rid in range(5):
        tr.submit(rid, float(rid), 1, 1)
        tr.done(rid, float(rid) + 1, "budget", 1)
    assert tr.ttft_s(0) is None and tr.wall_s(4) == 1.0


def test_request_trace_disabled_records_nothing(pkg):
    tr = pkg.trace.RequestTrace(enabled=False)
    tr.submit(1, 0.0, 1, 1)
    assert tr.timeline(1) is None and tr.ring.snapshot() == []


def test_request_trace_chrome_structure(pkg):
    tr = pkg.trace.RequestTrace()
    tr.submit(3, 10.0, 4, 8)
    tr.admitted(3, 10.1, slot=0, blocks=1)
    tr.prefill_chunk(3, 10.15, 4, 4)
    tr.first_token(3, 10.2)
    tr.done(3, 10.9, "budget", 8)
    tr.error(11.0, "oversize_reject")
    events = tr.chrome_trace()["traceEvents"]
    assert {"queued", "prefill", "decode", "error"} <= {e["name"] for e in events}
    for e in events:
        assert e["ph"] in ("X", "i", "M")
        if e["ph"] == "X":
            assert isinstance(e["ts"], int) and isinstance(e["dur"], int) and e["dur"] >= 0
    decode = next(e for e in events if e["name"] == "decode")
    assert decode["ts"] == 200_000 and decode["dur"] == 700_000


def test_request_trace_empty_exports(pkg):
    ct = pkg.trace.RequestTrace().chrome_trace()
    assert ct["traceEvents"] == []
    assert ct["otherData"]["clock_origin_monotonic_s"] is None


def test_request_trace_id_rides_spans_and_chrome_args(pkg):
    tr = pkg.trace.RequestTrace()
    tr.submit(3, 10.0, 4, 8, trace_id="abc-123")
    tr.admitted(3, 10.1, slot=0, blocks=1)
    tr.first_token(3, 10.2)
    tr.done(3, 10.9, "budget", 8)
    assert tr.timeline(3)["trace_id"] == "abc-123"
    ct = tr.chrome_trace()
    decode = next(e for e in ct["traceEvents"] if e["name"] == "decode")
    assert decode["args"]["trace_id"] == "abc-123"
    assert decode["args"]["ttft_s"] == tr.ttft_s(3)
    assert ct["otherData"]["clock_origin_monotonic_s"] == 10.0


@pytest.mark.parametrize("value,ok", [("ab-1.2:x_y", True), ("", False),
                                     ("a b", False), ("x" * 65, False), (7, False)])
def test_valid_trace_id(pkg, value, ok):
    assert pkg.trace.valid_trace_id(value) == (value if ok else None)


def _request_events(tr):
    """Every recording method, a ring that wraps and spans that retire."""
    for rid in range(6):
        t = 10.0 + rid
        tr.submit(rid, t, 3 + rid, 8, trace_id=f"t{rid}" if rid % 2 else None)
        tr.admitted(rid, t + 0.1, slot=rid % 2, blocks=1, cached=128 * (rid % 3))
        tr.prefill_chunk(rid, t + 0.15, 64, 3 + rid)
        tr.dispatch(t + 0.16, "mixed", 4, 0.0012345, 0.0456789)
        tr.spec_round(t + 0.17, 4, 2, 3)
        tr.first_token(rid, t + 0.2)
        if rid == 4:
            tr.error(t + 0.3, "engine_failure", rid=rid, detail="x")
        else:
            tr.done(rid, t + 0.9 + rid / 10, "budget", 8)
    tr.error(20.0, "oversize_reject")
    tr.event("drain", 20.5)
    tr.event("export_resident", 21.0, requests=2, migrated=1)


def test_request_trace_chrome_json_equal_to_jax():
    out = []
    for p in (PACKAGES["jax"], PACKAGES["port"]):
        tr = p.trace.RequestTrace(capacity=16, keep_done=4)
        _request_events(tr)
        out.append((json.dumps(tr.chrome_trace(), sort_keys=True),
                    tr.spans(), tr.ring.snapshot(), tr.ring.dropped))
    assert out[0] == out[1]
    assert out[1][3] > 0  # the ring wrapped


def test_router_trace_spans_and_ring_export(pkg):
    tr = pkg.trace.RouterTrace()
    tr.submit(7, trace_id="id7", t_submit=10.0, t_routed=10.02, replica="r0",
              policy="affinity", t_enqueue=9.99, affinity_key=0xDEADBEEF)
    tr.event("scale_up", 10.5, replica="spare0", reason="saturation")
    tr.collected(7, 11.0)
    ct = tr.chrome_trace()
    events = ct["traceEvents"]
    assert [e["name"] for e in events if e.get("ph") == "X"] == [
        "queue_wait", "route", "replica_roundtrip"]
    route = next(e for e in events if e["name"] == "route")
    assert route["args"] == {"trace_id": "id7", "replica": "r0",
                             "policy": "affinity", "affinity_key": "deadbeef"}
    rt = next(e for e in events if e["name"] == "replica_roundtrip")
    assert rt["dur"] == 980_000
    scale = next(e for e in events if e["name"] == "scale_up")
    assert scale["ph"] == "i" and scale["tid"] == 0
    assert ct["otherData"]["clock_origin_monotonic_s"] == 9.99


def test_router_trace_retention_and_disabled(pkg):
    tr = pkg.trace.RouterTrace(keep_done=1)
    for rid in range(3):
        tr.submit(rid, trace_id=f"t{rid}", t_submit=float(rid),
                  t_routed=float(rid) + 0.1, replica="r", policy="p2c")
        tr.collected(rid, float(rid) + 0.5)
    assert len(tr.spans()) == 1
    off = pkg.trace.RouterTrace(enabled=False)
    off.submit(0, trace_id="x", t_submit=0.0, t_routed=0.1, replica="r", policy="p2c")
    off.event("scale_up", 0.0)
    assert off.spans() == [] and off.chrome_trace()["traceEvents"] == []


def test_router_trace_chrome_json_equal_to_jax():
    out = []
    for p in (PACKAGES["jax"], PACKAGES["port"]):
        tr = p.trace.RouterTrace(capacity=8, keep_done=3)
        for rid in range(6):
            tr.submit(rid, trace_id=f"id{rid}", t_submit=1.0 + rid,
                      t_routed=1.01 + rid, replica=f"r{rid % 2}", policy="p2c",
                      t_enqueue=0.99 + rid if rid % 2 else None,
                      affinity_key=rid * 977 if rid % 3 else None)
            tr.event("anomaly_flagged", 1.5 + rid, replica="r0")
            if rid != 2:
                tr.collected(rid, 1.8 + rid)
        out.append((json.dumps(tr.chrome_trace(), sort_keys=True), tr.spans()))
    assert out[0] == out[1]


# -- dispatch classes -------------------------------------------------------------

def test_classify_dispatch_equals_jax_for_every_composition():
    assert tattrib.DISPATCH_KINDS == jattrib.DISPATCH_KINDS
    seen = set()
    for busy in range(4):
        for rows in range(4):
            for spec in (False, True):
                got = tattrib.classify_dispatch(busy, rows, spec)
                assert got == jattrib.classify_dispatch(busy, rows, spec)
                seen.add(got)
    assert seen == set(tattrib.DISPATCH_KINDS)


# -- the profile hook (JAX's cases) ------------------------------------------------

class _FakeProfile:
    """Stands in for `torch.profiler.profile` in the port's hook."""

    def __init__(self, calls, fail=None, **kwargs):
        self.calls, self.fail = calls, fail

    def __enter__(self):
        if self.fail == "start":
            raise RuntimeError("no profiler here")
        self.calls.append(("start",))
        return self

    def __exit__(self, *exc):
        self.calls.append(("stop",))

    def export_chrome_trace(self, path):
        if self.fail == "stop":
            raise OSError("disk full")


def _patched(pkg, monkeypatch, fail=None):
    """The profiler calls each package's hook makes, recorded as
    ("start",) / ("stop",)."""
    calls = []
    if pkg is PACKAGES["jax"]:
        import jax

        def start(logdir):
            if fail == "start":
                raise RuntimeError("no profiler here")
            calls.append(("start",))

        def stop():
            calls.append(("stop",))
            if fail == "stop":
                raise OSError("disk full")

        monkeypatch.setattr(jax.profiler, "start_trace", start)
        monkeypatch.setattr(jax.profiler, "stop_trace", stop)
    else:
        monkeypatch.setattr(torch.profiler, "profile",
                            lambda **kw: _FakeProfile(calls, fail, **kw))
    return calls


def test_profile_window_covers_exactly_n_dispatches(pkg, monkeypatch, tmp_path):
    calls = _patched(pkg, monkeypatch)
    hook = pkg.profile.ProfileHook()
    hook.arm(3, str(tmp_path))
    for _ in range(5):
        hook.on_dispatch()
    assert calls == [("start",), ("stop",)]
    s = hook.status()
    assert (s["completed_windows"], s["active"], s["remaining_dispatches"]) == (1, False, 0)
    assert s["last_error"] is None


def test_profile_unarmed_is_noop(pkg, monkeypatch):
    calls = _patched(pkg, monkeypatch)
    hook = pkg.profile.ProfileHook()
    for _ in range(10):
        hook.on_dispatch()
    assert calls == []


def test_profile_start_failure_disarms(pkg, monkeypatch, tmp_path):
    calls = _patched(pkg, monkeypatch, fail="start")
    hook = pkg.profile.ProfileHook()
    hook.arm(2, str(tmp_path))
    hook.on_dispatch()
    hook.on_dispatch()  # must not retry or raise
    s = hook.status()
    assert s["active"] is False and s["remaining_dispatches"] == 0
    assert "no profiler here" in s["last_error"] and calls == []


def test_profile_stop_failure_is_recorded(pkg, monkeypatch, tmp_path):
    _patched(pkg, monkeypatch, fail="stop")
    hook = pkg.profile.ProfileHook()
    hook.arm(1, str(tmp_path))
    hook.on_dispatch()
    s = hook.status()
    assert s["completed_windows"] == 1 and s["active"] is False
    assert "disk full" in s["last_error"] and s["last_error"].startswith("stop_trace")


def test_profile_arm_validation(pkg):
    hook = pkg.profile.ProfileHook()
    with pytest.raises(ValueError):
        hook.arm(0, "/tmp/p")
    with pytest.raises(ValueError):
        hook.arm(3, "")


def test_profile_rearm_while_active_rejected(pkg, monkeypatch, tmp_path):
    _patched(pkg, monkeypatch)
    hook = pkg.profile.ProfileHook()
    hook.arm(3, str(tmp_path))
    hook.on_dispatch()
    with pytest.raises(RuntimeError):
        hook.arm(2, str(tmp_path))


def test_profile_from_env(pkg):
    hook = pkg.profile.ProfileHook.from_env(
        {"WALKAI_PROFILE_DIR": "/tmp/x", "WALKAI_PROFILE_DISPATCHES": "7"})
    assert hook.status()["remaining_dispatches"] == 7
    assert pkg.profile.ProfileHook.from_env(
        {"WALKAI_PROFILE_DIR": "/tmp/x", "WALKAI_PROFILE_DISPATCHES": "x"}
    ).status()["remaining_dispatches"] == 20
    assert pkg.profile.ProfileHook.from_env({}).status()["remaining_dispatches"] == 0


def test_profile_disabled_bundle_never_arms_from_env(pkg, monkeypatch):
    monkeypatch.setenv("WALKAI_PROFILE_DIR", "/tmp/prof")
    monkeypatch.setenv("WALKAI_PROFILE_DISPATCHES", "5")
    assert pkg.serving.ServingObs(enabled=False).profile.status()[
        "remaining_dispatches"] == 0
    assert pkg.serving.ServingObs(enabled=True).profile.status()[
        "remaining_dispatches"] == 5


def test_profile_real_torch_window_writes_a_trace(tmp_path):
    """A real `torch.profiler` window on the CPU: nothing is written
    before the n-th dispatch, one Chrome trace after it, holding the
    operators run between the first call and the n-th."""
    hook = tprofile.ProfileHook()
    hook.arm(3, str(tmp_path))
    a = torch.ones(8, 8)
    for i in range(3):
        assert not list(tmp_path.iterdir())
        hook.on_dispatch()
        a = torch.mm(a, a) / 8
    s = hook.status()
    assert s["completed_windows"] == 1 and s["last_error"] is None
    files = list(tmp_path.iterdir())
    assert [str(f) for f in files] == [s["last_trace"]]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert sum(1 for e in events if e.get("name") == "aten::mm") == 2
