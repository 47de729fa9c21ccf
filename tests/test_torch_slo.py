"""The port's SLO layer (`walkai_nos_tpu_torch/obs/slo.py`) against the
JAX package's (`walkai_nos_tpu/obs/slo.py`), on scripted clocks, no
engine.

- JAX's own `TestBucketRing` and `TestSloTracker` cases
  (`tests/test_obs.py`), run unchanged against the port's modules;
- the same observations and the same clock through both packages'
  `ServingObs` + `SloTracker`: bursts, a gap longer than the window,
  partial windows, objectives met and breached, queue trends and pool
  headroom, drawn by hypothesis. Every `stats(now)`, `ok_at`,
  `saturation`, `ok` and the rendered registry must be equal (exact: the
  two compute on the same floats in the same order).
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from jax_cases import cases, port_copy, run_case
from walkai_nos_tpu.obs.serving import ServingObs as JaxObs
from walkai_nos_tpu.obs.slo import BucketRing as JaxRing
from walkai_nos_tpu.obs.slo import SloTracker as JaxTracker
from walkai_nos_tpu_torch.obs import slo as tslo
from walkai_nos_tpu_torch.obs.serving import ServingObs

JAX_TESTS = port_copy("test_obs")
CASES = cases(JAX_TESTS, ("TestBucketRing", "TestSloTracker"))


def test_the_copy_runs_the_port():
    assert JAX_TESTS["BucketRing"] is tslo.BucketRing
    assert JAX_TESTS["SloTracker"] is tslo.SloTracker
    assert JAX_TESTS["ServingObs"] is ServingObs
    assert len(CASES) == 14


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c}.{n}" for c, n in CASES])
def test_jax_case_on_the_port(cls, name, request):
    run_case(JAX_TESTS, cls, name, request)


def test_surface_equals_jax():
    from walkai_nos_tpu.obs import slo as jslo

    assert tslo.SATURATION_SIGNALS == jslo.SATURATION_SIGNALS
    assert tslo.OBJECTIVES == jslo.OBJECTIVES
    assert tslo.__all__ == jslo.__all__


# -- both packages on one scripted trace ---------------------------------------

# An operation: ("obs", histogram, value) | ("sync", dt, queue, busy,
# headroom) | ("read", dt).
_HIST = st.sampled_from(("ttft", "tpot", "dispatch_latency"))
_VALUE = st.one_of(
    st.sampled_from((0.0005, 0.02, 0.3, 1.0, 2.5, 9.0, 70.0, 400.0)),
    st.floats(1e-4, 500.0),
)
_OP = st.one_of(
    st.tuples(st.just("obs"), _HIST, _VALUE),
    st.tuples(
        st.just("sync"),
        st.one_of(st.floats(0.0, 3.0), st.sampled_from((0.0, 45.0, 400.0))),
        st.integers(0, 20),
        st.integers(0, 4),
        st.one_of(st.none(), st.floats(0.0, 1.0)),
    ),
    st.tuples(st.just("read"), st.one_of(st.floats(0.0, 5.0), st.just(120.0))),
)
_OBJECTIVES = st.one_of(
    st.none(),
    st.fixed_dictionaries({}, optional={
        "ttft_p99_s": st.sampled_from((0.5, 1.0, 10.0)),
        "tpot_p99_s": st.sampled_from((1e-4, 0.05, 1.0)),
    }),
)


def _both(objectives, window_s, refresh_s):
    out = []
    for obs_cls, tracker_cls in ((JaxObs, JaxTracker),
                                 (ServingObs, tslo.SloTracker)):
        obs = obs_cls()
        out.append((obs, tracker_cls(
            obs, slots=4, window_s=window_s, buckets=5,
            objectives=objectives, refresh_s=refresh_s,
        )))
    return out


def _read(obs, tracker, now):
    return (
        tracker.stats(now), tracker.ok_at(now), tracker.saturation,
        tracker.ok, obs.render(),
    )


@settings(max_examples=60, deadline=None)
@given(
    ops=st.lists(_OP, min_size=1, max_size=40),
    objectives=_OBJECTIVES,
    window_s=st.sampled_from((10.0, 30.0)),
    refresh_s=st.sampled_from((0.0, 1.0)),
)
def test_scripted_traces_read_as_in_jax(ops, objectives, window_s, refresh_s):
    pair = _both(objectives, window_s, refresh_s)
    now = 0.0
    for op in ops:
        if op[0] == "obs":
            for obs, _ in pair:
                getattr(obs, op[1]).observe(op[2])
            continue
        now += op[1]
        if op[0] == "sync":
            for _, tracker in pair:
                tracker.on_sync(now, queue_depth=op[2], busy_slots=op[3],
                                headroom_frac=op[4])
        (jobs, jtr), (tobs, ttr) = pair
        assert _read(tobs, ttr, now) == _read(jobs, jtr, now)


@pytest.mark.parametrize("window_s,buckets", [(10.0, 5), (30.0, 15), (1.0, 1)])
def test_ring_window_counts_equal_jax(window_s, buckets):
    """A long scripted run with a gap past the window, through both
    packages' rings over the same histogram writes."""
    jobs, tobs = JaxObs(), ServingObs()
    rings = (JaxRing(jobs.ttft, window_s=window_s, buckets=buckets),
             tslo.BucketRing(tobs.ttft, window_s=window_s, buckets=buckets))
    t = 0.0
    for i in range(200):
        t += 0.37 if i != 120 else 5 * window_s
        for obs in (jobs, tobs):
            obs.ttft.observe(0.01 * (i % 17) + (3.0 if i > 150 else 0.0))
        for ring in rings:
            ring.advance(t)
        for probe in (t, t + window_s / 2, t + 2 * window_s):
            j, p = (
                (r.window_counts(probe), r.quantile(0.5, probe),
                 r.quantile(0.99, probe), r.frac_over(0.1, probe))
                for r in rings
            )
            assert p == j
