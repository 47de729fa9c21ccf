"""The port's engine with its SLO and attribution layers against the JAX
engine's, on the CPU: tiny engines (LM_TINY's widths, f32, paged and
dense) on bridged weights serve the same greedy requests under the same
objectives.

What does not depend on wall time must be equal: tokens, dispatches per
composition class, the trailing window's length, the SLO windows' sample
counts, each objective's compliance and burn rate (objectives set far
past or far below any CPU latency), the saturation components and
`slo_ok`, and the attribution and SLO blocks of `debug_state()` in the
same fields. Both engines' SLO layers refresh at every sync (not once a
second of wall time), so their last refresh reads the same sync, over a
window longer than the run.
`slo_window_s` and `slo_objectives` are accepted, and an unknown
objective raises JAX's ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher

torch.set_num_threads(1)

FIELDS = dict(vocab_size=256, hidden_dim=128, num_layers=2, num_heads=4,
              max_seq_len=128, dtype="float32")
# An SLO window longer than any run here, so the windows hold every sample
# however slow the host.
ENGINE = dict(slots=2, cache_len=128, prompt_bucket=16, chunk_steps=4,
              slo_window_s=3600.0)
# Far past any CPU TTFT (met), far below any TPOT (breached).
OBJECTIVES = {"ttft_p99_s": 1000.0, "tpot_p99_s": 1e-9}
REQS = [(5, 9), (17, 6), (3, 12), (30, 5), (9, 7)]


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
    return jax.device_get(jax.jit(jlm.DecoderLM(cfg).init_params)(jax.random.PRNGKey(0)))


def _engine(pkg, params, paged, **kw):
    kw = {**ENGINE, "paged": paged, "slo_objectives": OBJECTIVES, **kw}
    if pkg == "jax":
        engine = JaxBatcher(jlm.LMConfig(**FIELDS), params, **kw)
    else:
        engine = ContinuousBatcher(tlm.LMConfig(**FIELDS), params,
                                   device="cpu", **kw)
    engine._slo.refresh_s = 0.0
    return engine


@pytest.fixture(scope="module")
def served(params):
    out = {}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n, _ in REQS]
    for paged in (True, False):
        for pkg in ("jax", "port"):
            engine = _engine(pkg, params, paged)
            rids = [engine.submit(p, max_new_tokens=m)
                    for p, (_, m) in zip(prompts, REQS)]
            done = engine.run()
            out[pkg, paged] = (engine, [done[r] for r in rids])
    return out


def _fixed(engine):
    """The engine's attribution and SLO readings that do not depend on
    wall time."""
    at, slo = engine.attrib_stats(), engine.slo_stats()
    return {
        "kinds": {k: v["dispatches"] for k, v in at["kinds"].items()},
        "window_dispatches": at["window_dispatches"],
        "roofline": (at["roofline_fraction"], at["hbm_bytes_per_step"]),
        "windows": {k: w["count"] for k, w in slo["windows"].items()},
        "window_s": slo["window_s"],
        "objectives": slo["objectives"],
        "slo_ok": slo["slo_ok"],
        "ok": slo["ok"],
        "burn_rate": slo["burn_rate"],
        "components": slo["saturation"]["components"],
        "saturation": (slo["saturation"]["value"], engine.saturation),
        "engine_slo_ok": engine.slo_ok,
    }


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_attribution_and_slo_equal_jax(served, paged):
    (jeng, jtok), (teng, ttok) = served["jax", paged], served["port", paged]
    assert ttok == jtok
    got, want = _fixed(teng), _fixed(jeng)
    assert got == want
    assert sum(got["kinds"].values()) == teng.obs.dispatches.value()
    assert got["windows"]["ttft"] == len(REQS)
    assert got["slo_ok"] == {"ttft_p99_s": True, "tpot_p99_s": False}
    assert got["burn_rate"]["tpot_p99_s"] == 100.0
    assert got["engine_slo_ok"] is False
    assert got["roofline"] == (None, None)  # no bandwidth on the CPU
    assert (got["components"]["pool"] is None) == (not paged)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_debug_state_blocks_equal_jax(served, paged):
    (jeng, _), (teng, _) = served["jax", paged], served["port", paged]
    got, want = teng.debug_state(), jeng.debug_state()
    assert list(got) == [k for k in want if k != "tp"]
    assert set(got["attrib"]) == set(want["attrib"])
    assert set(got["slo"]) == set(want["slo"])
    for view in ("attrib", "slo"):
        assert got[view]["kinds" if view == "attrib" else "windows"].keys() == (
            want[view]["kinds" if view == "attrib" else "windows"].keys())
    assert got["slo"]["burn_rate"] == want["slo"]["burn_rate"]
    assert got["attrib"]["window_dispatches"] == want["attrib"]["window_dispatches"]


def test_slo_options_equal_jax(params):
    for objectives in ({"nope_p99": 1.0}, {"ttft_s": 1.0}):
        errs = []
        for pkg in ("jax", "port"):
            with pytest.raises(ValueError) as err:
                _engine(pkg, params, True, slo_objectives=objectives)
            errs.append(str(err.value))
        assert errs[1] == errs[0]
    engine = _engine("port", params, True, slo_window_s=5.0,
                     slo_objectives={"ttft_p99_s": None})
    stats = engine.slo_stats()
    assert stats["window_s"] == 5.0 and stats["objectives"] == {}
    assert engine.saturation is None and engine.slo_ok is None
