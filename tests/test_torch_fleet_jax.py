"""One fleet end to end against JAX's: a two-replica JAX `FleetRouter` over
JAX engines and the port's over port engines, on bridged f32 weights
(`tests/test_router.py`'s engine config), serve one short trace in two
waves. Routes, tokens, the fleet prefix hit rate and every replica's
saturation must be identical.

Routing reads each engine's saturation, which its SLO layer refreshes
at most once a second of wall time by default: both packages' engines
here refresh at every sync, so a reading depends on the dispatches
only. The fleets run without the straggler detector, whose signals are
wall times.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu import router as jrouter
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch import router as trouter
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher

torch.set_num_threads(1)

FIELDS = dict(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2,
              max_seq_len=512, dtype="float32")
# An SLO window longer than any run here: the saturation's queue-trend term
# then reads every queue sample however slow the host.
ENGINE = dict(slots=2, cache_len=256, chunk_steps=4, pool_blocks=13,
              prefill_lanes=1, slo_window_s=3600.0)


def _jax_dev(self, a):
    return jnp.asarray(np.array(a, copy=True))


@pytest.fixture(scope="module", autouse=True)
def _jax_copies():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        yield


def _waves():
    rng = np.random.default_rng(5)
    bases = [rng.integers(0, 64, 128).astype(np.int32) for _ in range(3)]
    order = [[0, 1, 0, 2, 0, 1], [1, 0, 2, 0]]
    return [[np.concatenate([bases[t], rng.integers(0, 64, 3 + i)])
             for i, t in enumerate(wave)] for wave in order]


def _serve(pkg, params):
    if pkg == "jax":
        cfg, mod = jlm.LMConfig(**FIELDS), jrouter
        make = lambda: JaxBatcher(cfg, params, **ENGINE)  # noqa: E731
    else:
        cfg, mod = tlm.LMConfig(**FIELDS), trouter
        model = tlm.DecoderLM.from_params(cfg, params, torch.device("cpu"))
        make = lambda: ContinuousBatcher(cfg, model, device="cpu",  # noqa: E731
                                         **ENGINE)
    replicas = []
    for i in range(2):
        engine = make()
        engine._slo.refresh_s = 0.0
        replicas.append(mod.EngineReplica(engine, name=f"r{i}"))
    router = mod.FleetRouter(replicas, seed=0, anomaly=False)
    routes, tokens, sats = [], {}, []
    for wave in _waves():
        rids = [router.submit(p, max_new_tokens=6) for p in wave]
        routes += [(rid, router._routes[rid][0].name) for rid in rids]
        tokens.update(router.run())
        sats.append([r.saturation for r in replicas])
    return routes, tokens, router.prefix_hit_rate, sats, router.stats()


def test_fleet_routes_and_tokens_equal_jax():
    cfg = jlm.LMConfig(**FIELDS)
    params = jax.device_get(jax.jit(jlm.DecoderLM(cfg).init_params)(jax.random.PRNGKey(0)))
    (jr, jt, jh, js, jst), (tr, tt, th, ts, tst) = (
        _serve(pkg, params) for pkg in ("jax", "port"))
    assert tr == jr
    assert tt == jt
    assert th == jh and th > 0
    assert ts == js
    assert {r for _, r in tr} == {"r0", "r1"}
    for key in ("policy", "active", "affinity_keys", "prefix_hit_rate",
                "scale_events", "in_flight", "xfer_bytes"):
        assert tst[key] == jst[key], key
