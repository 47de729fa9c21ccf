"""The port's dispatch attribution (`walkai_nos_tpu_torch/obs/attrib.py`)
against the JAX package's, on the CPU, no engine.

- JAX's own `TestDispatchAttribution` cases (`tests/test_obs.py`), run
  unchanged against the port's modules;
- the same `record` sequences through both packages' `DispatchAttribution`
  with a bandwidth and without, over windows that evict: `stats()`, every
  gauge and the rendered registry equal (exact);
- the cost model's byte counts: `params_hbm_bytes` of the port's serving
  model equals JAX's of the bridged tree for f32 and int8 weights, and
  `kv_hbm_bytes_per_token` is equal for every `kv_dtype`, and is the
  engine's own figure.
"""

import jax
import numpy as np
import pytest
import torch

from jax_cases import cases, port_copy, run_case
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.obs import attrib as jattrib
from walkai_nos_tpu.obs.serving import ServingObs as JaxObs
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.obs import attrib as tattrib
from walkai_nos_tpu_torch.obs.serving import ServingObs

JAX_TESTS = port_copy("test_obs")
CASES = cases(JAX_TESTS, ("TestDispatchAttribution",))


def test_the_copy_runs_the_port():
    assert JAX_TESTS["DispatchAttribution"] is tattrib.DispatchAttribution
    assert len(CASES) == 3


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c}.{n}" for c, n in CASES])
def test_jax_case_on_the_port(cls, name, request):
    run_case(JAX_TESTS, cls, name, request)


def test_surface_equals_jax():
    assert tattrib.__all__ == jattrib.__all__
    assert tattrib.DISPATCH_KINDS == jattrib.DISPATCH_KINDS


def _records(seed, n):
    rng = np.random.default_rng(seed)
    kinds = tattrib.DISPATCH_KINDS
    for _ in range(n):
        yield dict(
            kind=kinds[int(rng.integers(len(kinds)))],
            steps=int(rng.integers(1, 9)),
            host_s=float(rng.choice([0.0, rng.exponential(0.02)])),
            device_s=float(rng.choice([0.0, 1e-9, rng.exponential(0.005)])),
            resident_tokens=int(rng.integers(0, 4096)),
            busy_slots=int(rng.integers(0, 9)),
        )


@pytest.mark.parametrize("bw", [None, 3.35e12, 1e6], ids=["no-bw", "h100", "slow"])
@pytest.mark.parametrize("window", [1, 4, 128])
@pytest.mark.parametrize("enabled", [True, False], ids=["on", "off"])
def test_record_sequences_equal_jax(bw, window, enabled):
    pair = []
    for obs_cls, mod in ((JaxObs, jattrib), (ServingObs, tattrib)):
        obs = obs_cls(enabled=enabled)
        pair.append((obs, mod.DispatchAttribution(
            obs, param_bytes=2_200_000_000, kv_bytes_per_token=45_056,
            hbm_bytes_per_s=bw, ici_bytes_per_token=0.0, window=window,
        )))
    for i, rec in enumerate(_records(window, 40)):
        for _, attr in pair:
            attr.record(**rec)
        (jobs, jattr), (tobs, tattr) = pair
        assert tattr.stats() == jattr.stats(), i
        assert tobs.render() == jobs.render(), i
    st = pair[1][1].stats()
    if enabled:
        assert st["window_dispatches"] == min(window, 40)
        assert (st["roofline_fraction"] is None) == (bw is None)
        if st["roofline_fraction"] is not None:
            assert 0.0 < st["roofline_fraction"] <= 1.0
    else:
        assert st["obs_disabled"] is True


def test_interconnect_term_equals_jax():
    """The TP term is computed as JAX's (the port serves tp 1, where it
    is 0 and its gauge is never written)."""
    pair = []
    for obs_cls, mod in ((JaxObs, jattrib), (ServingObs, tattrib)):
        obs = obs_cls()
        attr = mod.DispatchAttribution(obs, ici_bytes_per_token=1024.0)
        attr.record(kind="decode", steps=8, host_s=0.1, device_s=0.01,
                    resident_tokens=10, busy_slots=3)
        pair.append(obs.render())
    assert pair[0] == pair[1]
    cfg = tlm.LMConfig(**FIELDS)
    assert tattrib.tp_ici_bytes_per_token(cfg) == 0


# -- the cost model's byte counts ----------------------------------------------

FIELDS = dict(vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
              num_kv_heads=2, mlp_dim=128, max_seq_len=256, dtype="float32",
              norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False)


@pytest.fixture(scope="module")
def params():
    cfg = jlm.LMConfig(**FIELDS)
    return jax.device_get(jax.jit(jlm.DecoderLM(cfg).init_params)(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("w_dtype", ["model", "int8", "int8-sim"])
def test_params_hbm_bytes_equal_jax(params, w_dtype):
    jcfg = jlm.LMConfig(**FIELDS, w_dtype=w_dtype)
    tcfg = tlm.LMConfig(**FIELDS, w_dtype=w_dtype)
    jtree = jlm.quantize_lm_params(params, jcfg) if jcfg.w_quant else params
    model = tlm.DecoderLM.from_params(tcfg, tlm.quantize_lm_params(params, tcfg),
                                      torch.device("cpu"))
    got = tattrib.params_hbm_bytes(model)
    assert got == jattrib.params_hbm_bytes(jtree)
    if w_dtype == "int8":
        f32 = tlm.DecoderLM.from_params(tlm.LMConfig(**FIELDS), params,
                                        torch.device("cpu"))
        assert got < tattrib.params_hbm_bytes(f32)
    # An engine counts the model it serves, and a shared model once.
    engine = ContinuousBatcher(tcfg, model, slots=2, cache_len=256,
                               device="cpu")
    assert engine._param_bytes == got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["model", "int8", "int8-sim"])
def test_kv_hbm_bytes_per_token_equal_jax(params, dtype, kv_dtype):
    fields = dict(FIELDS, dtype=dtype, kv_dtype=kv_dtype)
    got = tattrib.kv_hbm_bytes_per_token(tlm.LMConfig(**fields))
    assert got == jattrib.kv_hbm_bytes_per_token(jlm.LMConfig(**fields))
    engine = ContinuousBatcher(tlm.LMConfig(**fields), params, slots=2,
                               cache_len=256, device="cpu")
    assert engine.kv_stats()["kv_bytes_per_token"] == got
    assert engine._attrib._kv_per_tok == got
