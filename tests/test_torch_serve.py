"""The port's ContinuousBatcher against the JAX engine, and its own
invariants.

A tiny f32 llama config (2 layers, hidden 64, 4 heads, 2 kv heads,
vocab 64, cache_len 256) on the same weights (bridged from the JAX
params). Six greedy requests of mixed lengths, three of them sharing a
prompt prefix of at least 128 tokens (one full shareable block), go
through both engines: every request's tokens must be identical. Only
one JAX engine is built (a cold build costs seconds).

The JAX engine's `_dev` uploads host arrays with `jnp.asarray`, which
on the CPU may alias the numpy block table the host keeps mutating
while an asynchronous dispatch still reads it; under that race the JAX
engine's greedy output varies from run to run. The fixture hands it a
private copy of every upload (the same values, no alias) so the
reference is deterministic.
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

# Tiny shapes: one intra-op thread leaves the cores to the other test
# workers.
torch.set_num_threads(1)

FIELDS = dict(
    vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
    num_kv_heads=2, mlp_dim=128, max_seq_len=256, dtype="float32",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False,
)
ENGINE = dict(slots=3, cache_len=256, chunk_steps=4, prefill_chunk=64,
              prefill_lanes=2)


def _requests():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 64, 200)
    prompts = [
        np.concatenate([shared[:150], rng.integers(0, 64, 10)]),
        rng.integers(0, 64, 20),
        np.concatenate([shared[:140], rng.integers(0, 64, 30)]),
        rng.integers(0, 64, 5),
        rng.integers(0, 64, 90),
        shared[:200],
    ]
    budgets = [12, 30, 9, 17, 25, 14]
    return [(p.astype(np.int32), m) for p, m in zip(prompts, budgets)]


@pytest.fixture(scope="module")
def served():
    cfg = jlm.LMConfig(**FIELDS)
    params = jax.device_get(
        jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(0))
    )
    reqs = _requests()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            JaxBatcher, "_dev",
            lambda self, a: jnp.asarray(np.array(a, copy=True)),
        )
        jeng = JaxBatcher(cfg, params, **ENGINE)
        rids = [jeng.submit(p, max_new_tokens=m) for p, m in reqs]
        jout = jeng.run()
    return {
        "params": params,
        "reqs": reqs,
        "jax": [jout[r] for r in rids],
        "jax_stats": {
            "occupancy": jeng.occupancy(),
            "kv": jeng.kv_stats(),
            "prefix": jeng.prefix_stats(),
        },
    }


def _port(served, **kw):
    return ContinuousBatcher(
        tlm.LMConfig(**FIELDS), served["params"], device="cpu",
        **{**ENGINE, **kw},
    )


def _serve(engine, reqs, **submit):
    rids = [engine.submit(p, max_new_tokens=m, **submit) for p, m in reqs]
    out = engine.run()
    return [out[r] for r in rids]


def test_greedy_tokens_match_jax_engine(served):
    engine = _port(served)
    got = _serve(engine, served["reqs"])
    for i, (a, b) in enumerate(zip(got, served["jax"])):
        assert a == b, f"request {i}"
    assert [len(t) for t in got] == [m for _, m in served["reqs"]]
    stats = engine.prefix_stats()
    assert stats["block_hits"] >= 1 and stats["prefill_tokens_saved"] >= 128
    # The counters the JAX engine exports come back with the same keys
    # and, for the deterministic host books, the same values.
    js = served["jax_stats"]
    assert stats == {k: js["prefix"][k] for k in stats}
    assert set(engine.kv_stats()) <= set(js["kv"])
    assert set(engine.occupancy()) <= set(js["occupancy"])


def test_prefix_cache_off_gives_same_tokens(served):
    got = _serve(_port(served, prefix_cache=False), served["reqs"])
    assert got == served["jax"]


def test_request_alone_matches_full_batch(served):
    for i in (0, 4):
        alone = _serve(_port(served), [served["reqs"][i]])
        assert alone[0] == served["jax"][i], i


def test_sampled_stream_reproducible_and_batch_independent(served):
    p, m = served["reqs"][2]
    knobs = dict(temperature=0.9, top_k=20, top_p=0.95, seed=1234)
    a = _serve(_port(served), [(p, m)], **knobs)[0]
    b = _serve(_port(served), [(p, m)], **knobs)[0]
    assert a == b and len(a) == m
    engine = _port(served)
    rids = [
        engine.submit(q, max_new_tokens=n, **knobs) if i == 2
        else engine.submit(q, max_new_tokens=n)
        for i, (q, n) in enumerate(served["reqs"])
    ]
    assert engine.run()[rids[2]] == a
    c = _serve(_port(served), [(p, m)], **{**knobs, "seed": 4321})[0]
    assert c != a  # another seed draws another stream


def test_records_and_drain(served):
    engine = _port(served)
    rid = engine.submit(served["reqs"][3][0], max_new_tokens=3)
    while engine.has_work:
        engine.step()
    rec = engine.drain_done_records()[rid]
    assert set(rec) == {
        "tokens", "ttft_s", "wall_s", "truncated", "trace_id",
        "fingerprint", "adapter",
    }
    assert len(rec["tokens"]) == 3 and rec["ttft_s"] <= rec["wall_s"]
    engine.drain()
    with pytest.raises(ValueError, match="draining"):
        engine.submit([1, 2], max_new_tokens=1)
    assert engine.obs.errors.value({"reason": "draining"}) == 1


@pytest.mark.parametrize(
    "prompt,kwargs,reason",
    [
        ([1, 2], dict(max_new_tokens=0), "bad_request"),
        ([], dict(max_new_tokens=1), "bad_request"),
        ([64], dict(max_new_tokens=1), "bad_request"),
        ([1], dict(max_new_tokens=1, temperature=-1.0), "bad_request"),
        ([1], dict(max_new_tokens=1, top_p=0.0), "bad_request"),
        ([1], dict(max_new_tokens=1, seed=2**31), "bad_request"),
        ([1], dict(max_new_tokens=1, adapter=3), "bad_request"),
        ([1] * 200, dict(max_new_tokens=100), "oversize_reject"),
    ],
)
def test_submit_rejection_taxonomy(served, prompt, kwargs, reason):
    engine = _port(served)
    with pytest.raises(ValueError):
        engine.submit(prompt, **kwargs)
    assert engine.obs.errors.value({"reason": reason}) == 1


def test_pool_overflow_rejected(served):
    engine = _port(served, pool_blocks=2)
    with pytest.raises(ValueError, match="pool"):
        engine.submit([1] * 130, max_new_tokens=10)
    assert engine.obs.errors.value({"reason": "pool_overflow"}) == 1


@pytest.mark.parametrize(
    "kwargs",
    [
        # The SLO windows are not ported: their options, set, raise rather
        # than sit inert. (The obs planes are: tests/test_torch_serve_obs.py.)
        dict(slo_objectives={"ttft_s": 1.0}),
        dict(slo_window_s=5.0),
    ],
)
def test_later_slice_features_raise(served, kwargs):
    with pytest.raises(NotImplementedError):
        _port(served, **kwargs)


@pytest.mark.parametrize(
    "kwargs",
    [
        # As in JAX: an `obs` that is no ServingObs is a truthy flag, on
        # either engine, and the paged engine takes any prompt_bucket up
        # to cache_len into its fingerprint.
        dict(paged=False, obs=object()),
        dict(obs=object()),
        dict(prompt_bucket=32),
    ],
)
def test_former_later_slice_options_build(served, kwargs):
    engine = _port(served, **kwargs)
    assert engine.obs.enabled
    fp = engine.config_fingerprint()["engine"]
    assert fp["prompt_bucket"] == kwargs.get("prompt_bucket", 16)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(loop_steps=2, paged=False),
        dict(spec=True),
        dict(spec=True, spec_k=8, draft=True),
        dict(spec=True, paged=False, draft=True),
    ],
    ids=["loop-dense", "spec-no-draft", "spec_k-8", "spec-dense"],
)
def test_loop_and_spec_options_raise_the_jax_errors(served, kwargs):
    """The device-resident loop and speculative rounds are ported: their
    invalid settings raise the JAX engine's ValueError, word for word."""
    kwargs = dict(kwargs)
    if kwargs.pop("draft", False):
        kwargs.update(draft_cfg=jlm.LMConfig(**FIELDS),
                      draft_params=served["params"])
    jkw = dict(kwargs)
    if "draft_cfg" in kwargs:
        kwargs["draft_cfg"] = tlm.LMConfig(**FIELDS)
    with pytest.raises(ValueError) as want:
        JaxBatcher(jlm.LMConfig(**FIELDS), served["params"], **ENGINE, **jkw)
    with pytest.raises(ValueError) as got:
        _port(served, **kwargs)
    assert str(got.value) == str(want.value)
    # JAX ignores the speculative options while `spec` is off.
    _port(served, spec_k=2, draft_params={})
