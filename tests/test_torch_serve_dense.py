"""The port's dense ContinuousBatcher (`paged=False`) against the JAX
dense engine and against the port's own one-shot generation.

A tiny f32 llama config (2 layers, hidden 64, 4 heads over 2 kv heads,
vocab 64, cache_len 256) on the same weights (bridged from the JAX
params), 3 slots for 6 greedy requests of mixed lengths: prompts under
and over `prompt_bucket` (power-of-two buckets), and more requests than
slots, so slots are freed and re-admitted while the others decode. The
decode steps run the dense decode kernel's per-row arm (its plain
version here). Every request's tokens must equal the JAX dense engine's
and a standalone greedy `make_generate_fn` call's.

As in tests/test_torch_serve.py, the JAX engine is handed a private copy
of every host array it uploads, so that its asynchronous CPU dispatch
cannot read an array the host mutates afterwards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch.models import decode as tdec
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
ENGINE = dict(slots=3, cache_len=256, chunk_steps=4, prompt_bucket=16,
              paged=False)


def _requests():
    rng = np.random.default_rng(5)
    lengths = [9, 40, 16, 3, 100, 17]  # buckets 16, 64, 16, 16, 128, 32
    budgets = [12, 7, 20, 5, 9, 14]
    return [
        (rng.integers(0, 64, n).astype(np.int32), m)
        for n, m in zip(lengths, budgets)
    ]


@pytest.fixture(scope="module")
def served():
    cfg = jlm.LMConfig(**FIELDS)
    params = jax.device_get(
        jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(1))
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
        "params": params, "reqs": reqs, "jax": [jout[r] for r in rids],
        "jax_kv": jeng.kv_stats(), "jax_occupancy": jeng.occupancy(),
    }


def _port(served, **kw):
    return ContinuousBatcher(
        tlm.LMConfig(**FIELDS), served["params"], device="cpu",
        **{**ENGINE, **kw},
    )


def test_dense_engine_matches_jax_and_generate(served):
    engine = _port(served)
    rids = [engine.submit(p, max_new_tokens=m) for p, m in served["reqs"]]
    out = engine.run()
    got = [out[r] for r in rids]
    assert got == served["jax"]
    gen = tdec.make_generate_fn(tlm.LMConfig(**FIELDS), device="cpu")
    for (p, m), tokens in zip(served["reqs"], got):
        alone = gen(engine.model, p[None], m).numpy()[0].tolist()
        assert tokens == alone
    # The dense books: the whole slots x cache_len allocation backs the
    # resident tokens; the JAX engine reports the same keys and values.
    kv, jkv = engine.kv_stats(), served["jax_kv"]
    assert kv["paged"] is False and kv["kv_pool_blocks"] is None
    for key in ("kv_backing_bytes", "kv_bytes_per_token", "kv_blocks_in_use",
                "kv_hbm_bytes_per_resident_token"):
        assert kv[key] == jkv[key], key
    assert engine.occupancy() == {
        k: served["jax_occupancy"][k] for k in engine.occupancy()
    }


def test_bucket_rule_matches_jax(served):
    engine = _port(served)
    jeng = JaxBatcher.__new__(JaxBatcher)
    jeng.prompt_bucket, jeng.cache_len = 16, 256
    for n in (1, 16, 17, 33, 64, 65, 200, 256):
        assert engine._bucket_for(n) == JaxBatcher._bucket_for(jeng, n), n


def test_slot_reuse_gives_the_same_tokens_alone(served):
    """The last request, admitted into a freed slot of a busy engine,
    matches itself served alone on a fresh one-slot engine."""
    p, m = served["reqs"][-1]
    engine = _port(served, slots=1)
    rid = engine.submit(p, max_new_tokens=m)
    assert engine.run()[rid] == served["jax"][-1]


def test_prompt_bucket_rules(served):
    with pytest.raises(ValueError, match="prompt_bucket 512 exceeds"):
        _port(served, prompt_bucket=512)
    _port(served, prompt_bucket=64)  # a dense-engine option: accepted
    # Accepted in paged mode too, as in JAX, and fingerprinted.
    engine = _port(served, paged=True, prompt_bucket=64)
    assert engine.config_fingerprint()["engine"]["prompt_bucket"] == 64
