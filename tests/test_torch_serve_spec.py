"""The port's batched speculative rounds (`ContinuousBatcher(spec=True)`)
against the JAX engine's, on the CPU.

A 1-layer f32 model at vocab 64 (the JAX package's
`tests/test_serve_spec.py` config, in f32) and an untrained
`draft_config` draft, both bridged from flax params. One JAX engine
serves a fixed schedule (mixed prompts of 3-140 tokens on 2 slots,
turn by turn): the target as its own draft at `spec_k` 3 with
`loop_steps` 4, and a `spec_min_accept` no round can reach, so the
controller walks k 3 -> 1 and turns drafting off after 3 rounds each,
partly while replaying a fold's rc matrix, and the rest is served by
plain folds and chunks. The port replays the schedule: tokens, k after
every turn, `spec_stats()`, `loop_stats()` and the occupancy counters
equal JAX's.

Greedy spec-on tokens are the spec-off tokens for any draft, so the
port's pinned spec engines at k 1 and 4 (untrained draft, self draft,
with and without the loop, an EOS inside an accepted window) are held
to JAX's tokens too, and seeded sampled streams to the port's own
spec-off ones. An MoE config under capacity drops, where spec-on tokens
differ from spec-off in JAX too, is held to JAX's spec engine, counters
included. The JAX engines get a private copy of every upload (`_dev`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serve_loop import (
    MOE_ENGINE,
    MOE_FIELDS,
    moe_params,
    moe_waves,
    serve_waves,
)
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher

torch.set_num_threads(1)

FIELDS = dict(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2,
              max_seq_len=512, dtype="float32")
ENGINE = dict(slots=2, cache_len=384, chunk_steps=3, prefill_chunk=32,
              prefill_lanes=2)
MIXED = [(3, 9), (20, 17), (100, 40), (140, 11)]
WALK = dict(spec=True, spec_k=3, spec_min_accept=5.0, spec_warmup_rounds=3,
            loop_steps=4, draft="self")


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int32)


def _jax_dev(self, a):
    return jnp.asarray(np.array(a, copy=True))


def _views(engine):
    return (engine.spec_stats(), engine.loop_stats(), engine.occupancy())


def _drive(engine):
    """The mixed greedy requests turn by turn: (tokens, k after each
    turn, the stats views)."""
    rids = [engine.submit(_prompt(n, seed=n), max_new_tokens=m) for n, m in MIXED]
    ks, done = [], {}
    while engine.has_work:
        engine.step()
        ks.append(engine.spec_stats()["k"])
        done.update(engine.drain_done())
    return [done[r] for r in rids], ks, _views(engine)


def _engine(batcher, cfg, params, drafts, draft=None, **kw):
    if draft is not None:
        kw["draft_cfg"], kw["draft_params"] = drafts[draft]
    return batcher(cfg, params, **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def served():
    jcfg = jlm.LMConfig(**FIELDS)
    params = jax.device_get(jlm.DecoderLM(jcfg).init_params(jax.random.PRNGKey(0)))
    dcfg = jlm.draft_config(jcfg)
    dparams = jax.device_get(jlm.DecoderLM(dcfg).init_params(jax.random.PRNGKey(1)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        jeng = _engine(JaxBatcher, jcfg, params, {"self": (jcfg, params)}, **WALK)
        walked = _drive(jeng)
    tcfg = tlm.LMConfig(**FIELDS)
    return {"params": params, "jax": walked,
            "drafts": {"tiny": (tlm.draft_config(tcfg), dparams),
                       "self": (tcfg, params)}}


def _port(served, **kw):
    return _engine(ContinuousBatcher, tlm.LMConfig(**FIELDS), served["params"],
                   served["drafts"], device="cpu", **kw)


def test_schedule_matches_jax(served):
    """Tokens, the k walk, `spec_stats()`, `loop_stats()` and occupancy
    after the same turns as JAX's engine."""
    tokens, ks, (spec, loop, occ) = _drive(_port(served, **WALK))
    jtokens, jks, (jspec, jloop, jocc) = served["jax"]
    assert tokens == jtokens
    assert ks == jks
    assert spec == {k: jspec[k] for k in spec}
    assert loop == {k: jloop[k] for k in loop}
    assert occ == jocc
    assert ks[0] == 3 and 1 in ks and spec["drafting_disabled"]
    assert spec["acceptance_rate"] == 1.0 and loop["dispatches"] >= 2


def test_eos_inside_an_accepted_window(served):
    """The self draft commits k+1 = 4 tokens a round; an EOS strictly
    inside a window cuts the output there, loop on or off."""
    engine = _port(served)
    rid = engine.submit(_prompt(6, seed=6), max_new_tokens=12)
    full = engine.run()[rid]
    cands = [(t, i) for i, t in enumerate(full) if 1 <= i < 11 and t not in full[:i]]
    eos, cut = min(cands, key=lambda c: (c[1] % 4 == 0, c[1]))
    for loop in (1, 4):
        engine = _port(served, spec=True, spec_k=3, spec_min_accept=0.0,
                       draft="self", loop_steps=loop)
        rid = engine.submit(_prompt(6, seed=6), max_new_tokens=12, eos_id=eos)
        assert engine.run()[rid] == full[:cut + 1]


@pytest.mark.parametrize(
    "kw",
    [dict(spec_k=1, draft="tiny"), dict(spec_k=4, draft="tiny"),
     dict(spec_k=4, draft="self"), dict(spec_k=1, draft="tiny", loop_steps=2),
     dict(spec_k=4, draft="tiny", loop_steps=4, prefix_cache=False)],
    ids=["k1-tiny", "k4-tiny", "k4-self", "k1-tiny-loop2", "k4-tiny-loop4-noprefix"],
)
def test_spec_tokens_match_jax(served, kw):
    """Pinned drafting (spec_min_accept 0) at k 1 and 4: JAX's greedy
    tokens, whatever the draft proposes."""
    engine = _port(served, spec=True, spec_min_accept=0.0, **kw)
    assert _drive(engine)[0] == served["jax"][0]
    assert not engine.spec_stats()["drafting_disabled"]


@pytest.mark.parametrize("draft", ["tiny", "self"])
def test_sampled_streams_equal_spec_off(served, draft):
    """Position j of a round draws with the request's counter + j, so a
    seeded sampled stream is the spec-off stream, loop on or off."""
    outs = []
    for kw in ({}, dict(spec=True, spec_min_accept=0.0, draft=draft),
               dict(spec=True, spec_min_accept=0.0, draft=draft, loop_steps=4)):
        engine = _port(served, **kw)
        rids = [engine.submit(_prompt(n, seed=n), max_new_tokens=m,
                              temperature=0.9, top_k=16, top_p=0.95, seed=123 + n)
                for n, m in MIXED]
        res = engine.run()
        outs.append([res[r] for r in rids])
    assert outs[0] == outs[1] == outs[2]


def test_pool_accounting_tracks_committed_tokens(served):
    """A 126-token prompt decodes across the block edge with an untrained
    draft: a verify window grabs block 2 and, rejected, hands it back the
    same sync. After every turn the blocks in use back exactly the
    committed rows."""
    engine = _port(served, spec=True, spec_min_accept=0.0, draft="tiny",
                   slots=1, prefill_chunk=128, prefill_lanes=1,
                   prefix_cache=False)
    rid = engine.submit(_prompt(126, seed=9), max_new_tokens=20)
    req = engine._requests[rid]
    while engine.has_work:
        engine.step()
        kv = engine.kv_stats()
        assert kv["kv_blocks_in_use"] + kv["kv_blocks_free"] == engine.pool_blocks - 1
        if not req.done and req.tokens:
            # Token 0 comes from the prefill; its K/V row is written by
            # the round that commits token 1.
            committed = 126 + len(req.tokens) - 1
            assert kv["kv_blocks_in_use"] == -(-committed // 128)
    assert len(engine.drain_done()[rid]) == 20
    kv = engine.kv_stats()
    assert (kv["kv_blocks_in_use"], kv["kv_blocks_reserved"]) == (0, 0)


def test_table_capacity_and_lookahead(served):
    """Totals of exactly cache_len = 256 at every alignment of the head:
    the verify rows past the table drop to the dump block and the tokens
    are the spec-off ones; a request whose lookahead crosses max_seq_len
    is refused as JAX refuses it."""
    specs = [(200, 56), (201, 55), (230, 26), (131, 125)]
    outs = []
    for kw in ({}, dict(spec=True, spec_min_accept=0.0, draft="tiny")):
        engine = _port(served, cache_len=256, prefill_chunk=64, **kw)
        rids = [engine.submit(_prompt(n, seed=n), max_new_tokens=m) for n, m in specs]
        res = engine.run()
        outs.append([res[r] for r in rids])
    assert outs[0] == outs[1]
    engine = _port(served, spec=True, draft="self", slots=1, cache_len=512)
    with pytest.raises(ValueError, match="lookahead"):
        engine.submit(_prompt(300, seed=3), max_new_tokens=212)
    assert engine.obs.errors.value({"reason": "oversize_reject"}) == 1
    assert isinstance(engine.submit(_prompt(300, seed=3), max_new_tokens=208), int)


def test_moe_under_drops_matches_jax_spec_engine():
    """Capacity 1.25: the verify routes slots x (k+1) rows, the draft
    (no experts) none; tokens equal JAX's spec engine's."""
    params = moe_params()
    waves = moe_waves(6)
    jcfg = jlm.LMConfig(**MOE_FIELDS)
    dcfg = jlm.draft_config(jcfg)
    dparams = jax.device_get(jax.jit(jlm.DecoderLM(dcfg).init_params)(
        jax.random.PRNGKey(7)))
    kw = dict(spec=True, spec_k=4, spec_min_accept=0.0, **MOE_ENGINE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        jeng = JaxBatcher(jcfg, params, draft_cfg=dcfg, draft_params=dparams, **kw)
        want = serve_waves(jeng, waves)
    tcfg = tlm.LMConfig(**MOE_FIELDS)
    engine = ContinuousBatcher(tcfg, params, draft_cfg=tlm.draft_config(tcfg),
                               draft_params=dparams, device="cpu", **kw)
    assert serve_waves(engine, waves) == want
    assert engine.spec_stats() == {
        k: v for k, v in jeng.spec_stats().items() if k in engine.spec_stats()}
