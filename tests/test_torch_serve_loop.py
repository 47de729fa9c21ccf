"""The port's device-resident loop (`ContinuousBatcher(loop_steps > 1)`)
against the JAX engine's, on the CPU.

On the CPU the fold is its plain version: a Python loop over the same
chunk body and exit computation the card's CUDA graph holds. A 1-layer
model at vocab 64 (the JAX package's `tests/test_serve_loop.py` config,
in f32: in bf16 the two packages round apart and flip near-ties) on the
same weights, bridged from the flax params. One JAX engine with
`loop_steps` 4 serves a fixed schedule of phases, the cases of
`tests/test_serve_loop.py`:

1. mixed prompts of 3-140 tokens (one crosses a block edge mid-prefill,
   one mid-decode);
2. a shared 140-token prefix served twice (the second admission maps the
   first's block through the trie);
3. an EOS inside the fold's horizon beside a long request;
4. a 99-token prompt whose 29-token budget ends exactly at the block's
   last row: a fold exits `unbacked`, and the next re-enters;
5. an admission arriving while a slot decodes (the turn goes back to the
   per-chunk path and the loop resumes).

The port replays the schedule: its tokens must equal JAX's at
`loop_steps` 2 and 4, and at 4 its `loop_stats()` (folds, chunks
folded, exits) and occupancy counters equal JAX's after every phase. An
MoE config under capacity drops is held to JAX's loop engine too.

As in tests/test_torch_serve.py, the JAX engines get a private copy of
every host array they upload (`_dev`): on the CPU `jnp.asarray` may
alias the block table the host mutates under an asynchronous dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.moe import MoEMlp
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher

torch.set_num_threads(1)

FIELDS = dict(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2,
              max_seq_len=512, dtype="float32")
ENGINE = dict(slots=2, cache_len=384, chunk_steps=3, prefill_chunk=32,
              prefill_lanes=2)
MIXED = [(3, 9), (20, 17), (100, 40), (140, 11)]


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int32)


def _jax_dev(self, a):
    return jnp.asarray(np.array(a, copy=True))


def _drive(engine, eos):
    """The schedule; returns, per phase, (tokens, loop_stats, occupancy)."""
    out = []

    def phase(reqs):
        rids = [engine.submit(p, max_new_tokens=m, **kw) for p, m, kw in reqs]
        res = engine.run()
        out.append(([res[r] for r in rids], engine.loop_stats(),
                     engine.occupancy()))

    phase([(_prompt(n, seed=n), m, {}) for n, m in MIXED])
    shared = _prompt(140, seed=3)
    phase([(shared, 9, {})])
    phase([(np.concatenate([shared[:130], _prompt(7, seed=9)]), 8, {})])
    phase([(_prompt(6, seed=6), 30, {"eos_id": eos}),
           (_prompt(9, seed=2), 40, {})])
    phase([(_prompt(99, seed=5), 29, {})])
    # An admission while a slot decodes.
    r1 = engine.submit(_prompt(9, seed=1), max_new_tokens=30)
    for _ in range(3):
        engine.step()
    r2 = engine.submit(_prompt(20, seed=2), max_new_tokens=12)
    res = engine.run()
    out.append(([res[r1], res[r2]], engine.loop_stats(), engine.occupancy()))
    return out


def _eos(params):
    """An EOS id inside the horizon: the first token of request (6, 30)'s
    greedy stream, past its first, that it has not emitted before."""
    engine = ContinuousBatcher(tlm.LMConfig(**FIELDS), params, device="cpu",
                               **ENGINE)
    rid = engine.submit(_prompt(6, seed=6), max_new_tokens=30)
    full = engine.run()[rid]
    return next(t for i, t in enumerate(full) if 1 <= i < 25 and t not in full[:i])


@pytest.fixture(scope="module")
def served():
    params = jax.device_get(
        jlm.DecoderLM(jlm.LMConfig(**FIELDS)).init_params(jax.random.PRNGKey(0))
    )
    eos = _eos(params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        jeng = JaxBatcher(jlm.LMConfig(**FIELDS), params, loop_steps=4, **ENGINE)
        phases = _drive(jeng, eos)
    return {"params": params, "eos": eos, "jax": phases}


def _port(served, **kw):
    return ContinuousBatcher(tlm.LMConfig(**FIELDS), served["params"],
                             device="cpu", **{**ENGINE, **kw})


@pytest.mark.parametrize("loop", [2, 4])
def test_loop_tokens_match_jax(served, loop):
    got = _drive(_port(served, loop_steps=loop), served["eos"])
    for i, (mine, theirs) in enumerate(zip(got, served["jax"])):
        assert mine[0] == theirs[0], f"phase {i}"
    # The EOS request stopped at its EOS; the long one ran its budget.
    eos_tokens, long_tokens = got[3][0]
    assert eos_tokens[-1] == served["eos"] and len(long_tokens) == 40


def test_loop_stats_match_jax(served):
    """Folds, chunks folded, exits per reason and the occupancy counters
    equal JAX's after every phase, and every exit reason occurs."""
    got = _drive(_port(served, loop_steps=4), served["eos"])
    for i, (mine, theirs) in enumerate(zip(got, served["jax"])):
        assert mine[1] == {k: theirs[1][k] for k in mine[1]}, f"phase {i}"
        assert mine[2] == theirs[2], f"phase {i}"
    exits = got[-1][1]["exits"]
    assert min(exits.values()) >= 1, exits
    # The unbacked phase exited unbacked and re-entered.
    before, after = got[3][1], got[4][1]
    assert after["exits"]["unbacked"] > before["exits"]["unbacked"]
    assert after["dispatches"] >= before["dispatches"] + 2


def test_prefix_cache_off_gives_same_tokens(served):
    got = _drive(_port(served, loop_steps=4, prefix_cache=False), served["eos"])
    assert [p[0] for p in got] == [p[0] for p in served["jax"]]


def test_sampled_streams_equal_loop_off(served):
    """Seeded sampled streams: the fold draws token n of a request with
    (seed, n), as the per-chunk path does."""
    outs = []
    for loop in (1, 4):
        engine = _port(served, loop_steps=loop)
        rids = [engine.submit(_prompt(n, seed=n), max_new_tokens=m,
                              temperature=t, top_k=k, seed=n)
                for (n, m), t, k in zip(MIXED, (0.9, 1.1, 0.7, 0.0), (0, 8, 0, 0))]
        res = engine.run()
        outs.append([res[r] for r in rids])
    assert outs[0] == outs[1]


def test_fold_is_the_plain_loop_on_the_cpu(served):
    """On the CPU a fold replays no graph; `allow_loop=False` keeps every
    turn on the per-chunk path."""
    engine = _port(served, loop_steps=4)
    rid = engine.submit(_prompt(9, seed=1), max_new_tokens=30)
    want = engine.run()[rid]
    fold = engine._loop
    assert fold.folds == engine.loop_stats()["dispatches"] >= 1
    assert fold.captures == 0
    rid = engine.submit(_prompt(9, seed=1), max_new_tokens=30)
    folds = fold.folds
    while engine.has_work:
        engine.step(allow_loop=False)
    assert engine.drain_done()[rid] == want and fold.folds == folds


MOE_FIELDS = dict(
    vocab_size=64, hidden_dim=64, num_layers=3, num_heads=4,
    num_kv_heads=2, mlp_dim=96, max_seq_len=256, dtype="float32",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False, layer_norm_eps=1e-5, num_experts=4, moe_every=2,
    expert_top_k=2,
)
# One lane row (a JAX program per lane width costs seconds to compile);
# idle slots beside live ones in every decode step.
MOE_ENGINE = dict(slots=4, cache_len=128, chunk_steps=2, prefill_chunk=16,
                  prefill_lanes=1)


def moe_params(seed=0):
    """tests/test_torch_moe_decode.py's MoE weights: a wide router bias
    skews routing, so capacity 1.25 drops tokens."""
    cfg = jlm.LMConfig(**MOE_FIELDS)
    params = jax.device_get(jax.jit(jlm.DecoderLM(cfg).init_params)(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(np.float32),
        params,
    )
    params["block1"]["moe"]["router"]["bias"] = rng.normal(
        0, 1.0, MOE_FIELDS["num_experts"]).astype(np.float32)
    return params


def moe_waves(seed):
    """Three waves of requests, each submitted one step after the last."""
    rng = np.random.default_rng(seed)
    pairs = [(rng.integers(0, 64, int(rng.integers(3, 40))).astype(np.int32), m)
             for m in (9, 5, 12, 7, 4, 10)]
    return [pairs[:3], pairs[3:4], pairs[4:]]


def count_decode_drops(model):
    """Hooks on the MoE layers counting the assignments capacity drops in
    one-token-a-row calls (decode steps); returns a one-element list."""
    drops = [0]

    def hook(moe, args):
        h = args[0]
        if h.shape[1] != 1:
            return
        gates = torch.softmax(moe.router(h.reshape(-1, h.shape[-1])), -1)
        chosen = torch.topk(gates, moe.top_k, dim=-1).indices
        load = torch.bincount(chosen.reshape(-1), minlength=moe.num_experts)
        drops[0] += int(torch.clamp(load - moe.capacity(h.shape[0]), min=0).sum())

    for m in model.modules():
        if isinstance(m, MoEMlp):
            m.register_forward_pre_hook(hook)
    return drops


def serve_waves(engine, waves):
    rids = []
    for i, wave in enumerate(waves):
        if i:
            engine.step()
        rids += [engine.submit(p, max_new_tokens=m) for p, m in wave]
    out = engine.run()
    return [out[r] for r in rids]


def test_moe_under_drops_matches_jax_loop_engine():
    """Capacity 1.25 (drops), idle slots beside live ones: the fold's
    decode steps route every slot, as JAX's loop body does."""
    params = moe_params()
    waves = moe_waves(4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        jeng = JaxBatcher(jlm.LMConfig(**MOE_FIELDS), params, loop_steps=4,
                          **MOE_ENGINE)
        want = serve_waves(jeng, waves)
    engine = ContinuousBatcher(tlm.LMConfig(**MOE_FIELDS), params, device="cpu",
                               loop_steps=4, **MOE_ENGINE)
    drops = count_decode_drops(engine.model)
    assert serve_waves(engine, waves) == want
    assert drops[0] > 0
    assert engine.loop_stats() == {
        k: v for k, v in jeng.loop_stats().items() if k in engine.loop_stats()}
