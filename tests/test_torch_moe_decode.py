"""MoE models through every decode path of the port, against the JAX
package's on one set of weights (flax params bridged by
`models/convert.py`).

The model: a tiny f32 llama-style config, 3 layers with an MoE block in
the middle (`moe_every` 2: 4 gelu experts, top-2), so a dense attention
layer reads the f32 residual an MoE block leaves. The router bias is
drawn wide (std 1) so routing is skewed and capacity bites.

JAX's `MoEMlp` sets each expert's capacity, min(T, ceil(cf x T x k /
E)), from the T tokens of one call and drops what overflows, so a
token's output depends on the other tokens of its call; the port must
route the same tokens in each call. At `capacity_factor` E / k = 2.0
nothing drops (capacity = T) and routing is per token.

- `make_generate_fn` and speculative decoding (a dense `draft_config`
  draft, k 4) at the default capacity 1.25: greedy tokens identical to
  JAX's (the cache forwards' logits are held to JAX's within 1e-4 in
  tests/test_torch_lm.py);
- both engines at the no-drop capacity: tokens identical to JAX's
  engines, and a request alone gives its tokens in the batch;
- the paged engine at the default capacity, with idle slots, lanes
  filled to 1, 2 and 3 of 4 rows, and multi-chunk prompts: tokens
  identical to JAX's engine, and the test counts the tokens the
  capacity formula dropped in the port's MoE calls (there must be
  some, in the lane and in decode steps);
- int8 weights and KV with experts: `quantize_lm_params` leaves the
  experts and the router alone, as JAX's does (bitwise), and the paged
  engine's tokens equal JAX's at the no-drop capacity;
- bf16: the serving build holds the experts in bf16 and the router in
  f32, as flax casts them, and the dense-cache forward (a 12-token prefill, then 3 steps at
  batch 3) within 2e-2 of the largest |logit| of JAX's (both round every
  projection and the residual to bf16, a bf16 ulp being 2**-8
  relative). The weights' seed, 17, is the first of 0-23 whose router
  has no near-ties on this input (every gap between the three largest
  gates over 1e-2; the test checks it), so bf16 rounding upstream
  cannot flip a route: the rule of tests/test_hf.py's seed 3. A flipped
  route would move a logit by O(1), not O(1e-2).

As in tests/test_torch_serve.py, the JAX engines get a private copy of
every host array they upload.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import decode as jdec
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models import speculative as jspec
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch.models import decode as tdec
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models import speculative as tspec
from walkai_nos_tpu_torch.models.moe import MoEMlp
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher

torch.set_num_threads(1)

FIELDS = dict(
    vocab_size=64, hidden_dim=64, num_layers=3, num_heads=4,
    num_kv_heads=2, mlp_dim=96, max_seq_len=256, dtype="float32",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False, layer_norm_eps=1e-5, num_experts=4, moe_every=2,
    expert_top_k=2,
)
NO_DROP = 2.0  # E / k: capacity = T


def _params(seed=0):
    cfg = jlm.LMConfig(**FIELDS)
    init = jax.jit(jlm.DecoderLM(cfg).init_params)  # one program, not op by op
    params = jax.device_get(init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(np.float32),
        params,
    )
    params["block1"]["moe"]["router"]["bias"] = rng.normal(
        0, 1.0, FIELDS["num_experts"]
    ).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def params():
    return _params()


def _cfgs(**changes):
    return (jlm.LMConfig(**{**FIELDS, **changes}),
            tlm.LMConfig(**{**FIELDS, **changes}))


def _prompts(n, seed, lo=3, hi=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def test_generate_matches_jax(params):
    jcfg, tcfg = _cfgs()
    prompt = np.random.default_rng(1).integers(0, 64, (3, 11)).astype(np.int32)
    want = jdec.make_generate_fn(jcfg, tokens_per_dispatch=4)(
        params, jnp.asarray(prompt), 14
    )
    got = tdec.make_generate_fn(tcfg, tokens_per_dispatch=4, device="cpu")(
        params, prompt, 14
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_speculative_matches_jax(params):
    jcfg, tcfg = _cfgs()
    jd, td = jlm.draft_config(jcfg), tlm.draft_config(tcfg)
    assert td.num_experts == jd.num_experts == 0
    dp = jax.device_get(jax.jit(jlm.DecoderLM(jd).init_params)(jax.random.PRNGKey(7)))
    prompt = np.random.default_rng(2).integers(0, 64, (1, 9)).astype(np.int32)
    want, jstats = jspec.make_speculative_generate_fn(
        jcfg, jd, k=4, return_stats=True
    )(params, dp, jnp.asarray(prompt), 16)
    got, stats = tspec.make_speculative_generate_fn(
        tcfg, td, k=4, return_stats=True, device="cpu"
    )(params, dp, prompt, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        np.asarray(stats["acceptance_hist"]), np.asarray(jstats["acceptance_hist"])
    )


def _serve(engine, waves):
    """Submit each wave of (prompt, budget) after one step of the
    previous; returns the tokens in submission order."""
    rids = []
    for i, wave in enumerate(waves):
        if i:
            engine.step()
        rids += [engine.submit(p, max_new_tokens=m) for p, m in wave]
    out = engine.run()
    return [out[r] for r in rids]


def _jax_serve(cfg, params, waves, **engine):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev",
                   lambda self, a: jnp.asarray(np.array(a, copy=True)))
        return _serve(JaxBatcher(cfg, params, **engine), waves)


def _waves(seed):
    prompts = _prompts(6, seed)
    budgets = [9, 5, 12, 7, 4, 10]
    pairs = list(zip(prompts, budgets))
    return [pairs[:3], pairs[3:4], pairs[4:]]


ENGINES = {
    "paged": dict(slots=4, cache_len=128, chunk_steps=2, prefill_chunk=16,
                  prefill_lanes=4),
    "dense": dict(slots=3, cache_len=128, chunk_steps=2, paged=False),
}


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_engines_match_jax_at_no_drop_capacity(params, mode):
    jcfg, tcfg = _cfgs(capacity_factor=NO_DROP)
    waves = _waves(3)
    want = _jax_serve(jcfg, params, waves, **ENGINES[mode])
    engine = ContinuousBatcher(tcfg, params, device="cpu", **ENGINES[mode])
    got = _serve(engine, waves)
    assert got == want
    # Per-token routing: the engine's invariant holds again.
    p, m = waves[0][1]
    alone = ContinuousBatcher(tcfg, engine.model, device="cpu", **ENGINES[mode])
    assert _serve(alone, [[(p, m)]]) == [got[1]]


def _count_drops(model):
    """Hooks on the MoE layers that count, per call, the assignments the
    capacity formula drops: each expert keeps min(its top-k assignments
    among the routed tokens, capacity). Returns {"lane": n, "decode": n}
    (lane calls route more than one token a row)."""
    drops = {"lane": 0, "decode": 0}

    def hook(moe, args):
        h, rows = args[0], (args[1] if len(args) > 1 else None)
        b, s, d = h.shape
        routed = (b if rows is None else rows) * s
        gates = torch.softmax(moe.router(h.reshape(-1, d)[:routed]), -1)
        chosen = torch.topk(gates, moe.top_k, dim=-1).indices
        per_expert = torch.bincount(chosen.reshape(-1), minlength=moe.num_experts)
        cap = moe.capacity(routed)
        drops["lane" if s > 1 else "decode"] += int(
            torch.clamp(per_expert - cap, min=0).sum()
        )

    for m in model.modules():
        if isinstance(m, MoEMlp):
            m.register_forward_pre_hook(hook)
    return drops


def test_paged_engine_matches_jax_under_drops(params):
    """Default capacity, 4 slots and 4 lanes: the first wave fills 3 of 4
    lanes (JAX: a 4-row lane with a pad row), the later waves 1 and 2
    (JAX: 1- and 2-row lanes, the port's rows past them unrouted), and
    idle slots decode beside live ones throughout."""
    jcfg, tcfg = _cfgs()
    waves = _waves(4)
    want = _jax_serve(jcfg, params, waves, **ENGINES["paged"])
    engine = ContinuousBatcher(tcfg, params, device="cpu", **ENGINES["paged"])
    drops = _count_drops(engine.model)
    got = _serve(engine, waves)
    assert drops["lane"] > 0 and drops["decode"] > 0, drops
    assert got == want


def test_int8_moe_matches_jax(params):
    jcfg, tcfg = _cfgs(capacity_factor=NO_DROP, kv_dtype="int8", w_dtype="int8")
    tree = tlm.quantize_lm_params(params, tcfg)
    jtree = jax.device_get(jlm.quantize_lm_params(params, jcfg))
    flat = dict(_leaves(tree))
    jflat = dict(_leaves(jtree))
    assert flat.keys() == jflat.keys()
    for name, leaf in flat.items():
        np.testing.assert_array_equal(leaf, jflat[name], err_msg=name)
    assert flat["block1/moe/experts_up"].dtype == np.float32
    assert flat["block1/attn/qkv/kernel"].dtype == np.int8
    waves = _waves(5)[:1]
    want = _jax_serve(jcfg, params, waves, **ENGINES["paged"])
    engine = ContinuousBatcher(tcfg, params, device="cpu", **ENGINES["paged"])
    assert _serve(engine, waves) == want


def _leaves(tree, prefix=""):
    for name, sub in tree.items():
        if hasattr(sub, "items"):
            yield from _leaves(sub, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", np.asarray(sub)


def test_bf16_dense_cache_forward_matches_jax():
    """Prefill 12 tokens, then 3 greedy steps, at batch 3 in bf16."""
    params = _params(seed=17)
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jmodel = jlm.DecoderLM(jcfg)
    tokens = np.random.default_rng(1).integers(0, 64, (3, 12)).astype(np.int32)
    cache = jax.jit(lambda t: jmodel.init(jax.random.PRNGKey(0), t, decode=True))(
        jnp.zeros((3, 1), jnp.int32))["cache"]
    apply = jax.jit(lambda cache, t: jmodel.apply(
        {"params": params, "cache": cache}, t, decode=True, mutable=["cache"]))
    tmodel = tlm.DecoderLM.from_params(tcfg, params, "cpu")
    moe = tmodel.blocks[1].moe
    assert moe.experts_up.dtype == moe.experts_down.dtype == torch.bfloat16
    assert moe.router.kernel.dtype == moe.router.bias.dtype == torch.float32
    tcache = tlm.DenseCache.zeros(tcfg, 3, "cpu")
    gaps = []

    def gap(moe, args):
        h = args[0]
        top = torch.softmax(moe.router(h.reshape(-1, h.shape[-1])), -1)
        top = torch.sort(top, -1, descending=True).values[:, :3]
        gaps.append(float((top[:, :-1] - top[:, 1:]).min()))

    tmodel.blocks[1].moe.register_forward_pre_hook(gap)
    for step in range(4):
        jl, variables = apply(cache, jnp.asarray(tokens))
        cache = variables["cache"]
        with torch.inference_mode():
            tl = tmodel(torch.from_numpy(tokens), tcache).numpy()
        jl = np.asarray(jl, np.float32)
        err = np.max(np.abs(tl - jl))
        assert err <= 2e-2 * np.max(np.abs(jl)), (step, err)
        tokens = np.argmax(jl[:, -1:], axis=-1).astype(np.int32)
    assert min(gaps) > 1e-2, gaps
