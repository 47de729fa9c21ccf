"""The paged engine's device-resident loop and speculative rounds on a
GPU: the CUDA-graph fold against the per-chunk path.

Every test here needs an NVIDIA GPU and `nvcc` (the kernels build at
first use); without one each skips, deciding inside the test. The file
imports neither jax nor the JAX package, so on a GPU machine without jax
it runs on its own:

    python -m pytest tests/test_torch_cuda_serve_loop.py --noconftest -q

A tiny bf16 llama (2 layers, hidden 128, 4 heads over 2 kv heads) with
random weights: the fold replays the same kernels on the same shapes as
the eager chunk, so its tokens must be identical, not close. The last
test holds the engine under MoE capacity drops to JAX's tokens on its
kernel route, read from `tests/moe_paged_tokens.npz`
(`tests/test_torch_moe_fixture.py` makes and checks that file).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher

CFG = tlm.LMConfig(
    vocab_size=256, hidden_dim=128, num_layers=2, num_heads=4,
    num_kv_heads=2, mlp_dim=256, max_seq_len=512, dtype="bfloat16",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False,
)
ENGINE = dict(slots=4, cache_len=512, chunk_steps=4, prefill_chunk=32,
              prefill_lanes=2)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _requests(seed=0):
    rng = np.random.default_rng(seed)
    lens, budgets = [5, 40, 130, 90, 17], [20, 33, 12, 41, 9]
    return [(rng.integers(0, CFG.vocab_size, n).astype(np.int32), m)
            for n, m in zip(lens, budgets)]


def _serve(engine, reqs, **submit):
    rids = [engine.submit(p, max_new_tokens=m, **submit) for p, m in reqs]
    out = engine.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("draft", [None, "tiny", "self"])
def test_graph_fold_tokens_equal_loop_off(cuda, draft):
    """loop_steps 4 against 1 (spec on too, with a random draft and with
    the target as its own draft): identical greedy tokens, and one
    capture."""
    model = tlm.DecoderLM(CFG, device=cuda, seed=0)
    kw = {}
    if draft == "tiny":
        dcfg = tlm.draft_config(CFG)
        kw = dict(spec=True, spec_min_accept=0.0, draft_cfg=dcfg,
                  draft_params=tlm.DecoderLM(dcfg, device=cuda, seed=1))
    elif draft == "self":
        kw = dict(spec=True, spec_min_accept=0.0, draft_cfg=CFG,
                  draft_params=model)
    reqs = _requests()
    outs = {}
    for loop in (1, 4):
        engine = ContinuousBatcher(CFG, model, loop_steps=loop, **ENGINE, **kw)
        outs[loop] = _serve(engine, reqs)
        if loop > 1:
            fold, stats = engine._loop, engine.loop_stats()
            assert stats["dispatches"] > 0 and stats["chunks_folded"] > stats["dispatches"]
            assert fold.folds == stats["dispatches"]
            assert fold.captures == 1
    assert outs[4] == outs[1]
    assert [len(t) for t in outs[4]] == [m for _, m in reqs]
    if draft == "self":
        # The draft's one-step forwards and the verify's k+1-step one may
        # round apart in bf16 at a near-tie; nearly every draft holds.
        assert engine.spec_stats()["acceptance_rate"] >= 0.9


def test_graph_fold_follows_the_controller(cuda):
    """The acceptance controller under the graph: a random draft and the
    default `spec_min_accept` walk k down from 4 and then turn drafting
    off, so folds of a halved k and plain folds are captured mid-serving,
    each at its first use. In f32 (a verify and a one-step decode round
    alike) the tokens equal loop_steps 1 under the same controller and
    spec off; one capture per kind of fold that ran."""
    cfg = dataclasses.replace(CFG, dtype="float32")
    model = tlm.DecoderLM(cfg, device=cuda, seed=0)
    dcfg = tlm.draft_config(cfg)
    kw = dict(spec=True, draft_cfg=dcfg,
              draft_params=tlm.DecoderLM(dcfg, device=cuda, seed=1))
    # As many requests as slots: admission ends early, so the walk runs
    # in folds (a queued request keeps every turn an eager round).
    reqs = [(p, 4 * m) for p, m in _requests(3)[:ENGINE["slots"]]]
    off = _serve(ContinuousBatcher(cfg, model, **ENGINE), reqs)
    one = _serve(ContinuousBatcher(cfg, model, **ENGINE, **kw), reqs)
    engine = ContinuousBatcher(cfg, model, loop_steps=4, **ENGINE, **kw)
    kinds, run = [], engine._loop.run

    def recording(*args, spec_k=0):
        kinds.append(spec_k)
        return run(*args, spec_k=spec_k)

    engine._loop.run = recording
    assert _serve(engine, reqs) == one == off
    assert engine.spec_stats()["drafting_disabled"]
    assert kinds[0] == 4 and {2, 1, 0} <= set(kinds)
    assert engine._loop.captures == len(set(kinds))


def test_graph_fold_sampled_equals_loop_off(cuda):
    """Seeded sampled streams: the fold draws as the per-chunk path does."""
    model = tlm.DecoderLM(CFG, device=cuda, seed=0)
    reqs = _requests(1)
    outs = [
        _serve(ContinuousBatcher(CFG, model, loop_steps=loop, **ENGINE), reqs,
               temperature=0.8, top_k=40, seed=5)
        for loop in (1, 4)
    ]
    assert outs[0] == outs[1]


def test_graph_fold_int8(cuda):
    """int8 KV and weights: the int8 arms of K1 and K2 inside the graph."""
    cfg = dataclasses.replace(CFG, kv_dtype="int8", w_dtype="int8")
    model = tlm.DecoderLM(cfg, device=cuda, seed=0)
    reqs = _requests(2)
    kw = dict(spec=True, spec_k=3, spec_min_accept=0.0, draft_cfg=cfg,
              draft_params=model)
    outs = [
        _serve(ContinuousBatcher(cfg, model, loop_steps=loop, **ENGINE, **kw), reqs)
        for loop in (1, 4)
    ]
    plain = _serve(ContinuousBatcher(cfg, model, **ENGINE), reqs)
    assert outs[0] == outs[1] == plain


# tests/test_torch_moe_fixture.py's model and engine: its .npz holds the
# weights, the requests and JAX's tokens on its kernel route.
MOE_FIELDS = dict(
    vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
    num_kv_heads=2, mlp_dim=96, max_seq_len=256, dtype="float32",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False, layer_norm_eps=1e-5, num_experts=4, moe_every=2,
    expert_top_k=2,
)
MOE_ENGINE = dict(slots=4, cache_len=128, chunk_steps=2, prefill_chunk=16,
                  prefill_lanes=4)


def test_moe_under_drops_matches_the_jax_kernel_route(cuda):
    """The paged engine on the card (K2, then K1 with the fresh rows
    injected), f32, capacity 1.25, an idle slot and a part-filled lane:
    JAX's tokens on its fused Pallas route, loop off and on."""
    fix = np.load(os.path.join(os.path.dirname(__file__), "moe_paged_tokens.npz"))
    params = {}
    for key in fix.files:
        if key.startswith("param/"):
            *scopes, leaf = key.split("/")[1:]
            node = params
            for scope in scopes:
                node = node.setdefault(scope, {})
            node[leaf] = fix[key]
    n = len(fix["budgets"])
    reqs = [(fix[f"prompt{i}"], int(fix["budgets"][i])) for i in range(n)]
    want = [fix[f"tokens{i}"].tolist() for i in range(n)]
    for loop in (1, 4):
        engine = ContinuousBatcher(tlm.LMConfig(**MOE_FIELDS), params,
                                   loop_steps=loop, **MOE_ENGINE)
        assert _serve(engine, reqs) == want
