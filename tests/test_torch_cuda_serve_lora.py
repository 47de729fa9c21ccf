"""Multi-LoRA serving on a GPU: the armed paged engine's routes on the
card.

Every test here needs an NVIDIA GPU and `nvcc` (the kernels build at
first use); without one each skips, deciding inside the test. The file
imports neither jax nor the JAX package, so on a GPU machine without jax
it runs on its own:

    python -m pytest tests/test_torch_cuda_serve_lora.py --noconftest -q

A tiny bf16 llama (2 layers, hidden 128, 4 heads over 2 kv heads) with
random weights and synthetic adapters at scale 0.5. An armed forward
takes the unfused route (K1 without injection, no K2), so its adapter-0
tokens must equal a LoRA-free `fused_qkv=False` engine's exactly (the
deltas add exact zeros), and the CUDA-graph fold must compute with
adapter weights loaded after its capture (they are written in place).
"""

import dataclasses

import numpy as np
import pytest
import torch

from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.lora import AdapterSet, lora_proj_dims
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.ops import decode_attention as da

CFG = tlm.LMConfig(
    vocab_size=256, hidden_dim=128, num_layers=2, num_heads=4,
    num_kv_heads=2, mlp_dim=256, max_seq_len=512, dtype="bfloat16",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False,
)
ENGINE = dict(slots=4, cache_len=512, chunk_steps=4, prefill_chunk=32,
              prefill_lanes=2)
IDS = (0, 1, 2, 3, 1)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _adapters():
    return AdapterSet.synthetic(CFG, k=4, rank=4, seed=0, scale=0.5)


def _requests(seed=0):
    rng = np.random.default_rng(seed)
    lens, budgets = [5, 40, 130, 90, 17], [20, 33, 12, 41, 9]
    return [(rng.integers(0, CFG.vocab_size, n).astype(np.int32), m)
            for n, m in zip(lens, budgets)]


def _serve(engine, reqs, ids):
    rids = [engine.submit(p, max_new_tokens=m, adapter=a)
            for (p, m), a in zip(reqs, ids)]
    out = engine.run()
    return [out[r] for r in rids]


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        f"block{i}": {
            proj: {"a": rng.standard_normal((din, 4), np.float32) / np.sqrt(din),
                   "b": rng.standard_normal((4, dout), np.float32) * 0.5}
            for proj, (din, dout) in lora_proj_dims(CFG).items()
        }
        for i in range(CFG.num_layers)
    }


@pytest.mark.cuda
def test_adapter_zero_equals_the_unfused_lora_free_engine(cuda):
    """bf16: adapter-0 traffic on an armed engine (a fused_qkv config)
    runs K1 without K2 and gives a LoRA-free fused_qkv=False engine's
    tokens exactly; adapter traffic gives other tokens."""
    model = tlm.DecoderLM(CFG, device=cuda, seed=0)
    cfg_u = dataclasses.replace(CFG, fused_qkv=False)
    model_u = tlm.DecoderLM(cfg_u, device=cuda, seed=0)
    model_u.load_state_dict(model.state_dict())
    reqs = _requests()
    base = _serve(ContinuousBatcher(cfg_u, model_u, **ENGINE), reqs, (0,) * 5)
    da.reset_launch_counts()
    armed = ContinuousBatcher(CFG, model, adapters=_adapters(), **ENGINE)
    assert _serve(armed, reqs, (0,) * 5) == base
    assert da.LAUNCHES["qkv_rope"] == 0 and da.LAUNCHES["paged_attention"] > 0
    mixed = _serve(ContinuousBatcher(CFG, model, adapters=_adapters(), **ENGINE),
                   reqs, IDS)
    for got, want, a in zip(mixed, base, IDS):
        assert (got == want) == (a == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_mixed_batch_equals_solo_and_the_fold(cuda, spec):
    """A mixed batch: each request alone gives its tokens (spec off), and
    `loop_steps` 4 (the CUDA graph) gives loop 1's."""
    model = tlm.DecoderLM(CFG, device=cuda, seed=0)
    reqs = _requests()
    kw = dict(ENGINE, adapters=_adapters())
    if spec:
        kw.update(spec=True, spec_k=3, spec_min_accept=0.0, draft_cfg=CFG,
                  draft_params=model)
    mixed = _serve(ContinuousBatcher(CFG, model, **kw), reqs, IDS)
    loop = ContinuousBatcher(CFG, model, loop_steps=4, **kw)
    assert _serve(loop, reqs, IDS) == mixed
    assert loop.loop_stats()["dispatches"] > 0
    if not spec:
        for i in (1, 3):
            alone = ContinuousBatcher(CFG, model, **kw)
            assert _serve(alone, reqs[i:i + 1], IDS[i:i + 1]) == mixed[i:i + 1]


@pytest.mark.cuda
def test_graph_fold_reads_a_hot_load(cuda):
    """The fold graph is captured under the synthetic adapter 2, then id 2
    is reloaded: a request under it, served by folds of that graph, gives
    the tokens of a fresh engine built with the new tree, and adapter 1's
    request its old tokens."""
    model = tlm.DecoderLM(CFG, device=cuda, seed=0)
    reqs = _requests()
    engine = ContinuousBatcher(CFG, model, loop_steps=4, adapters=_adapters(), **ENGINE)
    before = _serve(engine, reqs, IDS)
    captures, folds = engine._loop.captures, engine.loop_stats()["dispatches"]
    assert captures >= 1
    tree = _tree(5)
    engine.load_adapter(2, tree, name="hot")
    after = _serve(engine, [reqs[1], reqs[3]], (2, 3))
    assert engine.loop_stats()["dispatches"] > folds
    assert engine._loop.captures == captures
    assert after[1] == before[3]
    cold_set = _adapters()
    cold_set.load(2, tree, name="hot")
    cold = ContinuousBatcher(CFG, model, adapters=cold_set, **ENGINE)
    want = _serve(cold, [reqs[1]], (2,))
    assert after[0] == want[0]
    assert _serve(ContinuousBatcher(CFG, model, adapters=_adapters(), **ENGINE),
                  [reqs[1]], (2,))[0] != want[0]
