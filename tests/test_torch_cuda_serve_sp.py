"""The sequence-parallel prefill lane and live migration on a GPU.

Every test here needs an NVIDIA GPU and `nvcc` (the kernels build at
first use); without one each skips, deciding inside the test. The file
imports neither jax nor the JAX package, so on a GPU machine without jax
it runs on its own:

    python -m pytest tests/test_torch_cuda_serve_sp.py --noconftest -q

A tiny bf16 llama (2 layers, hidden 128, 4 heads over 2 kv heads) with
random weights. A wide prefill chunk's attention is the dense masked
tail over the row's whole table, where a future position weighs an
exact zero; so the fan-out, which writes a long prompt's later windows
in the same dispatch as its earlier ones, must give the serial lane's
tokens bit for bit in bf16. The streamed tail (`ops/sp_prefill.py`)
visits tiles up to a host horizon; the tiles it skips change no bit. A
migrated slot lands in place in the state the CUDA-graph folds captured,
so a fold after an import serves it.
"""

import numpy as np
import pytest
import torch

from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.ops import decode_attention as da
from walkai_nos_tpu_torch.ops import sp_prefill as sp

CFG = tlm.LMConfig(
    vocab_size=256, hidden_dim=128, num_layers=2, num_heads=4,
    num_kv_heads=2, mlp_dim=256, max_seq_len=1024, dtype="bfloat16",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False,
)
ENGINE = dict(slots=4, cache_len=1024, chunk_steps=4, prefill_chunk=32,
              prefill_lanes=4, sp_min_tokens=256, sp_span=3)
SPECS = [(700, 12), (40, 20), (333, 9), (129, 15)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _prompt(n):
    return np.random.default_rng(n).integers(0, CFG.vocab_size, n).astype(np.int32)


def _run(engine, specs, **kw):
    rids = [engine.submit(_prompt(n), max_new_tokens=m, **kw) for n, m in specs]
    out = engine.run()
    return [out[r] for r in rids]


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix-on", "prefix-off"])
def test_sp_on_equals_sp_off_in_bf16(cuda, prefix):
    model = tlm.DecoderLM(CFG, device=cuda, seed=0)
    outs = {}
    for on in (True, False):
        eng = ContinuousBatcher(CFG, model, sp_prefill=on, prefix_cache=prefix,
                                **ENGINE)
        outs[on] = _run(eng, SPECS)
        if on:
            st = eng.sp_stats()
            assert st["requests_total"] == 2
            assert st["rows_total"] > st["requests_total"]
    assert outs[True] == outs[False]


@pytest.mark.cuda
def test_streamed_tail_horizon_is_bitwise_and_near_dense(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(4, 32, 64, 64, device=cuda, generator=g).bfloat16()
    k = torch.randn(4, 4, 1024, 64, device=cuda, generator=g).bfloat16()
    v = torch.randn(4, 4, 1024, 64, device=cuda, generator=g).bfloat16()
    idx = torch.tensor([0, 100, 500, 900], dtype=torch.int32, device=cuda)
    every = sp.streamed_cache_attention(q, k, v, idx)
    for horizon in (963, 1000, 2000):
        assert torch.equal(
            sp.streamed_cache_attention(q, k, v, idx, horizon=horizon), every)
    dense = tlm._masked_cache_attention(q, k, v, idx)
    assert (every.float() - dense.float()).abs().max().item() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    {}, {"temperature": 0.8, "top_k": 20, "top_p": 0.9, "seed": 7},
], ids=["greedy", "sampled"])
def test_fold_serves_imported_slots(cuda, knobs):
    """A loop_steps 4 engine imports four live streams mid-decode; its
    folds (captured before the import) finish them with the tokens of an
    uninterrupted engine, and launch K1 and K2."""
    model = tlm.DecoderLM(CFG, device=cuda, seed=1)
    specs = [(300, 40), (50, 40), (140, 40), (9, 40)]
    kw = dict(slots=4, cache_len=1024, chunk_steps=4, prefill_chunk=64,
              prefill_lanes=4)
    want = _run(ContinuousBatcher(CFG, model, **kw), specs, **knobs)
    dst = ContinuousBatcher(CFG, model, loop_steps=4, **kw)
    dst.warm()  # captures the plain fold
    assert dst._loop.captures
    src = ContinuousBatcher(CFG, model, **kw)
    rids = [src.submit(_prompt(n), max_new_tokens=m, **knobs) for n, m in specs]
    while not all(src._requests[r].tokens for r in rids):
        src.step()
    src.step()
    payload = src.export_resident()
    assert len(payload["migrate"]) == 4 and not src.has_work
    out = dst.import_resident(payload)
    da.reset_launch_counts()
    folds0 = dst.loop_stats()["dispatches"]
    res = dst.run()
    assert dst.loop_stats()["dispatches"] > folds0
    assert da.LAUNCHES["paged_attention"] > 0 and da.LAUNCHES["qkv_rope"] > 0
    assert [res[o["rid"]] for o in out] == want
