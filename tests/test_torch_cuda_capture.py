"""The capture plane and offline replay on a GPU.

Every test here needs an NVIDIA GPU and `nvcc` (the kernels build at
first use); without one each skips, deciding inside the test. The file
imports neither jax nor the JAX package, so on a GPU machine without jax
it runs on its own:

    python -m pytest tests/test_torch_cuda_capture.py --noconftest -q

A tiny bf16 llama (2 layers, hidden 128, 4 heads over 2 kv heads) with
random weights serves mixed greedy and sampled traffic through a
capturing engine with the device-resident loop (`loop_steps` 4) and the
prefix cache on, through K2 and K1. The capture must replay on fresh
engines token for token as captured, at `loop_steps` 1 and with the
prefix cache off; weights from another seed must diverge and triage
`config_dependent`; `debug_state()` must survive a JSON round trip.
"""

import json

import numpy as np
import pytest
import torch

from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.obs.capture import CaptureLog
from walkai_nos_tpu_torch.ops import decode_attention as da
from walkai_nos_tpu_torch.sim import replay

CFG = tlm.LMConfig(
    vocab_size=256, hidden_dim=128, num_layers=2, num_heads=4,
    num_kv_heads=2, mlp_dim=256, max_seq_len=1024, dtype="bfloat16",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False,
)
ENGINE = dict(slots=4, cache_len=1024, chunk_steps=4, prefill_chunk=32,
              prefill_lanes=2, loop_steps=4)
# (prompt length, new tokens, temperature); 300 and 301 share 256 tokens.
SPECS = [(300, 12, 0.0), (40, 20, 0.8), (333, 9, 0.0), (129, 15, 0.8),
         (301, 10, 0.0)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _prompt(n):
    rng = np.random.default_rng(n)
    shared = np.random.default_rng(0).integers(0, CFG.vocab_size, 256)
    own = rng.integers(0, CFG.vocab_size, n)
    return np.concatenate([shared, own[256:]]) if n > 256 else own


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """One capture over the module's model, made once (None off a GPU)."""
    if not torch.cuda.is_available():
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    model = tlm.DecoderLM(CFG, device="cuda", seed=3)
    log = CaptureLog(str(tmp_path_factory.mktemp("ring")), max_bytes=4096,
                     max_files=64)
    engine = ContinuousBatcher(CFG, model, capture=log, **ENGINE)
    engine.warm()
    da.reset_launch_counts()
    for n, m, t in SPECS:
        engine.submit(_prompt(n), max_new_tokens=m, temperature=t, top_k=40)
    out = engine.run()
    return {"model": model, "engine": engine, "log": log, "out": out,
            "launches": dict(da.LAUNCHES)}


@pytest.mark.cuda
def test_capture_records_every_request_through_the_kernels(cuda, captured):
    log, engine = captured["log"], captured["engine"]
    stats = log.stats()
    assert stats["records"] == {"submit": len(SPECS), "done": len(SPECS)}
    assert not any(stats["dropped"].values())
    assert len(log.files()) >= 3  # the ring rotated at least twice
    for path in log.files():
        with open(path) as f:
            assert json.loads(f.readline())["kind"] == "header"
    assert captured["launches"]["paged_attention"] > 0
    assert captured["launches"]["qkv_rope"] > 0
    assert engine.prefix_stats()["block_hits"] >= 2
    cap = replay.load_capture(log.dir)
    assert cap.fingerprint == engine.config_fingerprint()
    assert {r.rid: r.tokens for r in cap.records} == captured["out"]


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [None, {"loop_steps": 1},
                                       {"prefix_cache": False}],
                         ids=["as-captured", "loop1", "prefix-off"])
def test_replay_verifies_every_digest(cuda, captured, overrides):
    cap = replay.load_capture(captured["log"].dir)
    report = replay.replay_capture(cap, captured["model"], overrides=overrides,
                                   device="cuda")
    assert report.ok, report.summary()
    assert report.n_verified == len(SPECS)


@pytest.mark.cuda
def test_other_weights_triage_config_dependent(cuda, captured, tmp_path):
    cap = replay.load_capture(captured["log"].dir)
    other = tlm.DecoderLM(CFG, device="cuda", seed=4)
    report = replay.replay_capture(cap, other, device="cuda")
    assert len(report.divergent) == len(SPECS)
    verdict = replay.triage_divergence(cap, report, other, device="cuda",
                                       flight_dir=str(tmp_path))
    assert verdict["classification"] == "config_dependent"
    with open(verdict["bundle_path"]) as f:
        bundle = json.load(f)
    assert bundle["record"]["rid"] == verdict["rid"]
    assert bundle["debug_state"]["paged"] is True


@pytest.mark.cuda
def test_debug_state_is_json(cuda, captured, tmp_path):
    engine = ContinuousBatcher(CFG, captured["model"], capture=str(tmp_path),
                               **ENGINE)
    rid = engine.submit(_prompt(200), max_new_tokens=30)
    engine.step()
    engine.step()
    state = engine.debug_state()
    assert json.loads(json.dumps(state)) == state
    assert state["capture"]["enabled"] and state["has_work"]
    assert rid in [s["rid"] for s in state["slots"]] + [
        p["rid"] for p in state["prefilling"]]
    engine.run()
