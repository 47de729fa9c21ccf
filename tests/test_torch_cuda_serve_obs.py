"""The engine's telemetry planes on a GPU.

Every test here needs an NVIDIA GPU and `nvcc` (the kernels build at
first use); without one each skips, deciding inside the test. The file
imports neither jax nor the JAX package, so on a GPU machine without jax
it runs on its own:

    python -m pytest tests/test_torch_cuda_serve_obs.py --noconftest -q

A tiny bf16 llama (2 layers, hidden 128, 4 heads over 2 kv heads) with
random weights in the paged engine, through K2 and K1:

- the engine's own `ProfileHook` armed for 3 dispatches of steady decode
  writes a `torch.profiler` trace whose K1 and K2 kernel events number
  layers x chunk steps x the dispatches between its first tick and its
  last (the last tick stops the profiler before its dispatch launches),
  which is what the wrappers counted in between;
- greedy tokens with telemetry on equal those with it off, loop on and
  off, and the on engine's trace holds one dispatch event per dispatch.
"""

import json

import numpy as np
import pytest
import torch

from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.ops import decode_attention as da

CFG = tlm.LMConfig(
    vocab_size=256, hidden_dim=128, num_layers=2, num_heads=4,
    num_kv_heads=2, mlp_dim=256, max_seq_len=1024, dtype="bfloat16",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False,
)
ENGINE = dict(slots=4, cache_len=1024, chunk_steps=4, prefill_chunk=32,
              prefill_lanes=2)
# (prompt length, new tokens); no request finishes inside the window.
SPECS = [(300, 40), (40, 48), (129, 44)]
WINDOW = 3


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _prompt(n):
    return np.random.default_rng(n).integers(0, CFG.vocab_size, n)


def _serve(engine):
    rids = [engine.submit(_prompt(n), max_new_tokens=m) for n, m in SPECS]
    out = engine.run()
    return [out[r] for r in rids]


@pytest.mark.cuda
def test_profile_hook_window_holds_k1_and_k2(cuda, tmp_path):
    engine = ContinuousBatcher(CFG, tlm.DecoderLM(CFG, device=cuda, seed=0), **ENGINE)
    rids = [engine.submit(_prompt(n), max_new_tokens=m) for n, m in SPECS]
    while engine._pending or engine._prefilling:
        engine.step()
    hook, counts = engine.obs.profile, {}
    start, stop = hook._start, hook._stop

    def counted_start(logdir):
        counts["start"] = dict(da.LAUNCHES)
        return start(logdir)

    def counted_stop():
        counts["stop"] = dict(da.LAUNCHES)
        stop()

    hook._start, hook._stop = counted_start, counted_stop
    hook.arm(WINDOW, str(tmp_path))
    while not hook.status()["completed_windows"]:
        engine.step()
    out = engine.run()
    assert [len(out[r]) for r in rids] == [m for _, m in SPECS]
    status = hook.status()
    assert status["last_error"] is None and not status["active"]
    want = CFG.num_layers * ENGINE["chunk_steps"] * (WINDOW - 1)
    launched = {k: counts["stop"][k] - counts["start"][k]
                for k in ("paged_attention", "qkv_rope")}
    assert launched == {"paged_attention": want, "qkv_rope": want}
    events = json.loads(open(status["last_trace"]).read())["traceEvents"]
    kernels = [e["name"] for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    assert sum("decode_mma_kernel" in k for k in kernels) == want
    assert sum("qkv_mma_kernel" in k for k in kernels) == want


@pytest.mark.cuda
@pytest.mark.parametrize("loop_steps", [1, 4])
def test_tokens_equal_with_telemetry_on_and_off(cuda, loop_steps):
    model = tlm.DecoderLM(CFG, device=cuda, seed=1)
    on = ContinuousBatcher(CFG, model, loop_steps=loop_steps, **ENGINE)
    off = ContinuousBatcher(CFG, model, loop_steps=loop_steps, obs=False, **ENGINE)
    assert _serve(on) == _serve(off)
    ring = on.obs.trace.ring.snapshot()
    assert sum(e["name"] == "dispatch" for e in ring) == on.obs.dispatches.value()
    assert sum(e["name"] == "done" for e in ring) == len(SPECS)
    assert all(e["args"]["device_ms"] >= 0 and e["args"]["host_ms"] > 0
               for e in ring if e["name"] == "dispatch")
    assert off.occupancy()["obs_disabled"] and not off.obs.trace.ring.snapshot()
