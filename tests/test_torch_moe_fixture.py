"""MoE tokens under capacity drops on JAX's kernel route: the fixture the
card is held to.

JAX's paged engine routes its decode step through its fused Pallas
kernel (projection + rotary, then paged attention with the fresh rows
injected) only on a TPU, or on the CPU in interpret mode with both
`WALKAI_DECODE_INTERPRET=1` and `WALKAI_FUSED_QKV=1`
(`walkai_nos_tpu/models/lm.py:_fused_qkv_backend_ok`). That route is the
counterpart of the port's card route (K2, then K1's injection arm). This
test runs it, the variables set in this test only, on a tiny f32 MoE
model under drops (capacity 1.25; 4 slots, 3 requests: an idle slot
throughout and a lane filled to 3 of 4 rows), and holds its tokens to
`moe_paged_tokens.npz`, which also carries the weights and the requests.
`tests/test_torch_cuda_serve_loop.py` holds the port's engine on the
card to the same file, with no JAX there.

The router: a random one routes some token within 1e-2 of a tie over a
run this long (seeds 0-39 of `tests/test_torch_moe_decode.py`'s draw
all did), and a near-tie may flip on rounding alone. So the router
kernel is scaled by 0.05 and its bias set to log([0.5, 0.3, 0.15,
0.05]): every routed token's three largest gates stay over 0.1 apart
(the test checks 1e-2). Its choices then do not depend on the token, so
the drops (the tokens past an expert's capacity, by position) are what
the check sees through routing, not the idle slot's attention output.

Regenerate the file with `JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_moe_fixture.py`.
"""

import os

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

FIXTURE = os.path.join(os.path.dirname(__file__), "moe_paged_tokens.npz")
FIELDS = dict(
    vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
    num_kv_heads=2, mlp_dim=96, max_seq_len=256, dtype="float32",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False, layer_norm_eps=1e-5, num_experts=4, moe_every=2,
    expert_top_k=2,
)
ENGINE = dict(slots=4, cache_len=128, chunk_steps=2, prefill_chunk=16,
              prefill_lanes=4)


def _params():
    cfg = jlm.LMConfig(**FIELDS)
    params = jax.device_get(jax.jit(jlm.DecoderLM(cfg).init_params)(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(np.float32),
        params,
    )
    router = params["block1"]["moe"]["router"]
    router["kernel"] = router["kernel"] * np.float32(0.05)
    router["bias"] = np.log(np.array([0.5, 0.3, 0.15, 0.05], np.float32))
    return params


def _requests():
    """Three prompts of 17-32 tokens (two lane chunks each, so they
    finish their prefill together and JAX's lane keeps one width)."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 64, int(rng.integers(17, 33))).astype(np.int32), m)
            for m in (6, 3, 8)]


def _flat(tree, prefix=""):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _flat(sub, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", np.asarray(sub)


def _serve(engine, reqs):
    rids = [engine.submit(p, max_new_tokens=m) for p, m in reqs]
    out = engine.run()
    return [out[r] for r in rids]


def _jax_kernel_route_tokens(params, reqs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WALKAI_DECODE_INTERPRET", "1")
        mp.setenv("WALKAI_FUSED_QKV", "1")
        mp.setattr(JaxBatcher, "_dev",
                   lambda self, a: jnp.asarray(np.array(a, copy=True)))
        return _serve(JaxBatcher(jlm.LMConfig(**FIELDS), params, **ENGINE), reqs)


def _write_fixture():
    params, reqs = _params(), _requests()
    tokens = _jax_kernel_route_tokens(params, reqs)
    np.savez_compressed(
        FIXTURE,
        **{f"param/{k}": v for k, v in _flat(params)},
        **{f"prompt{i}": p for i, (p, _) in enumerate(reqs)},
        budgets=np.array([m for _, m in reqs]),
        **{f"tokens{i}": np.array(t) for i, t in enumerate(tokens)},
    )


def test_jax_kernel_route_under_drops_matches_the_fixture():
    params, reqs = _params(), _requests()
    fix = np.load(FIXTURE)
    for name, leaf in _flat(params):
        np.testing.assert_array_equal(fix[f"param/{name}"], leaf, err_msg=name)
    for i, (p, m) in enumerate(reqs):
        np.testing.assert_array_equal(fix[f"prompt{i}"], p)
        assert fix["budgets"][i] == m
    want = [fix[f"tokens{i}"].tolist() for i in range(len(reqs))]
    assert _jax_kernel_route_tokens(params, reqs) == want
    # The port on the CPU (its plain route) gives them too; its MoE calls
    # drop assignments and keep every top-3 gate gap over 1e-2.
    engine = ContinuousBatcher(tlm.LMConfig(**FIELDS), params, device="cpu",
                               **ENGINE)
    seen = {"drops": 0, "gap": 1.0}

    def hook(moe, args):
        h, rows = args[0], (args[1] if len(args) > 1 else None)
        b, s, d = h.shape
        routed = (b if rows is None else rows) * s
        gates = torch.softmax(moe.router(h.reshape(-1, d)[:routed]), -1)
        top = torch.sort(gates, -1, descending=True).values[:, :3]
        seen["gap"] = min(seen["gap"], float((top[:, :-1] - top[:, 1:]).min()))
        load = torch.bincount(torch.topk(gates, moe.top_k, -1).indices.reshape(-1),
                              minlength=moe.num_experts)
        seen["drops"] += int(torch.clamp(load - moe.capacity(routed), min=0).sum())

    for m in engine.model.modules():
        if isinstance(m, MoEMlp):
            m.register_forward_pre_hook(hook)
    assert _serve(engine, reqs) == want
    assert seen["drops"] > 0 and seen["gap"] > 1e-2, seen


if __name__ == "__main__":
    _write_fixture()
