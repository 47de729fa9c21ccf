"""The port's quantized serving (`kv_dtype` / `w_dtype`) against the JAX
engine's, and its own invariants.

A tiny f32 llama config (2 layers, hidden 64, 4 heads over 2 kv heads,
vocab 64) on one flax tree, served at cache_len 384 with the JAX
`tests/test_serve_quant.py` mixed ragged workload, whose prompts cross
128-row blocks mid-prefill (140) and mid-decode (120 + 12). Greedy
tokens must be identical:

- "int8-sim" (KV and weights) against the port's unquantized engine and
  against the JAX "int8-sim" engine: the sim arms are lossless;
- "int8" against the JAX "int8" engine: both quantize bit for bit alike
  (tests/test_torch_quant.py) given equal rows, and f32 rows differ only
  in summation order, far from any int8 rounding edge on this workload.

The JAX engine gets private copies of its uploads (see
tests/test_torch_serve.py: its `_dev` can alias a host array the host
then mutates). Dense-cache entry points take int8 weights too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import decode as jdec
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch.models import decode as tdec
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models import speculative as tspec
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.ops.decode_attention import PAGE_ROWS

# Tiny shapes: one intra-op thread leaves the cores to the other test
# workers.
torch.set_num_threads(1)

FIELDS = dict(
    vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
    num_kv_heads=2, mlp_dim=128, max_seq_len=512, dtype="float32",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False,
)
ENGINE = dict(slots=2, cache_len=384, chunk_steps=3, prefill_chunk=32,
              prefill_lanes=2)
GREEDY_SPECS = [(3, 9), (20, 12), (120, 12), (140, 8)]
QUANT = {"sim": dict(kv_dtype="int8-sim", w_dtype="int8-sim"),
         "int8": dict(kv_dtype="int8", w_dtype="int8")}


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int32)


def _serve(engine):
    rids = {
        engine.submit(_prompt(n, n), max_new_tokens=m): (n, m)
        for n, m in GREEDY_SPECS
    }
    out = engine.run()
    return {rids[r]: list(map(int, t)) for r, t in out.items()}


@pytest.fixture(scope="module")
def served():
    cfg = jlm.LMConfig(**FIELDS)
    params = jax.device_get(
        jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(0))
    )
    out = {"params": params}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            JaxBatcher, "_dev",
            lambda self, a: jnp.asarray(np.array(a, copy=True)),
        )
        for name, q in QUANT.items():
            eng = JaxBatcher(dataclasses.replace(cfg, **q), params, **ENGINE)
            out[name] = _serve(eng)
            out[name + "_stats"] = (eng.kv_stats(), eng.quant_stats())
    return out


def _port(served, **fields):
    return ContinuousBatcher(
        tlm.LMConfig(**FIELDS, **fields), served["params"], device="cpu",
        **ENGINE,
    )


def test_sim_engine_matches_unquantized_and_jax(served):
    sim = _serve(_port(served, **QUANT["sim"]))
    assert sim == _serve(_port(served))
    assert sim == served["sim"]
    assert {k: len(v) for k, v in sim.items()} == {
        (n, m): m for n, m in GREEDY_SPECS
    }


def test_int8_engine_matches_jax(served):
    got = _serve(_port(served, **QUANT["int8"]))
    assert got == served["int8"]


@pytest.mark.parametrize("kind", ["sim", "int8"])
def test_byte_books_match_jax(served, kind):
    """KV bytes per token (4 scale bytes per row and head beside the
    storage dtype's), the pools' backing bytes by dtype and the served
    weights' bytes equal the JAX engine's."""
    engine = _port(served, **QUANT[kind])
    jkv, jq = served[kind + "_stats"]
    qs = engine.quant_stats()
    assert engine.kv_stats()["kv_bytes_per_token"] == jkv["kv_bytes_per_token"]
    assert engine.kv_stats()["kv_backing_bytes"] == jkv["kv_backing_bytes"]
    for key in ("enabled", "kv_dtype", "w_dtype", "kv_storage_dtype",
                "kv_bytes_per_token", "param_bytes", "kv_cache_bytes"):
        assert qs[key] == jq[key], key
    c = engine.cfg
    hd = c.head_dim
    item = 1 if kind == "int8" else 4
    assert qs["kv_bytes_per_token"] == c.num_layers * 2 * c.kv_heads * (
        hd * item + 4
    )
    assert qs["weight_quant_seconds"] > 0


def test_scale_pool_residency_tracks_committed_rows(served):
    """After the prefill of a 130-token prompt the slot holds 2 blocks:
    the first with all 128 scale rows written, the second rows 0-1 only,
    and no other block but the scratch block 0 carries a scale."""
    engine = ContinuousBatcher(
        tlm.LMConfig(**FIELDS, **QUANT["int8"]), served["params"],
        device="cpu", **{**ENGINE, "slots": 1, "prefill_lanes": 1},
    )
    engine.submit(_prompt(130, 130), max_new_tokens=64)
    for _ in range(32):
        engine.step()
        if engine._slot_req[0] is not None:
            break
    assert engine._slot_req[0] is not None
    pos = int(engine.pool.slot_pos[0])
    blocks = list(engine.pool.slot_blocks[0])
    assert pos == 130 and len(blocks) == -(-pos // PAGE_ROWS)
    cache = engine._state.cache
    for scales in cache.ks + cache.vs:
        written = (scales > 0).numpy()
        for i, blk in enumerate(blocks):
            rows = min(max(pos - i * PAGE_ROWS, 0), PAGE_ROWS)
            assert written[blk, :, :rows].all(), (i, blk)
            assert not written[blk, :, rows:].any(), (i, blk)
        others = [b for b in range(1, engine.pool_blocks) if b not in blocks]
        assert not written[others].any(), "scales leaked off the slot"
    assert all(p.dtype == torch.int8 for p in cache.k + cache.v)
    engine.run()


def test_kv_quant_requires_the_paged_engine(served):
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(
            tlm.LMConfig(**FIELDS, **QUANT["int8"]), served["params"],
            device="cpu", slots=2, cache_len=256, paged=False,
        )
    with pytest.raises(ValueError, match="paged"):
        tlm.DenseCache.zeros(tlm.LMConfig(**FIELDS, kv_dtype="int8-sim"), 1, "cpu")


def test_caller_tree_and_prequantized_tree(served):
    """The engine quantizes its own copy: the caller's tree is left
    alone, and a tree quantized beforehand serves the same tokens."""
    params = served["params"]
    engine = _port(served, **QUANT["int8"])
    assert "scale" not in params["block0"]["attn"]["qkv"]
    assert engine.model.blocks[0].fc1.kernel.dtype == torch.int8
    pre = tlm.quantize_lm_params(params, tlm.LMConfig(**FIELDS, **QUANT["int8"]))
    again = ContinuousBatcher(
        tlm.LMConfig(**FIELDS, **QUANT["int8"]), pre, device="cpu", **ENGINE
    )
    assert _serve(again) == served["int8"]


@pytest.fixture(scope="module")
def int8_weights(served):
    """The w_dtype="int8" tree (KV unquantized: the dense cache path)."""
    cfg = tlm.LMConfig(**FIELDS, w_dtype="int8")
    return cfg, tlm.quantize_lm_params(served["params"], cfg)


def test_generate_int8_weights_matches_jax(int8_weights):
    cfg, tree = int8_weights
    prompts = np.stack([_prompt(40, 1), _prompt(40, 2)])
    want = jdec.make_generate_fn(jlm.LMConfig(**FIELDS, w_dtype="int8"))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(prompts), max_new_tokens=10,
    )
    got = tdec.make_generate_fn(cfg, device="cpu")(tree, prompts, 10)
    assert got.tolist() == np.asarray(want).tolist()


def test_dense_engine_and_speculative_take_int8_weights(int8_weights):
    """The dense engine and speculative decoding (the model as its own
    draft) give `make_generate_fn`'s greedy tokens on the int8 tree."""
    cfg, tree = int8_weights
    model = tlm.DecoderLM.from_params(cfg, tree, device="cpu")
    gen = tdec.make_generate_fn(cfg, device="cpu")
    spec = tspec.make_speculative_generate_fn(cfg, cfg, k=3, device="cpu")
    engine = ContinuousBatcher(cfg, model, device="cpu", slots=2,
                               cache_len=256, paged=False)
    specs = [(20, 9), (70, 6)]
    rids = [engine.submit(_prompt(n, n), max_new_tokens=m) for n, m in specs]
    out = engine.run()
    for (n, m), rid in zip(specs, rids):
        want = gen(model, _prompt(n, n)[None], m)[0].tolist()
        assert out[rid] == want
        assert spec(model, model, _prompt(n, n)[None], m)[0].tolist() == want
