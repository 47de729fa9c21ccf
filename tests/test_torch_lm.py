"""The port's DecoderLM against the JAX package's, on the same weights.

The JAX model's flax params go through the port's weight bridge
(`models/convert.py`); both models then run the paged decode path over
the same block tables: one 64-token prefill chunk (the engine's
`prefill_chunk`), then single steps. Tiny f32 configs of both families:
llama (rmsnorm, swiglu, rope, GQA) and gpt2 (layernorm, gelu, learned
positions, biases). f32 on both sides, so the logits agree up to
summation order: atol = rtol = 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.convert import load_flax_params

# Tiny shapes: one intra-op thread leaves the cores to the other test
# workers.
torch.set_num_threads(1)

TOL = 1e-4
FAMILIES = {
    "llama": dict(
        vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
        num_kv_heads=2, mlp_dim=96, max_seq_len=256, dtype="float32",
        norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
        head_bias=False, layer_norm_eps=1e-5,
    ),
    "gpt2": dict(
        vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
        max_seq_len=256, dtype="float32", layer_norm_eps=1e-5,
    ),
}
PAGED = dict(ragged_decode=True, paged_decode=True, paged_blocks=8)


def _jax_params(cfg, seed):
    """Flax init, then noise on every leaf so zero-initialised biases
    and unit norm scales are exercised too."""
    params = jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(np.float32),
        jax.device_get(params),
    )


def _run_both(family, index0, steps_after=3, seed=0, **extra):
    fields = {**FAMILIES[family], **extra}
    jcfg = jlm.LMConfig(**fields, **PAGED)
    tcfg = tlm.LMConfig(**fields, **PAGED)
    params = _jax_params(jlm.LMConfig(**fields), seed)
    rng = np.random.default_rng(seed + 1)
    b = len(index0)
    table = rng.permutation(np.arange(1, 8))[:b * 2].reshape(b, 2).astype(np.int32)
    index = np.asarray(index0, np.int32)

    jmodel = jlm.DecoderLM(jcfg)
    cache = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((b, 1), jnp.int32), decode=True
    )["cache"]
    cache = jax.tree.map(
        lambda leaf: jnp.asarray(index) if leaf.ndim == 1 else leaf, cache
    )
    tmodel = load_flax_params(
        tlm.DecoderLM(tcfg, device="cpu"), params
    )
    tcache = tlm.PagedCache.zeros(tcfg, "cpu")
    t_index = torch.from_numpy(index.astype(np.int64))
    t_table = torch.from_numpy(table)

    tokens = rng.integers(0, 64, (b, 64)).astype(np.int32)
    outs = []
    # One program per shape: op-by-op dispatch compiles every primitive.
    apply = jax.jit(lambda cache, tokens: jmodel.apply(
        {"params": params, "cache": cache}, tokens, decode=True,
        block_table=jnp.asarray(table), mutable=["cache"],
    ))
    for step in range(1 + steps_after):
        jl, variables = apply(cache, jnp.asarray(tokens))
        cache = variables["cache"]
        with torch.inference_mode():
            tl = tmodel(torch.from_numpy(tokens), tcache, t_table, t_index)
        t_index += tokens.shape[1]
        outs.append((np.asarray(jl), tl.numpy()))
        tokens = np.argmax(np.asarray(jl)[:, -1:], axis=-1).astype(np.int32)
    return outs, cache, tcache, tcfg


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_paged_decode_logits_match_jax(family):
    # Slot 0 from the start; slot 1 crosses a block edge in the chunk;
    # slot 2 runs past the table and (gpt2) past max_seq_len, where the
    # position table is read with XLA's clamped dynamic_slice.
    outs, jcache, tcache, cfg = _run_both(family, [0, 70, 250])
    for step, (jl, tl) in enumerate(outs):
        np.testing.assert_allclose(
            tl, jl, atol=TOL, rtol=TOL, err_msg=f"{family} step {step}"
        )
    # The pools hold the same rows (block 0 is the scratch block, and the
    # port's pools end in the scatter's dump block).
    for i in range(cfg.num_layers):
        attn = jcache[f"block{i}"]["attn"]
        np.testing.assert_allclose(
            tcache.k[i].numpy()[1:-1], np.asarray(attn["cached_key"])[1:],
            atol=TOL, rtol=TOL,
        )
        np.testing.assert_allclose(
            tcache.v[i].numpy()[1:-1], np.asarray(attn["cached_value"])[1:],
            atol=TOL, rtol=TOL,
        )


def test_fused_flag_takes_the_plain_path_on_cpu():
    """CPU tensors run the unfused composition whatever `fused_qkv`
    says, as the JAX package does off the TPU."""
    base = tlm.LMConfig(**FAMILIES["llama"], **PAGED)
    tokens = torch.randint(0, 64, (2, 1), generator=torch.Generator().manual_seed(0))
    table = torch.tensor([[1, 2], [3, 4]])
    index = torch.tensor([5, 130])
    logits = []
    for fused in (True, False):
        cfg = dataclasses.replace(base, fused_qkv=fused)
        model = tlm.DecoderLM(cfg, device="cpu", seed=3)
        logits.append(model(tokens, tlm.PagedCache.zeros(cfg, "cpu"), table, index))
    torch.testing.assert_close(logits[0], logits[1], atol=0, rtol=0)


def test_config_fields_and_presets_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jlm.LMConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tlm.LMConfig)}
    assert tf == jf
    for name in ("LM_TINY", "LM_SMALL"):
        assert dataclasses.asdict(getattr(tlm, name)) == dataclasses.asdict(
            getattr(jlm, name)
        )


@pytest.mark.parametrize(
    "kwargs,err",
    [
        (dict(norm="batchnorm"), ValueError),
        (dict(num_heads=8, num_kv_heads=3), ValueError),
        (dict(paged_decode=True, ragged_decode=True, paged_blocks=1), ValueError),
        (dict(kv_dtype="fp4"), ValueError),
        (dict(tp_devices=2), NotImplementedError),
        (dict(use_ring_attention=True), NotImplementedError),
    ],
)
def test_config_validation(kwargs, err):
    with pytest.raises(err):
        tlm.LMConfig(**kwargs)
    if err is ValueError:  # the JAX config refuses the same values
        with pytest.raises(ValueError):
            jlm.LMConfig(**kwargs)


def test_moe_cache_forwards_match_jax():
    """Experts in the cache forwards (4 experts, top-2, an MoE block on
    the second layer, the default capacity 1.25): the paged cache over
    three slots, the dense cache, and `from_params` of a flax tree and of
    a DecoderLM give JAX's logits, in f32 within TOL. Each call routes
    its batch x steps tokens together, as JAX's does."""
    moe = dict(num_experts=4, expert_top_k=2)
    outs, _, _, _ = _run_both("llama", [0, 70, 250], **moe)
    for step, (jl, tl) in enumerate(outs):
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL,
                                   err_msg=f"paged step {step}")
    fields = dict(FAMILIES["llama"], **moe)
    jcfg, tcfg = jlm.LMConfig(**fields), tlm.LMConfig(**fields)
    params = _jax_params(jcfg, 1)
    jmodel = jlm.DecoderLM(jcfg)
    cache = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32), decode=True
    )["cache"]
    apply = jax.jit(lambda cache, tokens: jmodel.apply(
        {"params": params, "cache": cache}, tokens, decode=True,
        mutable=["cache"],
    ))
    from_tree = tlm.DecoderLM.from_params(tcfg, params, "cpu")
    assert tlm.DecoderLM.from_params(tcfg, from_tree) is from_tree
    tcache = tlm.DenseCache.zeros(tcfg, 2, "cpu")
    tokens = np.random.default_rng(2).integers(0, 64, (2, 20)).astype(np.int32)
    for step in range(3):
        jl, variables = apply(cache, jnp.asarray(tokens))
        cache = variables["cache"]
        with torch.inference_mode():
            tl = from_tree(torch.from_numpy(tokens), tcache).numpy()
        np.testing.assert_allclose(tl, np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"dense step {step}")
        tokens = np.argmax(np.asarray(jl)[:, -1:], axis=-1).astype(np.int32)


@pytest.mark.parametrize("kv_dtype", ["model", "int8", "int8-sim"])
@pytest.mark.parametrize("w_dtype", ["model", "int8", "int8-sim"])
def test_quant_properties_match_jax(kv_dtype, w_dtype):
    """Every kv_dtype x w_dtype constructs, and kv_quant, w_quant and
    kv_storage_dtype read as the JAX config's properties do."""
    kw = dict(kv_dtype=kv_dtype, w_dtype=w_dtype, dtype="bfloat16")
    t, j = tlm.LMConfig(**kw), jlm.LMConfig(**kw)
    assert (t.kv_quant, t.w_quant) == (j.kv_quant, j.w_quant)
    assert str(t.kv_storage_dtype).removeprefix("torch.") == str(
        j.kv_storage_dtype
    )


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [100, 101, 102, 103, 104]])
    want = jlm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tlm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
