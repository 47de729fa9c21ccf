"""The port's one-shot generation (`make_generate_fn` over a dense
cache) against the JAX package's, on the same weights.

Three tiny f32 configs, each built from a numpy-seeded flax tree bridged
into the port: a llama-style GQA model (rmsnorm, swiglu, rope, 4 heads
over 2 kv heads), whose decode steps route to the dense decode kernel's
plain version, the same at head_dim 80 (2 heads over 1 kv head, a width
the kernel takes since it takes any head_dim up to 256), and an
LM_TINY-like MHA model with learned positions and `decode_kernel=True`,
which routes there too. The JAX side runs its
default CPU path (the XLA reference). Greedy tokens must be identical;
prefill logits agree within 1e-4 x max|logit| + 1e-5 (f32 against f32,
other summation orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import decode as jdec
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu_torch.models import decode as tdec
from walkai_nos_tpu_torch.models import lm as tlm

# Tiny shapes: one intra-op thread leaves the cores to the other test
# workers.
torch.set_num_threads(1)

CONFIGS = {
    "gqa": dict(
        vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
        num_kv_heads=2, mlp_dim=96, max_seq_len=256, dtype="float32",
        norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
        head_bias=False, layer_norm_eps=1e-5,
    ),
    "gqa_hd80": dict(
        vocab_size=64, hidden_dim=160, num_layers=2, num_heads=2,
        num_kv_heads=1, mlp_dim=96, max_seq_len=256, dtype="float32",
        norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
        head_bias=False, layer_norm_eps=1e-5,
    ),
    "mha": dict(
        vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
        max_seq_len=256, dtype="float32", decode_kernel=True,
    ),
}


def _params(name, seed=0):
    """Flax init plus numpy noise on every leaf (zero biases and unit
    norm scales get exercised too)."""
    cfg = jlm.LMConfig(**CONFIGS[name])
    params = jax.device_get(jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
        params,
    )


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in CONFIGS:
        params = _params(name)
        cfg = tlm.LMConfig(**CONFIGS[name])
        out[name] = (params, tlm.DecoderLM.from_params(cfg, params, "cpu"), cfg)
    return out


def _prompt(batch, length, seed):
    return np.random.default_rng(seed).integers(0, 64, (batch, length)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_tokens_and_prefill_logits_match_jax(models, name):
    params, model, cfg = models[name]
    prompt = _prompt(3, 21, seed=1)
    want = np.asarray(
        jdec.make_generate_fn(jlm.LMConfig(**CONFIGS[name]))(
            params, jnp.asarray(prompt), 12
        )
    )
    got = tdec.make_generate_fn(cfg, device="cpu")(params, prompt, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    # Prefill logits of the dense-cache forward, both sides.
    bucket = tdec.cache_bucket(21 + 12, cfg.max_seq_len)
    jcfg = jlm.LMConfig(**CONFIGS[name], cache_len=bucket)
    jmodel = jlm.DecoderLM(jcfg)
    cache = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((3, 1), jnp.int32), decode=True
    )["cache"]
    jl, _ = jmodel.apply(
        {"params": params, "cache": cache}, jnp.asarray(prompt),
        decode=True, mutable=["cache"],
    )
    jl = np.asarray(jl)
    tcache = tlm.DenseCache.zeros(dataclasses.replace(cfg, cache_len=bucket), 3, "cpu")
    with torch.inference_mode():
        tl = model(torch.from_numpy(prompt), tcache).numpy()
    assert int(tcache.index) == 21
    np.testing.assert_allclose(tl, jl, atol=1e-4 * np.abs(jl).max() + 1e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chunking_and_bucket_overshoot(models, name):
    """tokens_per_dispatch None / 1 / 3 give identical tokens, here with
    prompt + new tokens = 256 = max_seq_len = the bucket: the last chunk
    of 3 overshoots the bucket by 2 steps, whose writes clamp at
    cache_len - 1 (and, with learned positions, whose position rows
    clamp at the table's end); the JAX generator's one-chunk run
    agrees."""
    params, model, cfg = models[name]
    prompt = _prompt(2, 248, seed=2)
    runs = [
        tdec.make_generate_fn(cfg, tokens_per_dispatch=n, device="cpu")(
            model, prompt, 8
        ).numpy()
        for n in (None, 1, 3)
    ]
    for r in runs[1:]:
        np.testing.assert_array_equal(r, runs[0])
    want = jdec.make_generate_fn(jlm.LMConfig(**CONFIGS[name]))(
        params, jnp.asarray(prompt), 8
    )
    np.testing.assert_array_equal(runs[0], np.asarray(want))


def test_eos_mid_chunk_and_early_stop(models):
    """A row that emits eos_id keeps emitting it; the host stops
    dispatching once every row is done (fewer forwards), and any
    chunking gives the same tokens."""
    _, model, cfg = models["gqa"]
    prompt = _prompt(1, 9, seed=3)
    greedy = tdec.make_generate_fn(cfg, device="cpu")(model, prompt, 16).numpy()[0]
    eos = int(greedy[4])
    first = int(np.argmax(greedy == eos))
    calls = []
    hook = model.register_forward_hook(lambda *a: calls.append(1))
    try:
        outs = []
        for n in (None, 3):
            calls.clear()
            outs.append(tdec.make_generate_fn(
                cfg, eos_id=eos, tokens_per_dispatch=n, device="cpu"
            )(model, prompt, 16).numpy()[0])
            forwards = len(calls)
    finally:
        hook.remove()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0][:first + 1], greedy[:first + 1])
    assert (outs[0][first:] == eos).all()
    # Chunks of 3 after the prefill: the one holding token `first` ends
    # the run; 16 tokens would take 1 + 15 forwards.
    assert forwards == 1 + 3 * (-(-first // 3)) < 16


def test_sampling_is_seeded_and_top_k_1_is_greedy(models):
    _, model, cfg = models["gqa"]
    prompt = _prompt(2, 7, seed=4)
    greedy = tdec.make_generate_fn(cfg, device="cpu")(model, prompt, 10)
    hot = tdec.make_generate_fn(cfg, temperature=1.5, device="cpu")
    a, b = hot(model, prompt, 10, seed=5), hot(model, prompt, 10, seed=5)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, hot(model, prompt, 10, seed=6))
    one = tdec.make_generate_fn(
        cfg, temperature=0.7, top_k=1, top_p=0.9, device="cpu"
    )(model, prompt, 10, seed=5)
    torch.testing.assert_close(one, greedy, atol=0, rtol=0)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(temperature=-0.5), "temperature"),
        (dict(top_k=65), "top_k"),
        (dict(top_p=0.0), "top_p"),
        (dict(tokens_per_dispatch=0), "tokens_per_dispatch"),
    ],
)
def test_validation_errors_match_jax(kwargs, match):
    cfg = tlm.LMConfig(**CONFIGS["gqa"])
    with pytest.raises(ValueError, match=match):
        tdec.make_generate_fn(cfg, device="cpu", **kwargs)
    with pytest.raises(ValueError, match=match):
        jdec.make_generate_fn(jlm.LMConfig(**CONFIGS["gqa"]), **kwargs)


def test_generation_past_max_seq_len_rejected(models):
    _, model, cfg = models["gqa"]
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        tdec.make_generate_fn(cfg, device="cpu")(model, _prompt(1, 250, 0), 7)


def test_dense_cache_refuses_int8_kv():
    """The dense cache has no scale pools: kv_dtype != 'model' raises
    ValueError, as the JAX dense path does."""
    cfg = tlm.LMConfig(**CONFIGS["gqa"], kv_dtype="int8")
    with pytest.raises(ValueError, match="requires paged_decode"):
        tlm.DenseCache.zeros(cfg, 1, "cpu")
