"""The port's speculative decoding against the JAX package's, and
against the port's own greedy generation.

Target: a tiny f32 llama-style GQA model (4 heads over 2 kv heads), so
its k+1-position verify forward routes to the dense decode kernel's
multi-step arm (its plain version here). Drafts: the target itself
(every round accepts all k drafts) and a `draft_config` model (1 layer,
MHA), both from numpy-seeded flax trees bridged into the port. Greedy
with exact-match acceptance, f32: the tokens and the acceptance
histogram must be identical to JAX's, and the tokens to greedy decoding
of the target alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models import speculative as jspec
from walkai_nos_tpu_torch.models import decode as tdec
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models import speculative as tspec

# Tiny shapes: one intra-op thread leaves the cores to the other test
# workers.
torch.set_num_threads(1)

TARGET = dict(
    vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
    num_kv_heads=2, mlp_dim=96, max_seq_len=256, dtype="float32",
    norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
    head_bias=False, layer_norm_eps=1e-5,
)


def _params(cfg, seed):
    params = jax.device_get(jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
        params,
    )


@pytest.fixture(scope="module")
def setup():
    jt = jlm.LMConfig(**TARGET)
    jd = jlm.draft_config(jt)
    tt = tlm.LMConfig(**TARGET)
    td = tlm.draft_config(tt)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    tp, dp = _params(jt, 0), _params(jd, 1)
    prompt = np.random.default_rng(2).integers(0, 64, (1, 11)).astype(np.int32)
    greedy = tdec.make_generate_fn(tt, device="cpu")(tp, prompt, 20).numpy()
    return dict(jt=jt, jd=jd, tt=tt, td=td, tp=tp, dp=dp, prompt=prompt,
                greedy=greedy)


@pytest.mark.parametrize("draft", ["draft_config", "self"])
@pytest.mark.parametrize("k", [1, 4])
def test_matches_jax_and_greedy(setup, k, draft):
    s = setup
    jd, td, dp = (
        (s["jt"], s["tt"], s["tp"]) if draft == "self"
        else (s["jd"], s["td"], s["dp"])
    )
    want, jstats = jspec.make_speculative_generate_fn(
        s["jt"], jd, k=k, return_stats=True
    )(s["tp"], dp, jnp.asarray(s["prompt"]), 20)
    got, stats = tspec.make_speculative_generate_fn(
        s["tt"], td, k=k, return_stats=True, device="cpu"
    )(s["tp"], dp, s["prompt"], 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), s["greedy"])
    hist = stats["acceptance_hist"]
    np.testing.assert_array_equal(
        hist.numpy(), np.asarray(jstats["acceptance_hist"])
    )
    # Rounds emit a + 1 tokens each; the last may overshoot the budget.
    emitted = 1 + int((hist * torch.arange(1, k + 2)).sum())
    assert 20 <= emitted < 20 + k + 1, emitted
    if draft == "self":  # the target drafting for itself: all accepted
        assert hist[:-1].sum() == 0


def test_verify_wider_than_the_kernel_matches_jax(setup):
    """k = 8: the 9-position verify is wider than the decode kernel's
    MAX_KERNEL_STEPS and takes the model's masked cache attention, as in
    JAX; tokens and the acceptance histogram are JAX's."""
    s = setup
    want, jstats = jspec.make_speculative_generate_fn(
        s["jt"], s["jd"], k=8, return_stats=True
    )(s["tp"], s["dp"], jnp.asarray(s["prompt"]), 20)
    got, stats = tspec.make_speculative_generate_fn(
        s["tt"], s["td"], k=8, return_stats=True, device="cpu"
    )(s["tp"], s["dp"], s["prompt"], 20)
    assert got.shape == (1, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), s["greedy"])
    np.testing.assert_array_equal(
        stats["acceptance_hist"].numpy(), np.asarray(jstats["acceptance_hist"])
    )


def test_accept_tokens_matches_jax():
    rng = np.random.default_rng(3)
    for k in (1, 3, 4):
        chosen = rng.integers(0, 4, (64, k + 1)).astype(np.int32)
        drafts = chosen[:, :k].copy()
        # Mismatch at a random position (or none) per row.
        cut = rng.integers(0, k + 1, 64)
        for r, c in enumerate(cut):
            if c < k:
                drafts[r, c] = (drafts[r, c] + 1) % 4
        want = jspec.accept_tokens(jnp.asarray(drafts), jnp.asarray(chosen))
        got = tspec.accept_tokens(torch.from_numpy(drafts), torch.from_numpy(chosen))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(got[0].numpy(), cut)


def test_rewind_cache_moves_only_the_index():
    cfg = tlm.LMConfig(**TARGET)
    for ragged in (False, True):
        cache = tlm.DenseCache.zeros(
            dataclasses.replace(cfg, ragged_decode=ragged), 3, "cpu", cache_len=128
        )
        cache.k[0][:, :, :9] = 1.0
        rows = cache.k[0].clone()
        cache.index += 9
        new = torch.tensor([4, 5, 6]) if ragged else 4
        assert tspec.rewind_cache(cache, new) is cache
        want = torch.tensor([4, 5, 6]) if ragged else torch.full((), 4)
        torch.testing.assert_close(tspec.cache_positions(cache), want.int())
        torch.testing.assert_close(cache.k[0], rows, atol=0, rtol=0)


def test_guards_match_jax(setup):
    s = setup
    gen = tspec.make_speculative_generate_fn(s["tt"], s["td"], k=2, device="cpu")
    with pytest.raises(ValueError, match="single-sequence"):
        gen(s["tp"], s["dp"], np.zeros((2, 4), np.int32), 4)
    with pytest.raises(ValueError, match="exceeds"):
        gen(s["tp"], s["dp"], np.zeros((1, 4), np.int32), 251)
    out = gen(s["tp"], s["dp"], np.zeros((1, 4), np.int32), 250)
    assert out.shape == (1, 250)
    with pytest.raises(ValueError, match="k"):
        tspec.make_speculative_generate_fn(s["tt"], s["td"], device="cpu", k=0)
    with pytest.raises(ValueError, match="vocabulary"):
        tspec.make_speculative_generate_fn(
            s["tt"], dataclasses.replace(s["td"], vocab_size=32), device="cpu"
        )
