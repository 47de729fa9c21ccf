"""The port's LM training path against the JAX package's, on the same
weights (flax params bridged by `models/convert.py`) and tokens.

- `lm_loss` equals the JAX loss on the same logits (1e-6 relative);
- the full causal forward (no cache) gives `jlm.DecoderLM(cfg).apply`'s
  logits: in f32 within 1e-4 of the largest |logit| (summation order
  only); in bf16 within 2e-2 of it (both sides round every projection,
  the attention output and the residual to bf16, a bf16 ulp being 2**-8
  relative; the port's plain attention keeps the probabilities f32 in
  the PV product where the JAX reference rounds them to bf16, and that
  difference passes through two layers);
- three `make_lm_train_step` steps agree with the JAX step on a
  one-device CPU mesh, in losses (1e-4 relative) and in parameters
  (1e-4 of each tensor's max |value| + 1e-6, the rule of
  tests/test_torch_train.py);
- `remat=True` gives the loss and the gradients of `remat=False`,
  bitwise;
- `fit` with a checkpoint directory resumes at the saved step and
  replays the losses of an uninterrupted run;
- the compute flow of `hack/smoke.py`: train, then generate from the
  trained master-weight model, and the engine's greedy tokens equal
  the one-shot generation's.

Two tiny families: llama (GQA 4 heads over 2, rope, rmsnorm, swiglu, no
biases) and gpt2 (learned positions, layernorm, gelu, biases).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.parallel.mesh import build_mesh
from walkai_nos_tpu_torch.models import data as tdata
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.convert import load_flax_params
from walkai_nos_tpu_torch.models.decode import make_generate_fn
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.models.trainer import fit

torch.set_num_threads(1)

FAMILIES = {
    "llama": dict(
        vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
        num_kv_heads=2, mlp_dim=96, max_seq_len=64, dtype="float32",
        norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
        head_bias=False, layer_norm_eps=1e-5,
    ),
    "gpt2": dict(
        vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
        max_seq_len=64, dtype="float32", layer_norm_eps=1e-5,
    ),
}
LOGIT_REL = {"float32": 1e-4, "bfloat16": 2e-2}


def _tokens(b=2, s=32, seed=0, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _noisy_params(cfg, seed=0):
    """Flax init plus noise on every leaf, so zero biases and unit norm
    scales are exercised too."""
    params = jax.device_get(jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(np.float32), params
    )


def _flat_jax(params) -> dict:
    flat = {}
    for name, sub in params.items():
        top = f"blocks.{name[5:]}" if name.startswith("block") and name[5:].isdigit() else name
        if not hasattr(sub, "items"):
            flat[top] = np.asarray(sub)
            continue
        for path, leaf in jax.tree_util.tree_flatten_with_path(sub)[0]:
            flat[".".join([top] + [p.key for p in path])] = np.asarray(leaf)
    return flat


def assert_params_match(model, jparams, hidden_dim):
    """Every parameter within 1e-4 of its tensor's max |value| + 1e-6."""
    flat = _flat_jax(jparams)
    own = dict(model.named_parameters())
    assert set(own) == set(flat)
    for name, p in own.items():
        got, want = p.detach().numpy(), flat[name]
        if name.endswith("attn.qkv.bias") and got.shape[0] == 3 * hidden_dim:
            # The key bias adds q . b_k to every visible score of a row,
            # which the softmax cancels: its exact gradient is 0, so both
            # sides hold rounding noise that Adam scales to +-lr steps.
            # Compare the query and value thirds.
            keep = np.r_[0:hidden_dim, 2 * hidden_dim:3 * hidden_dim]
            got, want = got[keep], want[keep]
        err = np.max(np.abs(got - want))
        assert err <= 1e-4 * np.max(np.abs(want)) + 1e-6, (name, err)


def run_three_steps(fields, tokens):
    """Three JAX steps on a one-device mesh and three port steps from the
    same init; returns (jax losses, port losses, jax params, port
    state)."""
    jcfg, tcfg = jlm.LMConfig(**fields), tlm.LMConfig(**fields)
    mesh = build_mesh(jax.devices()[:1])
    state = jlm.init_lm_state(jcfg, mesh, jax.random.PRNGKey(0))
    params0 = jax.device_get(state.params)
    jstep = jlm.make_lm_train_step(jcfg, mesh)
    tstate = tlm.init_lm_state(tcfg, device="cpu")
    load_flax_params(tstate.params, params0)
    tstep = tlm.make_lm_train_step(tcfg, device="cpu")
    jlosses, tlosses = [], []
    for _ in range(3):
        # The JAX step donates its state: hand it a fresh copy of the batch.
        state, loss = jstep(state, jnp.array(tokens, copy=True))
        jlosses.append(float(loss))
        tstate, loss = tstep(tstate, tokens)
        tlosses.append(float(loss))
    return jlosses, tlosses, jax.device_get(state.params), tstate


def test_lm_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 17, 50)).astype(np.float32) * 3
    tokens = rng.integers(0, 50, (3, 17)).astype(np.int32)
    want = float(jlm.lm_loss(jnp.asarray(logits), jnp.asarray(tokens)))
    got = tlm.lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_full_forward_matches_jax(family, dtype):
    fields = dict(FAMILIES[family], dtype=dtype)
    params = _noisy_params(jlm.LMConfig(**fields))
    tokens = _tokens()
    want = np.asarray(jlm.DecoderLM(jlm.LMConfig(**fields)).apply(
        {"params": params}, jnp.asarray(tokens)
    ))
    cfg = tlm.LMConfig(**fields)
    for param_dtype in (None, torch.float32):  # serving and training builds
        model = load_flax_params(
            tlm.DecoderLM(cfg, device="cpu", param_dtype=param_dtype), params
        )
        with torch.no_grad():
            got = model(torch.from_numpy(tokens)).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        err = np.max(np.abs(got - want))
        assert err <= LOGIT_REL[dtype] * np.max(np.abs(want)), (param_dtype, err)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_three_train_steps_match_jax(family):
    jlosses, tlosses, jparams, tstate = run_three_steps(FAMILIES[family], _tokens())
    assert tstate.step == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    assert_params_match(tstate.params, jparams, FAMILIES[family]["hidden_dim"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_gives_the_same_loss_and_gradients(family):
    tokens = torch.from_numpy(_tokens(seed=3))
    results = []
    for remat in (False, True):
        cfg = tlm.LMConfig(**FAMILIES[family], remat=remat)
        model = tlm.init_lm_state(cfg, seed=2, device="cpu").params
        loss = tlm.lm_loss(model(tokens), tokens)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (loss0, grads0), (loss1, grads1) = results
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    for name, g in grads0.items():
        assert g is not None and torch.equal(g, grads1[name]), name


def test_fit_resumes_from_checkpoint_and_replays_losses(tmp_path):
    cfg = tlm.LMConfig(**FAMILIES["llama"])
    step = tlm.make_lm_train_step(cfg, device="cpu")
    batches = [_tokens(seed=10 + i) for i in range(6)]
    straight = fit(tlm.init_lm_state(cfg, device="cpu"), step, iter(batches),
                   num_steps=6, log_every=1)
    assert straight.steps_run == 6 and len(straight.losses) == 6

    ckpt = str(tmp_path / "ckpt")
    first = fit(tlm.init_lm_state(cfg, device="cpu"), step, iter(batches[:3]),
                num_steps=3, log_every=1, checkpoint_dir=ckpt, checkpoint_every=2)
    assert first.resumed_from is None and first.state.step == 3
    # A template from another seed: everything must come from the file.
    template = tlm.init_lm_state(cfg, seed=1, device="cpu")
    second = fit(template, step, iter(batches[3:]), num_steps=3, log_every=1,
                 checkpoint_dir=ckpt, checkpoint_every=2)
    assert second.resumed_from == 3 and second.state.step == 6
    np.testing.assert_array_equal(second.losses, straight.losses[3:])
    for (name, p), q in zip(second.state.params.named_parameters(),
                            straight.state.params.parameters()):
        assert torch.equal(p, q), name


def test_smoke_compute_flow_trains_generates_and_serves(tmp_path):
    """hack/smoke.py's `_drive_compute` in the port: 8 steps through
    `fit` (data pipeline, checkpoints), then greedy generation from the
    trained master-weight model, which the paged engine reproduces
    beside a sampled co-tenant."""
    cfg = tlm.LMConfig(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=2,
                       max_seq_len=16)
    corpus = np.random.default_rng(0).integers(0, cfg.vocab_size, 4096, dtype=np.int32)
    batches = tdata.prefetch_to_device(
        tdata.token_batches(corpus, batch_size=8, seq_len=cfg.max_seq_len), device="cpu"
    )
    state = tlm.init_lm_state(cfg, device="cpu")
    result = fit(state, tlm.make_lm_train_step(cfg, device="cpu"), batches,
                 num_steps=8, log_every=0, checkpoint_dir=str(tmp_path),
                 checkpoint_every=4)
    assert result.steps_run == 8 and sorted(p.name for p in tmp_path.iterdir()) == ["4", "8"]
    trained = result.state.params
    out = make_generate_fn(cfg, device="cpu")(trained, [[1, 2, 3, 4]], max_new_tokens=4)
    assert out.shape == (1, 4)
    engine = ContinuousBatcher(cfg, trained, slots=2, cache_len=16, chunk_steps=2,
                               device="cpu")
    # The engine runs a compute-dtype copy; the masters stay f32.
    assert engine.model is not trained
    assert engine.model.blocks[0].attn.qkv.kernel.dtype == torch.bfloat16
    assert trained.blocks[0].attn.qkv.kernel.dtype == torch.float32
    greedy = engine.submit([1, 2, 3, 4], max_new_tokens=4)
    sampled = engine.submit([2, 3], max_new_tokens=4, temperature=0.8, seed=7)
    results = engine.run()
    assert results[greedy] == out[0].tolist()
    assert len(results[sampled]) == 4


def test_builds_share_draws_and_serving_storage_is_unchanged():
    """The training build draws the serving build's values in f32; the
    serving build keeps compute-dtype projections and embedding that do
    not train; `from_params` casts a master build once."""
    cfg = tlm.LMConfig(**dict(FAMILIES["llama"], dtype="bfloat16"))
    serving = tlm.DecoderLM(cfg, device="cpu", seed=4)
    master = tlm.DecoderLM(cfg, device="cpu", seed=4, param_dtype=torch.float32)
    assert not any(p.requires_grad for p in serving.parameters())
    assert all(p.requires_grad and p.dtype == torch.float32 for p in master.parameters())
    for (name, s), m in zip(serving.named_parameters(), master.parameters()):
        want = torch.float32 if name.startswith(("head", "norm")) or ".norm" in name else torch.bfloat16
        assert s.dtype == want, name
        assert torch.equal(s, m.to(s.dtype)), name
    paged = dataclasses.replace(cfg, ragged_decode=True, paged_decode=True, paged_blocks=4,
                                remat=True)
    copy = tlm.DecoderLM.from_params(paged, master)
    assert copy.param_dtype is None and copy.cfg == paged
    for (name, c), s in zip(copy.named_parameters(), serving.parameters()):
        assert c.dtype == s.dtype and torch.equal(c, s), name
    assert tlm.DecoderLM.from_params(paged, serving) is serving
    with pytest.raises(ValueError, match="another config"):
        tlm.DecoderLM.from_params(dataclasses.replace(paged, num_layers=1), master)
    with pytest.raises(ValueError, match="serving format"):
        tlm.DecoderLM(dataclasses.replace(cfg, w_dtype="int8"), device="cpu",
                      param_dtype=torch.float32)


def test_training_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    cfg = tlm.LMConfig(**FAMILIES["llama"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_lm_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.make_lm_train_step(cfg)
    state = tlm.init_lm_state(cfg, device="cpu")
    assert state.params.device == torch.device("cpu")
    with pytest.raises(ValueError, match="another config"):
        tlm.make_lm_train_step(dataclasses.replace(cfg, remat=True), device="cpu")(
            state, _tokens())

