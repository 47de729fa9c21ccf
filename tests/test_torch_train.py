"""The port's training modules against the JAX package's.

- `detection_loss` equals the JAX loss on the same outputs (1e-6 rel);
- three `make_train_step` steps from the same bridged params and batch
  agree with the JAX step on a one-device CPU mesh, in losses (1e-4
  relative) and in parameters (1e-4 of each tensor's max |value| + 1e-6:
  f32 on both sides, but Adam's normalised update turns a last-digit
  difference in a near-zero gradient into a difference of up to the
  learning rate in that one element);
- `make_optimizer` (clipping, warmup, cosine decay) gives optax's
  parameter trajectory on the same gradients (1e-5 relative: the same
  arithmetic in another order);
- `fit` with a checkpoint directory resumes at the saved step and
  replays the losses of an uninterrupted run;
- `token_batches` and `prefetch_to_device` keep the JAX pipeline's
  order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from walkai_nos_tpu.models import data as jdata
from walkai_nos_tpu.models import train as jtrain
from walkai_nos_tpu.models import vit as jvit
from walkai_nos_tpu.parallel.mesh import build_mesh
from walkai_nos_tpu_torch.models import data as tdata
from walkai_nos_tpu_torch.models import train as ttrain
from walkai_nos_tpu_torch.models.checkpoint import CheckpointManager
from walkai_nos_tpu_torch.models.convert import load_flax_params
from walkai_nos_tpu_torch.models.trainer import evaluate, fit
from walkai_nos_tpu_torch.models.vit import ViTConfig

torch.set_num_threads(1)

TINY_F32 = dataclasses.replace(jvit.VIT_TINY, dtype="float32")
T_TINY_F32 = ViTConfig(**dataclasses.asdict(TINY_F32))


def _batch(cfg, b=4, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.num_classes, (b, cfg.num_det_tokens)).astype(np.int32)
    labels[:, ::3] = cfg.num_classes - 1  # some no-object slots
    return {
        "images": rng.standard_normal((b, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
        "labels": labels,
        "boxes": rng.random((b, cfg.num_det_tokens, 4)).astype(np.float32),
    }


def test_detection_loss_matches_jax():
    rng = np.random.default_rng(1)
    batch = _batch(TINY_F32, seed=2)
    out = {
        "logits": rng.standard_normal((4, 8, 10)).astype(np.float32),
        "boxes": rng.random((4, 8, 4)).astype(np.float32),
    }
    want = float(jtrain.detection_loss(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, num_classes=10,
    ))
    got = float(ttrain.detection_loss(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()}, num_classes=10,
    ))
    assert got == pytest.approx(want, rel=1e-6)


def test_three_train_steps_match_jax():
    mesh = build_mesh(jax.devices()[:1])
    state = jtrain.init_train_state(TINY_F32, mesh, jax.random.PRNGKey(0))
    params0 = jax.device_get(state.params)
    batch = _batch(TINY_F32)
    jstep = jtrain.make_train_step(TINY_F32, mesh)
    jlosses = []
    for _ in range(3):
        # The JAX step donates its state: hand it fresh copies of the batch.
        state, loss = jstep(state, {k: jnp.array(v, copy=True) for k, v in batch.items()})
        jlosses.append(float(loss))
    jparams = jax.device_get(state.params)

    tstate = ttrain.init_train_state(T_TINY_F32, device="cpu")
    load_flax_params(tstate.params, params0)
    tstep = ttrain.make_train_step(T_TINY_F32, device="cpu")
    tlosses = []
    for _ in range(3):
        tstate, loss = tstep(tstate, batch)
        tlosses.append(float(loss))
    assert tstate.step == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    flat = {}
    for name, sub in jparams.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(sub)[0]:
            flat[".".join([name.replace("block", "blocks.") if name[5:].isdigit() else name]
                          + [p.key for p in path])] = np.asarray(leaf)
    own = dict(tstate.params.named_parameters())
    assert set(own) == set(flat)
    d = TINY_F32.hidden_dim
    for name, p in own.items():
        got, want = p.detach().numpy(), flat[name]
        if name.endswith("attn.qkv.bias"):
            # The key bias adds q . b_k to every score of a row, which the
            # softmax cancels: its exact gradient is 0, so both sides hold
            # rounding noise that Adam scales to +-lr steps. Compare the
            # query and value thirds.
            keep = np.r_[0:d, 2 * d:3 * d]
            got, want = got[keep], want[keep]
        err = np.max(np.abs(got - want))
        assert err <= 1e-4 * np.max(np.abs(want)) + 1e-6, (name, err)


@pytest.mark.parametrize(
    "knobs",
    [
        dict(clip_norm=1.0, warmup_steps=2, decay_steps=3),
        dict(warmup_steps=3),
        dict(decay_steps=4),
        dict(),
    ],
    ids=["clip_warmup_decay", "warmup_hold", "decay", "constant"],
)
def test_optimizer_matches_optax(knobs):
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    # Gradient scales around the clip norm, so some steps clip.
    grads = [{k: (s * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (0.1, 2.0, 0.3, 5.0, 0.05, 1.0, 0.2)]
    tx = jtrain.make_optimizer(1e-2, weight_decay=0.1, **knobs)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    update = jax.jit(tx.update)

    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    )
    ttx = ttrain.make_optimizer(1e-2, weight_decay=0.1, **knobs)
    topt = ttx.init(module)
    for count, g in enumerate(grads):
        updates, opt_state = update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        ttx.apply(topt, count)
        for k, p in module.items():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7,
                err_msg=f"{k} after update {count}",
            )


def _fit_batches(n, seed=5):
    return [_batch(TINY_F32, b=2, seed=seed + i) for i in range(n)]


def test_fit_resumes_from_checkpoint_and_replays_losses(tmp_path):
    step = ttrain.make_train_step(T_TINY_F32, device="cpu")
    batches = _fit_batches(6)
    straight = fit(ttrain.init_train_state(T_TINY_F32, device="cpu"), step,
                   iter(batches), num_steps=6, log_every=1)
    assert straight.steps_run == 6 and len(straight.losses) == 6

    ckpt = str(tmp_path / "ckpt")
    first = fit(ttrain.init_train_state(T_TINY_F32, device="cpu"), step,
                iter(batches[:3]), num_steps=3, log_every=1,
                checkpoint_dir=ckpt, checkpoint_every=2)
    assert first.resumed_from is None and first.state.step == 3
    # A template from another seed: everything must come from the file.
    template = ttrain.init_train_state(T_TINY_F32, device="cpu", seed=1)
    second = fit(template, step, iter(batches[3:]), num_steps=3, log_every=1,
                 checkpoint_dir=ckpt, checkpoint_every=2)
    assert second.resumed_from == 3 and second.state.step == 6
    np.testing.assert_allclose(second.losses, straight.losses[3:], rtol=1e-6)
    manager = CheckpointManager(ckpt)
    assert manager.latest_step() == 6
    assert sorted(int(p.name) for p in (tmp_path / "ckpt").iterdir()) == [3, 5, 6]
    manager.close()

    loss_fn = lambda model, b: ttrain.detection_loss(  # noqa: E731
        model(torch.from_numpy(b["images"])),
        {k: torch.from_numpy(v) for k, v in b.items()}, num_classes=10,
    )
    assert evaluate(second.state, loss_fn, iter(batches), max_batches=2) > 0


def test_checkpoint_keeps_max_and_refuses_a_saved_step(tmp_path):
    state = ttrain.init_train_state(T_TINY_F32, device="cpu")
    manager = CheckpointManager(tmp_path, max_to_keep=2)
    for s in (1, 2, 3):
        state.step = s
        assert manager.save(state)
    assert not manager.save(state)  # step 3 is on disk already
    assert manager.save(state, force=True, wait=True)
    assert manager.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2", "3"]
    manager.close()


def test_fit_profile_window_writes_a_trace(tmp_path):
    step = ttrain.make_train_step(T_TINY_F32, device="cpu")
    fit(ttrain.init_train_state(T_TINY_F32, device="cpu"), step,
        iter(_fit_batches(3)), num_steps=3, log_every=0,
        profile_dir=str(tmp_path), profile_steps=(1, 2))
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_data_pipeline_matches_jax():
    tokens = np.arange(1000, dtype=np.int32)
    kw = dict(batch_size=4, seq_len=16, seed=7, epochs=2)
    want = list(jdata.token_batches(tokens, **kw))
    got = list(tdata.token_batches(tokens, **kw))
    assert len(got) == len(want) == 30
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    moved = list(tdata.prefetch_to_device(iter(got), device="cpu", size=3))
    for a, b in zip(moved, want):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), b)
    dicts = list(tdata.prefetch_to_device(iter([_batch(TINY_F32, b=1)]), device="cpu"))
    assert set(dicts[0]) == {"images", "labels", "boxes"}
    with pytest.raises(ValueError, match="prefetch size"):
        tdata.prefetch_to_device(iter(got), device="cpu", size=0)
