"""The port's ViT detector against the JAX package's, on the same weights.

The JAX model's flax params (`ViTDetector(VIT_TINY).init_params`, plus
noise on every leaf so zero biases and unit norm scales are exercised)
go through the port's weight bridge (`models/convert.py`); both models
then run the same numpy images. Off the TPU the JAX model takes its plain
attention (`_packed_reference`), the path its own tests use; the port
takes the plain versions its kernels' wrappers use for CPU tensors.
- f32: logits and boxes within 1e-4 * max |ref| (summation order only);
- bf16: within 2e-2 * max |ref| + 4e-3 (the two frameworks round to bf16
  at other points: a few bf16 ulps).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import vit as jvit
from walkai_nos_tpu_torch.models import vit as tvit
from walkai_nos_tpu_torch.models.convert import load_flax_params

torch.set_num_threads(1)

TINY_F32 = dataclasses.replace(jvit.VIT_TINY, dtype="float32")


def _jax_params(cfg, seed=0):
    params = jvit.ViTDetector(cfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(np.float32),
        jax.device_get(params),
    )


def _port(cfg, params, **changes):
    tcfg = tvit.ViTConfig(**{**dataclasses.asdict(cfg), **changes})
    return load_flax_params(tvit.ViTDetector(tcfg, device="cpu"), params)


def _images(cfg, b=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def _both(cfg, seed=0):
    params = _jax_params(cfg, seed)
    images = _images(cfg)
    # Traced once (jit), not dispatched op by op: a few compiles, not
    # hundreds.
    want = jax.jit(jvit.ViTDetector(cfg).apply)({"params": params}, images)
    with torch.no_grad():
        got = _port(cfg, params)(torch.from_numpy(images))
    return got, want


def test_config_is_field_for_field():
    assert dataclasses.asdict(tvit.VIT_SMALL) == dataclasses.asdict(jvit.VIT_SMALL)
    assert dataclasses.asdict(tvit.VIT_TINY) == dataclasses.asdict(jvit.VIT_TINY)
    assert tvit.VIT_SMALL.num_patches + tvit.VIT_SMALL.num_det_tokens == 296


@pytest.mark.parametrize(
    "cfg,rel,floor",
    [(TINY_F32, 1e-4, 0.0), (jvit.VIT_TINY, 2e-2, 4e-3)],
    ids=["f32", "bf16"],
)
def test_forward_matches_jax(cfg, rel, floor):
    got, want = _both(cfg)
    for key in ("logits", "boxes"):
        w = np.asarray(want[key], np.float32)
        g = got[key].float().numpy()
        assert g.shape == w.shape and got[key].dtype == torch.float32
        err = float(np.max(np.abs(g - w)))
        assert err <= rel * float(np.max(np.abs(w))) + floor, (key, err)


def test_bridge_covers_every_leaf_and_refuses_a_mismatch():
    params = _jax_params(jvit.VIT_TINY)
    model = _port(jvit.VIT_TINY, params)
    assert len(list(model.parameters())) == len(jax.tree.leaves(params))
    assert model.patch_embed.kernel.shape == (16, 16, 3, 128)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    params["block1"]["attn"].pop("out_proj")
    with pytest.raises(ValueError, match="missing"):
        _port(jvit.VIT_TINY, params)


def test_remat_gives_the_same_gradients():
    params = _jax_params(TINY_F32)
    images = torch.from_numpy(_images(TINY_F32))
    grads = []
    for remat in (False, True):
        model = _port(TINY_F32, params, remat=remat)
        out = model(images)
        (out["logits"].square().sum() + out["boxes"].sum()).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, msg=name)


def test_serving_cast_keeps_masters_and_stays_close():
    params = _jax_params(jvit.VIT_TINY)
    model = _port(jvit.VIT_TINY, params)
    served = tvit.cast_serving_weights(model)
    assert all(p.dtype == torch.bfloat16 for p in served.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    images = torch.from_numpy(_images(jvit.VIT_TINY))
    with torch.no_grad():
        a, b = model(images), served(images)
    for key in ("logits", "boxes"):
        w = a[key].float()
        assert float((b[key].float() - w).abs().max()) <= 2e-2 * float(w.abs().max()) + 4e-3
