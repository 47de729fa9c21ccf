"""Weight bridge: the JAX package's flax param tree -> the port's modules.

The input is the flax `params` tree of `walkai_nos_tpu.models.lm.
DecoderLM` as nested dicts of numpy arrays (`jax.device_get(params)`
gives one; the port itself never imports jax). Names map one to one:
`blockN/...` becomes `blocks.N....`, every other scope keeps its flax
name, and each leaf keeps its flax name (`kernel`, `bias`, `scale`,
`embedding`, `pos_embed`).

Layout: the port KEEPS flax's Dense layout, kernel [in, out] — the
layout the fused QKV kernel reads and `x @ kernel` computes with — so
no leaf is transposed. Each leaf is cast to the dtype the port's module
holds it in (Dense kernels and biases in the compute dtype, as flax
casts them at every call; norms, `pos_embed` and the LM head in f32).
"""

from __future__ import annotations

import numpy as np
import torch

from walkai_nos_tpu_torch.models.lm import DecoderLM

__all__ = ["flatten_flax_params", "load_flax_params"]


def flatten_flax_params(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{'block0': {'attn': {'qkv': {'kernel': a}}}} ->
    {'blocks.0.attn.qkv.kernel': a}."""
    out: dict[str, np.ndarray] = {}
    for name, sub in tree.items():
        if name.startswith("block") and name[5:].isdigit():
            name = f"blocks.{name[5:]}"
        key = f"{prefix}{name}"
        if hasattr(sub, "items"):
            out.update(flatten_flax_params(sub, key + "."))
        else:
            out[key] = np.asarray(sub)
    return out


@torch.no_grad()
def load_flax_params(model: DecoderLM, params) -> DecoderLM:
    """Copy a flax param tree into `model` in place (every parameter
    must be covered, and nothing extra may be left over). Returns the
    model."""
    flat = flatten_flax_params(params)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise ValueError(
            f"param trees differ: missing {missing[:5]}, extra {extra[:5]}"
        )
    for name, p in own.items():
        src = torch.from_numpy(np.array(flat[name], np.float32))
        if src.shape != p.shape:
            raise ValueError(
                f"{name}: flax shape {tuple(src.shape)} != {tuple(p.shape)}"
            )
        p.copy_(src.to(p.dtype))
    return model
