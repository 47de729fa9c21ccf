"""Weight bridge: the JAX package's flax param tree -> the port's modules.

The input is the flax `params` tree of `walkai_nos_tpu.models.lm.
DecoderLM` or of `walkai_nos_tpu.models.vit.ViTDetector`, as nested dicts
of numpy arrays (`jax.device_get(params)` gives one; the port itself
never imports jax). Names map one to one: `blockN/...` becomes
`blocks.N....`, every other scope keeps its flax name, and each leaf keeps
its flax name (`kernel`, `bias`, `scale`, `embedding`, `pos_embed`, an
MoE block's `moe/router/{kernel,bias}`, `moe/experts_up` and
`moe/experts_down`, and the ViT's `patch_embed`, `det_tokens`, `norm`,
`class_head`, `box_head`).

Layout: the port KEEPS flax's Dense layout, kernel [in, out] — the
layout the fused QKV kernel reads and `x @ kernel` computes with — so
no leaf is transposed; the ViT's patch kernel keeps flax's `[p, p, 3,
hidden]` Conv layout. Each leaf is cast to the dtype the port's module
holds it in (the LM's serving build: Dense kernels and biases, the
embedding and the experts in the compute dtype, as flax casts them at
every call, norms, `pos_embed`, the router and the LM head in f32; the
LM's training build and the ViT: every leaf an f32 master, as in JAX
training, so f32 leaves stay f32). A quantized LM
tree (`models/lm.quantize_lm_params`) keeps its int8 kernels int8 and its
`scale` rows f32: an int8 parameter takes only an int8 leaf, never a
float one cast down.

`flax_params_from_model` goes the other way: a module's parameters as
that tree (`unflatten_flax_params` inverts the flattening), which the
HuggingFace exports of `models/hf.py` take. `served_tree` is the same
tree over the module's own tensors, in the dtypes and on the device the
module holds them: what the capture plane's weights digest reads.
"""

from __future__ import annotations

import numpy as np
import torch

from torch import nn

__all__ = [
    "flatten_flax_params",
    "flax_params_from_model",
    "load_flax_params",
    "served_tree",
    "unflatten_flax_params",
]


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


def unflatten_flax_params(flat) -> dict:
    """The inverse of `flatten_flax_params`: {'blocks.0.attn.qkv.kernel':
    a} -> {'block0': {'attn': {'qkv': {'kernel': a}}}}."""
    tree: dict = {}
    for key, leaf in flat.items():
        parts = key.split(".")
        if parts[0] == "blocks":
            parts = [f"block{parts[1]}", *parts[2:]]
        node = tree
        for name in parts[:-1]:
            node = node.setdefault(name, {})
        node[parts[-1]] = leaf
    return tree


def flax_params_from_model(model: nn.Module) -> dict:
    """A module's parameters as the flax tree `load_flax_params` takes
    (nested numpy arrays on the host): float leaves widened to f32, int8
    leaves kept int8."""
    flat = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        flat[name] = (t if t.dtype == torch.int8 else t.float()).numpy()
    return unflatten_flax_params(flat)


def served_tree(model: nn.Module) -> dict:
    """A module's parameters under the flax tree's names, as the module
    holds them (no copy, no cast)."""
    return unflatten_flax_params(
        {name: p.detach() for name, p in model.named_parameters()}
    )


@torch.no_grad()
def load_flax_params(model: nn.Module, params) -> nn.Module:
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
        leaf = np.asarray(flat[name])
        if p.dtype == torch.int8:
            if leaf.dtype != np.int8:
                raise ValueError(
                    f"{name}: an int8 parameter needs an int8 leaf (a "
                    f"quantized tree); got {leaf.dtype}"
                )
            src = torch.from_numpy(leaf.copy())
        else:
            src = torch.from_numpy(np.array(leaf, np.float32))
        if src.shape != p.shape:
            raise ValueError(
                f"{name}: flax shape {tuple(src.shape)} != {tuple(p.shape)}"
            )
        p.copy_(src.to(p.dtype))
    return model
