"""YOLOS-style detection Vision Transformer, in PyTorch.

Port of `walkai_nos_tpu/models/vit.py`: a plain ViT encoder with learnable
detection tokens appended to the patch sequence and heads predicting
class logits and boxes per detection token (YOLOS, Fang et al. 2021).

Numerics follow flax's modules as the JAX model uses them:

- parameters are f32 masters (trainable); every call casts them to the
  compute dtype (`cfg.dtype`) as flax casts at each call. A model whose
  parameters were cast to bf16 once (`cast_serving_weights`, the demo's
  serving policy) runs the same code with no per-call weight cast;
- Dense layers keep flax's `[in, out]` kernel layout: `x @ kernel + bias`
  in the compute dtype, bias added after the product;
- LayerNorm takes its statistics in f32 (E[x^2] - E[x]^2, epsilon 1e-6,
  flax's defaults), applies scale and bias in f32 and writes the compute
  dtype;
- gelu is the tanh approximation (flax's `nn.gelu` default);
- the patch embedding is flax's NHWC `nn.Conv` with a `[p, p, 3, hidden]`
  kernel and stride p, done as patchify + matmul with the kernel read in
  `(kh, kw, cin)` order (no layout transpose, no cuDNN convolution);
- the heads run in f32 on the final tokens; boxes go through a sigmoid.

Attention is `ops/attention.flash_attention_packed` straight off the
fused qkv projection: K3 on a CUDA tensor, and in training its backward
(K4 recompute, K5, K6). `remat=True` recomputes each block in the
backward (`torch.utils.checkpoint`), the JAX `nn.remat` knob.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from walkai_nos_tpu_torch.device import resolve_device
from walkai_nos_tpu_torch.ops.attention import flash_attention_packed

__all__ = [
    "VIT_SMALL",
    "VIT_TINY",
    "Attention",
    "Block",
    "Dense",
    "LayerNorm",
    "Mlp",
    "ViTConfig",
    "ViTDetector",
    "cast_serving_weights",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# flax's lecun_normal draws from a normal truncated at 2 std, rescaled by
# this factor so the truncated draw keeps variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class ViTConfig:
    """Field for field the JAX `ViTConfig`."""

    image_size: int = 224
    patch_size: int = 16
    hidden_dim: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    num_det_tokens: int = 100
    num_classes: int = 92  # COCO classes + no-object, as YOLOS
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


VIT_TINY = ViTConfig(
    image_size=64, patch_size=16, hidden_dim=128, num_layers=2,
    num_heads=4, num_det_tokens=8, num_classes=10,
)
VIT_SMALL = ViTConfig()  # YOLOS-small scale: 384 dim, 12 layers, 6 heads


def _lecun(shape, fan_in: int, gen, device) -> nn.Parameter:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)
    return nn.Parameter(t)


class Dense(nn.Module):
    """flax `nn.Dense`: kernel [in, out] (lecun normal), bias [out]
    (zeros), computed in `dtype`."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, gen, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = _lecun((d_in, d_out), d_in, gen, device)
        self.bias = nn.Parameter(
            torch.zeros(d_out, dtype=torch.float32, device=device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=...)`: f32 statistics, epsilon 1e-6,
    scale and bias applied in f32, output in `dtype`."""

    def __init__(self, dim: int, dtype: torch.dtype, device, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, gen, device):
        super().__init__()
        dt, d = cfg.compute_dtype, cfg.hidden_dim
        self.num_heads = cfg.num_heads
        self.qkv = Dense(d, 3 * d, dt, gen, device)
        self.out_proj = Dense(d, d, dt, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(flash_attention_packed(self.qkv(x), self.num_heads))


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, gen, device):
        super().__init__()
        dt, d = cfg.compute_dtype, cfg.hidden_dim
        self.fc1 = Dense(d, cfg.mlp_ratio * d, dt, gen, device)
        self.fc2 = Dense(cfg.mlp_ratio * d, d, dt, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, gen, device):
        super().__init__()
        dt, d = cfg.compute_dtype, cfg.hidden_dim
        self.norm1 = LayerNorm(d, dt, device)
        self.attn = Attention(cfg, gen, device)
        self.norm2 = LayerNorm(d, dt, device)
        self.mlp = Mlp(cfg, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    """flax `nn.Conv(hidden, (p, p), strides=(p, p))` on NHWC images:
    kernel [p, p, 3, hidden], bias [hidden]. 'SAME' padding pads nothing
    when p divides the image size, the only case taken here."""

    def __init__(self, cfg: ViTConfig, gen, device):
        super().__init__()
        p, d = cfg.patch_size, cfg.hidden_dim
        self.patch, self.dtype = p, cfg.compute_dtype
        self.kernel = _lecun((p, p, 3, d), p * p * 3, gen, device)
        self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, hgt, wid, c = images.shape
        p = self.patch
        if hgt % p or wid % p or c != 3:
            raise ValueError(
                f"images {tuple(images.shape)}: expected [b, H, W, 3] with "
                f"H and W multiples of the patch size {p}"
            )
        x = images.to(self.dtype).reshape(b, hgt // p, p, wid // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, p * p * c)
        w = self.kernel.to(self.dtype).reshape(p * p * c, -1)
        return x @ w + self.bias.to(self.dtype)


class ViTDetector(nn.Module):
    """ViT encoder + detection tokens + class/box heads (YOLOS shape).

    `ViTDetector(cfg)` builds random parameters from `seed` (flax's
    initializers: lecun normal kernels, zero biases, unit norm scales,
    normal(0.02) tokens and positions) on `device` (`cuda` unless the
    caller passes `device="cpu"`); `models/convert.load_flax_params`
    loads a flax tree instead. Parameter names are flax's, with `blockN`
    as `blocks.N`."""

    def __init__(self, cfg: ViTConfig, *, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if cfg.image_size % cfg.patch_size:
            raise ValueError("patch_size must divide image_size")
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        d, dt = cfg.hidden_dim, cfg.compute_dtype
        self.patch_embed = _PatchEmbed(cfg, gen, dev)
        self.det_tokens = nn.Parameter(
            0.02 * torch.randn(1, cfg.num_det_tokens, d, generator=gen, device=dev)
        )
        self.pos_embed = nn.Parameter(0.02 * torch.randn(
            1, cfg.num_patches + cfg.num_det_tokens, d, generator=gen, device=dev,
        ))
        self.blocks = nn.ModuleList(
            Block(cfg, gen, dev) for _ in range(cfg.num_layers)
        )
        self.norm = LayerNorm(d, dt, dev)
        self.class_head = Dense(d, cfg.num_classes, torch.float32, gen, dev)
        self.box_head = Dense(d, 4, torch.float32, gen, dev)

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """images: [batch, H, W, 3] -> {"logits": [batch, num_det_tokens,
        num_classes] f32, "boxes": [batch, num_det_tokens, 4] f32 in
        normalized cxcywh}."""
        c = self.cfg
        x = self.patch_embed(images)
        det = self.det_tokens.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([x, det], dim=1) + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            if c.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        tokens = self.norm(x)[:, -c.num_det_tokens:, :]
        return {
            "logits": self.class_head(tokens),
            "boxes": torch.sigmoid(self.box_head(tokens)),
        }


@torch.no_grad()
def cast_serving_weights(model: ViTDetector) -> ViTDetector:
    """The demo's serving precision policy (`main.py`, weights cast to
    bf16 ONCE at load): a copy of `model` with every parameter in bf16,
    for inference. The training masters are left as they are."""
    import copy

    served = copy.deepcopy(model).to(torch.bfloat16)
    served.requires_grad_(False)
    return served
