"""Decoder-only language model: the full causal forward and its
training step, and the decode paths of the serving engine and of one-shot
generation, in PyTorch.

Port of `walkai_nos_tpu/models/lm.py`. `LMConfig` keeps every field,
default and validation of the JAX config, so configurations, capture
fingerprints and replay keys carry over; the knobs the port does not run
yet (tensor parallelism, ring/ulysses attention) raise
NotImplementedError at construction. Experts (`num_experts > 0`,
`models/moe.py`) run in every forward, routed as JAX routes them: over
the tokens of one call, with a capacity from that call's token count, so
under drops a row's output depends on the rest of the call (the paged
engine's prefill lane names the rows JAX would route: `moe_rows`).

`DecoderLM(tokens)` with no cache is the JAX `model.apply(params,
tokens)`: rotary (or learned positions) at 0 .. seq-1, K/V repeated to
every query head, and `ops/attention.flash_attention(q, k, v,
causal=True)` per layer (K4 forward, K5 + K6 backward on the card), each
block under `torch.utils.checkpoint` when `cfg.remat` is set. Training
uses the f32-master build (`param_dtype=torch.float32`, flax's
`param_dtype`): every parameter is an f32 tensor that trains and is cast
to the compute dtype at every call. The default (serving) build stores
the projections and embedding in the compute dtype and trains nothing;
`DecoderLM.from_params` turns a trained master build into one.
`lm_loss`, `init_lm_state` and `make_lm_train_step` are the JAX
functions on one device, through `models/train.py`.

The decode forward runs over one of two KV caches:

- a PAGED cache (`PagedCache`, the paged serving engine): each layer
  holds a shared pool of 128-row K/V blocks ([paged_blocks + 1,
  kv_heads, PAGE_ROWS, head_dim]: the extra last block takes the writes
  `scatter_paged_rows` drops, and no table names it); a per-slot block
  table maps logical cache block j of slot b to a pool block. The per-slot cache index is an argument,
  not cache state: the caller advances it by the step count after each
  forward;
- a DENSE cache (`DenseCache`: one-shot generation, speculative decoding
  and the dense serving engine): per layer K/V of [batch, kv_heads,
  cache_len, head_dim], and one index, 0-d or [batch] (ragged). It is the
  JAX cache collection (`cached_key`, `cached_value`, `cache_index`,
  `pos_index`); the forward advances its index by the step count, even
  past cache_len, on the device.

Both are written IN PLACE (the JAX model returns a new cache from a
donated buffer).

Quantized storage, as in JAX: `kv_dtype="int8"` makes the paged pools
int8 with parallel per-row f32 scale pools (rows quantize at the one
emit, `scatter_paged_rows`; the dense cache refuses it), and
`w_dtype="int8"` makes the five decode-path projections (`qkv`,
`out_proj`, `gate`, `fc1`, `fc2`) `QuantDense` layers holding int8
kernels with per-output-channel f32 scales (`quantize_lm_params` turns a
full-precision flax tree into one). "int8-sim" runs the same code with
full-precision storage and unit scales, bit for bit the unquantized
model. Attention routes exactly as `CausalAttention.__call__`
does in JAX:

- paged, a short step (<= MAX_KERNEL_STEPS positions) on a CUDA tensor
  with `fused_qkv=True` and no adapters takes the fused QKV + rotary +
  paged attention kernels (`ops/decode_attention.fused_qkv_paged_attention`),
  then scatters the fresh rows;
- paged otherwise, the unfused composition: projection, rotary, scatter,
  then the paged attention kernel for short steps (plain version on the
  CPU) or, for wide prefill chunks, a gather of the slot's blocks and
  plain masked attention (`_masked_cache_attention`);
- dense: projection, rotary, the cache write with XLA's
  `dynamic_update_slice` clamping, then the streamed dense kernel
  (`ops/decode_attention.decode_attention`) for a short step of a GQA
  model or with `decode_kernel`, else `_masked_cache_attention`.

Multi-LoRA (`models/lora.py`): a cache forward given `adapters=(tree,
ids)` (the engine's stacked per-block A/B tensors and per-row adapter
ids) adds `lora_delta`, cast to the projection output's dtype, onto
`qkv` and `out_proj` in every block and onto `gate`/`fc1`/`fc2` in a
non-MoE block (an MoE block's MLP takes none), as JAX's `_apply_lora`
does. An armed paged forward leaves the fused route (the deltas add
onto the projection's output, which the fused kernel never writes out)
and takes the unfused composition, K1 without injection for short
steps.

Parameter layout follows flax (see `models/convert.py`): Dense kernels
are stored [in, out], the layout the fused QKV kernel reads.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from walkai_nos_tpu_torch.device import resolve_device
from walkai_nos_tpu_torch.models.convert import load_flax_params
from walkai_nos_tpu_torch.models.data import to_device
from walkai_nos_tpu_torch.models.lora import lora_delta
from walkai_nos_tpu_torch.models.moe import MoEMlp, aux_loss_from_intermediates
from walkai_nos_tpu_torch.models.train import TrainState, make_optimizer
from walkai_nos_tpu_torch.ops.attention import flash_attention
from walkai_nos_tpu_torch.ops.decode_attention import (
    MAX_KERNEL_STEPS,
    PAGE_ROWS,
    decode_attention,
    dequantize_gathered,
    fused_qkv_paged_attention,
    gather_paged_cache,
    paged_decode_attention,
    rope_tables,
    rotate,
    scatter_paged_rows,
    split_qkv,
)

__all__ = [
    "DecoderLM",
    "DenseCache",
    "LMConfig",
    "LM_SMALL",
    "LM_TINY",
    "PagedCache",
    "QuantDense",
    "apply_rope",
    "draft_config",
    "init_lm_state",
    "lm_loss",
    "make_lm_train_step",
    "quantize_kernel",
    "quantize_lm_params",
]

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclass(frozen=True)
class LMConfig:
    """Field for field the JAX `LMConfig` (see its comments for what
    each knob means)."""

    vocab_size: int = 32000
    hidden_dim: int = 512
    num_layers: int = 8
    num_heads: int = 8
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    dtype: str = "bfloat16"
    num_kv_heads: int | None = None
    norm: str = "layernorm"
    mlp: str = "gelu"
    mlp_dim: int | None = None
    rope: bool = False
    rope_theta: float = 10000.0
    use_bias: bool = True
    use_ring_attention: bool = False
    use_ulysses_attention: bool = False
    num_experts: int = 0
    moe_every: int = 2
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    layer_norm_eps: float = 1e-6
    head_bias: bool = True
    remat: bool = False
    cache_len: int | None = None
    decode_kernel: bool = False
    ragged_decode: bool = False
    paged_decode: bool = False
    paged_blocks: int = 0
    fused_qkv: bool = True
    kv_dtype: str = "model"
    w_dtype: str = "model"
    tp_devices: int = 1

    def __post_init__(self):
        for knob, value in (
            ("kv_dtype", self.kv_dtype), ("w_dtype", self.w_dtype)
        ):
            if value not in ("model", "int8", "int8-sim"):
                raise ValueError(
                    f"unknown {knob} {value!r}: expected one of "
                    f"'model', 'int8', 'int8-sim'"
                )
        if self.num_kv_heads is not None and (
            self.num_kv_heads < 1
            or self.num_heads % self.num_kv_heads != 0
        ):
            raise ValueError(
                f"num_kv_heads must divide num_heads="
                f"{self.num_heads}; got {self.num_kv_heads}"
            )
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.mlp not in ("gelu", "swiglu"):
            raise ValueError(f"unknown mlp {self.mlp!r}")
        if self.tp_devices < 1:
            raise ValueError(
                f"tp_devices must be >= 1; got {self.tp_devices}"
            )
        if self.tp_devices > 1:
            tp = self.tp_devices
            if self.num_heads % tp != 0:
                raise ValueError(
                    f"tp_devices={tp} must divide num_heads="
                    f"{self.num_heads}: attention heads shard over the "
                    f"model axis"
                )
            mlp_width = self.mlp_dim or self.mlp_ratio * self.hidden_dim
            if mlp_width % tp != 0:
                raise ValueError(
                    f"tp_devices={tp} must divide the MLP width "
                    f"{mlp_width}: gate/fc1 split their output "
                    f"channels over the model axis"
                )
            kvh = self.num_kv_heads or self.num_heads
            if kvh % tp != 0 and tp % kvh != 0:
                raise ValueError(
                    f"tp_devices={tp} must divide num_kv_heads={kvh} "
                    f"(kv-split) or be a multiple of it "
                    f"(head-replicated K/V); got neither"
                )
        if self.paged_decode:
            if not self.ragged_decode:
                raise ValueError(
                    "paged_decode requires ragged_decode (the block "
                    "table is per-slot, so the cache index must be too)"
                )
            if self.paged_blocks < 2:
                raise ValueError(
                    f"paged_decode needs paged_blocks >= 2 (block 0 is "
                    f"the reserved scratch block); got {self.paged_blocks}"
                )
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        # Knobs of the JAX model that later slices of the port add.
        for knob, on, item in (
            ("tp_devices > 1", self.tp_devices > 1, "parallelism"),
            ("use_ring_attention", self.use_ring_attention, "parallelism"),
            ("use_ulysses_attention", self.use_ulysses_attention,
             "parallelism"),
        ):
            if on:
                raise NotImplementedError(
                    f"{knob} is not ported yet (ROADMAP: {item})"
                )

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def mlp_width(self) -> int:
        return self.mlp_dim or self.mlp_ratio * self.hidden_dim

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def kv_quant(self) -> str | None:
        """The paged pools' quantization mode: None, "int8" or "sim"."""
        return {"int8": "int8", "int8-sim": "sim"}.get(self.kv_dtype)

    @property
    def w_quant(self) -> str | None:
        """The projections' quantization mode: None, "int8" or "sim"."""
        return {"int8": "int8", "int8-sim": "sim"}.get(self.w_dtype)

    @property
    def kv_storage_dtype(self) -> torch.dtype:
        """int8 for kv_dtype="int8", else the compute dtype ("int8-sim"
        stores full precision, so its round trip is exact)."""
        return torch.int8 if self.kv_dtype == "int8" else self.compute_dtype


LM_TINY = LMConfig(
    vocab_size=256, hidden_dim=128, num_layers=2, num_heads=4,
    max_seq_len=128,
)
LM_SMALL = LMConfig()


def draft_config(
    cfg: LMConfig,
    *,
    num_layers: int = 1,
    hidden_dim: int | None = None,
    num_heads: int | None = None,
) -> LMConfig:
    """A draft-model config for speculative decoding against `cfg` (the
    JAX `draft_config`): same vocabulary, context, positional scheme and
    norm/MLP family, but `num_layers` layers (1) at ~1/4 of the width and
    heads, MHA, no experts, no paged or ragged cache fields."""
    heads = num_heads or max(1, cfg.num_heads // 4)
    hidden = hidden_dim or max(32, cfg.hidden_dim // 4)
    # head_dim must divide evenly, and rope needs it even.
    quantum = 2 * heads
    hidden = -(-hidden // quantum) * quantum
    return dataclasses.replace(
        cfg,
        num_layers=num_layers,
        hidden_dim=hidden,
        num_heads=heads,
        num_kv_heads=None,
        mlp_dim=None,
        num_experts=0,
        remat=False,
        use_ring_attention=False,
        use_ulysses_attention=False,
        ragged_decode=False,
        paged_decode=False,
        paged_blocks=0,
        tp_devices=1,
    )


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float
) -> torch.Tensor:
    """Rotary position embedding, HF half-split convention. x: [batch,
    heads, seq, head_dim]; positions: [seq] or [batch, seq]. Angles in
    f32, result in x's dtype."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    if positions.dim() == 1:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    return rotate(x, cos, sin)


def _param(shape, dtype, device, gen, std=None, fill=None, train=False):
    if std is not None:
        t = torch.randn(shape, generator=gen, device=device) * std
    else:
        t = torch.full(shape, float(fill), device=device)
    return nn.Parameter(t.to(dtype), requires_grad=train)


class Dense(nn.Module):
    """flax `nn.Dense`: kernel [in, out] and bias; the input, kernel and
    bias are cast to `dtype` at every call and the bias added in `dtype`.
    `param_dtype=None` (the serving build) stores them in `dtype`, so the
    casts are no-ops and K2 reads the kernel as it lies; `torch.float32`
    (the training build) stores f32 masters that train."""

    def __init__(self, d_in, d_out, *, bias, dtype, device, gen,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        store, train = param_dtype or dtype, param_dtype is not None
        self.kernel = _param((d_in, d_out), store, device, gen, std=0.02,
                             train=train)
        self.bias = _param(
            (d_out,), store, device, gen, fill=0.0, train=train
        ) if bias else None

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def quantize_kernel(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX `quantize_lm_params`'s rule for one [in, out] kernel: per
    OUTPUT channel, scale = column amax / 127 in f32 (floored at 1e-12),
    values rounded half to even and clipped to +-127. Returns (int8
    kernel, f32 scale row)."""
    k32 = kernel.float()
    scale = torch.clamp(k32.abs().amax(dim=0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(k32 / scale), -127, 127).to(torch.int8)
    return q, scale


class QuantDense(nn.Module):
    """JAX `QuantDense`: `Dense`'s kernel and bias plus a `scale` row
    ([out] f32). int8: the kernel is stored int8; the product runs in
    f32 over the losslessly converted kernel, the scale multiplies the
    f32 result, one rounding to the compute dtype follows, then the bias
    is added in the compute dtype. sim: the kernel keeps the compute
    dtype and the op sequence is `Dense`'s followed by an f32 multiply by
    exactly 1.0, so the result is `Dense`'s bit for bit.

    On the GPU the int8 product is a library GEMM over an f32 copy of
    the kernel made per call (JAX leaves this product to XLA, not to a
    Pallas kernel); the weight stays int8 in memory. Random weights are
    `Dense`'s draws, quantized by `quantize_kernel`."""

    def __init__(self, d_in, d_out, *, bias, dtype, device, gen, sim):
        super().__init__()
        self.sim = sim
        self.dtype = dtype
        kernel = _param((d_in, d_out), dtype, device, gen, std=0.02)
        if sim:
            self.kernel = kernel
            self.scale = _param((d_out,), torch.float32, device, None, fill=1.0)
        else:
            q, scale = quantize_kernel(kernel.data)
            self.kernel = nn.Parameter(q, requires_grad=False)
            self.scale = nn.Parameter(scale, requires_grad=False)
        self.bias = (
            _param((d_out,), dtype, device, gen, fill=0.0) if bias else None
        )

    def forward(self, x):
        x = x.to(self.dtype)
        if self.sim:
            y = ((x @ self.kernel).float() * self.scale).to(self.dtype)
        else:
            y = ((x.float() @ self.kernel.float()) * self.scale).to(self.dtype)
        return y if self.bias is None else y + self.bias


# The projections `_dense` builds and `quantize_lm_params` transforms (the
# JAX names). Embedding, head and norms stay full precision.
_QUANT_DENSE_NAMES = ("qkv", "out_proj", "gate", "fc1", "fc2")


def _apply_lora(y, x, adapters, name: str):
    """JAX `_apply_lora`: add projection `name`'s batched LoRA delta on
    `x` (the projection's input) to its output `y`. `adapters` is (this
    block's stacked A/B tree, per-row adapter ids) or None; adapter 0's
    B slices are zero, so base rows add an exact zero."""
    if adapters is None:
        return y
    tree, ids = adapters
    proj = None if tree is None else tree.get(name)
    if proj is None:
        return y
    return y + lora_delta(x, proj, ids).to(y.dtype)


def _dense(cfg: LMConfig, d_in: int, d_out: int, *, device, gen,
           param_dtype=None):
    """The decode-path projection factory: `Dense` at w_dtype="model",
    `QuantDense` otherwise, so all five projections flip together (the
    training build, `param_dtype` set, takes w_dtype="model" only)."""
    kw = dict(bias=cfg.use_bias, dtype=cfg.compute_dtype, device=device,
              gen=gen)
    if cfg.w_quant:
        return QuantDense(d_in, d_out, sim=cfg.w_quant == "sim", **kw)
    return Dense(d_in, d_out, param_dtype=param_dtype, **kw)


def quantize_lm_params(params, cfg: LMConfig):
    """JAX `quantize_lm_params` on a flax tree of numpy arrays, bit for
    bit: "int8" turns each `_QUANT_DENSE_NAMES` kernel into int8 with a
    per-output-channel f32 `scale` row (`quantize_kernel`); "int8-sim"
    adds unit scales and keeps the kernels; "model" returns the tree
    untouched. Biases and every other leaf pass through. Idempotent: a
    scope that already has a `scale` is left alone. Returns a new tree;
    the caller's is not changed."""
    if not cfg.w_quant:
        return params
    sim = cfg.w_quant == "sim"

    def transform(scope):
        if "scale" in scope:
            return scope
        kernel = np.asarray(scope["kernel"])
        if sim:
            return {**scope, "scale": np.ones(kernel.shape[-1], np.float32)}
        q, scale = quantize_kernel(torch.from_numpy(kernel.astype(np.float32)))
        return {**scope, "kernel": q.numpy(), "scale": scale.numpy()}

    def walk(tree):
        out = {}
        for name, sub in tree.items():
            if (name in _QUANT_DENSE_NAMES and isinstance(sub, Mapping)
                    and "kernel" in sub):
                out[name] = transform(dict(sub))
            elif isinstance(sub, Mapping):
                out[name] = walk(sub)
            else:
                out[name] = sub
        return out

    return walk(params)


class Norm(nn.Module):
    """flax `LayerNorm` / `RMSNorm` with dtype=f32: f32 statistics
    (LayerNorm's variance as mean(x^2) - mean(x)^2), f32 output."""

    def __init__(self, cfg: LMConfig, device, train=False):
        super().__init__()
        d = cfg.hidden_dim
        self.rms = cfg.norm == "rmsnorm"
        self.eps = cfg.layer_norm_eps
        self.scale = _param((d,), torch.float32, device, None, fill=1.0,
                            train=train)
        self.bias = None if self.rms else _param(
            (d,), torch.float32, device, None, fill=0.0, train=train
        )

    def forward(self, x):
        x = x.float()
        if self.rms:
            var = torch.mean(x * x, dim=-1, keepdim=True)
            return x * (torch.rsqrt(var + self.eps) * self.scale)
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.clamp(
            torch.mean(x * x, dim=-1, keepdim=True) - mean * mean, min=0.0
        )
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def _masked_cache_attention(q, k_all, v_all, idx):
    """Dense masked attention over a full cache view: the decode tail of
    the dense cache and of the paged gather path. q: [batch, heads,
    steps, d]; k/v_all: [batch, kv_heads, cache_len, d]; idx: 0-d (every
    row at one position) or [batch] (ragged); position p is visible to
    query row r iff p <= idx + r. GQA computes per (slot, kv head) cell
    with f32 accumulation; MHA mirrors the JAX branch (f32 scores, PV in
    v's dtype)."""
    batch, heads, steps, hd = q.shape
    kvh, cache_len = k_all.shape[1], k_all.shape[2]
    q_pos = idx.long()[..., None] + torch.arange(steps, device=q.device)
    k_pos = torch.arange(cache_len, device=q.device)
    # [steps, cache] for a shared index, [b, steps, cache] when ragged;
    # either way [b or 1, steps, cache] below.
    mask = k_pos <= q_pos[..., None]
    if mask.dim() == 2:
        mask = mask[None]
    scale = hd ** -0.5
    if kvh != heads:
        g = heads // kvh
        qg = q.reshape(batch * kvh, g * steps, hd).float()
        kg = k_all.reshape(batch * kvh, cache_len, hd)
        vg = v_all.reshape(batch * kvh, cache_len, hd)
        logits = torch.bmm(qg, kg.float().transpose(1, 2)) * scale
        gmask = mask[:, None, None].expand(
            batch, kvh, g, steps, cache_len
        ).reshape(batch * kvh, g * steps, cache_len)
        logits = torch.where(gmask, logits, torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1)
        o = torch.bmm(probs.to(vg.dtype).float(), vg.float()).to(q.dtype)
        return o.reshape(batch, heads, steps, hd)
    logits = torch.einsum(
        "bhqd,bhkd->bhqk", q.float(), k_all.float()
    ) * scale
    logits = torch.where(
        mask[:, None], logits, torch.full_like(logits, -1e30)
    )
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v_all.dtype), v_all)


class CausalAttention(nn.Module):
    def __init__(self, cfg: LMConfig, device, gen, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        kw = dict(device=device, gen=gen, param_dtype=param_dtype)
        self.qkv = _dense(cfg, d, d + 2 * cfg.kv_heads * cfg.head_dim, **kw)
        self.out_proj = _dense(cfg, d, d, **kw)

    def sequence(self, x):
        """The full causal forward (JAX `CausalAttention.__call__` with
        decode=False): projection -> split -> rotary at 0 .. seq-1 -> K/V
        repeated to every query head (query head i reads kv head i //
        group, `jnp.repeat`'s order) -> `flash_attention(causal=True)` ->
        out projection."""
        c = self.cfg
        b, s = x.shape[0], x.shape[1]
        q, k, v = split_qkv(
            self.qkv(x), torch.zeros((), dtype=torch.long, device=x.device),
            num_heads=c.num_heads, kv_heads=c.kv_heads,
            rope_theta=c.rope_theta if c.rope else None,
        )
        if c.kv_heads != c.num_heads:
            group = c.num_heads // c.kv_heads
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        o = flash_attention(q, k, v, causal=True)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, c.hidden_dim))

    def forward(self, x, kv, table, index, adapters=None):
        """kv: the layer's (k, v, k_scales, v_scales) from the cache's
        `layer(i)`. `table` None means a dense cache: k / v are then the
        layer's [batch, kv_heads, cache_len, head_dim] K/V (no scales).
        `adapters`: (this block's LoRA tree, per-row ids) or None; an
        armed call takes the unfused route."""
        c = self.cfg
        b, s = x.shape[0], x.shape[1]
        theta = c.rope_theta if c.rope else None
        k_pool, v_pool, ks, vs = kv
        if table is None:
            o = self._dense(x, k_pool, v_pool, index, adapters)
        elif (c.fused_qkv and adapters is None and s <= MAX_KERNEL_STEPS
              and x.is_cuda):
            o, k_new, v_new = fused_qkv_paged_attention(
                x.to(c.compute_dtype), self.qkv.kernel, self.qkv.bias,
                k_pool, v_pool, table, index,
                num_heads=c.num_heads, rope_theta=theta,
                w_scale=self.qkv.scale if c.w_quant else None,
                k_scales=ks, v_scales=vs,
            )
            # The kernel attended to the fresh rows at full precision;
            # they quantize here, at the one emit.
            scatter_paged_rows(
                k_pool, v_pool, k_new, v_new, table, index,
                k_scale_pool=ks, v_scale_pool=vs, quant=c.kv_quant,
            )
        else:
            o = self._unfused(x, kv, table, index, adapters)
        o = o.transpose(1, 2).reshape(b, s, c.hidden_dim)
        return _apply_lora(self.out_proj(o), o, adapters, "out_proj")

    def _unfused(self, x, kv, table, index, adapters):
        """Projection (+ LoRA) -> split -> rotary -> scatter (quantizing)
        -> paged attention (JAX `_paged_decode_attention` +
        `_paged_scatter_and_attend`)."""
        c = self.cfg
        k_pool, v_pool, ks, vs = kv
        q, k, v = split_qkv(
            _apply_lora(self.qkv(x), x, adapters, "qkv"), index,
            num_heads=c.num_heads, kv_heads=c.kv_heads,
            rope_theta=c.rope_theta if c.rope else None,
        )
        scatter_paged_rows(
            k_pool, v_pool, k, v, table, index,
            k_scale_pool=ks, v_scale_pool=vs, quant=c.kv_quant,
        )
        if x.shape[1] <= MAX_KERNEL_STEPS:
            return paged_decode_attention(
                q, k_pool, v_pool, table, index, k_scales=ks, v_scales=vs
            )
        # Wide prefill chunks: every row's K/V is written above, before
        # this gather, so a window reads the window before it in the same
        # dispatch (the sp lane's fan-out relies on it).
        if c.kv_quant:
            k_all = dequantize_gathered(k_pool, ks, table, q.dtype)
            v_all = dequantize_gathered(v_pool, vs, table, q.dtype)
        else:
            k_all = gather_paged_cache(k_pool, table)
            v_all = gather_paged_cache(v_pool, table)
        return _masked_cache_attention(q, k_all, v_all, index)

    def _dense(self, x, k_cache, v_cache, idx, adapters):
        """Dense-cache decoding (JAX `_decode_attention`): projection ->
        split -> rotary at idx + r -> cache write -> attention. The write
        lands at min(idx, cache_len - steps), as XLA's dynamic_update_slice
        clamps its start (freed serving slots keep stepping past
        cache_len); the attention still masks at the true idx. No host
        sync: positions stay device tensors."""
        c = self.cfg
        steps = x.shape[1]
        q, k, v = split_qkv(
            _apply_lora(self.qkv(x), x, adapters, "qkv"), idx,
            num_heads=c.num_heads, kv_heads=c.kv_heads,
            rope_theta=c.rope_theta if c.rope else None,
        )
        batch, kvh, cache_len, hd = k_cache.shape
        widx = torch.clamp(idx.long(), 0, cache_len - steps)
        pos = widx[..., None] + torch.arange(steps, device=x.device)
        pos = pos.expand(batch, steps)[:, None, :, None].expand(
            batch, kvh, steps, hd
        )
        k_cache.scatter_(2, pos, k.to(k_cache.dtype))
        v_cache.scatter_(2, pos, v.to(v_cache.dtype))
        if steps <= MAX_KERNEL_STEPS and (
            kvh != c.num_heads or c.decode_kernel
        ):
            return decode_attention(q, k_cache, v_cache, idx)
        return _masked_cache_attention(q, k_cache, v_cache, idx)


class DecoderBlock(nn.Module):
    """Attention and an MLP, each behind a pre-norm and a residual. With
    `use_moe` the MLP is `MoEMlp` (the JAX block's `moe` scope). Its
    output keeps the f32 norm's dtype, as in JAX, so from the first MoE
    block on the residual is f32 in every forward; the projections and
    K2 still take the compute dtype (`Dense` casts its input, as flax
    does)."""

    def __init__(self, cfg: LMConfig, device, gen, param_dtype=None,
                 use_moe=False):
        super().__init__()
        self.cfg = cfg
        train = param_dtype is not None
        kw = dict(device=device, gen=gen, param_dtype=param_dtype)
        self.norm1 = Norm(cfg, device, train)
        self.attn = CausalAttention(cfg, **kw)
        self.norm2 = Norm(cfg, device, train)
        self.moe = None
        if use_moe:
            self.moe = MoEMlp(
                cfg.hidden_dim, cfg.mlp_width, cfg.num_experts,
                top_k=cfg.expert_top_k, capacity_factor=cfg.capacity_factor,
                dtype=cfg.compute_dtype, **kw,
            )
        else:
            if cfg.mlp == "swiglu":
                self.gate = _dense(cfg, cfg.hidden_dim, cfg.mlp_width, **kw)
            self.fc1 = _dense(cfg, cfg.hidden_dim, cfg.mlp_width, **kw)
            self.fc2 = _dense(cfg, cfg.mlp_width, cfg.hidden_dim, **kw)

    def _mlp(self, h, adapters=None):
        if self.cfg.mlp == "swiglu":
            h = (F.silu(_apply_lora(self.gate(h), h, adapters, "gate"))
                 * _apply_lora(self.fc1(h), h, adapters, "fc1"))
        else:
            h = F.gelu(_apply_lora(self.fc1(h), h, adapters, "fc1"),
                       approximate="tanh")
        return _apply_lora(self.fc2(h), h, adapters, "fc2")

    def forward(self, x, kv, table, index, moe_rows=None, adapters=None):
        """The cache forward. An MoE block routes the first `moe_rows`
        batch rows (None: all) and drops its aux loss: JAX's decode
        forward sows it and nothing reads it. `adapters` (this block's
        LoRA tree, per-row ids) puts deltas on the attention's
        projections and, in a non-MoE block, on the MLP's."""
        x = x + self.attn(self.norm1(x), kv, table, index, adapters)
        h = self.norm2(x)
        if self.moe is None:
            return x + self._mlp(h, adapters)
        return x + self.moe(h, moe_rows)[0]

    def sequence(self, x):
        """The full causal forward: (x, the MoE layer's aux loss or
        None)."""
        x = x + self.attn.sequence(self.norm1(x))
        h = self.norm2(x)
        if self.moe is None:
            return x + self._mlp(h), None
        y, aux = self.moe(h)
        return x + y, aux


@dataclass
class PagedCache:
    """Per-layer K/V block pools, [paged_blocks + 1, kv_heads,
    PAGE_ROWS, head_dim] each in `kv_storage_dtype`, written in place by
    `DecoderLM.forward`: the tables name blocks 0 .. paged_blocks - 1,
    and the last is `scatter_paged_rows`' dump block. With `kv_quant`,
    per-layer f32 scale pools `ks` / `vs` [paged_blocks + 1, kv_heads,
    PAGE_ROWS] parallel them under the same block ids (zero-initialized:
    an unwritten row dequantizes to zero); else `ks` / `vs` are None."""

    k: list
    v: list
    ks: list | None = None
    vs: list | None = None

    @classmethod
    def zeros(cls, cfg: LMConfig, device) -> "PagedCache":
        if not cfg.paged_decode:
            raise ValueError("a paged cache needs a paged_decode config")
        shape = (cfg.paged_blocks + 1, cfg.kv_heads, PAGE_ROWS, cfg.head_dim)

        def pools(shape, dtype):
            return [
                torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(cfg.num_layers)
            ]

        cache = cls(
            pools(shape, cfg.kv_storage_dtype),
            pools(shape, cfg.kv_storage_dtype),
        )
        if cfg.kv_quant:
            cache.ks = pools(shape[:3], torch.float32)
            cache.vs = pools(shape[:3], torch.float32)
        return cache

    def layer(self, i: int) -> tuple:
        """Layer i's (k, v, k_scales, v_scales)."""
        if self.ks is None:
            return self.k[i], self.v[i], None, None
        return self.k[i], self.v[i], self.ks[i], self.vs[i]


@dataclass
class DenseCache:
    """Per-layer dense K/V, [batch, kv_heads, cache_len, head_dim] each in
    the compute dtype, and the cache index: 0-d (every row at one
    position) or [batch] int32 when `ragged_decode` is set. The JAX cache
    collection's `cached_key` / `cached_value` / `cache_index` /
    `pos_index`; `DecoderLM.forward` writes the rows in place and
    advances `index` by the step count, on the device."""

    k: list
    v: list
    index: torch.Tensor

    @classmethod
    def zeros(
        cls, cfg: LMConfig, batch: int, device, cache_len: int | None = None,
    ) -> "DenseCache":
        """A zeroed cache of `cache_len` rows (default: cfg.cache_len,
        else max_seq_len) at index 0."""
        if cfg.paged_decode:
            raise ValueError("a paged_decode config takes a PagedCache")
        if cfg.kv_dtype != "model":
            raise ValueError(
                "kv_dtype != 'model' requires paged_decode (the per-row "
                "scale store is block-parallel; the dense cache has no "
                "block pool to parallel)"
            )
        rows = cache_len or cfg.cache_len or cfg.max_seq_len
        shape = (batch, cfg.kv_heads, rows, cfg.head_dim)

        def buf():
            return torch.zeros(shape, dtype=cfg.compute_dtype, device=device)

        index = torch.zeros(
            (batch,) if cfg.ragged_decode else (), dtype=torch.int32,
            device=device,
        )
        return cls(
            [buf() for _ in range(cfg.num_layers)],
            [buf() for _ in range(cfg.num_layers)],
            index,
        )

    def layer(self, i: int) -> tuple:
        """Layer i's (k, v, None, None): a dense cache has no scales."""
        return self.k[i], self.v[i], None, None

    def row(self, b: int) -> "DenseCache":
        """Batch row b as a one-row ragged cache at index 0 whose K/V are
        VIEWS of this cache's: a forward through it writes row b's rows
        in place (the dense engine's admission prefill)."""
        return DenseCache(
            [k[b:b + 1] for k in self.k], [v[b:b + 1] for v in self.v],
            torch.zeros(1, dtype=torch.int32, device=self.index.device),
        )


class Embed(nn.Module):
    """flax `nn.Embed(dtype=compute)`: the table cast to the compute dtype
    (a no-op in the serving build), then the rows gathered."""

    def __init__(self, cfg: LMConfig, device, gen, param_dtype=None):
        super().__init__()
        self.dtype = cfg.compute_dtype
        self.embedding = _param(
            (cfg.vocab_size, cfg.hidden_dim), param_dtype or self.dtype,
            device, gen, std=0.02, train=param_dtype is not None,
        )

    def forward(self, tokens):
        return self.embedding.to(self.dtype)[tokens.long()]


class DecoderLM(nn.Module):
    """The decoder LM: the full causal forward (no cache) and the decode
    forward over a paged or a dense cache. Weights are random from `seed`
    (normal, std 0.02; norms at 1, biases at 0) until `models/convert.py`
    loads a JAX tree. `device=None` means `cuda`.

    `param_dtype=None` is the serving build: projections and embedding
    stored in the compute dtype, nothing trains. `param_dtype=
    torch.float32` is the training build: every parameter an f32 master
    that trains, cast to the compute dtype at every call (it takes
    w_dtype="model" only). Both draw the same random values."""

    def __init__(self, cfg: LMConfig, *, device=None, seed: int = 0,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        if param_dtype not in (None, torch.float32):
            raise ValueError(
                f"param_dtype must be None (serving) or torch.float32 "
                f"(training); got {param_dtype}"
            )
        if param_dtype is not None and cfg.w_quant:
            raise ValueError(
                f"w_dtype={cfg.w_dtype!r} is a serving format; the training "
                f"build holds full-precision masters (w_dtype='model')"
            )
        self.cfg = cfg
        self.param_dtype = param_dtype
        train = param_dtype is not None
        dev = resolve_device(device)
        self.device = dev
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embed = Embed(cfg, dev, gen, param_dtype)
        self.pos_embed = None
        if not cfg.rope:
            self.pos_embed = _param(
                (1, cfg.max_seq_len, cfg.hidden_dim), torch.float32, dev,
                gen, std=0.02, train=train,
            )
        self.blocks = nn.ModuleList(
            DecoderBlock(
                cfg, dev, gen, param_dtype,
                use_moe=cfg.num_experts > 0 and (i + 1) % cfg.moe_every == 0,
            )
            for i in range(cfg.num_layers)
        )
        self.norm = Norm(cfg, dev, train)
        self.head = Dense(
            cfg.hidden_dim, cfg.vocab_size, bias=cfg.head_bias,
            dtype=torch.float32, device=dev, gen=gen, param_dtype=param_dtype,
        )

    @classmethod
    def from_params(cls, cfg: LMConfig, params, device=None) -> "DecoderLM":
        """`params` as the cache paths' entry points take it: a serving
        `DecoderLM` built for `cfg` up to its cache fields and `remat`
        (used as it is, weights shared), a training build of the same
        (copied once into a new serving build: compute-dtype projections,
        as K2 reads them), or the JAX package's flax param tree as nested
        numpy arrays (bridged by `models/convert.py` onto `device`, None
        meaning `cuda`)."""
        if isinstance(params, DecoderLM):
            ignored = {
                f: getattr(cfg, f) for f in (
                    "ragged_decode", "paged_decode", "paged_blocks",
                    "cache_len", "remat",
                )
            }
            if dataclasses.replace(params.cfg, **ignored) != cfg:
                raise ValueError("the DecoderLM was built for another config")
            if device is not None and resolve_device(device) != params.device:
                raise ValueError(
                    f"the DecoderLM lives on {params.device}, not {device}"
                )
            if params.param_dtype is None:
                return params
            serving = cls(cfg, device=params.device)
            serving.load_state_dict(params.state_dict())
            return serving
        if not isinstance(params, Mapping):
            raise TypeError(
                "params must be a flax param tree (nested numpy arrays) "
                "or a DecoderLM"
            )
        return load_flax_params(cls(cfg, device=device), params)

    def forward(self, tokens, cache=None, table=None, index=None, *,
                intermediates: list | None = None,
                moe_rows: int | None = None, adapters=None):
        """tokens [batch, steps] -> f32 logits [batch, steps, vocab].

        With no cache: the full causal forward over positions 0 ..
        steps-1; each MoE layer appends its aux loss to `intermediates`
        when a list is given (the JAX `intermediates` collection; see
        `models/moe.aux_loss_from_intermediates`).

        With a `PagedCache`: the tokens sit at positions index ..
        index+steps-1 of each slot, the new K/V rows go into the pools
        through `table` ([batch, nlog] block ids), and `index` ([batch]
        int) is the caller's to advance. With a `DenseCache` (table and
        index None): the tokens sit at cache.index onwards, and the
        forward writes the rows and advances cache.index by steps.

        `moe_rows` (cache forwards): the MoE layers route only the first
        `moe_rows` batch rows, the others get no MoE output (None: all
        rows route).

        `adapters` (cache forwards): (tree, ids), the stacked LoRA tensors
        under "block{i}" -> projection -> {"lora_a", "lora_b"} and the
        per-row adapter ids [batch] (`models/lora.py`); None: no deltas."""
        if cache is None:
            if (table is not None or index is not None or moe_rows is not None
                    or adapters is not None):
                raise ValueError(
                    "table=, index=, moe_rows= and adapters= go with a cache"
                )
            return self._sequence(tokens, intermediates)
        c = self.cfg
        steps = tokens.shape[1]
        dense = isinstance(cache, DenseCache)
        if dense:
            if table is not None or index is not None:
                raise ValueError(
                    "a DenseCache carries its own index and takes no table"
                )
            index = cache.index
        elif table is None or index is None:
            raise ValueError("a PagedCache needs table= and index=")
        x = self.embed(tokens)
        if self.pos_embed is not None:
            # Slices of the position table with XLA's dynamic_slice
            # clamping: a start past max_seq_len - steps (freed slots keep
            # stepping; the last chunk of a generation overshoots) reads
            # the table's last rows. Shared index: [steps] rows; ragged:
            # [batch, steps].
            start = torch.clamp(index.long(), 0, c.max_seq_len - steps)
            rows = start[..., None] + torch.arange(steps, device=x.device)
            x = x + self.pos_embed[0][rows].to(x.dtype)
        for i, block in enumerate(self.blocks):
            adp = (None if adapters is None
                   else (adapters[0].get(f"block{i}"), adapters[1]))
            x = block(x, cache.layer(i), table, index, moe_rows, adp)
        if dense:
            cache.index += steps
        return self.head(self.norm(x))

    def _sequence(self, tokens, intermediates):
        c = self.cfg
        steps = tokens.shape[1]
        if steps > c.max_seq_len:
            raise ValueError(
                f"{steps} tokens exceed max_seq_len {c.max_seq_len}"
            )
        x = self.embed(tokens)
        if self.pos_embed is not None:
            x = x + self.pos_embed[0, :steps].to(x.dtype)
        # nn.remat: each block's activations are recomputed in the
        # backward (K4 runs again there), only its input is kept.
        remat = c.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x, aux = checkpoint(block.sequence, x, use_reentrant=False)
            else:
                x, aux = block.sequence(x)
            if aux is not None and intermediates is not None:
                intermediates.append(aux)
        return self.head(self.norm(x))


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (shift by one), mean, in f32."""
    vocab = logits.shape[-1]
    return F.cross_entropy(
        logits[:, :-1].reshape(-1, vocab).float(),
        tokens[:, 1:].reshape(-1).long(),
    )


def init_lm_state(
    cfg: LMConfig, *, seed: int = 0, lr: float = 3e-4, device=None,
) -> TrainState:
    """A fresh training build (f32 masters) from `seed` on `device`
    (`cuda` unless the caller passes `device="cpu"`) and its AdamW
    state."""
    model = DecoderLM(cfg, device=device, seed=seed, param_dtype=torch.float32)
    return TrainState(model, make_optimizer(lr).init(model), 0)


def make_lm_train_step(cfg: LMConfig, *, lr: float = 3e-4, device=None):
    """Returns `(state, tokens) -> (state, loss)`: one AdamW step
    (`make_optimizer(lr)`) of `lm_loss`, plus 1e-2 x the summed MoE aux
    loss when `cfg.num_experts > 0`, applied to `state` (an
    `init_lm_state` of `cfg`) in place. `tokens` [batch, seq] int, a
    tensor or numpy array; the loss is a 0-d tensor on the device, not
    synced to the host."""
    dev = resolve_device(device)
    tx = make_optimizer(lr)

    def loss_fn(model, tokens):
        if cfg.num_experts > 0:
            sown = []
            logits = model(tokens, intermediates=sown)
            return lm_loss(logits, tokens) + 1e-2 * aux_loss_from_intermediates(sown)
        return lm_loss(model(tokens), tokens)

    def step(state: TrainState, tokens) -> tuple[TrainState, torch.Tensor]:
        if state.params.cfg != cfg:
            raise ValueError("the state's model was built for another config")
        tokens = to_device(tokens, dev)
        state.opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, tokens)
        loss.backward()
        tx.apply(state.opt_state, state.step)
        state.step += 1
        return state, loss.detach()

    return step
