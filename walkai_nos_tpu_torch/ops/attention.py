"""Full-sequence attention: four CUDA kernels for Hopper, their plain
PyTorch versions, and the differentiable public functions.

Port of `walkai_nos_tpu/ops/attention.py` (the reference). Kernels
(sources in `csrc/`, built by `ops/_build.py` at first use):

- K3 `packed_attention` (`csrc/flash_attention.cu`) replaces the TPU
  kernel `_packed_pallas_fwd` / `_packed_kernel`: the ViT's attention read
  straight off the fused qkv projection `[b, s, 3*h*d]`, written as
  `[b, s, h*d]`, with no transposing copy.
- K4 `flash_fwd` (same source, same templated body) replaces
  `_flash_pallas_impl` / `_flash_kernel`: online-softmax attention over
  `[b, h, s, d]` that also returns the f32 logsumexp, with the
  bottom-right causal mask (blocks past the diagonal skipped) and the
  `kv_len` tail mask. The bf16 arm of K3/K4 runs both products on tensor
  cores (warpgroup MMA, `wgmma`): Q resident in swizzled shared memory,
  K/V streamed through a two-stage `cp.async` ring, the online softmax
  and P in registers (P rounded to bf16 for the PV product).
- K5 `flash_dq` and K6 `flash_dkv` (`csrc/flash_attention_bwd.cu`)
  replace `_flash_bwd_impl`: its `_flash_dq_kernel` and
  `_flash_dkv_kernel`, and the XLA reduction in front of them. K5 also
  computes the row term `D' = rowsum(dO * O) - g_lse` and writes it
  (f32 [b, h, sq]) for K6, so a backward on the card is exactly two
  launches, K5 then K6 on one stream; P is rebuilt from the saved
  logsumexp; no atomics, bitwise repeatable. Both read ~44 MB per ViT
  layer call (b 32, s 296, h 6, d 64) against 6.5 and 8.6 GFLOP, so
  bytes bound them there (13.2 us each at 3.35 TB/s). Their bf16 arms
  run every product on tensor cores (`wgmma`), keep the operand tiles
  bf16 in swizzled shared memory, stream the next tile with `cp.async`
  while the current one computes, and keep P and dS in registers.

The f32 arms of all four stay CUDA-core kernels (tensor cores would mean
TF32, short of the f32 tolerance). The bf16 tiles and `wgmma` wrappers
the four share live in `csrc/hopper_mma.cuh`.

The kernels address every tensor through (batch, head, row) strides with
a unit column stride, so the packed path's backward (unpack, recompute
(out, lse) with K4, K5 + K6, repack) reads q/k/v as views of the packed
tensor and writes dq/dk/dv straight into the packed gradient.

Routing follows the tensor's device and nothing else: a CPU tensor takes
the plain version (the tests' path), a CUDA tensor launches the kernel or
raises. There is no environment switch and no fallback. The TPU wrapper's
shape gates (tile divisibility, VMEM budgets, the padded dispatch) are
TPU limits, not semantics: the kernels take any sq, sk and kv_len, and
raise only on what they cannot take (head_dim above 128). The edge the
JAX wrapper leaves to its reference, causal with sq > sk, has rows that
see no key; both the plain versions and the kernels give them the
reference's answer, the mean of V over all keys (and 1/sk * dO into dv in
the backward). Each wrapper counts its launches in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from walkai_nos_tpu_torch.ops.decode_attention import (
    _check,
    _kernel_fn,
    _require_cuda,
    _suffix,
)

__all__ = [
    "LAUNCHES",
    "attention_reference",
    "flash_attention",
    "flash_attention_packed",
    "flash_attention_with_lse",
    "flash_backward_reference",
    "flash_reference",
    "packed_reference",
    "packed_unpack",
    "reset_launch_counts",
]

_NEG_INF = -1e30
_MAX_HEAD_DIM = 128

# Launch counts per kernel: each wrapper adds one where it launches its
# kernel, and nowhere else.
LAUNCHES = {"packed_attention": 0, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain versions -----------------------------------------------------


def _visible(sq: int, sk: int, causal: bool, kv_len: int, device):
    """[sq, sk] bool: key k is visible to query row q iff k < kv_len and,
    when causal, k <= q + sk - sq (the reference's tril(k=sk-sq))."""
    k_pos = torch.arange(sk, device=device)
    vis = (k_pos < kv_len)[None, :].expand(sq, sk)
    if causal:
        q_pos = torch.arange(sq, device=device)
        vis = vis & (k_pos[None, :] <= q_pos[:, None] + (sk - sq))
    return vis


def attention_reference(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """Plain attention over [batch, heads, seq, head_dim]: f32 scores and
    softmax, probabilities rounded to v's dtype before the PV product
    (accumulated in f32), as the JAX `attention_reference`."""
    sq, sk = q.shape[2], k.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits * q.shape[-1] ** -0.5
    if causal:
        vis = _visible(sq, sk, True, sk, q.device)
        logits = torch.where(vis, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum(
        "bhqk,bhkd->bhqd", probs.float(), v.float()
    ).to(v.dtype)


def flash_reference(q, k, v, *, causal: bool = False, kv_len: int | None = None):
    """Plain version of K4, the function `_flash_pallas_impl` computes:
    (out [b, h, sq, d] in q's dtype, lse [b, h, sq] f32). q is scaled in
    f32 before the product; masked scores are -1e30; the probabilities
    stay f32 in the PV product."""
    sq, sk = q.shape[2], k.shape[2]
    kv_len = sk if kv_len is None else kv_len
    s = torch.einsum(
        "bhqd,bhkd->bhqk", q.float() * q.shape[-1] ** -0.5, k.float()
    )
    s = torch.where(_visible(sq, sk, causal, kv_len, q.device), s, _NEG_INF)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.float())
    return out.to(q.dtype), torch.logsumexp(s, -1)


def _row_term(g, out, g_lse):
    """D' = rowsum(dO * O) - g_lse, f32 [b, h, sq]."""
    dcap = (g.float() * out.float()).sum(-1)
    if g_lse is not None:
        dcap = dcap - g_lse.float()
    return dcap


def flash_backward_reference(
    q, k, v, out, lse, g, *, causal: bool = False,
    kv_len: int | None = None, g_lse=None,
):
    """Plain version of K5 + K6 (`_flash_bwd_impl`): (dq, dk, dv) in the
    dtypes of q, k, v. P = exp(S - lse) on visible entries and 0 elsewhere
    (selected, never multiplied, so an overflowing masked entry cannot
    NaN a row); rows that see no key (causal, sq > sk) weigh every key
    1/sk, as autodiff of the reference does."""
    sq, sk = q.shape[2], k.shape[2]
    kv_len = sk if kv_len is None else kv_len
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    vis = _visible(sq, sk, causal, kv_len, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
    if causal and sq > sk:
        blind = (torch.arange(sq, device=q.device) + (sk - sq) < 0)[:, None]
        p = torch.where(blind, 1.0 / sk, p)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = torch.where(vis, p * (dp - _row_term(g, out, g_lse)[..., None]), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def packed_unpack(qkv: torch.Tensor, num_heads: int):
    """[b, s, 3*h*d] -> (q, k, v), each a [b, h, s, d] VIEW of qkv."""
    b, s, three_d = qkv.shape
    head_dim = three_d // (3 * num_heads)
    qkv5 = qkv.unflatten(2, (3, num_heads, head_dim))
    return tuple(qkv5[:, :, i].transpose(1, 2) for i in range(3))


def packed_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of K3 (`_packed_reference`): [b, s, 3*h*d] ->
    [b, s, h*d]."""
    o = attention_reference(*packed_unpack(qkv, num_heads))
    b, s, three_d = qkv.shape
    return o.transpose(1, 2).reshape(b, s, three_d // 3)


# -- CUDA wrappers --------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _unit_cols(t: torch.Tensor) -> torch.Tensor:
    """t itself when its last dim has stride 1 (any other strides are
    fine: the kernels take them), else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _strides(*views) -> ctypes.Array:
    vals = []
    for t in views:
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(
                f"kernel views are [b, h, s, d] with unit column stride; "
                f"got shape {tuple(t.shape)} strides {t.stride()}"
            )
        vals += list(t.stride()[:3])
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_qkv(q, k, v, kv_len):
    _require_cuda(q, k, v)
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("q, k, v must be [batch, heads, seq, head_dim]")
    b, h, _, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "do not fit together"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} is above the kernels' {_MAX_HEAD_DIM}")
    if not 1 <= kv_len <= sk:
        raise ValueError(f"kv_len {kv_len} must lie in [1, {sk}]")
    _suffix(q)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _flash_fwd_cuda(q, k, v, causal: bool, kv_len: int):
    """Launch K4: (out [b, h, sq, d], lse [b, h, sq] f32)."""
    q, k, v = _unit_cols(q), _unit_cols(k), _unit_cols(v)
    _check_qkv(q, k, v, kv_len)
    b, h, sq, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    fn = _kernel_fn(
        "flash_attention", "flash_fwd_" + _suffix(q),
        [_P] * 6 + [_I] * 7 + [_F, _P],
    )
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _strides(q, k, v, out), b, h, sq, k.shape[2], d,
        kv_len, int(causal), d ** -0.5, _stream(q),
    )
    _check(code, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _packed_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Launch K3 on the packed tensor as it lies."""
    qkv = _unit_cols(qkv)
    b, s, three_d = qkv.shape
    d_model = three_d // 3
    q, k, v = packed_unpack(qkv, num_heads)
    _check_qkv(q, k, v, s)
    out = torch.empty(b, s, d_model, dtype=qkv.dtype, device=qkv.device)
    o = out.unflatten(2, (num_heads, d_model // num_heads)).transpose(1, 2)
    hd = d_model // num_heads
    fn = _kernel_fn(
        "flash_attention", "packed_attention_" + _suffix(qkv),
        [_P] * 5 + [_I] * 4 + [_F, _P],
    )
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _strides(q, k, v, o), b, num_heads, s, hd, hd ** -0.5, _stream(qkv),
    )
    _check(code, "packed_attention")
    LAUNCHES["packed_attention"] += 1
    return out


def _bwd_args(q, k, v, g, lse, causal, kv_len):
    """Checked inputs and the shared scalar arguments of K5 and K6."""
    q, k, v, g = (_unit_cols(t) for t in (q, k, v, g))
    _check_qkv(q, k, v, kv_len)
    _require_cuda(g, lse)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError("the output cotangent must match q in shape and dtype")
    b, h, sq, d = q.shape
    scalars = (b, h, sq, k.shape[2], d, kv_len, int(causal), d ** -0.5, _stream(q))
    return q, k, v, g, lse.float().contiguous(), scalars


def _empty_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, memory_format=torch.contiguous_format)


def _flash_dq_cuda(q, k, v, g, out, lse, g_lse, causal, kv_len, dq=None):
    """Launch K5: dq, and D' = rowsum(dO * O) - g_lse, the f32 [b, h, sq]
    row term K6 reads. g_lse: the lse cotangent or None; dq: optional
    [b, h, sq, d] view to write into. Returns (dq, dcap)."""
    q, k, v, g, lse, scalars = _bwd_args(q, k, v, g, lse, causal, kv_len)
    out = _unit_cols(out)
    _require_cuda(out, g_lse)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("the forward output must match q in shape and dtype")
    if g_lse is not None:
        g_lse = g_lse.float().contiguous()
    dq = _empty_like(q) if dq is None else dq
    dcap = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    fn = _kernel_fn(
        "flash_attention_bwd", "flash_dq_" + _suffix(q), [_P] * 10 + [_I] * 7 + [_F, _P],
    )
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(),
        lse.data_ptr(), None if g_lse is None else g_lse.data_ptr(),
        dcap.data_ptr(), dq.data_ptr(), _strides(q, k, v, g, out, dq), *scalars,
    )
    _check(code, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq, dcap


def _flash_dkv_cuda(q, k, v, g, lse, dcap, causal, kv_len, dk=None, dv=None):
    """Launch K6 over the D' that K5 wrote (`dcap`, f32 [b, h, sq]; K5
    must run first, on the same stream); dk/dv: optional [b, h, sk, d]
    views to write into."""
    q, k, v, g, lse, scalars = _bwd_args(q, k, v, g, lse, causal, kv_len)
    _require_cuda(dcap)
    dcap = dcap.float().contiguous()
    dk = _empty_like(k) if dk is None else dk
    dv = _empty_like(v) if dv is None else dv
    fn = _kernel_fn(
        "flash_attention_bwd", "flash_dkv_" + _suffix(q), [_P] * 9 + [_I] * 7 + [_F, _P],
    )
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        dcap.data_ptr(), dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, g, dk, dv),
        *scalars,
    )
    _check(code, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


def _flash_bwd_cuda(q, k, v, out, lse, g, g_lse, causal, kv_len,
                    dq=None, dk=None, dv=None):
    """K5 (dq and D'), then K6 (dk, dv) on the same stream: two launches
    and no other device work for contiguous inputs. dq/dk/dv: optional
    [b, h, s, d] views to write into (unit column stride); fresh tensors
    otherwise."""
    dq, dcap = _flash_dq_cuda(q, k, v, g, out, lse, g_lse, causal, kv_len, dq)
    dk, dv = _flash_dkv_cuda(q, k, v, g, lse, dcap, causal, kv_len, dk, dv)
    return dq, dk, dv


# -- routing and autograd ---------------------------------------------------


def _forward(q, k, v, causal, kv_len):
    if q.device.type == "cpu":
        return flash_reference(q, k, v, causal=causal, kv_len=kv_len)
    return _flash_fwd_cuda(q, k, v, causal, kv_len)


def _backward(q, k, v, out, lse, g, g_lse, causal, kv_len, **into):
    if q.device.type == "cpu":
        return flash_backward_reference(
            q, k, v, out, lse, g, causal=causal, kv_len=kv_len, g_lse=g_lse
        )
    return _flash_bwd_cuda(q, k, v, out, lse, g, g_lse, causal, kv_len, **into)


class _FlashFn(torch.autograd.Function):
    """(q, k, v) -> (out, lse); the backward is K5 + K6 (the plain
    versions on the CPU), with the lse cotangent folded into D'."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len):
        ctx.set_materialize_grads(False)
        out, lse = _forward(q, k, v, causal, kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kv_len = causal, kv_len
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(out)
        dq, dk, dv = _backward(
            q, k, v, out, lse, g, g_lse, ctx.causal, ctx.kv_len
        )
        return dq, dk, dv, None, None


class _PackedFn(torch.autograd.Function):
    """[b, s, 3*h*d] -> [b, s, h*d] through K3; the backward mirrors
    `_packed_pallas_bwd`: unpack, recompute (out, lse) with K4, run K5 +
    K6, repack into the fused-qkv layout."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        if qkv.device.type == "cpu":
            out = packed_reference(qkv, num_heads)
        else:
            out = _packed_cuda(qkv, num_heads)
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        h = ctx.num_heads
        b, s, three_d = qkv.shape
        q, k, v = packed_unpack(_unit_cols(qkv), h)
        out, lse = _forward(q, k, v, False, s)
        g4 = g.unflatten(2, (h, three_d // (3 * h))).transpose(1, 2)
        if qkv.device.type == "cpu":
            dq, dk, dv = _backward(q, k, v, out, lse, g4, None, False, s)
            return torch.stack(
                [x.transpose(1, 2).reshape(b, s, three_d // 3)
                 for x in (dq, dk, dv)], dim=2,
            ).reshape(b, s, three_d), None
        dqkv = torch.empty(b, s, three_d, dtype=qkv.dtype, device=qkv.device)
        dq, dk, dv = packed_unpack(dqkv, h)
        _backward(q, k, v, out, lse, g4, None, False, s, dq=dq, dk=dk, dv=dv)
        return dqkv, None


def flash_attention(
    q, k, v, *, causal: bool = False, kv_len: int | None = None,
) -> torch.Tensor:
    """Differentiable attention over [batch, heads, seq, head_dim] (K4
    forward, K5 + K6 backward on CUDA tensors). `kv_len < sk` masks the
    key/value tail out of the softmax (the JAX kernel's padded-dispatch
    mask); causal is bottom-right aligned."""
    return _FlashFn.apply(q, k, v, causal, k.shape[2] if kv_len is None else kv_len)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = False):
    """`flash_attention` that also returns the f32 per-row logsumexp
    [b, h, sq]; differentiable in both outputs (the lse cotangent folds
    into the backward as D' = D - g_lse)."""
    return _FlashFn.apply(q, k, v, causal, k.shape[2])


def flash_attention_packed(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention straight off the fused qkv projection: [b, s, 3*h*d] in,
    [b, s, h*d] out (K3 on a CUDA tensor); differentiable (the backward
    recomputes with K4 and runs K5 + K6 on views of the packed tensor)."""
    b, s, three_d = qkv.shape
    if three_d % (3 * num_heads):
        raise ValueError(
            f"qkv minor dim {three_d} must be 3 * num_heads * head_dim"
        )
    return _PackedFn.apply(qkv, num_heads)
