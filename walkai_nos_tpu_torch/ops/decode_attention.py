"""Decode attention over a dense or a paged KV cache: three CUDA kernels
for Hopper and their plain PyTorch versions.

Port of `walkai_nos_tpu/ops/decode_attention.py` (the reference). The
dense cache (one-shot generation, speculative decoding, the dense
serving engine) holds `[batch, kv_heads, cache_len, head_dim]` per
layer. The paged serving engine stores K/V in a SHARED pool of 128-row
physical blocks per layer (`[num_blocks, kv_heads, PAGE_ROWS,
head_dim]`); a per-slot block table maps logical cache block j of slot b
to pool block `table[b, j]`. The decode step is memory-bound: each step
re-reads every resident K/V byte once, and the projection weight once.

Three kernels carry the decode step (sources in `csrc/`, built by
`ops/_build.py` at first use):

- `decode_attention.cu` (K7) replaces the TPU kernel `_gqa_pallas`
  (`_gqa_stream_kernel` -> `_stream_fold`): streamed attention over the
  dense cache, GQA rows served from one K/V read per kv head (up to 64
  query rows a CTA, more rows on more CTAs), scalar or per-row index
  read on the device, tiles past the index never read. It takes any
  cache length (the JAX wrapper falls back to its reference when the
  length is not a multiple of 128), any group and steps, and head_dim
  up to 256.
- `paged_attention.cu` (K1) replaces the TPU kernel `_paged_pallas`
  (`_paged_stream_kernel` -> `_stream_fold`): streamed paged attention
  through the block table, tail blocks never read, GQA rows served from
  one K/V read per kv head, and optional injection of the step's fresh
  K/V rows (what `_fused_stream_kernel` does in VMEM).
- K1 and K7 share one body, `decode_mma.cuh`: bf16 products on tensor
  cores (mma.sync through ldmatrix), K/V tiles through a cp.async ring,
  each cell's visible tiles split over CTAs by its own row's index (the
  split count from the shapes and the card only), and the splits
  combined in split order: by each cell's last CTA to finish in a
  one-step bf16 call, else by a second kernel. A row's result depends on
  its own inputs and index only, and is bitwise repeatable.
- `qkv_rope.cu` (K2) replaces the projection half of `_fused_qkv_pallas`:
  one launch computes `x @ w_qkv` for every slot's rows (the weight is
  read once for up to 64 rows; bf16 products on tensor cores, the weight
  streamed by the TMA unit through a ring of stages, its k dimension
  split over CTAs by `_qkv_geometry` and the splits added in split order
  by each head's last CTA), scales, adds the bias, rounds to x's dtype and
  applies RoPE.

`fused_qkv_paged_attention` on a CUDA tensor is K2 followed by K1 with
injection; it returns `(o, k_new, v_new)` and the CALLER scatters the
fresh rows (`scatter_paged_rows`), as with the TPU kernel.

Routing follows the tensor's device and nothing else: a CPU tensor takes
the plain version (the tests' path), a CUDA tensor launches the kernel
or raises. There is no environment switch and no fallback. Each wrapper
counts its launches in `LAUNCHES`, and K1's and K2's also by query steps
in `LAUNCHES_AT_STEPS`.

Layouts at the public functions are the JAX package's. The one
difference: `scatter_paged_rows` writes the pools IN PLACE (JAX returns
new pools from a donated buffer) and returns them for convenience, and
its pools hold one block past those the tables name, where the rows it
drops land (`with_dump_block`).

Quantized storage (the JAX package's int8 arms): a paged pool may hold
int8 rows with one f32 scale per row in parallel `[num_blocks, kv_heads,
PAGE_ROWS]` scale pools (`k_scales` / `v_scales`, indexed by the same
block ids); rows quantize once, at emit (`scatter_paged_rows`), and K1
dequantizes inside its fold (K scales on the f32 score columns, V scales
on the probability columns). The fused QKV weight may be int8 with a
per-output-channel f32 scale row (`w_scale`), applied by K2 to the f32
sum before the bias and the rounding. The "sim" arms run the same code
with full-precision storage and unit scales, bit for bit the unquantized
arms. An int8 pool or weight on a CUDA tensor launches its int8 arm
(`LAUNCHES["paged_attention_int8"]`, `LAUNCHES["qkv_rope_int8"]`) or
raises; it is never dequantized into the unquantized kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = [
    "KV_QUANT_MODES",
    "LAUNCHES",
    "LAUNCHES_AT_STEPS",
    "MAX_KERNEL_STEPS",
    "PAGE_ROWS",
    "decode_attention",
    "decode_attention_reference",
    "dequantize_gathered",
    "fused_qkv_paged_attention",
    "fused_qkv_paged_reference",
    "gather_paged_cache",
    "gather_paged_scales",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "qkv_rope_projection",
    "qkv_rope_reference",
    "quantize_kv_rows",
    "reset_launch_counts",
    "rope_tables",
    "rotate",
    "scatter_paged_rows",
    "split_qkv",
    "with_dump_block",
]

_NEG_INF = -1e30

# Rows per physical cache block: the paged pool's allocation quantum and
# the kernels' streaming block (the JAX package's PAGE_ROWS).
PAGE_ROWS = 128

# Decode-path query positions per call K1 and K2 take, and the widest
# step models/lm.py sends to the decode kernels (K7 takes any); wider
# chunks go through the gather + masked-attention path, as in JAX.
MAX_KERNEL_STEPS = 8

# K7's widest head, and the shared memory a CTA may have.
_K7_MAX_HEAD_DIM = 256
_MAX_SMEM = 232448

# Launch counts per kernel: each wrapper adds one where it launches its
# kernel, and nowhere else.
# The int8 arms count apart from the full-precision ones (a "sim" pool or
# weight is full precision and counts with those).
LAUNCHES = {
    "paged_attention": 0, "paged_attention_int8": 0, "qkv_rope": 0,
    "qkv_rope_int8": 0, "decode_attention": 0,
}
# K1's and K2's launches again, keyed (counter name, query steps): a
# speculative verify runs them at k+1 steps, its draft at 1.
LAUNCHES_AT_STEPS: dict[tuple[str, int], int] = {}

# Quantized KV storage modes (`LMConfig.kv_quant`): "int8" stores int8 rows
# with per-row f32 scales; "sim" stores full-precision rows with unit
# scales, the lossless arm that runs the same code.
KV_QUANT_MODES = ("int8", "sim")
_INT8_MAX = 127.0
# Per-row scale floor: an all-zero row quantizes to zeros under this scale
# instead of dividing by zero, and dequantizes to exactly zero.
_SCALE_TINY = 1e-12


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_AT_STEPS.clear()


def _count(arm: str, steps: int) -> None:
    LAUNCHES[arm] += 1
    LAUNCHES_AT_STEPS[arm, steps] = LAUNCHES_AT_STEPS.get((arm, steps), 0) + 1


# -- plain versions -----------------------------------------------------


def decode_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, index
) -> torch.Tensor:
    """Plain decode attention over a dense cache.

    q: [batch, heads, head_dim] or [batch, heads, steps, head_dim];
    k/v: [batch, kv_heads, cache_len, head_dim] with kv_heads dividing
    heads (query head i reads kv head i // group); index: int scalar or
    [batch] tensor. Position p is visible to query step r iff
    p <= index + r. Scores and the PV product accumulate in f32;
    probabilities round to v's dtype before the PV product, as in JAX."""
    single = q.dim() == 3
    if single:
        q = q[:, :, None, :]
    steps = q.shape[2]
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum(
        "bhsd,bhkd->bhsk", q.float(), k.float()
    ) * scale
    pos = torch.arange(k.shape[2], device=q.device)
    off = torch.arange(steps, device=q.device)
    index = torch.as_tensor(index, device=q.device)
    if index.dim() == 0:
        mask = (pos[None] <= (index + off)[:, None])[None, None]
    else:
        mask = (
            pos[None, None] <= (index[:, None] + off[None])[..., None]
        )[:, None]
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "bhsk,bhkd->bhsd", probs.to(v.dtype).float(), v.float()
    ).to(q.dtype)
    return out[:, :, 0] if single else out


def gather_paged_cache(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Dense slot-major view of a block pool: [num_blocks, kv_heads,
    PAGE_ROWS, head_dim] through [batch, nlog] -> [batch, kv_heads,
    nlog * PAGE_ROWS, head_dim]. A copy; reference and wide-prefill
    use only."""
    b, nlog = table.shape
    _, kvh, rows, d = pool.shape
    gathered = pool[table.long()]  # [b, nlog, kvh, rows, d]
    return gathered.permute(0, 2, 1, 3, 4).reshape(b, kvh, nlog * rows, d)


def with_dump_block(pool: torch.Tensor) -> torch.Tensor:
    """A copy of a pool (or scale pool) with one zero block appended: the
    dump block `scatter_paged_rows` aims the rows it drops at, past every
    block the table names."""
    return torch.cat([pool, pool.new_zeros((1, *pool.shape[1:]))])


def quantize_kv_rows(
    rows: torch.Tensor, quant: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """rows [..., head_dim] -> (stored [..., head_dim], scales [...] f32).

    "int8": symmetric per-row quantization, scale = amax / 127 in f32
    (floored at `_SCALE_TINY`), values rounded half to even and clipped
    to +-127, stored int8. "sim": the rows unchanged with unit scales
    (the lossless arm). The scatter casts `stored` to the pool dtype."""
    if quant == "int8":
        r32 = rows.float()
        amax = r32.abs().amax(dim=-1)
        scale = torch.clamp(amax / _INT8_MAX, min=_SCALE_TINY)
        q = torch.clamp(
            torch.round(r32 / scale[..., None]), -_INT8_MAX, _INT8_MAX
        ).to(torch.int8)
        return q, scale
    if quant == "sim":
        return rows, torch.ones(
            rows.shape[:-1], dtype=torch.float32, device=rows.device
        )
    raise ValueError(f"unknown kv quant mode {quant!r}")


def gather_paged_scales(
    scale_pool: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """Scale-side `gather_paged_cache`: [num_blocks, kv_heads, PAGE_ROWS]
    through [batch, nlog] -> [batch, kv_heads, nlog * PAGE_ROWS]."""
    b, nlog = table.shape
    _, kvh, rows = scale_pool.shape
    return scale_pool[table.long()].permute(0, 2, 1, 3).reshape(
        b, kvh, nlog * rows
    )


def dequantize_gathered(pool, scale_pool, table, dtype) -> torch.Tensor:
    """Dense DEQUANTIZED view: gather blocks and their scales through the
    table, multiply in f32, cast to `dtype`. With "sim" scales (all 1.0)
    the round trip is exact."""
    view = gather_paged_cache(pool, table).float()
    scales = gather_paged_scales(scale_pool, table)
    return (view * scales[..., None]).to(dtype)


def paged_decode_attention_reference(
    q, k_pool, v_pool, table, index, k_scales=None, v_scales=None,
) -> torch.Tensor:
    """Plain paged attention: gather each slot's blocks into a dense
    view (dequantized through the scale pools when given), then
    `decode_attention_reference`. Whatever unreferenced pool blocks hold
    is masked out."""
    if k_scales is not None:
        k_view = dequantize_gathered(k_pool, k_scales, table, q.dtype)
        v_view = dequantize_gathered(v_pool, v_scales, table, q.dtype)
    else:
        k_view = gather_paged_cache(k_pool, table)
        v_view = gather_paged_cache(v_pool, table)
    return decode_attention_reference(q, k_view, v_view, index)


def scatter_paged_rows(
    k_pool: torch.Tensor, v_pool: torch.Tensor,
    k: torch.Tensor, v: torch.Tensor,
    table: torch.Tensor, index: torch.Tensor,
    *,
    k_scale_pool: torch.Tensor | None = None,
    v_scale_pool: torch.Tensor | None = None,
    quant: str | None = None,
) -> tuple[torch.Tensor, ...]:
    """Write fresh K/V rows through the block table, IN PLACE.

    k/v: [batch, kv_heads, steps, head_dim] for positions
    index .. index+steps-1 of each slot. Rows at positions past the
    table's capacity (nlog * PAGE_ROWS) are DROPPED, never clipped: a
    clipped write would land in the slot's last real block and corrupt
    committed rows. Returns the (mutated) pools: (k_pool, v_pool), or
    with `quant` (k_pool, v_pool, k_scale_pool, v_scale_pool).

    With `quant` the rows quantize HERE (`quantize_kv_rows`), the one
    emit every paged writer passes through, and their scales land at the
    same (block, row) indices, dropped past capacity alike.

    The pool's LAST block is the dump block: no table names it
    (`PagedCache` allocates it past `paged_blocks`). Without a host sync
    (no boolean indexing), every row that must not land is aimed there
    instead: a dropped row, and a kept row that a later row of the same
    call writes over (slots parked on the scratch block 0 share its
    rows). So each (block, row) a table names takes the last of its
    writers in row order, as XLA's scatter writes them in order, on
    every device: two rows of one call never race for a location that
    anything reads."""
    kvh, page, hd = k_pool.shape[1:]
    bsz, _, steps, _ = k.shape
    nlog = table.shape[1]
    pos = (index.long()[:, None] + torch.arange(steps, device=k.device)).reshape(-1)
    logical = torch.clamp(pos // page, 0, nlog - 1).reshape(bsz, steps)
    phys = torch.gather(table.long(), 1, logical).reshape(-1)
    row = pos % page
    inside = pos < nlog * page
    # Sorted stably by location, a row is its location's last writer when
    # the next row in that order writes elsewhere.
    loc, order = torch.sort(torch.where(inside, phys * page + row, -1), stable=True)
    last = torch.ones_like(inside)
    last[:-1] = loc[:-1] != loc[1:]
    keep = torch.empty_like(inside)
    keep[order] = last
    phys = torch.where(keep & inside, phys, k_pool.shape[0] - 1)
    if quant is not None:
        k, k_scales = quantize_kv_rows(k, quant)
        v, v_scales = quantize_kv_rows(v, quant)
    for pool, new in ((k_pool, k), (v_pool, v)):
        rows = new.permute(0, 2, 1, 3).reshape(bsz * steps, kvh, hd)
        pool[phys, :, row, :] = rows.to(pool.dtype)
    if quant is None:
        return k_pool, v_pool
    for pool, new in ((k_scale_pool, k_scales), (v_scale_pool, v_scales)):
        pool[phys, :, row] = new.permute(0, 2, 1).reshape(bsz * steps, kvh)
    return k_pool, v_pool, k_scale_pool, v_scale_pool


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 cos/sin tables [*positions.shape, head_dim] in the HF
    half-split layout (the JAX `_rope_tables` and `apply_rope` angle
    math) for integer positions."""
    inv_freq = 1.0 / (
        theta ** (
            torch.arange(
                0, head_dim, 2, dtype=torch.float32, device=positions.device
            ) / head_dim
        )
    )
    angles = positions.float()[..., None] * inv_freq
    cos = torch.cat([torch.cos(angles)] * 2, dim=-1)
    sin = torch.cat([torch.sin(angles)] * 2, dim=-1)
    return cos, sin


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Half-split rotary from precomputed tables (pairs dimension i with
    i + head_dim/2): f32 math, result in x's dtype."""
    h = x.shape[-1] // 2
    rotated = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def split_qkv(qkv, index, *, num_heads, kv_heads, rope_theta=None):
    """Split a fused [batch, steps, (heads + 2 * kv_heads) * head_dim]
    projection at positions index .. index+steps-1 into q [batch, heads,
    steps, head_dim] and k, v [batch, kv_heads, steps, head_dim] ([q | k
    | v] column blocks), rotating q and k when `rope_theta` is set.
    index: a [batch] tensor, or a 0-d tensor shared by every row."""
    bsz, steps, dout = qkv.shape
    hd = dout // (num_heads + 2 * kv_heads)
    d, kd = num_heads * hd, kv_heads * hd
    q = qkv[..., :d].reshape(bsz, steps, num_heads, hd).transpose(1, 2)
    k = qkv[..., d:d + kd].reshape(bsz, steps, kv_heads, hd).transpose(1, 2)
    v = qkv[..., d + kd:].reshape(bsz, steps, kv_heads, hd).transpose(1, 2)
    if rope_theta is not None:
        pos = index.long()[..., None] + torch.arange(steps, device=qkv.device)
        cos, sin = rope_tables(pos, hd, rope_theta)
        if pos.dim() == 2:  # per-row positions: broadcast over heads
            cos, sin = cos[:, None], sin[:, None]
        q = rotate(q, cos, sin)
        k = rotate(k, cos, sin)
    return q, k, v


def qkv_rope_reference(
    x, w_qkv, b_qkv, index, *, num_heads, kv_heads, rope_theta=None,
    w_scale=None,
):
    """Plain version of K2, as the TPU kernel's `_project` stage
    computes it: qkv = (x @ w) in f32 (x `w_scale` per output channel
    for an int8 weight) + bias in f32, rounded to x's dtype, split and
    rotated. x: [batch, steps, d_model]; w_qkv: [d_model, d_model + 2 *
    kv_dim]. Returns q [batch, heads, steps, head_dim] and k_new, v_new
    [batch, kv_heads, steps, head_dim]."""
    qkv = x.float() @ w_qkv.float()
    if w_scale is not None:
        qkv = qkv * w_scale.float()
    if b_qkv is not None:
        qkv = qkv + b_qkv.float()
    q, k, v = split_qkv(
        qkv.to(x.dtype), index, num_heads=num_heads, kv_heads=kv_heads,
        rope_theta=rope_theta,
    )
    return q.contiguous(), k.contiguous(), v.contiguous()


def fused_qkv_paged_reference(
    x, w_qkv, b_qkv, k_pool, v_pool, table, index,
    *, num_heads, rope_theta=None,
    w_scale=None, k_scales=None, v_scales=None,
):
    """Plain version of the fused path, the unfused composition the JAX
    reference spells out: projection (in x's dtype) -> split/transpose
    -> rotary -> scatter into COPIES of the pools -> gather + plain
    paged attention. Returns (o, k_new, v_new); the caller's pools are
    not touched.

    `w_scale` marks an int8 weight: the product runs in f32, the scale
    multiplies it before the bias, and one rounding to x's dtype follows.
    `k_scales` / `v_scales` mark quantized pools: attention reads the
    dequantized view with the fresh rows placed at FULL precision at
    their positions (dropped past capacity), as the kernel injects
    them; they quantize only at the caller's scatter."""
    if w_scale is not None:
        qkv = (x.float() @ w_qkv.float()) * w_scale.float()
        if b_qkv is not None:
            qkv = qkv + b_qkv.float()
        qkv = qkv.to(x.dtype)
    else:
        qkv = x @ w_qkv
        if b_qkv is not None:
            qkv = qkv + b_qkv
    q, k, v = split_qkv(
        qkv, index, num_heads=num_heads, kv_heads=k_pool.shape[1],
        rope_theta=rope_theta,
    )
    if k_scales is not None:
        views = []
        for pool, scales, new in ((k_pool, k_scales, k), (v_pool, v_scales, v)):
            view = dequantize_gathered(pool, scales, table, x.dtype)
            bsz, kvh, cap, hd = view.shape
            # One spare row past capacity takes the dropped writes.
            view = torch.cat([view, view.new_zeros(bsz, kvh, 1, hd)], dim=2)
            pos = index.long()[:, None] + torch.arange(
                new.shape[2], device=x.device
            )
            pos = torch.where(pos < cap, pos, torch.full_like(pos, cap))
            bidx = torch.arange(bsz, device=x.device)[:, None]
            view[bidx, :, pos, :] = new.permute(0, 2, 1, 3).to(x.dtype)
            views.append(view[:, :, :cap])
        return decode_attention_reference(q, *views, index), k, v
    kp, vp = scatter_paged_rows(
        with_dump_block(k_pool), with_dump_block(v_pool), k, v, table, index
    )
    o = paged_decode_attention_reference(q, kp, vp, table, index)
    return o, k, v


# -- CUDA wrappers --------------------------------------------------------

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_P = ctypes.c_void_p
_I = ctypes.c_int


_FNS: dict[str, object] = {}


def _kernel_fn(source: str, name: str, argtypes):
    """The C entry point `name` of kernel library `source`, typed
    (built and loaded at its first use)."""
    fn = _FNS.get(name)
    if fn is None:
        from walkai_nos_tpu_torch.ops._build import load_kernels

        fn = getattr(load_kernels()[source], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code}")


def _suffix(t: torch.Tensor) -> str:
    if t.dtype not in _SUFFIX:
        raise TypeError(
            f"the CUDA kernels take bfloat16 or float32; got {t.dtype}"
        )
    return _SUFFIX[t.dtype]


def _require_cuda(*tensors) -> None:
    for t in tensors:
        if t is not None and t.device.type != "cuda":
            raise ValueError(
                "CUDA kernel inputs must all lie on the GPU; got a tensor "
                f"on {t.device}"
            )


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# K2's geometry (csrc/qkv_rope.cu): k rows per stage (the split quantum),
# rows a CTA holds, the most splits, and the CTAs per SM a call aims for.
_QKV_K_TILE = 64
_QKV_ROWS = 64
_QKV_MAX_SPLITS = 32
_QKV_CTAS_PER_SM = 3


def _qkv_geometry(d_model: int, heads: int, rows: int, sm_count: int):
    """K2's split of the k dimension: (k rows per split, splits, row
    blocks). A CTA owns one head's columns, up to `_QKV_ROWS` rows and
    one split; the splits give the call about `_QKV_CTAS_PER_SM` CTAs an
    SM, each a whole number of k tiles (the last split takes the rest).
    A function of the shapes and the SM count only, never of the data, so
    a row's result does not depend on what shares the launch."""
    mblocks = -(-rows // _QKV_ROWS)
    tiles = -(-d_model // _QKV_K_TILE)
    target = -(-_QKV_CTAS_PER_SM * sm_count // (heads * mblocks))
    per = -(-tiles // max(1, min(tiles, _QKV_MAX_SPLITS, target)))
    return per * _QKV_K_TILE, -(-tiles // per), mblocks


# The decode kernels' geometry (csrc/decode_mma.cuh): keys per tile of the
# bf16 arms and of K1's f32 arm, keys per tile of K7's f32 arm, query rows
# a bf16 CTA holds, and the most splits a cell may take.
_KEYS = 64
_K7_F32_KEYS = 32
_MMA_ROWS = 64
_MAX_SPLITS = 64
# CTAs per SM the split aims for: a call's splits fill the card about twice.
_CTAS_PER_SM = 2


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def _mma_smem_bytes(chunk: int, hd: int, int8_pool: bool, paged: bool,
                    nlog: int = 0) -> int:
    """Shared memory of a bf16-arm CTA holding `chunk` query rows
    (`mma_layout` in csrc/decode_mma.cuh): the cp.async ring of K/V tiles
    (later the warps' merge), the Q tile (rows padded by 16 bytes), the
    per-warp int8 widening buffers and the table entries."""
    dmax = 64 if hd <= 64 else 128 if hd <= 128 else 256
    stage = 2 * _KEYS * dmax * (1 if int8_pool else 2)
    stage += 2 * _KEYS * 4 if paged else 0
    ring = (4 if int8_pool else 3) * stage
    merge = 4 * 16 * (dmax + 2) * 4
    total = _r16(max(ring, merge))
    total += _r16(16 * -(-chunk // 16) * (dmax + 8) * 2)
    total += 4 * 2 * 16 * dmax * 2 if int8_pool else 0
    return total + (_r16(nlog * 4) if paged else 0)


def _fma_smem_bytes(chunk: int, hd: int, int8_pool: bool, paged: bool,
                    nlog: int = 0) -> int:
    """Shared memory of an f32-arm CTA (`fma_layout` in
    csrc/decode_mma.cuh): a two-stage ring of K/V tiles (K1: 64 keys, K7:
    32), f32 q, accumulator, scores and three row vectors."""
    keys = _KEYS if paged else _K7_F32_KEYS
    rs = _r16(hd) if int8_pool else -(-hd // 4) * 4 + 4
    stage = _r16(2 * keys * rs * (1 if int8_pool else 4)
                 + (2 * keys * 4 if paged else 0))
    total = _r16(2 * stage + (2 * chunk * hd + chunk * keys + 3 * chunk) * 4)
    return total + (_r16(nlog * 4) if paged else 0)


def _chunk(rows: int, hd: int, dtype, *, int8_pool=False, paged=False,
           nlog=0) -> int:
    """Query rows per CTA: up to 64 (the bf16 arms' four m16 tiles),
    halved until the CTA's shared memory fits."""
    size = _mma_smem_bytes if dtype == torch.bfloat16 else _fma_smem_bytes
    chunk = min(rows, _MMA_ROWS)
    while chunk > 1 and size(chunk, hd, int8_pool, paged, nlog) > _MAX_SMEM:
        chunk = -(-chunk // 2)
    return chunk


def _nsplit(ntiles: int, cells: int, device: torch.device,
            round_up: bool) -> int:
    """Splits of each cell's key tiles, so that the call's CTAs fill the
    card about `_CTAS_PER_SM` times: at most that (`round_up` False: no SM
    takes a third CTA, measured best for K7, whose dense cache is sized to
    the live length) or at least that (True: K1, whose table spans the
    slot's capacity while the visible range is often half of it). A
    function of the shapes and the card only; each split's share of the
    tiles is computed on the device from its own row's index, so a row's
    result depends on its own index and never on the other rows."""
    slots = _CTAS_PER_SM * _sm_count(device.index or 0)
    target = -(-slots // cells) if round_up else slots // cells
    return max(1, min(ntiles, target, _MAX_SPLITS))


# Cells of at most this many outputs (a CTA's chunk rows x head_dim) in
# the bf16 arms are combined by their last CTA to finish, chosen by a
# per-cell ticket; larger cells, and the f32 arms, by a second kernel.
_TICKET_OUTPUTS = 512

# The tickets, per device: int32 zeros that every call leaves zero. Calls
# on one device share them, so they run on one stream at a time.
_TICKETS: dict[int, torch.Tensor] = {}


def _tickets(cells: int, chunk: int, hd: int, dtype, device: torch.device):
    """The ticket buffer for a call whose last CTAs combine, or None."""
    if dtype != torch.bfloat16 or hd < 8 or chunk * hd > _TICKET_OUTPUTS:
        return None
    t = _TICKETS.get(device.index or 0)
    if t is None or t.numel() < cells:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the decode kernels' tickets must exist before CUDA graph "
                "capture: call the kernel once at this shape first"
            )
        t = torch.zeros(max(cells, 4096), dtype=torch.int32, device=device)
        _TICKETS[device.index or 0] = t
    return t


# K2's tickets, per device, apart from K1/K7's: int32 zeros that every call
# leaves zero. Calls on one device share them, so they run on one stream at
# a time.
_QKV_TICKETS: dict[int, torch.Tensor] = {}


def _qkv_tickets(cells: int, device: torch.device) -> torch.Tensor:
    t = _QKV_TICKETS.get(device.index or 0)
    if t is None or t.numel() < cells:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the QKV kernel's tickets must exist before CUDA graph "
                "capture: call the kernel once at this shape first"
            )
        t = torch.zeros(max(cells, 1024), dtype=torch.int32, device=device)
        _QKV_TICKETS[device.index or 0] = t
    return t


def _partials(b, kvh, nsplit, rows, hd, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(b, kvh, nsplit, rows, **f32),
            torch.empty(b, kvh, nsplit, rows, **f32),
            torch.empty(b, kvh, nsplit, rows, hd, **f32))


def _decode_attention_cuda(q, k, v, index):
    """Launch K7: the split kernel, then a combine kernel unless each
    cell's last CTA combines (`_tickets`). q [b, h, steps, hd]; k/v [b,
    kv_heads, cache_len, hd]; index a [1] (shared) or [b] (per-row) int32
    tensor on the device. The group * steps query rows of a kv head go to
    CTAs in chunks of at most 64 (`_chunk`); each cell's visible tiles go
    to `_nsplit` CTAs, each taking its share from its own row's index."""
    _require_cuda(q, k, v, index)
    b, h, steps, hd = q.shape
    kvh, cache_len = k.shape[1], k.shape[2]
    if k.shape != (b, kvh, cache_len, hd) or v.shape != k.shape:
        raise ValueError(
            f"cache shapes {tuple(k.shape)} / {tuple(v.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if h % kvh != 0:
        raise ValueError(f"heads {h} must be a multiple of kv_heads {kvh}")
    if not 1 <= hd <= _K7_MAX_HEAD_DIM:
        raise ValueError(
            f"decode_attention takes head_dim up to {_K7_MAX_HEAD_DIM}; "
            f"got {hd}"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q and the cache must share one dtype")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the K/V cache must be contiguous")
    per_row = index.dim() != 0
    if per_row and tuple(index.shape) != (b,):
        raise ValueError(
            f"index must be 0-d or [batch={b}]; got {tuple(index.shape)}"
        )
    idx = index.reshape(-1).to(torch.int32).contiguous()
    q = q.contiguous()
    rows = (h // kvh) * steps
    chunk = _chunk(rows, hd, q.dtype)
    cells = b * kvh * -(-rows // chunk)
    keys = _KEYS if q.dtype == torch.bfloat16 else _K7_F32_KEYS
    nsplit = _nsplit(-(-cache_len // keys), cells, q.device, round_up=False)
    m_part, l_part, acc_part = _partials(b, kvh, nsplit, rows, hd, q.device)
    tickets = _tickets(cells, chunk, hd, q.dtype, q.device)
    out = torch.empty_like(q)
    fn = _kernel_fn(
        "decode_attention", "decode_attention_" + _suffix(q),
        [_P] * 9 + [_I] * 9 + [ctypes.c_float, _P],
    )
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), None if tickets is None else tickets.data_ptr(),
        b, h, kvh, steps, hd, cache_len,
        nsplit, int(per_row), chunk, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check(code, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out


def decode_attention(q, k, v, index) -> torch.Tensor:
    """Decode attention over a dense cache (K7 on a CUDA tensor, the plain
    `decode_attention_reference` on a CPU tensor).

    q: [batch, heads, head_dim] or [batch, heads, steps, head_dim];
    k/v: [batch, kv_heads, cache_len, head_dim] with kv_heads dividing
    heads; index: an int, a 0-d tensor (every row at one position) or a
    [batch] tensor (ragged rows), read by the kernel on the device.
    Query step r sees positions p <= index + r. Any cache_len, group and
    steps; on the GPU head_dim up to 256, bf16 or f32 (a shape outside
    these raises, naming the limit)."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, index)
    if not torch.is_tensor(index):
        index = torch.tensor(int(index), dtype=torch.int32, device=q.device)
    single = q.dim() == 3
    out = _decode_attention_cuda(
        q[:, :, None, :] if single else q, k, v, index
    )
    return out[:, :, 0] if single else out


def _check_pool_scales(k_pool, v_pool, k_scales, v_scales) -> None:
    """Scales come both or neither, and an int8 pool comes with them."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales go together")
    if k_scales is None and torch.int8 in (k_pool.dtype, v_pool.dtype):
        raise ValueError(
            "an int8 pool needs its scale pools (k_scales / v_scales)"
        )
    if k_pool.dtype != v_pool.dtype:
        raise TypeError("the K and V pools must share one dtype")


def _vector_elems(t: torch.Tensor) -> int:
    """Elements of `t` per 16-byte load (8 bf16, 4 f32, 16 int8)."""
    return 16 // t.element_size()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it when its data does not start on 16 bytes (the
    kernels copy its rows with 16-byte cp.async)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _paged_attention_cuda(
    q, k_pool, v_pool, table, index, k_new, v_new,
    k_scales=None, v_scales=None,
):
    """Launch K1: the split kernel (each split takes its share of its own
    slot's visible tiles), then a combine kernel unless each cell's last
    CTA combines (`_tickets`). q [b, h, steps, hd];
    k_new/v_new None or [b, kv_heads, steps, hd] fresh rows injected at
    positions index .. index+steps-1; k/v_scales None or the f32
    [nb, kv_heads, PAGE_ROWS] scale pools of a quantized pool (int8, or
    q's dtype for the "sim" arm)."""
    _require_cuda(q, k_pool, v_pool, table, index, k_new, v_new, k_scales,
                  v_scales)
    _check_pool_scales(k_pool, v_pool, k_scales, v_scales)
    b, h, steps, hd = q.shape
    nb, kvh, page, _ = k_pool.shape
    if (page != PAGE_ROWS or k_pool.shape[3] != hd
            or hd % _vector_elems(k_pool) != 0):
        raise ValueError(
            f"pool shape {tuple(k_pool.shape)} does not match q, or "
            f"head_dim {hd} is not a multiple of "
            f"{_vector_elems(k_pool)} (one 16-byte load)"
        )
    if h % kvh != 0 or steps > MAX_KERNEL_STEPS:
        raise ValueError(
            f"heads {h} must be a multiple of kv_heads {kvh} and steps "
            f"{steps} <= {MAX_KERNEL_STEPS}"
        )
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged pools must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged pools must be 16-byte aligned")
    int8 = k_pool.dtype == torch.int8
    if not int8 and k_pool.dtype != q.dtype:
        raise TypeError("q and the pools must share one dtype (or int8 pools)")
    if k_scales is not None:
        for s in (k_scales, v_scales):
            if s.dtype != torch.float32 or tuple(s.shape) != (nb, kvh, page):
                raise ValueError(
                    f"scale pools must be f32 [{nb}, {kvh}, {page}]; got "
                    f"{s.dtype} {tuple(s.shape)}"
                )
        k_scales = _aligned(k_scales.contiguous())
        v_scales = _aligned(v_scales.contiguous())
    rows = (h // kvh) * steps
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new go together")
    if k_new is not None:
        k_new = _aligned(k_new.to(q.dtype).contiguous())
        v_new = _aligned(v_new.to(q.dtype).contiguous())
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    index = index.to(torch.int32).contiguous()
    nlog = table.shape[1]
    # The f32 arm holds all rows of a kv head in one CTA (its shared
    # memory bounds the group); the bf16 arms take 64 a CTA, more rows on
    # more CTAs.
    chunk = rows if q.dtype == torch.float32 else _chunk(
        rows, hd, q.dtype, int8_pool=int8, paged=True, nlog=nlog)
    cells = b * kvh * -(-rows // chunk)
    nsplit = _nsplit(nlog * PAGE_ROWS // _KEYS, cells, q.device, round_up=True)
    m_part, l_part, acc_part = _partials(b, kvh, nsplit, rows, hd, q.device)
    tickets = _tickets(cells, chunk, hd, q.dtype, q.device)
    out = torch.empty_like(q)
    arm = "paged_attention_int8" if int8 else "paged_attention"
    fn = _kernel_fn(
        "paged_attention",
        ("paged_attention_i8_" if int8 else "paged_attention_") + _suffix(q),
        [_P] * 14 + [_I] * 8 + [ctypes.c_float, _P],
    )
    code = fn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), index.data_ptr(),
        None if k_new is None else k_new.data_ptr(),
        None if v_new is None else v_new.data_ptr(),
        None if k_scales is None else k_scales.data_ptr(),
        None if v_scales is None else v_scales.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), None if tickets is None else tickets.data_ptr(),
        b, h, kvh, steps, hd, nlog,
        nsplit, chunk, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check(code, arm)
    _count(arm, steps)
    return out


def paged_decode_attention(
    q, k_pool, v_pool, table, index, *, k_scales=None, v_scales=None,
) -> torch.Tensor:
    """Paged decode attention (K1 on a CUDA tensor, the plain version on
    a CPU tensor). q: [batch, heads, head_dim] or [batch, heads, steps,
    head_dim]; k/v_pool: [num_blocks, kv_heads, PAGE_ROWS, head_dim];
    table: [batch, nlog] int physical block ids (every entry a valid
    block; idle slots park on block 0); index: [batch] int. A quantized
    pool (int8, or "sim" in q's dtype) comes with its f32 `k_scales` /
    `v_scales` [num_blocks, kv_heads, PAGE_ROWS]; an int8 pool without
    them raises."""
    _check_pool_scales(k_pool, v_pool, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, table, index, k_scales, v_scales
        )
    single = q.dim() == 3
    out = _paged_attention_cuda(
        q[:, :, None, :] if single else q, k_pool, v_pool, table, index,
        None, None, k_scales, v_scales,
    )
    return out[:, :, 0] if single else out


def qkv_rope_projection(
    x, w_qkv, b_qkv, index, *, num_heads, kv_heads, rope_theta=None,
    w_scale=None,
):
    """The decode step's QKV projection + bias + RoPE (K2 on a CUDA
    tensor, `qkv_rope_reference` on a CPU tensor). Returns (q, k_new,
    v_new) in the layouts of `qkv_rope_reference`. `w_scale` ([dout]
    f32) is the per-output-channel scale row of an int8 weight (or a
    row of ones beside a full-precision one, the "sim" arm); an int8
    weight without it raises."""
    if w_qkv.dtype == torch.int8 and w_scale is None:
        raise ValueError("an int8 w_qkv needs its w_scale row")
    if x.device.type == "cpu":
        return qkv_rope_reference(
            x, w_qkv, b_qkv, index, num_heads=num_heads,
            kv_heads=kv_heads, rope_theta=rope_theta, w_scale=w_scale,
        )
    _require_cuda(x, w_qkv, b_qkv, index, w_scale)
    bsz, steps, dm = x.shape
    dout = w_qkv.shape[1]
    heads = num_heads + 2 * kv_heads
    if w_qkv.shape[0] != dm or dout % heads != 0:
        raise ValueError(f"w_qkv shape {tuple(w_qkv.shape)} does not fit x")
    hd = dout // heads
    if hd == 0 or hd % _vector_elems(w_qkv) != 0 or hd > 128:
        raise ValueError(
            f"head_dim {hd} must be a multiple of {_vector_elems(w_qkv)} "
            f"(one 16-byte load) and <= 128"
        )
    int8 = w_qkv.dtype == torch.int8
    if (not int8 and w_qkv.dtype != x.dtype) or (
        b_qkv is not None and b_qkv.dtype != x.dtype
    ):
        raise TypeError(
            "x, w_qkv and b_qkv must share one dtype (or an int8 w_qkv)"
        )
    if not w_qkv.is_contiguous() or w_qkv.data_ptr() % 16:
        raise ValueError(
            "w_qkv must be contiguous ([d_model, dout]) and 16-byte aligned"
        )
    if w_scale is not None:
        if w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (dout,):
            raise ValueError(
                f"w_scale must be f32 [{dout}]; got {w_scale.dtype} "
                f"{tuple(w_scale.shape)}"
            )
        w_scale = w_scale.contiguous()
    x = x.contiguous()
    bias = None if b_qkv is None else b_qkv.contiguous()
    dev = x.device
    M = bsz * steps
    if rope_theta is not None and not rope_theta > 0:
        raise ValueError(f"rope_theta must be > 0; got {rope_theta}")
    index = index.to(torch.int32).contiguous()
    q = torch.empty(bsz, num_heads, steps, hd, dtype=x.dtype, device=dev)
    k = torch.empty(bsz, kv_heads, steps, hd, dtype=x.dtype, device=dev)
    v = torch.empty_like(k)
    k_per, ksplit, mblocks = _qkv_geometry(
        dm, heads, M, _sm_count(dev.index or 0))
    partial = tickets = None
    if ksplit > 1:
        cells = heads * mblocks
        partial = torch.empty(cells, ksplit, min(M, _QKV_ROWS), hd,
                              dtype=torch.float32, device=dev)
        tickets = _qkv_tickets(cells, dev)
    arm = "qkv_rope_int8" if int8 else "qkv_rope"
    fn = _kernel_fn(
        "qkv_rope", ("qkv_rope_i8_" if int8 else "qkv_rope_") + _suffix(x),
        [_P] * 5 + [ctypes.c_float] + [_P] * 5 + [_I] * 8 + [_P],
    )
    code = fn(
        x.data_ptr(), w_qkv.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if w_scale is None else w_scale.data_ptr(),
        index.data_ptr(), 0.0 if rope_theta is None else float(rope_theta),
        None if partial is None else partial.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        M, dm, num_heads, kv_heads, steps, hd, ksplit, k_per,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _check(code, arm)
    _count(arm, steps)
    return q, k, v


def fused_qkv_paged_attention(
    x, w_qkv, b_qkv, k_pool, v_pool, table, index,
    *, num_heads, rope_theta=None,
    w_scale=None, k_scales=None, v_scales=None,
):
    """Fused QKV projection + rotary + paged decode attention.

    x: [batch, steps <= MAX_KERNEL_STEPS, d_model]; w_qkv: [d_model,
    d_model + 2 * kv_dim] ([q | k | v] column blocks); b_qkv: [dout] or
    None; pools/table/index/scales as `paged_decode_attention`; `w_scale`
    as `qkv_rope_projection`. Returns (o [batch, heads, steps,
    head_dim], k_new, v_new [batch, kv_heads, steps, head_dim] in x's
    dtype): o already attends to the fresh rows, at full precision also
    over a quantized pool, and the CALLER scatters (and there quantizes)
    k_new/v_new into the pools. On a CUDA tensor: K2, then K1 with the
    fresh rows injected (their scale columns pinned to 1.0); on a CPU
    tensor: `fused_qkv_paged_reference`."""
    _check_pool_scales(k_pool, v_pool, k_scales, v_scales)
    if w_qkv.dtype == torch.int8 and w_scale is None:
        raise ValueError("an int8 w_qkv needs its w_scale row")
    if x.device.type == "cpu":
        return fused_qkv_paged_reference(
            x, w_qkv, b_qkv, k_pool, v_pool, table, index,
            num_heads=num_heads, rope_theta=rope_theta,
            w_scale=w_scale, k_scales=k_scales, v_scales=v_scales,
        )
    q, k_new, v_new = qkv_rope_projection(
        x, w_qkv, b_qkv, index, num_heads=num_heads,
        kv_heads=k_pool.shape[1], rope_theta=rope_theta, w_scale=w_scale,
    )
    o = _paged_attention_cuda(
        q, k_pool, v_pool, table, index, k_new, v_new, k_scales, v_scales
    )
    return o, k_new, v_new
