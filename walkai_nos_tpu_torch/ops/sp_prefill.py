"""The paged engine's streamed wide-prefill attention tail.

Port of `walkai_nos_tpu/ops/sp_prefill.py:streamed_cache_attention`
(:45-115). A wide prefill-lane chunk (more query steps than the decode
kernel takes) gathers each row's blocks into a dense cache view and
attends over it. The dense tail (`models/lm._masked_cache_attention`)
materializes a [rows, cache_len] score block per kv-head cell; this one
folds the cache in `tile`-row tiles through an online-softmax
accumulator, so a tile's [rows, tile] block is all that exists at once,
and it skips tiles wholly in every row's future.

The JAX function is XLA (a `fori_loop` over tiles with a `lax.cond`
skip), not a Pallas kernel, and so is this one: plain PyTorch on either
device. JAX streams its wide tail on the TPU; the port's engine keeps
the dense tail on both devices (`models/lm.py`), because on the H100
this tile loop, a dozen eager launches per tile, took about twice the
dense tail's time (PERF.md). It is the plain version a hand-written
tile kernel of the wide tail would be held to.

The skip needs the largest query position. JAX reads it on the device;
here the caller may pass it from the host (`horizon`), so the tile
count is a host int and no device value is read back. A fully masked
tile is an exact no-op for a row that has seen key 0 (p = 0, alpha =
1), so how many tiles past a row's own horizon are visited changes no
row's output, bit for bit.

`online_fold`, `online_finish` and `_NEG_INF` are the port's own copies
of `walkai_nos_tpu/ops/ring_attention.py:30-60`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["online_finish", "online_fold", "streamed_cache_attention"]

_NEG_INF = -1e30


def online_fold(acc, m_prev, l_prev, s, v):
    """One online-softmax fold: merge a masked f32 score block `s`
    ([..., q, k]) and its value block `v` ([..., k, d]) into the running
    (acc, m, l). Returns (acc, m_new, l_new)."""
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.matmul(p, v.float())
    return acc, m_new, l_new


def online_finish(acc, l):
    """Normalize an online-softmax accumulator into attention output."""
    return acc / l[..., None]


def streamed_cache_attention(q, k_all, v_all, idx, *, tile: int = 128,
                             horizon: int | None = None):
    """Masked attention over a full cache view, streamed tile by tile.

    q [batch, heads, steps, d]; k/v_all [batch, kv_heads, cache_len, d];
    idx [batch]: position p is visible to query row r iff p <= idx + r
    (the dense tail's contract). GQA queries group onto their kv head as
    [batch * kv_heads, group * steps, d]; scores and the accumulator are
    f32. Tiles t with t * tile > horizon are skipped; `horizon` is the
    largest query position (None: read from `idx` on the CPU, every tile
    on a CUDA tensor, so nothing syncs)."""
    batch, heads, steps, head_dim = q.shape
    kv_heads, cache_len = k_all.shape[1], k_all.shape[2]
    tile = max(1, min(int(tile), cache_len))
    pad = (-cache_len) % tile
    if pad:
        k_all = F.pad(k_all, (0, 0, 0, pad))
        v_all = F.pad(v_all, (0, 0, 0, pad))
    ntiles = (cache_len + pad) // tile
    scale = head_dim ** -0.5
    group = heads // kv_heads
    rows = group * steps
    cells = batch * kv_heads
    qg = q.reshape(cells, rows, head_dim).float()
    kg = k_all.reshape(cells, -1, head_dim)
    vg = v_all.reshape(cells, -1, head_dim)
    dev = q.device
    q_pos = idx.long().reshape(-1, 1) + torch.arange(steps, device=dev)
    q_pos_g = q_pos.expand(batch, steps)[:, None, None, :].expand(
        batch, kv_heads, group, steps
    ).reshape(cells, rows)
    if horizon is None:
        horizon = ntiles * tile - 1 if q.is_cuda else int(q_pos.max())
    visit = min(ntiles, horizon // tile + 1) if horizon >= 0 else 0
    acc = torch.zeros(cells, rows, head_dim, dtype=torch.float32, device=dev)
    m = torch.full((cells, rows), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(cells, rows, dtype=torch.float32, device=dev)
    for t in range(visit):
        k_t = kg[:, t * tile:(t + 1) * tile]
        v_t = vg[:, t * tile:(t + 1) * tile]
        k_pos = t * tile + torch.arange(tile, device=dev)
        s = torch.bmm(qg, k_t.float().transpose(1, 2)) * scale
        visible = (k_pos <= q_pos_g[:, :, None]) & (k_pos < cache_len)
        s = torch.where(visible, s, torch.full_like(s, _NEG_INF))
        acc, m, l = online_fold(acc, m, l, s, v_t)
    out = online_finish(acc, l).to(q.dtype)
    return out.reshape(batch, heads, steps, head_dim)
