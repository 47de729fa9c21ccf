"""Per-row sampling for the serving engine, and the cache bucket rule.

Port of `walkai_nos_tpu/models/decode.py:sample_rows` and
`cache_bucket`. The one deliberate difference is the random stream:
JAX draws from threefry keys split per token, which PyTorch cannot
reproduce. Here every draw is counter-based: the Gumbel noise for
(row seed, token counter, vocabulary column) comes from an integer hash
of those three numbers alone, so a request's samples depend on its seed
and on how many tokens it has drawn, never on the batch, the slot or the
device (integer arithmetic is exact on the CPU and the GPU alike).
Greedy rows (temperature 0) are the plain argmax and match JAX token for
token.
"""

from __future__ import annotations

import torch

__all__ = ["cache_bucket", "gumbel_noise", "sample_rows"]

_M32 = 0xFFFFFFFF
# Odd multiplier < 2**31 (a well-mixing 32-bit hash constant): every
# product of a 32-bit value with it stays below 2**63, so int64
# arithmetic never overflows.
_MUL = 0x45D9F3B


def cache_bucket(total_len: int, max_seq_len: int) -> int:
    """KV-cache length for a generation of `total_len` tokens: rounded
    up to a multiple of 128, capped at the model's context."""
    return min(max_seq_len, ((total_len + 127) // 128) * 128)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer avalanche hash on int64 tensors holding values in
    [0, 2**32)."""
    x = ((x ^ (x >> 16)) * _MUL) & _M32
    x = ((x ^ (x >> 16)) * _MUL) & _M32
    return x ^ (x >> 16)


def gumbel_noise(
    seeds: torch.Tensor, counters: torch.Tensor, vocab: int
) -> torch.Tensor:
    """[rows, vocab] f32 standard Gumbel noise keyed by (seed, counter,
    column) per row."""
    dev = seeds.device
    s = _mix((seeds.long() & _M32) ^ 0x9E3779B9)
    h = _mix(s ^ (counters.long() & _M32))[:, None]
    col = torch.arange(vocab, device=dev, dtype=torch.int64)[None]
    h = _mix(_mix(h ^ col) ^ 0x7F4A7C15)
    u = ((h >> 8).float() + 0.5) / 16777216.0  # (0, 1), 24 bits
    return -torch.log(-torch.log(u))


def sample_rows(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    seeds: torch.Tensor,
    counters: torch.Tensor,
) -> torch.Tensor:
    """Per-row sampling: greedy at temperature 0, else temperature
    sampling with optional top-k (0 = off) and nucleus (1.0 = off)
    truncation, with the JAX function's threshold rules. logits
    [rows, vocab] f32; temperature/top_p f32 [rows]; top_k int [rows];
    seeds/counters int [rows] name each row's draw. Returns int64
    [rows]."""
    rows, vocab = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    t = torch.where(
        temperature > 0, temperature, torch.ones_like(temperature)
    )[:, None]
    scaled = logits / t
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(
        sorted_desc, 1, torch.clamp(top_k.long() - 1, 0, vocab - 1)[:, None]
    )
    neg_inf = torch.full_like(kth, float("-inf"))
    threshold = torch.where(top_k[:, None] > 0, kth, neg_inf)
    cumulative = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    keep = torch.cat(
        [
            torch.ones((rows, 1), dtype=torch.bool, device=logits.device),
            cumulative[:, :-1] < top_p[:, None],
        ],
        dim=-1,
    )
    p_thr = torch.min(
        torch.where(keep, sorted_desc, torch.full_like(sorted_desc, float("inf"))),
        dim=-1, keepdim=True,
    ).values
    threshold = torch.maximum(
        threshold, torch.where(top_p[:, None] < 1.0, p_thr, neg_inf)
    )
    scaled = torch.where(
        scaled < threshold, torch.full_like(scaled, float("-inf")), scaled
    )
    sampled = torch.argmax(scaled + gumbel_noise(seeds, counters, vocab), dim=-1)
    return torch.where(temperature > 0, sampled, greedy)
