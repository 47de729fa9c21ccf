"""Autoregressive generation over a dense KV cache, per-row sampling for
the serving engine, and the cache bucket rule.

Port of `walkai_nos_tpu/models/decode.py`: `make_generate_fn` (one-shot
generation: a prefill, then chunks of `tokens_per_dispatch` decode steps
over one `cache_bucket`-sized `DenseCache`), `_sample`, `sample_rows`
and `cache_bucket`. The one deliberate difference is the random stream:
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

import dataclasses

import numpy as np
import torch

from walkai_nos_tpu_torch.device import resolve_device
from walkai_nos_tpu_torch.models.lm import DecoderLM, DenseCache, LMConfig

__all__ = ["cache_bucket", "gumbel_noise", "make_generate_fn", "sample_rows"]

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


def _sample(
    logits: torch.Tensor,
    temperature: float,
    seeds: torch.Tensor,
    counters: torch.Tensor,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """logits [batch, vocab] -> tokens [batch] (int64), with one set of
    knobs for the batch (the JAX `_sample`): greedy at temperature 0,
    else temperature sampling optionally truncated to the `top_k` most
    probable tokens and/or the `top_p` nucleus, drawn with the
    counter-based Gumbel noise of (row seed, counter)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0 or top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        threshold = torch.full_like(logits[:, :1], float("-inf"))
        if top_k > 0:
            threshold = torch.maximum(
                threshold, sorted_desc[:, top_k - 1:top_k]
            )
        if top_p < 1.0:
            cumulative = torch.cumsum(
                torch.softmax(sorted_desc, dim=-1), dim=-1
            )
            # Keep every token whose PRECEDING cumulative mass is < top_p
            # (always keeps the most probable token).
            keep = torch.cat(
                [torch.ones_like(cumulative[:, :1], dtype=torch.bool),
                 cumulative[:, :-1] < top_p],
                dim=-1,
            )
            inf = torch.full_like(sorted_desc, float("inf"))
            threshold = torch.maximum(threshold, torch.min(
                torch.where(keep, sorted_desc, inf), dim=-1, keepdim=True,
            ).values)
        logits = torch.where(
            logits < threshold, torch.full_like(logits, float("-inf")), logits
        )
    noise = gumbel_noise(seeds, counters, logits.shape[-1])
    return torch.argmax(logits + noise, dim=-1)


def make_generate_fn(
    cfg: LMConfig,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    tokens_per_dispatch: int | None = None,
    eos_id: int | None = None,
    device=None,
):
    """Build `generate(params, prompt, max_new_tokens, seed=0) -> tokens`
    (the JAX `make_generate_fn`, its validation errors included).

    `params`: a `DecoderLM` built for `cfg` (a trained master-weight
    build is copied to the compute dtype at each call, as a flax tree is
    bridged), or the JAX package's flax param tree (bridged onto
    `device`; None means `cuda`). `prompt`:
    [batch, prompt_len] ints (array or tensor); the result is an int64
    tensor [batch, max_new_tokens] on the model's device (prompt not
    repeated). prompt_len + max_new_tokens must fit `cfg.max_seq_len`;
    the cache holds `cache_bucket(prompt_len + max_new_tokens)` rows.

    One prefill writes the prompt and samples the first token; then the
    host runs chunks of `tokens_per_dispatch` decode steps (None: one
    chunk for the whole generation), the cache index advancing on the
    device, never read by the host. The last chunk may overshoot the
    budget; its writes clamp at the cache edge and the overshoot is
    trimmed. Chunking never changes the tokens.

    `eos_id`: a row that emits it keeps emitting it (masked on the
    device), and the host stops once every row is done, reading the
    done mask once per chunk.

    Sampling: greedy at temperature 0, else seeded counter-based draws
    (row r of the batch draws its n-th token with Gumbel noise keyed by
    (seed mixed with r, n)), with optional top-k / top-p truncation."""
    if temperature < 0.0:
        raise ValueError(
            f"temperature must be >= 0 (a negative one inverts the "
            f"distribution); got {temperature}"
        )
    if not 0 <= top_k <= cfg.vocab_size or not 0.0 < top_p <= 1.0:
        raise ValueError(
            f"top_k must be in [0, vocab_size={cfg.vocab_size}] and "
            f"top_p in (0, 1]; got {top_k}, {top_p}"
        )
    if tokens_per_dispatch is not None and tokens_per_dispatch < 1:
        raise ValueError(
            f"tokens_per_dispatch must be >= 1; got {tokens_per_dispatch}"
        )
    dev = resolve_device(device)

    def sample_next(logits, seeds, counters, done):
        nxt = _sample(logits, temperature, seeds, counters, top_k, top_p)
        if eos_id is not None:
            # A finished row keeps emitting eos_id: any chunking yields
            # the same tokens even when EOS lands mid-chunk.
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        return nxt, done

    @torch.inference_mode()
    def generate(params, prompt, max_new_tokens: int, seed: int = 0):
        model = DecoderLM.from_params(cfg, params, dev)
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64)
        batch, prompt_len = prompt.shape
        if prompt_len + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"prompt {prompt_len} + {max_new_tokens} new tokens "
                f"exceeds max_seq_len {cfg.max_seq_len}"
            )
        prompt = prompt.to(model.device)
        bucket = cache_bucket(prompt_len + max_new_tokens, cfg.max_seq_len)
        cache = DenseCache.zeros(
            dataclasses.replace(cfg, ragged_decode=False, cache_len=bucket),
            batch, model.device,
        )
        rows = torch.arange(batch, device=model.device, dtype=torch.int64)
        seeds = _mix(rows) ^ (seed & _M32)
        counters = torch.zeros(batch, dtype=torch.int64, device=model.device)
        done = torch.zeros(batch, dtype=torch.bool, device=model.device)
        logits = model(prompt, cache)
        tok, done = sample_next(logits[:, -1], seeds, counters, done)
        pieces = [tok[:, None]]  # the prefill-sampled first token
        remaining = max_new_tokens - 1
        chunk = tokens_per_dispatch or max(1, remaining)
        while remaining > 0:
            for _ in range(chunk):
                counters += 1
                logits = model(tok[:, None], cache)
                tok, done = sample_next(logits[:, -1], seeds, counters, done)
                pieces.append(tok[:, None])
            remaining -= chunk
            if eos_id is not None and remaining > 0 and bool(done.all()):
                # Every row finished: pad the budget with eos_id, what
                # further chunks would emit, minus the device time.
                pieces.append(torch.full(
                    (batch, remaining), eos_id, dtype=tok.dtype,
                    device=tok.device,
                ))
                remaining = 0
        return torch.cat(pieces, dim=1)[:, :max_new_tokens]

    return generate
