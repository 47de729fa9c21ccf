"""Speculative decoding: draft-model lookahead with exact verification.

Port of `walkai_nos_tpu/models/speculative.py`. A small draft model
proposes `k` tokens greedily; the target verifies all of them in ONE
forward of k+1 positions and keeps the longest prefix it agrees with,
plus its own next token. Greedy with exact-match acceptance: the output
is the target's greedy decoding for ANY draft; the draft buys speed (the
acceptance rate), never other tokens.

Position bookkeeping (cache index n = tokens 0..n-1 processed; the next
input is the last emitted token, at position n):

- a round feeds the target [cur, d_0 .. d_{k-1}] (positions n..n+k);
  its logits at position n+j predict P_j. For a GQA target a verify of
  k + 1 <= MAX_KERNEL_STEPS positions goes through the streamed dense
  decode kernel (`ops/decode_attention.decode_attention`, multi-step
  queries); a wider one through the model's masked cache attention, as
  in JAX;
- accept a = the longest prefix with d_j == P_j; emit P_0..P_a;
- both caches hold valid K/V through position n+a, so both indices
  rewind to n+a+1; stale rows past it are masked until overwritten.

What differs from the JAX function: the rounds run as a host loop in
place of `lax.while_loop`, so the host reads each round's acceptance
(one sync per round); the caches are written in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from walkai_nos_tpu_torch.device import resolve_device
from walkai_nos_tpu_torch.models.decode import cache_bucket
from walkai_nos_tpu_torch.models.lm import DecoderLM, DenseCache, LMConfig

__all__ = [
    "accept_tokens",
    "cache_positions",
    "make_speculative_generate_fn",
    "rewind_cache",
]


def rewind_cache(cache: DenseCache, new_index) -> DenseCache:
    """Set the cache's index to `new_index` (an int, a 0-d tensor, or a
    [batch] tensor for a ragged cache), in place, leaving the K/V rows as
    they are: stale rows past the index are masked until overwritten.
    Returns the cache."""
    cache.index.copy_(
        torch.as_tensor(new_index, device=cache.index.device)
        .to(cache.index.dtype).expand_as(cache.index)
    )
    return cache


def cache_positions(cache: DenseCache) -> torch.Tensor:
    """The cache's write head: its index (0-d, or [batch] when ragged)."""
    return cache.index


def accept_tokens(drafts: torch.Tensor, chosen: torch.Tensor):
    """The acceptance rule. drafts: [rows, k] draft tokens; chosen:
    [rows, k + 1] the target's token at each verified position. Per row:
    the longest prefix with drafts[j] == chosen[j] is accepted, and
    chosen[0..a] is emitted (the matched drafts plus the bonus token).

    Returns (accepted [rows], n_emit [rows], last [rows]): a in [0, k],
    a + 1 tokens to commit, and chosen[row, a] (the next round's input)."""
    rows, k = drafts.shape
    match = drafts == chosen[:, :k]
    # argmin over [match, False] is the first mismatch: k when every
    # draft matched (torch returns the first minimal index).
    pad = torch.zeros((rows, 1), dtype=torch.bool, device=drafts.device)
    a = torch.argmin(torch.cat([match, pad], dim=1).to(torch.int32), dim=1)
    n_emit = a + 1
    last = torch.gather(chosen, 1, a[:, None])[:, 0]
    return a, n_emit, last


def make_speculative_generate_fn(
    target_cfg: LMConfig,
    draft_cfg: LMConfig,
    *,
    k: int = 4,
    return_stats: bool = False,
    device=None,
):
    """Build `generate(target_params, draft_params, prompt,
    max_new_tokens) -> tokens` (greedy, exactly the target's greedy
    output). Params as `DecoderLM.from_params` takes them (on `device`,
    None meaning `cuda`); `prompt` is [1, prompt_len]; the result is an
    int64 tensor [1, max_new_tokens]. With `return_stats` it is
    `(tokens, {"acceptance_hist": [k + 1] int64 tensor})`: rounds per
    accepted prefix length."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            "target and draft must share a vocabulary "
            f"({target_cfg.vocab_size} != {draft_cfg.vocab_size})"
        )
    dev = resolve_device(device)

    @torch.inference_mode()
    def generate(target_params, draft_params, prompt, max_new_tokens: int):
        target = DecoderLM.from_params(target_cfg, target_params, dev)
        draft = DecoderLM.from_params(draft_cfg, draft_params, dev)
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64)
        batch, prompt_len = prompt.shape
        if batch != 1:
            raise ValueError(
                "speculative decoding is single-sequence (acceptance "
                f"length is data-dependent per row); got batch {batch}"
            )
        limit = min(target_cfg.max_seq_len, draft_cfg.max_seq_len)
        # The last round enters with emitted <= max_new - 1 and verifies
        # positions n..n+k, so indices stay < prompt + max_new + k.
        if prompt_len + max_new_tokens + k > limit:
            raise ValueError(
                f"prompt {prompt_len} + {max_new_tokens} new + {k} "
                f"lookahead exceeds max_seq_len {limit}"
            )
        bucket = cache_bucket(prompt_len + max_new_tokens + k, limit)

        def cache_for(model, cfg):
            cfg = dataclasses.replace(
                cfg, ragged_decode=False, cache_len=bucket
            )
            return DenseCache.zeros(cfg, 1, model.device)

        t_cache = cache_for(target, target_cfg)
        d_cache = cache_for(draft, draft_cfg)
        prompt = prompt.to(target.device)
        cur = torch.argmax(target(prompt, t_cache)[:, -1], dim=-1)  # [1]
        draft(prompt, d_cache)
        out = [cur]
        n, emitted = prompt_len, 1
        hist = torch.zeros(k + 1, dtype=torch.int64)
        while emitted < max_new_tokens:
            # 1. Draft k tokens; one extra step writes d_{k-1}'s K/V,
            # which the rewind point n+k+1 needs on full acceptance.
            tok, drafts = cur, []
            for _ in range(k):
                logits = draft(tok[:, None], d_cache)
                tok = torch.argmax(logits[:, -1], dim=-1)
                drafts.append(tok)
            drafts = torch.stack(drafts, dim=1)  # [1, k]
            draft(drafts[:, k - 1:], d_cache)
            # 2. The target verifies all k+1 positions in one forward.
            t_in = torch.cat([cur[:, None], drafts], dim=1)
            preds = torch.argmax(target(t_in, t_cache), dim=-1)  # [1, k+1]
            # 3. Acceptance; 4. emit and rewind both caches to n + a + 1.
            a, _, last = accept_tokens(drafts, preds)
            a = int(a[0])  # the round's one host sync
            out.append(preds[0, :a + 1])
            n += a + 1
            emitted += a + 1
            rewind_cache(t_cache, n)
            rewind_cache(d_cache, n)
            hist[a] += 1
            cur = last
        tokens = torch.cat(out)[None, :max_new_tokens]
        if return_stats:
            return tokens, {"acceptance_hist": hist}
        return tokens

    return generate
