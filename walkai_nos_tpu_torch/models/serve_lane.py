"""The serving engine's device programs and records.

`models/serve.py` owns the host logic (admission, block books, commit);
this module holds what runs on the device per dispatch, with the JAX
engine's semantics (`walkai_nos_tpu/models/serve.py`):

- `decode_chunk` is `_decode_scan`: every slot advances `chunk_steps`
  single-token steps, sampling each token, and the chunk returns
  [slots, 1 + chunk_steps] tokens whose column 0 is the chunk's input
  token (how the host learns a newly live slot's first token). Paged:
  through the block table; dense (no table): over the engine's ragged
  `DenseCache`, whose per-slot index the forward advances.
- `run_lane` is `target_lane`: the prefill lane's [P, W] prompt chunks,
  each row at its own start position through its own block table;
  rows that finish their prompt sample the slot's first token and
  write the slot's state.
- `admit_dense` is the dense engine's `prefill` + `admit` programs: one
  request's prompt, padded to its bucket, prefilled at batch 1 straight
  into its slot's rows of the dense cache; the slot's index is set to
  the true length and its first token sampled.

Shapes are fixed by `slots`, `prefill_lanes` and `prefill_chunk` (the
lane always runs all `prefill_lanes` rows over the full table width),
or by the prompt bucket (dense admission), so a row's output never
depends on what shares the dispatch, even through stock GEMMs. The one
exception is JAX's own: an MoE layer with a capacity that drops tokens
routes the rows of one call together, so there a row's output depends
on the other rows JAX would route with it (ROADMAP §3). The caches are
updated in place (JAX donates them).

Sampling is counter-based (`models/decode.py`): slot s draws token n of
its request with (seed, n); the lane draws the first token with n = 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from walkai_nos_tpu_torch.models.decode import sample_rows
from walkai_nos_tpu_torch.models.lm import DecoderLM, DenseCache, PagedCache

__all__ = ["SlotState", "admit_dense", "decode_chunk", "run_lane", "to_device"]


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray  # [len] int32
    max_new_tokens: int
    eos_id: int | None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    tokens: list = field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    completed_at: float = 0.0
    truncated: bool = False
    trace_id: str | None = None


@dataclass
class _Prefill:
    """A request part-way through the prefill lane (the JAX engine's
    `_Prefill`): `consumed` prompt tokens written through `blocks`; the
    first `cached` tokens are shared prefix-index blocks it must never
    write; `pending` holds its own inserted index nodes awaiting their
    writing chunk; `resv` is its unallocated worst-case decode blocks."""

    req: _Request
    slot: int
    blocks: list
    consumed: int = 0
    cached: int = 0
    nodes: list = field(default_factory=list)
    pending: list = field(default_factory=list)
    resv: int = 0


@dataclass
class SlotState:
    """Per-slot device state: the cache, the per-slot cache index, the
    next input token, the sampling knobs, and the draw counter. With a
    `DenseCache` the index IS the cache's own (one tensor)."""

    cache: PagedCache | DenseCache
    index: torch.Tensor     # [slots] int32 cache index (write head)
    tokens: torch.Tensor    # [slots] int64 next input token
    temps: torch.Tensor     # [slots] f32
    topks: torch.Tensor     # [slots] int64
    topps: torch.Tensor     # [slots] f32
    seeds: torch.Tensor     # [slots] int64
    counters: torch.Tensor  # [slots] int64 tokens drawn so far

    @classmethod
    def zeros(
        cls, cache: PagedCache | DenseCache, slots: int, device
    ) -> "SlotState":
        def z(dtype):
            return torch.zeros(slots, dtype=dtype, device=device)

        dense = isinstance(cache, DenseCache)
        index = cache.index if dense else z(torch.int32)
        return cls(
            cache, index, z(torch.int64), z(torch.float32),
            z(torch.int64), torch.ones(slots, device=device), z(torch.int64),
            z(torch.int64),
        )


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without stalling the stream: CUDA
    uploads go through pinned memory, asynchronously."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@torch.inference_mode()
def decode_chunk(
    model: DecoderLM, st: SlotState, table: torch.Tensor, chunk_steps: int
) -> torch.Tensor:
    """Advance every slot `chunk_steps` tokens; returns [slots,
    1 + chunk_steps] int64 tokens (column 0 = the chunk's input).
    `table` None: the dense cache, which advances its own index."""
    first = st.tokens
    tok = first
    out = []
    for _ in range(chunk_steps):
        if table is None:
            logits = model(tok[:, None], st.cache)
        else:
            logits = model(tok[:, None], st.cache, table, st.index)
            st.index += 1
        tok = sample_rows(
            logits[:, -1].float(), st.temps, st.topks, st.topps,
            st.seeds, st.counters,
        )
        st.counters += 1
        out.append(tok)
    st.tokens = tok
    return torch.stack([first] + out, dim=1)


@torch.inference_mode()
def run_lane(model: DecoderLM, st: SlotState, lane: dict) -> None:
    """One prefill-lane forward. `lane` holds device tensors: `tok`
    [P, W], `start` [P], `table` [P, nlog], `true_len` [P] and the
    per-row knobs `temp`/`topk`/`topp`/`seed` [P]; `fin_rows` / `fin_slots`
    (host-built, possibly empty) name the rows that finish their prompt
    and the slots they flip; `rows` (a host int) is how many leading rows
    route through the MoE layers (the rows of JAX's lane)."""
    tok = lane["tok"]
    logits = model(tok, st.cache, lane["table"], lane["start"],
                   moe_rows=lane["rows"])
    rows, slots = lane["fin_rows"], lane["fin_slots"]
    if rows.numel() == 0:
        return
    true_len = lane["true_len"][rows]
    last = torch.clamp(true_len - lane["start"][rows] - 1, 0, tok.shape[1] - 1)
    fl = logits[rows, last].float()
    seed = lane["seed"][rows]
    first = sample_rows(
        fl, lane["temp"][rows], lane["topk"][rows], lane["topp"][rows],
        seed, torch.zeros_like(seed),
    )
    st.index[slots] = true_len
    st.tokens[slots] = first
    st.temps[slots] = lane["temp"][rows]
    st.topks[slots] = lane["topk"][rows]
    st.topps[slots] = lane["topp"][rows]
    st.seeds[slots] = seed
    st.counters[slots] = 1


@torch.inference_mode()
def admit_dense(
    model: DecoderLM, st: SlotState, slot: int, prompt: torch.Tensor,
    true_len: int, knobs: dict,
) -> None:
    """Prefill one request into `slot` of the dense engine. `prompt`:
    [1, bucket] device tokens (the prompt padded to its bucket); the rows
    land in the slot's rows of the cache (rows past the bucket keep what
    they held: masked until rewritten, as every write precedes its
    read). `knobs`: the request's `temp`/`topk`/`topp`/`seed` as
    one-element device tensors. Sets the slot's index to the true length
    (the padded rows are hidden until decoding overwrites them) and
    samples its first token with counter 0 from the last TRUE position."""
    logits = model(prompt, st.cache.row(slot))
    first = sample_rows(
        logits[:, true_len - 1].float(), knobs["temp"], knobs["topk"],
        knobs["topp"], knobs["seed"], torch.zeros_like(knobs["seed"]),
    )
    st.index[slot] = true_len
    st.tokens[slot] = first[0]
    st.temps[slot] = knobs["temp"][0]
    st.topks[slot] = knobs["topk"][0]
    st.topps[slot] = knobs["topp"][0]
    st.seeds[slot] = knobs["seed"][0]
    st.counters[slot] = 1
