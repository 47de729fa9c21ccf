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
  write the slot's state. `mirror_lane` writes the same rows into the
  draft model's pool (the speculative round's lane).
- `spec_round` is `spec_core`: one batched draft-and-verify round over
  every slot (k greedy draft steps, one target forward over k+1
  positions, exact-match acceptance), both write heads moving to the
  committed count.
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
A speculative round draws its verified position j with n + j, so a
committed token has the draw it would have had spec-off.

Multi-LoRA (`models/lora.py`): on an armed engine `SlotState` carries
per-slot adapter ids and each program takes the device LoRA tree
(`lora`): the decode chunk and the speculative verify apply each slot's
deltas, the lane each row's (pad rows id 0), and a finishing row writes
its id into its slot. The speculative draft stays the base model: the
exact-match acceptance keeps the committed stream the target's
whatever the draft proposed. Idle slots keep the last id they held, as
in JAX (their outputs are dropped).

Every update of `SlotState` is in place (`copy_`, `+=`, index writes on
the persistent tensors): the device-resident loop (`serve_graph.py`)
captures these programs into CUDA graphs, which replay on the same
storage.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from walkai_nos_tpu_torch.models.decode import sample_rows
from walkai_nos_tpu_torch.models.lm import DecoderLM, DenseCache, PagedCache
from walkai_nos_tpu_torch.models.speculative import accept_tokens

__all__ = [
    "SlotState", "admit_dense", "decode_chunk", "mirror_lane", "run_lane",
    "spec_round", "to_device",
]


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
    adapter: int = 0
    streamed: int = 0  # tokens handed out by drain_new_tokens


@dataclass
class _Prefill:
    """A request part-way through the prefill lane (the JAX engine's
    `_Prefill`): `consumed` prompt tokens written through `blocks`; the
    first `cached` tokens are shared prefix-index blocks it must never
    write; `pending` holds its own inserted index nodes awaiting their
    writing chunk; `resv` is its unallocated worst-case decode blocks;
    `sp` marks a long prompt of the sequence-parallel lane."""

    req: _Request
    slot: int
    blocks: list
    consumed: int = 0
    cached: int = 0
    nodes: list = field(default_factory=list)
    pending: list = field(default_factory=list)
    resv: int = 0
    sp: bool = False


@dataclass
class SlotState:
    """Per-slot device state: the cache, the per-slot cache index, the
    next input token, the sampling knobs, the draw counter, and on a
    LoRA-armed engine the adapter ids. With a `DenseCache` the index IS
    the cache's own (one tensor)."""

    cache: PagedCache | DenseCache
    index: torch.Tensor     # [slots] int32 cache index (write head)
    tokens: torch.Tensor    # [slots] int64 next input token
    temps: torch.Tensor     # [slots] f32
    topks: torch.Tensor     # [slots] int64
    topps: torch.Tensor     # [slots] f32
    seeds: torch.Tensor     # [slots] int64
    counters: torch.Tensor  # [slots] int64 tokens drawn so far
    adapters: torch.Tensor | None = None  # [slots] int64 (armed engines)

    @classmethod
    def zeros(
        cls, cache: PagedCache | DenseCache, slots: int, device,
        armed: bool = False,
    ) -> "SlotState":
        def z(dtype):
            return torch.zeros(slots, dtype=dtype, device=device)

        dense = isinstance(cache, DenseCache)
        index = cache.index if dense else z(torch.int32)
        return cls(
            cache, index, z(torch.int64), z(torch.float32),
            z(torch.int64), torch.ones(slots, device=device), z(torch.int64),
            z(torch.int64), z(torch.int64) if armed else None,
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
    model: DecoderLM, st: SlotState, table: torch.Tensor, chunk_steps: int,
    lora: dict | None = None,
) -> torch.Tensor:
    """Advance every slot `chunk_steps` tokens; returns [slots,
    1 + chunk_steps] int64 tokens (column 0 = the chunk's input).
    `table` None: the dense cache, which advances its own index. `lora`:
    the device LoRA tree of an armed engine, applied per slot."""
    first = st.tokens.clone()
    tok = first
    out = []
    adp = None if lora is None else (lora, st.adapters)
    for _ in range(chunk_steps):
        if table is None:
            logits = model(tok[:, None], st.cache)
        else:
            logits = model(tok[:, None], st.cache, table, st.index,
                           adapters=adp)
            st.index += 1
        tok = sample_rows(
            logits[:, -1].float(), st.temps, st.topks, st.topps,
            st.seeds, st.counters,
        )
        st.counters += 1
        out.append(tok)
    st.tokens.copy_(tok)
    return torch.stack([first] + out, dim=1)


@torch.inference_mode()
def spec_round(
    model: DecoderLM, draft: DecoderLM, st: SlotState, d_cache: PagedCache,
    table: torch.Tensor, k: int, lora: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One batched draft-and-verify round over every slot (JAX
    `spec_core`). Entering with both pools' write heads at idx0 =
    `st.index`: the draft proposes k tokens greedily (k single-step
    forwards through its own pool on the same table, plus one more that
    writes d_{k-1}'s K/V, needed at full acceptance); the target verifies
    all k+1 positions in one forward; position j samples with the draw
    counter + j, so the chain is what the plain chunk would draw;
    `accept_tokens` keeps the longest agreeing prefix plus the target's
    own next token. Both heads move to idx0 + n_emit (one index serves
    both pools); rows past the head are masked until overwritten. `lora`
    arms the target's verify only; the draft proposes from the base.

    Returns (emitted [slots, k+2] int64, n_emit [slots] int64): column 0
    is the round's input token, columns 1..k+1 the chosen chain, of
    which the first n_emit[s] are committed."""
    idx0 = st.index.clone()
    last = st.tokens.clone()
    d_idx = idx0.clone()
    tok, drafts = last, []
    for _ in range(k):
        logits = draft(tok[:, None], d_cache, table, d_idx)
        d_idx += 1
        tok = torch.argmax(logits[:, -1], dim=-1)
        drafts.append(tok)
    drafts = torch.stack(drafts, dim=1)  # [slots, k]
    draft(drafts[:, k - 1:], d_cache, table, d_idx)
    t_in = torch.cat([last[:, None], drafts], dim=1)
    t_logits = model(t_in, st.cache, table, idx0,
                     adapters=None if lora is None else (lora, st.adapters))
    chosen = torch.stack([
        sample_rows(
            t_logits[:, j].float(), st.temps, st.topks, st.topps,
            st.seeds, st.counters + j,
        )
        for j in range(k + 1)
    ], dim=1)  # [slots, k+1]
    _, n_emit, nxt = accept_tokens(drafts, chosen)
    st.index.copy_(idx0 + n_emit)
    st.tokens.copy_(nxt)
    st.counters += n_emit
    return torch.cat([last[:, None], chosen], dim=1), n_emit


@torch.inference_mode()
def run_lane(
    model: DecoderLM, st: SlotState, lane: dict, lora: dict | None = None
) -> None:
    """One prefill-lane forward. `lane` holds device tensors: `tok`
    [P, W], `start` [P], `table` [P, nlog], `true_len` [P] and the
    per-row knobs `temp`/`topk`/`topp`/`seed` [P]; `fin_rows` / `fin_slots`
    (host-built, possibly empty) name the rows that finish their prompt
    and the slots they flip; `rows` (a host int) is how many leading rows
    route through the MoE layers (the rows of JAX's lane). An armed
    engine passes `lora` and the lane its per-row ids `adapter` [P]."""
    tok = lane["tok"]
    logits = model(tok, st.cache, lane["table"], lane["start"],
                   moe_rows=lane["rows"],
                   adapters=None if lora is None else (lora, lane["adapter"]))
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
    if lora is not None:
        st.adapters[slots] = lane["adapter"][rows]


@torch.inference_mode()
def mirror_lane(draft: DecoderLM, d_cache: PagedCache, lane: dict) -> None:
    """The prefill lane's rows into the draft's pool (the JAX spec
    round's lane mirror): block b holds the same prompt rows in both
    pools, so a slot is draft-warm the moment it flips live. The rows
    are exactly the ones `run_lane` writes (pad rows start past the
    table and go to the dump block); the draft routes no experts."""
    draft(lane["tok"], d_cache, lane["table"], lane["start"])


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
