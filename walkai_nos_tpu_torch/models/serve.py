"""Continuous batching for LM serving over a paged or a dense KV cache.

Port of `walkai_nos_tpu/models/serve.py:ContinuousBatcher` in its
default mode (`paged=True`, `prefix_cache=True`) and its dense mode
(`paged=False`): a fixed pool of `slots` sequences advances together
through one decode program; requests join at dispatch boundaries and
leave at EOS or their budget, without stopping the batch.

- **Paged KV cache**: each layer's K/V live in a shared pool of 128-row
  blocks (`models/lm.PagedCache`); the host owns a per-slot block table
  (`models/block_pool.py`) uploaded per dispatch. Block 0 is the scratch
  block idle slots write into; one more block past `pool_blocks` takes
  the writes the scatter drops (`scatter_paged_rows`).
- **Chunked prefill lane**: up to `prefill_lanes` admitted requests each
  write `prefill_chunk` prompt tokens per dispatch, after every live
  slot's decode chunk in the same dispatch; the final chunk samples the
  first token and the slot flips live.
- **Shared-prefix reuse** (`prefix_cache=True`): full 128-token prompt
  blocks are indexed in a radix trie (`models/prefix_cache.py`);
  admission maps every matched block to the existing physical block,
  released prefix blocks park (LRU) and are evicted only under
  pressure. Decode blocks are grabbed lazily at 128-row boundaries
  against a virtual worst-case reservation.
- **Dense mode** (`paged=False`, the exactness baseline): one
  `DenseCache` of `slots x cache_len` rows with a per-slot index, and
  blocking admission: each request is prefilled alone at its bucket
  (`prompt_bucket`, or the smallest power of two that fits) straight
  into its slot's rows, then decodes with the others through the dense
  decode kernel's per-row arm.
- **Pipelined stepping**: the host keeps one chunk in flight and reads
  the previous chunk's tokens while the device computes the next.
- **Device-resident loop** (`loop_steps` > 1, paged only): with no
  admission pending, one dispatch folds up to `loop_steps` decode chunks
  (or speculative rounds) and exits on the first condition the host must
  see (`models/serve_graph.py`: a CUDA graph on the card, one replay and
  one sync a fold). `loop_stats()` reports the folds.
- **Speculative rounds** (`spec=True`, paged only): a draft model with
  its own paged pool of the same block count (one physical block id
  names a (target, draft) pair, so the host keeps one set of books)
  proposes `spec_k` tokens per slot, the target verifies them in one
  forward of k+1 positions, and each slot commits its accepted prefix
  plus the target's next token (`serve_lane.spec_round`). Rounds are
  synchronous; an acceptance controller halves k, then turns drafting
  off for the engine's lifetime. `spec_stats()` reports them.
- **Quantized storage** (`LMConfig.kv_dtype` / `w_dtype`, "int8" or
  "int8-sim"): int8 paged pools with per-row f32 scale pools (paged mode
  only), and int8 projection weights with per-output-channel scales. A
  flax tree is quantized at build (`quantize_lm_params`, on the engine's
  own copy; idempotent), the draft's too; a `DecoderLM` must already be
  built for the config. `quant_stats()` reports what the knobs did.

What differs from the JAX engine, and why:

- Device programs run eagerly (PyTorch) instead of under `jit`, except
  the folds of the device-resident loop (CUDA graphs); the pools are
  written in place where JAX donates buffers.
- Every device program's shapes are fixed by `slots`, `prefill_lanes`
  and `prefill_chunk`: the lane always runs `prefill_lanes` rows over
  the full table width (JAX rounds both to powers of two); a dense
  admission's by its prompt bucket, the dense decode by `slots` and
  `cache_len`. With fixed
  shapes a row's output does not depend on what else shares the
  dispatch, even through stock GEMMs for the MLP and the LM head — the
  engine's defining invariant (ARCHITECTURE.md, capture & replay). An
  MoE layer routes the tokens JAX's call routes (the lane's first
  `rows`, a power of two of the rows in use; every slot in a decode
  step or a verify), so under capacity drops a row depends on the batch
  in both engines, as in JAX's.
- Sampled streams are counter-based (`models/decode.py`), not JAX's
  threefry bits; greedy streams match the JAX engine token for token.
- The engine's features of later slices raise NotImplementedError at
  construction: `adapters`, `sp_prefill`, `capture`, and the `obs`
  telemetry planes, as does any of their options (`sp_*`, `slo_*`) set
  to other than its JAX default, and `prompt_bucket` in paged mode,
  where it does nothing (the engine keeps only the counters its stats
  views read, `models/serve_stats.py`).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from collections.abc import Mapping

import numpy as np
import torch

from walkai_nos_tpu_torch.models.block_pool import BlockPool
from walkai_nos_tpu_torch.models.lm import (
    DecoderLM,
    DenseCache,
    LMConfig,
    PagedCache,
    quantize_lm_params,
)
from walkai_nos_tpu_torch.models.prefix_cache import PrefixIndex
from walkai_nos_tpu_torch.models.serve_graph import LOOP_EXITS, DecodeLoop
from walkai_nos_tpu_torch.models.serve_lane import (
    SlotState,
    _Prefill,
    _Request,
    admit_dense,
    decode_chunk,
    mirror_lane,
    run_lane,
    spec_round,
    to_device,
)
from walkai_nos_tpu_torch.models.serve_stats import EngineStats
from walkai_nos_tpu_torch.ops.decode_attention import MAX_KERNEL_STEPS, PAGE_ROWS

__all__ = ["ContinuousBatcher"]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


class ContinuousBatcher:
    """Continuous-batching engine over a slot pool.

        engine = ContinuousBatcher(cfg, params, slots=8, cache_len=256)
        rid = engine.submit(prompt_ids, max_new_tokens=64, eos_id=2)
        results = engine.run()   # {rid: [token, ...]}

    `params` is the JAX package's flax param tree as nested numpy arrays
    (bridged by `models/convert.py`), or a `DecoderLM` built for `cfg`
    (a serving build's weights are shared, not copied; a trained
    master-weight build is copied once to the compute dtype;
    `DecoderLM(cfg, seed=...)` makes random ones). `device=None` means
    `cuda`; pass `device="cpu"`
    for the plain PyTorch path. Argument names are the JAX engine's."""

    def __init__(
        self,
        cfg: LMConfig,
        params,
        *,
        slots: int = 8,
        cache_len: int | None = None,
        prompt_bucket: int = 16,
        chunk_steps: int = 8,
        loop_steps: int = 1,
        paged: bool = True,
        pool_blocks: int | None = None,
        prefill_chunk: int = 64,
        prefill_lanes: int = 4,
        sp_prefill: bool = False,
        sp_min_tokens: int = 2048,
        sp_span: int = 0,
        prefix_cache: bool = True,
        spec: bool = False,
        spec_k: int = 4,
        draft_cfg: LMConfig | None = None,
        draft_params=None,
        spec_min_accept: float = 0.35,
        spec_warmup_rounds: int = 16,
        spec_ema_alpha: float = 0.25,
        obs: bool = True,
        slo_window_s: float = 30.0,
        slo_objectives: dict | None = None,
        capture=None,
        adapters=None,
        device=None,
    ) -> None:
        for on, what, item in (
            (adapters is not None, "adapters", "LoRA"),
            (sp_prefill, "sp_prefill=True", "sp_prefill"),
            (capture is not None, "capture", "capture"),
            (not isinstance(obs, bool) or slo_objectives is not None
             or slo_window_s != 30.0, "the obs telemetry planes", "obs"),
            # The options of those features keep their JAX names; set to
            # anything but the JAX default they raise, never sit inert.
            (paged and prompt_bucket != 16,
             "prompt_bucket in paged mode (a dense-engine option)",
             "engine features"),
            ((sp_min_tokens, sp_span) != (2048, 0), "the sp_prefill options",
             "sp_prefill"),
        ):
            if on:
                raise _not_ported(what, item)
        if loop_steps < 1:
            raise ValueError(f"loop_steps must be >= 1; got {loop_steps}")
        if loop_steps > 1 and not paged:
            raise ValueError(
                "loop_steps > 1 requires the paged engine (the "
                "device-resident loop pre-backs per-slot block tables "
                "to its horizon; the dense cache has no table)"
            )
        if cfg.kv_dtype != "model" and not paged:
            raise ValueError(
                f"kv_dtype={cfg.kv_dtype!r} requires the paged engine "
                f"(the per-row scale pools parallel the block pool; "
                f"the dense cache has none)"
            )
        cache_len = cache_len or cfg.max_seq_len
        if prompt_bucket > cache_len:
            raise ValueError(
                f"prompt_bucket {prompt_bucket} exceeds cache_len "
                f"{cache_len}: prefilled rows would not fit the cache"
            )
        self.slots = slots
        self.cache_len = cache_len
        self.prompt_bucket = prompt_bucket
        self.chunk_steps = chunk_steps
        self.loop_steps = loop_steps
        self.paged = paged
        self._nlog = -(-cache_len // PAGE_ROWS)
        self.obs = EngineStats()
        if paged:
            self.pool_blocks = pool_blocks or slots * self._nlog + 1
            if self.pool_blocks < 2:
                raise ValueError(
                    f"pool_blocks must be >= 2 (block 0 is the reserved "
                    f"scratch block); got {self.pool_blocks}"
                )
            self.prefill_chunk = max(1, min(prefill_chunk, cache_len))
            self.prefill_lanes = max(1, prefill_lanes)
            self.cfg = dataclasses.replace(
                cfg, ragged_decode=True, cache_len=cache_len,
                paged_decode=True, paged_blocks=self.pool_blocks,
            )
            self.pool = BlockPool(
                slots=slots, cache_len=cache_len,
                pool_blocks=self.pool_blocks,
                prefix=PrefixIndex(PAGE_ROWS) if prefix_cache else None,
                obs=self.obs,
            )
            self.pool.set_gauges()
        else:
            self.pool_blocks = 0
            self.prefill_lanes = 1  # admissions prefill one at a time
            self.cfg = dataclasses.replace(
                cfg, ragged_decode=True, cache_len=cache_len
            )
            self.pool = None
        # Speculative serving (paged only): the draft holds its own paged
        # pool with the same block count, addressed through the same
        # host tables.
        self._spec = bool(spec)
        if self._spec:
            if not paged:
                raise ValueError(
                    "spec=True requires the paged engine (per-slot "
                    "write heads are what make variable-length "
                    "acceptance per row possible)"
                )
            if draft_cfg is None or draft_params is None:
                raise ValueError(
                    "spec=True needs draft_cfg and draft_params "
                    "(models/lm.py:draft_config builds a compatible one)"
                )
            if not 1 <= spec_k <= MAX_KERNEL_STEPS - 1:
                raise ValueError(
                    f"spec_k must be in [1, {MAX_KERNEL_STEPS - 1}] "
                    f"(k+1 verify positions ride the multi-step decode "
                    f"kernel); got {spec_k}"
                )
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "target and draft must share a vocabulary "
                    f"({cfg.vocab_size} != {draft_cfg.vocab_size})"
                )
            if draft_cfg.max_seq_len < cache_len:
                raise ValueError(
                    f"draft max_seq_len {draft_cfg.max_seq_len} is "
                    f"shorter than cache_len {cache_len}: the draft "
                    f"cache tracks the target's positions row for row"
                )
            self._draft_cfg = dataclasses.replace(
                draft_cfg, ragged_decode=True, cache_len=cache_len,
                paged_decode=True, paged_blocks=self.pool_blocks,
                tp_devices=1,
            )
        self._spec_k = spec_k
        self._k_now = spec_k
        self._spec_on = self._spec  # the controller may turn it off, once
        self._spec_min_accept = spec_min_accept
        self._spec_warmup = max(1, spec_warmup_rounds)
        self._spec_alpha = spec_ema_alpha
        self._spec_ema: float | None = None
        self._spec_rounds_seen = 0
        # Weight quantization: a flax tree transforms once, here, into a
        # new tree (the caller's is left alone).
        t_quant = time.monotonic()
        if isinstance(params, Mapping):
            params = quantize_lm_params(params, self.cfg)
        if self._spec and isinstance(draft_params, Mapping):
            draft_params = quantize_lm_params(draft_params, self._draft_cfg)
        self._quant_seconds = time.monotonic() - t_quant
        self.model = DecoderLM.from_params(self.cfg, params, device)
        self.device = self.model.device
        cache = (
            PagedCache.zeros(self.cfg, self.device) if paged
            else DenseCache.zeros(self.cfg, slots, self.device)
        )
        self._state = SlotState.zeros(cache, slots, self.device)
        self._draft = self._d_cache = None
        if self._spec:
            self._draft = DecoderLM.from_params(
                self._draft_cfg, draft_params, self.device
            )
            self._d_cache = PagedCache.zeros(self._draft_cfg, self.device)
            self.obs.spec_k_gauge.set(spec_k)
            self.obs.spec_disabled.set(0)
        self._loop = None
        if loop_steps > 1:
            self._loop = DecodeLoop(
                self.model, self._state, slots=slots, nlog=self._nlog,
                loop_steps=loop_steps, chunk_steps=chunk_steps,
                draft=self._draft, d_cache=self._d_cache,
                spec_k=spec_k if self._spec else 0,
            )
        # Trailing run averages behind the cb_loop_steps_per_sync gauge.
        self._loop_sync_n = 0
        self._loop_steps_acc = 0
        self._requests: dict[int, _Request] = {}
        self._draining = False
        self._pending: deque[_Request] = deque()
        self._slot_req: list[_Request | None] = [None] * slots
        self._slot_new: list[bool] = [False] * slots
        self._next_rid = 0
        self._budget = np.zeros(slots, np.int64)
        self._prefilling: list[_Prefill] = []
        # In-flight chunk: (host copy of its tokens, ready event or
        # None, slot->request snapshot, "first token expected" flags).
        self._inflight: tuple | None = None

    # -- requests ----------------------------------------------------------

    def submit(
        self,
        prompt,
        *,
        max_new_tokens: int,
        eos_id: int | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int | None = None,
        trace_id: str | None = None,
        adapter: int = 0,
    ) -> int:
        """Queue a generation; returns a request id. Greedy at
        temperature 0, else seeded sampling (`seed` defaults to the
        request id). Rejections raise ValueError and count under the
        JAX engine's reasons: bad_request | oversize_reject |
        pool_overflow | draining."""
        if self._draining:
            raise self._reject(
                "draining",
                "engine is draining: new requests are not accepted "
                "(resident work runs to completion)",
            )
        if not temperature >= 0.0:
            raise self._reject(
                "bad_request", f"temperature must be >= 0; got {temperature}"
            )
        if not 0 <= top_k <= self.cfg.vocab_size or not 0.0 < top_p <= 1.0:
            raise self._reject(
                "bad_request",
                f"top_k must be in [0, vocab_size={self.cfg.vocab_size}] "
                f"and top_p in (0, 1]; got {top_k}, {top_p}",
            )
        if seed is not None and not -(2**31) <= seed < 2**31:
            raise self._reject(
                "bad_request", f"seed must fit int32; got {seed}"
            )
        if max_new_tokens <= 0:
            raise self._reject(
                "bad_request",
                f"max_new_tokens must be >= 1; got {max_new_tokens}",
            )
        if adapter:
            raise self._reject(
                "bad_request",
                f"adapter {adapter} requested but the engine has no "
                f"adapter set (construct with adapters=)",
            )
        prompt = np.asarray(prompt).reshape(-1)
        if len(prompt) == 0:
            raise self._reject("bad_request", "empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise self._reject(
                "bad_request",
                f"prompt ids must be in [0, vocab_size="
                f"{self.cfg.vocab_size}); got range "
                f"[{prompt.min()}, {prompt.max()}]",
            )
        prompt = prompt.astype(np.int32)
        total = len(prompt) + max_new_tokens
        if total > self.cache_len:
            raise self._reject(
                "oversize_reject",
                f"prompt + max_new_tokens = {total} exceeds cache_len "
                f"{self.cache_len}",
            )
        if self._spec_on:
            # A verify window reaches spec_k positions past the last
            # committed token; they must stay inside both models'
            # positional range. Gated on the live controller state: once
            # drafting is off no verify runs again.
            limit = min(self.cfg.max_seq_len, self._draft_cfg.max_seq_len)
            if total + self._spec_k > limit:
                raise self._reject(
                    "oversize_reject",
                    f"prompt + max_new_tokens = {total} + spec_k "
                    f"{self._spec_k} lookahead exceeds max_seq_len "
                    f"{limit}",
                )
        if self.paged:
            need = self.pool.blocks_needed(len(prompt), max_new_tokens)
            if need > self.pool_blocks - 1:
                raise self._reject(
                    "pool_overflow",
                    f"request needs {need} cache blocks but the pool "
                    f"holds {self.pool_blocks - 1} allocatable blocks",
                )
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(
            rid, prompt, max_new_tokens, eos_id,
            temperature=temperature, top_k=top_k, top_p=top_p,
            seed=rid if seed is None else seed,
            submitted_at=time.monotonic(),
            trace_id=None if trace_id is None else str(trace_id)[:64],
        )
        self._requests[rid] = req
        self._pending.append(req)
        return rid

    def _reject(self, reason: str, message: str) -> ValueError:
        self.obs.errors.inc(labels={"reason": reason})
        return ValueError(message)

    # -- driving -------------------------------------------------------------

    def step(self, *, allow_loop: bool = True) -> bool:
        """One pipeline turn: admit, dispatch a chunk, then process the
        PREVIOUS chunk's tokens (its host copy overlaps the chunk just
        dispatched). True while work remains.

        With `loop_steps` > 1 and no admission pending (empty queue and
        prefill lane), the turn folds up to `loop_steps` chunks or
        speculative rounds into one device-resident dispatch instead
        (`_step_loop`, synchronous); `allow_loop=False` keeps the turn on
        the per-chunk path (a streaming consumer sees tokens per chunk).
        While drafting is on, a turn is one synchronous speculative round
        (`_dispatch_spec` + `_process_spec`). A synchronous turn first
        drains the chunk in flight."""
        t0 = time.monotonic()
        if self.paged:
            self._admit_paged()
        else:
            self._admit_dense()
        self.obs.stall.inc(time.monotonic() - t0)
        live_any = any(r is not None for r in self._slot_req)
        has_live = live_any or bool(self._prefilling)
        if (
            allow_loop and self.loop_steps > 1 and live_any
            and not self._prefilling and not self._pending
        ):
            self._drain_inflight()
            if any(r is not None for r in self._slot_req):
                self._step_loop()
            return self.has_work
        if self._spec_on and has_live:
            self._drain_inflight()
            self._process_spec(*self._dispatch_spec())
            return True
        handle = self._dispatch() if has_live else None
        if self._inflight is not None:
            self._process(*self._inflight)
        self._inflight = handle
        if handle is None:
            return bool(self._pending)
        return True

    def _drain_inflight(self) -> None:
        if self._inflight is not None:
            self._process(*self._inflight)
            self._inflight = None

    @property
    def has_work(self) -> bool:
        return bool(
            self._pending
            or any(self._slot_req)
            or self._prefilling
            or self._inflight is not None
        )

    def run(self) -> dict[int, list[int]]:
        """Drive until every submitted request finishes."""
        out: dict[int, list[int]] = {}
        while self.has_work:
            self.step()
            out.update(self.drain_done())
        out.update(self.drain_done())
        return out

    def warm(self, max_new_tokens: int = 2) -> None:
        """Run the serving programs once off the request path (kernel
        builds, library handles): one admission burst per power-of-two
        lane width, each run to completion. Single-token prompts, so
        the prefix index is untouched."""
        width = 1
        while width <= min(self.slots, self.prefill_lanes):
            for _ in range(width):
                self.submit([1], max_new_tokens=max_new_tokens)
            self.run()
            width *= 2

    def drain(self) -> None:
        """Reject every further submit (reason `draining`) while all
        accepted work runs to completion. One-way."""
        self._draining = True

    def drain_done(self) -> dict[int, list[int]]:
        """Pop every finished request's tokens."""
        return {
            rid: rec["tokens"]
            for rid, rec in self.drain_done_records().items()
        }

    def drain_done_records(self) -> dict[int, dict]:
        """Pop every finished request with its serving record: tokens,
        ttft_s (submit -> first token known to the host), wall_s,
        truncated, trace_id, fingerprint (None: no capture plane) and
        adapter (always the base model, 0)."""
        done = {
            rid: {
                "tokens": r.tokens,
                "ttft_s": r.first_token_at - r.submitted_at,
                "wall_s": r.completed_at - r.submitted_at,
                "truncated": r.truncated,
                "trace_id": r.trace_id,
                "fingerprint": None,
                "adapter": 0,
            }
            for rid, r in self._requests.items()
            if r.done
        }
        for rid in done:
            del self._requests[rid]
        return done

    # -- stats ---------------------------------------------------------------

    def occupancy(self) -> dict:
        busy = int(self.obs.busy_steps.value())
        total = int(self.obs.total_steps.value())
        return {
            "busy_slot_steps": busy,
            "total_slot_steps": total,
            "occupancy": round(busy / max(1, total), 4),
        }

    def _kv_bytes_per_token(self) -> int:
        """Cache bytes one resident token takes: per layer, K and V of
        every kv head at the storage dtype's size, plus one f32 scale per
        row and head in a quantized pool ("int8-sim" too: its scale pools
        are resident) (JAX `obs/attrib.kv_hbm_bytes_per_token`)."""
        c = self.cfg
        item = torch.empty((), dtype=c.kv_storage_dtype).element_size()
        scale = 4 if c.kv_quant else 0
        return c.num_layers * 2 * c.kv_heads * (c.head_dim * item + scale)

    def _kv_backing_bytes(self) -> int:
        """Cache bytes backing the resident tokens: paged, the allocated
        blocks (shared prefix blocks once); dense, the whole slots x
        cache_len allocation, however empty."""
        if self.paged:
            blocks = self.pool.blocks_allocated()
            return blocks * PAGE_ROWS * self._kv_bytes_per_token()
        return self.slots * self.cache_len * self._kv_bytes_per_token()

    def kv_stats(self) -> dict:
        per_tok = self._kv_bytes_per_token()
        backing = (
            self.pool_blocks * PAGE_ROWS * per_tok if self.paged
            else self._kv_backing_bytes()
        )
        pool = self.pool
        books = dict(
            kv_pool_blocks=self.pool_blocks,
            kv_blocks_in_use=pool.blocks_allocated(),
            kv_blocks_free=len(pool.free_blocks),
            kv_blocks_parked=pool.parked_count(),
            kv_blocks_reserved=pool.reserved,
        ) if self.paged else dict.fromkeys((
            "kv_pool_blocks", "kv_blocks_in_use", "kv_blocks_free",
            "kv_blocks_parked", "kv_blocks_reserved",
        ))
        return {
            "kv_hbm_bytes_per_resident_token": self.obs.kv_ratio.value(),
            "kv_bytes_dispatch_acc": self.obs.kv_bytes.value(),
            "kv_resident_dispatch_acc": int(self.obs.kv_resident.value()),
            "kv_bytes_per_token": per_tok,
            "kv_backing_bytes": backing,
            "kv_shard_backing_bytes": backing,  # one card: no sharding
            **books,
            "paged": self.paged,
            "admission_stall_s": round(self.obs.stall.value(), 6),
        }

    def quant_stats(self) -> dict:
        """Quantization view (the JAX engine's `quant_stats()`, without
        its obs planes): the configured dtypes, the per-token KV bytes,
        the served weights' bytes, the paged pools' backing bytes by
        storage dtype with the f32 scale pools apart, and the seconds the
        build spent quantizing weights."""
        c = self.cfg
        name = str(c.kv_storage_dtype).removeprefix("torch.")
        kv_cache_bytes = {}
        if self.paged:
            tokens = self.pool_blocks * PAGE_ROWS
            per_head = c.num_layers * 2 * c.kv_heads
            item = torch.empty((), dtype=c.kv_storage_dtype).element_size()
            kv_cache_bytes[name] = tokens * per_head * c.head_dim * item
            if c.kv_quant:
                kv_cache_bytes["scale-f32"] = tokens * per_head * 4
        return {
            "enabled": bool(c.kv_quant or c.w_quant),
            "kv_dtype": c.kv_dtype,
            "w_dtype": c.w_dtype,
            "kv_storage_dtype": name,
            "kv_bytes_per_token": self._kv_bytes_per_token(),
            "param_bytes": sum(
                p.numel() * p.element_size() for p in self.model.parameters()
            ),
            "kv_cache_bytes": kv_cache_bytes,
            "weight_quant_seconds": round(self._quant_seconds, 6),
        }

    def prefix_stats(self) -> dict:
        hits = int(self.obs.prefix_hits.value())
        misses = int(self.obs.prefix_misses.value())
        lookups = hits + misses
        saved = int(self.obs.prefix_saved.value())
        prompt_tokens = int(self.obs.prefix_prompt_tokens.value())
        idx = self.pool.prefix if self.paged else None
        return {
            "enabled": idx is not None,
            "block_hits": hits,
            "block_misses": misses,
            "hit_rate": round(hits / lookups, 4) if lookups else None,
            "evictions": int(self.obs.prefix_evictions.value()),
            "cached_blocks": idx.cached_blocks if idx else 0,
            "parked_blocks": idx.parked_blocks if idx else 0,
            "cached_tokens": idx.cached_tokens if idx else 0,
            "prefill_tokens_saved": saved,
            "prompt_tokens": prompt_tokens,
            "prefill_tokens_saved_frac": (
                round(saved / prompt_tokens, 4) if prompt_tokens else None
            ),
        }

    def spec_stats(self) -> dict:
        """Speculative-serving view (the JAX engine's `spec_stats()`):
        the `cb_spec_*` counters and the controller's state.
        `acceptance_rate` is accepted over proposed drafts;
        `accepted_per_round` and `emitted_per_round` average over (live
        slot, round) pairs, emitted = accepted + 1."""
        if not self._spec:
            return {"enabled": False}
        proposed = int(self.obs.spec_proposed.value())
        accepted = int(self.obs.spec_accepted.value())
        slot_rounds = int(self.obs.spec_rounds.value())
        return {
            "enabled": True,
            "k": self._k_now,
            "k_configured": self._spec_k,
            "drafting_disabled": not self._spec_on,
            "draft_dispatches": int(self.obs.spec_draft.value()),
            "verify_dispatches": int(self.obs.spec_verify.value()),
            "slot_rounds": slot_rounds,
            "proposed_tokens": proposed,
            "accepted_tokens": accepted,
            "acceptance_rate": (
                round(accepted / proposed, 4) if proposed else None
            ),
            "accepted_per_round": (
                round(accepted / slot_rounds, 4) if slot_rounds else None
            ),
            "emitted_per_round": (
                round(self.obs.spec_emitted.value() / slot_rounds, 4)
                if slot_rounds else None
            ),
            "accepted_ema": (
                round(self._spec_ema, 4)
                if self._spec_ema is not None else None
            ),
        }

    def loop_stats(self) -> dict:
        """Device-resident-loop view (the JAX engine's `loop_stats()`):
        `steps_per_sync` is per-slot device steps surfaced per fold,
        averaged over the run (loop_steps * chunk_steps when every fold
        reaches its horizon)."""
        exits = {
            r: int(self.obs.loop_exits.value({"reason": r}))
            for r in ("slot_done", "unbacked", "horizon")
        }
        return {
            "loop_steps": self.loop_steps,
            "enabled": self.loop_steps > 1,
            "dispatches": int(self.obs.loop_dispatches.value()),
            "chunks_folded": int(self.obs.loop_chunks.value()),
            "steps_per_sync": self.obs.loop_steps_per_sync.value(),
            "exits": exits,
        }

    # -- admission -------------------------------------------------------------

    def _bucket_for(self, prompt_len: int) -> int:
        """Dense-mode prefill bucket: `prompt_bucket` when it fits, else
        the smallest power of two that does (capped at the cache width):
        prompt lengths share program shapes, and long prompts are served
        instead of rejected."""
        if prompt_len <= self.prompt_bucket:
            return self.prompt_bucket
        bucket = 1 << (prompt_len - 1).bit_length()
        return min(max(bucket, self.prompt_bucket), self.cache_len)

    def _admit_dense(self) -> None:
        """Blocking admission (dense mode): every free slot takes the next
        pending request, prefilled alone at its bucket into the slot's
        rows; its first token is sampled on the device and reaches the
        host as column 0 of the next chunk."""
        for s in range(self.slots):
            if self._slot_req[s] is not None or not self._pending:
                continue
            req = self._pending.popleft()
            true_len = len(req.prompt)
            padded = np.zeros((1, self._bucket_for(true_len)), np.int64)
            padded[0, :true_len] = req.prompt
            dev = self.device
            knobs = {
                name: to_device(np.asarray([value], dtype), dev)
                for name, value, dtype in (
                    ("temp", req.temperature, np.float32),
                    ("topk", req.top_k, np.int64),
                    ("topp", req.top_p, np.float32),
                    ("seed", req.seed, np.int64),
                )
            }
            admit_dense(
                self.model, self._state, s, to_device(padded, dev), true_len,
                knobs,
            )
            self._slot_req[s] = req
            self._slot_new[s] = True
            self._budget[s] = req.max_new_tokens

    def _admit_paged(self) -> None:
        """Assign pending requests to free slots and pool blocks and
        queue them on the prefill lane (host bookkeeping only): the
        prefix trie is walked first and matched blocks are shared;
        only the prompt's own new blocks allocate now, while the worst
        case is reserved virtually. Head-of-line: a request that does
        not fit waits."""
        busy = {p.slot for p in self._prefilling}
        prefix = self.pool.prefix
        for s in range(self.slots):
            if len(self._prefilling) >= self.prefill_lanes or not self._pending:
                break
            if self._slot_req[s] is not None or s in busy:
                continue
            req = self._pending[0]
            true_len = len(req.prompt)
            total = self.pool.blocks_needed(true_len, req.max_new_tokens)
            matched = prefix.match(req.prompt) if prefix is not None else []
            new_need = total - len(matched)
            matched_parked = sum(1 for n in matched if n.refcount == 0)
            if self.pool.available(excluding_parked=matched_parked) < new_need:
                break
            self._pending.popleft()
            cached = len(matched) * PAGE_ROWS
            blocks = [n.block for n in matched]
            if prefix is not None:
                prefix.acquire(matched)
            new_now = -(-true_len // PAGE_ROWS) - len(matched)
            for _ in range(new_now):
                block = self.pool.grab_block()
                if block is None:
                    raise RuntimeError(
                        "paged pool accounting violated: free list and "
                        "parked index both dry under reservation"
                    )
                blocks.append(block)
            entry = _Prefill(
                req, s, blocks, consumed=cached, cached=cached,
                nodes=list(matched), resv=new_need - new_now,
            )
            if prefix is not None:
                walkable = prefix.matchable_blocks(true_len)
                inserted = prefix.insert(
                    req.prompt, matched[-1] if matched else None,
                    blocks[len(matched):walkable],
                )
                entry.nodes += inserted
                entry.pending = list(inserted)
                self.obs.prefix_hits.inc(len(matched))
                self.obs.prefix_misses.inc(walkable - len(matched))
                self.obs.prefix_saved.inc(cached)
                self.obs.prefix_prompt_tokens.inc(true_len)
                self.obs.prefix_cached_tokens.set(prefix.cached_tokens)
            self.pool.reserved += entry.resv
            self._prefilling.append(entry)
            busy.add(s)
            self.pool.set_gauges()

    # -- dispatch --------------------------------------------------------------

    def _dispatch(self):
        """Paged: back the chunk's decode rows, snapshot the table, run
        the decode chunk and the prefill lane, flip finished prefills
        live. Dense: run the decode chunk. Returns the in-flight handle."""
        table, lane, finished = None, None, []
        if self.paged:
            table, lane, finished = self._paged_prologue(
                self.chunk_steps, advance=True
            )
        else:
            self._record_kv_snapshot()
        emitted = decode_chunk(self.model, self._state, table, self.chunk_steps)
        if lane is not None:
            run_lane(self.model, self._state, lane)
        host, ready = self._to_host(emitted)
        snapshot, fresh = self._epilogue(finished, self.chunk_steps)
        return host, ready, snapshot, fresh

    def _paged_prologue(self, steps: int, advance: bool):
        """Back the rows this dispatch writes before the table snapshot
        names them, record the KV gauges, upload the table and assemble
        the prefill lane. Returns (table, lane or None, finished)."""
        self._ensure_decode_blocks(steps, advance=advance)
        self._record_kv_snapshot()
        # int32, the kernels' index type: no per-layer conversion.
        table = to_device(self.pool.table.astype(np.int32), self.device)
        if self._prefilling:
            lane, finished = self._prepare_lane()
            return table, lane, finished
        return table, None, []

    def _epilogue(self, finished: list[_Prefill], steps: int):
        """Snapshot the slots before finished prefills flip live (their
        first token rides the next dispatch's input column), then count
        the dispatch. Returns (snapshot, fresh)."""
        snapshot = list(self._slot_req)
        fresh = list(self._slot_new)
        self._slot_new = [False] * self.slots
        self._flip_finished(finished)
        self._mark_dispatch(sum(1 for r in snapshot if r is not None), steps)
        return snapshot, fresh

    def _mark_dispatch(self, busy: int, steps: int) -> None:
        """`steps` is the dispatch's per-slot step window: chunk_steps, k+1
        for a round, the steps a fold ran."""
        self.obs.dispatches.inc()
        self.obs.busy_steps.inc(busy * steps)
        self.obs.total_steps.inc(self.slots * steps)

    def _dispatch_spec(self):
        """One speculative round: back every live slot's k+1 verify rows
        (the head mirror is exact here: rounds are synchronous), then the
        round, and the prefill lane with its draft mirror when admissions
        ride along."""
        k = self._k_now
        table, lane, finished = self._paged_prologue(k + 1, advance=False)
        emitted, n_emit = spec_round(
            self.model, self._draft, self._state, self._d_cache, table, k
        )
        if lane is not None:
            run_lane(self.model, self._state, lane)
            mirror_lane(self._draft, self._d_cache, lane)
        out = torch.cat([emitted, n_emit[:, None]], dim=1)
        snapshot, fresh = self._epilogue(finished, k + 1)
        return out, snapshot, fresh

    def _to_host(self, t: torch.Tensor):
        """Start the device->host copy of a chunk's tokens; the event
        (None on the CPU) marks when it has landed."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def _prepare_lane(self):
        """Host-side lane assembly: [prefill_lanes, prefill_chunk]
        token and table arrays, each admitted request writing its next
        chunk (the final chunk aligned to the prompt's end, clamped to
        its cached prefix), plus the finishing rows. Marks the request's
        own index nodes ready once their writing chunk is dispatched.

        JAX runs a lane of `rows` rows: those in use, rounded up to a
        power of two, capped at `prefill_lanes`; its pad rows carry
        token 0 at position 0 through the scratch table. The port's
        first `rows` rows are the same, and only they route through the
        MoE layers (`moe_rows`); the rows past them start at the table's
        capacity, so their K/V writes go to the dump block and the
        scratch block holds what JAX's does (the last of its writers in
        row order, as XLA's scatter writes them)."""
        W, P = self.prefill_chunk, self.prefill_lanes
        rows = min(1 << (len(self._prefilling) - 1).bit_length(), P)
        tok = np.zeros((P, W), np.int64)
        start = np.zeros(P, np.int32)
        start[rows:] = self._nlog * PAGE_ROWS
        tbl = np.zeros((P, self._nlog), np.int32)
        true_len = np.ones(P, np.int32)
        temp = np.zeros(P, np.float32)
        topk = np.zeros(P, np.int64)
        topp = np.ones(P, np.float32)
        seed = np.zeros(P, np.int64)
        fin_rows, fin_slots, finished = [], [], []
        for r, entry in enumerate(self._prefilling):
            req = entry.req
            n = len(req.prompt)
            if n - entry.consumed > W:
                begin = entry.consumed
                entry.consumed += W
            else:
                begin = max(entry.cached, n - W)
                entry.consumed = n
                finished.append(entry)
                fin_rows.append(r)
                fin_slots.append(entry.slot)
                true_len[r] = n
                temp[r] = req.temperature
                topk[r] = req.top_k
                topp[r] = req.top_p
                seed[r] = req.seed
            seg = req.prompt[begin:begin + W]
            tok[r, :len(seg)] = seg
            start[r] = begin
            tbl[r, :len(entry.blocks)] = entry.blocks
            while (
                entry.pending
                and entry.pending[0].depth * PAGE_ROWS <= entry.consumed
            ):
                self.pool.prefix.mark_ready(entry.pending.pop(0))
        dev = self.device
        lane = {
            name: to_device(a, dev) for name, a in (
                ("tok", tok), ("start", start), ("table", tbl),
                ("true_len", true_len), ("temp", temp), ("topk", topk),
                ("topp", topp), ("seed", seed),
                ("fin_rows", np.asarray(fin_rows, np.int64)),
                ("fin_slots", np.asarray(fin_slots, np.int64)),
            )
        }
        lane["rows"] = rows
        return lane, finished

    def _flip_finished(self, finished: list[_Prefill]) -> None:
        """Requests whose final prefill chunk just dispatched go live:
        slot, budget, blocks, prefix pins and write-head mirror."""
        for entry in finished:
            self._prefilling.remove(entry)
            s = entry.slot
            self._slot_req[s] = entry.req
            self._slot_new[s] = True
            self._budget[s] = entry.req.max_new_tokens
            self.pool.bind_slot(
                s, entry.blocks, entry.nodes, entry.resv,
                len(entry.req.prompt),
            )

    def _ensure_decode_blocks(self, window: int, *, advance: bool) -> None:
        """Back every live slot's next `window` cache writes, grabbing
        decode blocks as the write head crosses 128-row boundaries; a
        truly dry pool truncates the request (`pool_overflow`).
        `advance` moves the write-head mirror with the device's cache
        index (a plain chunk adds `window`); speculative rounds and folds
        pass False and advance it at the sync by what they committed."""
        pool = self.pool
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None or req.done:
                continue
            if not req.truncated:
                total = len(req.prompt) + req.max_new_tokens
                end = min(int(pool.slot_pos[s]) + window, total)
                if not pool.back_slot(s, end):
                    self._truncate_slot(s)
            if advance:
                pool.slot_pos[s] += window
        pool.set_gauges()

    def _rollback_spec_blocks(self, s: int) -> None:
        """Return a live slot's decode blocks that back only uncommitted
        speculative rows (grabbed for a verify window whose rows were
        rejected); truncated slots keep theirs."""
        req = self._slot_req[s]
        if req is None or req.done or req.truncated:
            return
        pool = self.pool
        keep = max(
            -(-int(pool.slot_pos[s]) // PAGE_ROWS), len(pool.slot_nodes[s]), 1,
        )
        pool.rollback_unused(s, keep)

    def _truncate_slot(self, s: int) -> None:
        """Cap a live slot's budget at what its allocated blocks back."""
        req = self._slot_req[s]
        pool = self.pool
        cap = pool.backed_rows(s) - len(req.prompt)
        new_budget = max(0, cap - len(req.tokens))
        if new_budget < self._budget[s]:
            self._budget[s] = new_budget
            req.truncated = True
            pool.reserved -= int(pool.slot_resv[s])
            pool.slot_resv[s] = 0

    def _record_kv_snapshot(self) -> None:
        live = [r for r in self._slot_req if r is not None]
        resident = sum(len(r.prompt) + len(r.tokens) for r in live)
        resident += sum(p.consumed for p in self._prefilling)
        if resident <= 0:
            return
        backing = self._kv_backing_bytes()
        self.obs.kv_ratio.set(round(backing / resident, 1))
        self.obs.kv_bytes.inc(float(backing))
        self.obs.kv_resident.inc(resident)

    # -- sync and commit -------------------------------------------------------

    def _process(self, host, ready, snapshot, fresh) -> None:
        if ready is not None:
            ready.synchronize()
        tokens = host.numpy()
        now = time.monotonic()
        for s, req in enumerate(snapshot):
            if req is None or req.done:
                continue
            emit = tokens[s] if fresh[s] else tokens[s, 1:]
            self._commit_tokens(s, req, emit, now)

    def _process_spec(self, out, snapshot, fresh) -> None:
        """Sync one round and commit it: per live slot, advance the head
        mirror by the committed count, commit `[input?] + chosen[:n]`,
        return the verify-window blocks the rejections left unused; then
        the counters and the acceptance controller."""
        out = out.cpu().numpy()  # the round's one sync
        tokens, counts = out[:, :-1], out[:, -1]
        now = time.monotonic()
        live = np.array([r is not None and not r.done for r in snapshot], bool)
        for s in np.flatnonzero(live):
            c = int(counts[s])
            self.pool.slot_pos[s] += c
            emit = tokens[s, :1 + c] if fresh[s] else tokens[s, 1:1 + c]
            self._commit_tokens(s, snapshot[s], emit, now)
            self._rollback_spec_blocks(s)
        self._account_round(counts, live, self._k_now)
        self.pool.set_gauges()

    def _account_round(self, counts, live, k: int) -> None:
        """The counters and the controller for one speculative round of k
        drafts: counts [slots] tokens committed per slot, live [slots]
        the slots that were live in it."""
        obs = self.obs
        obs.spec_verify.inc()
        obs.spec_draft.inc(k + 1)
        n = int(live.sum())
        if not n:
            return
        emitted = int(counts[live].sum())
        obs.spec_emitted.inc(emitted)
        obs.spec_rounds.inc(n)
        obs.spec_proposed.inc(k * n)
        obs.spec_accepted.inc(emitted - n)
        self._spec_controller((emitted - n) / n)

    def _step_loop(self) -> None:
        """One device-resident fold, dispatch and sync (synchronous: the
        next turn's admissions, backing and k depend on what it
        committed). Pre-back every live slot to the fold's horizon
        (`loop_steps` x chunk_steps rows, or x (k+1) for rounds), upload
        the exit inputs beside the table, run the fold, and replay what
        it surfaced through `_commit_tokens`, the controller and the
        counters as if each chunk or round had synced on its own."""
        pool = self.pool
        spec = self._spec_on
        k = self._k_now
        kstep = (k + 1) if spec else self.chunk_steps
        self._ensure_decode_blocks(self.loop_steps * kstep, advance=False)
        self._record_kv_snapshot()
        live_mask = np.array(
            [r is not None and not r.done for r in self._slot_req], bool
        )
        eos = np.array([
            r.eos_id if (r is not None and r.eos_id is not None) else -1
            for r in self._slot_req
        ])
        # What the device may still generate per slot: the budget, less
        # the input-column token a freshly flipped slot surfaces.
        owed = np.array([
            max(int(self._budget[s]) - int(self._slot_new[s]), 0)
            if self._slot_req[s] is not None else 0
            for s in range(self.slots)
        ])
        backed = np.array([pool.backed_rows(s) for s in range(self.slots)])
        snapshot = list(self._slot_req)
        fresh = list(self._slot_new)
        self._slot_new = [False] * self.slots
        busy = int(live_mask.sum())
        tokens, t_run, code, counts = self._loop.run(
            pool.table, live_mask, eos, owed, backed, spec_k=k if spec else 0
        )
        now = time.monotonic()
        steps = t_run * kstep
        obs = self.obs
        for s, req in enumerate(snapshot):
            if req is None or req.done:
                continue
            adv = int(counts[:t_run, s].sum()) if spec else steps
            pool.slot_pos[s] += adv
            emit = tokens[s, :1 + adv] if fresh[s] else tokens[s, 1:1 + adv]
            self._commit_tokens(s, req, emit, now)
            if spec:
                self._rollback_spec_blocks(s)
        if spec:
            for r in range(t_run):
                self._account_round(counts[r], live_mask, k)
            pool.set_gauges()
        self._mark_dispatch(busy, steps)
        obs.loop_dispatches.inc()
        obs.loop_chunks.inc(t_run)
        obs.loop_exits.inc(labels={"reason": LOOP_EXITS[code]})
        self._loop_sync_n += 1
        self._loop_steps_acc += steps
        obs.loop_steps_per_sync.set(
            round(self._loop_steps_acc / self._loop_sync_n, 2)
        )

    def _spec_controller(self, round_accepted: float) -> None:
        """Acceptance-adaptive drafting: an EMA of the accepted drafts per
        live slot per round; under `spec_min_accept` past the warmup, halve
        k, and at k = 1 turn drafting off for the engine's lifetime. Every
        change of k restarts the EMA."""
        a = self._spec_alpha
        self._spec_ema = (
            round_accepted if self._spec_ema is None
            else a * round_accepted + (1 - a) * self._spec_ema
        )
        self._spec_rounds_seen += 1
        if (
            self._spec_rounds_seen < self._spec_warmup
            or self._spec_ema >= self._spec_min_accept
        ):
            return
        if self._k_now > 1:
            self._k_now = max(1, self._k_now // 2)
            self._spec_rounds_seen = 0
            self._spec_ema = None
            self.obs.spec_k_gauge.set(self._k_now)
        else:
            self._spec_on = False
            self.obs.spec_disabled.set(1)

    def _commit_tokens(self, s: int, req: _Request, emit, now) -> int:
        """Feed one slot's newly visible tokens into its request: TTFT,
        EOS and budget termination, slot release."""
        n = 0
        for t in emit:
            if not req.tokens:
                req.first_token_at = now
            req.tokens.append(int(t))
            n += 1
            self._budget[s] -= 1
            hit_eos = req.eos_id is not None and int(t) == req.eos_id
            if hit_eos or self._budget[s] <= 0:
                req.done = True
                req.completed_at = now
                if hit_eos:
                    reason = "eos"
                elif req.truncated:
                    reason = "pool_overflow"
                else:
                    reason = "budget"
                req.truncated = reason == "pool_overflow"
                if self._slot_req[s] is req:
                    self._slot_req[s] = None
                    self._budget[s] = 0
                    self._release_slot(s)
                break
        return n

    def _release_slot(self, s: int) -> None:
        """Return a freed slot's private blocks, release its prefix pins
        (refcount 0 parks the block) and park its table row on the
        scratch block. The chunk in flight still writes the old blocks
        at the dead sequence's tail positions — harmless: a reused block
        is rewritten before any of its positions become visible. Dense
        mode keeps no books: the next admission overwrites the slot."""
        if self.paged:
            self.pool.release_slot(s)
