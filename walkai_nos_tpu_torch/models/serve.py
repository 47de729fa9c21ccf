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
- **Multi-LoRA serving** (`adapters=AdapterSet(...)`, paged only,
  `models/lora.py`): every request carries an adapter id (`submit(...,
  adapter=k)`; 0 is the base model), the lane applies each row's deltas
  and each decode step, verify and fold each slot's, with the stacked
  A/B tensors and per-slot ids on the device. Armed forwards take the
  unfused attention route. Prefix-index keys carry the adapter's tag, so
  adapters never share cached K/V. `load_adapter` / `unload_adapter`
  swap an adapter's weights between dispatches (refused while a request
  uses it) by writing the device tensors in place, which the CUDA-graph
  folds read; they also drop the adapter's cached prefix blocks, whose
  rows the old weights wrote (the JAX engine keeps those). `lora_stats()`
  reports the set.
- **Sequence-parallel prefill lane** (`sp_prefill=True`, paged only):
  a prompt of `sp_min_tokens` or more is a long entry; at most one
  prefills at a time (a held long head is jumped by the first short
  behind it, a long never jumps anything), and each dispatch fans its
  next chunk windows over up to `sp_span` lane rows the other entries
  leave spare, so one dispatch advances it `span x prefill_chunk`
  tokens. Every row's K/V lands before any row's attention reads, so
  window j+1 sees window j of the same dispatch. `sp_stats()` reports
  it.
- **Deterministic capture** (`capture=` a directory or an
  `obs/capture.CaptureLog`): every accepted request's inputs (with its
  effective seed, and its adapter on an armed engine) and every
  completion's tokens and digest go to a bounded rotating on-disk ring
  behind the engine's `config_fingerprint()` (every determinism-relevant
  knob plus a digest of the served weights), at `submit` and at the
  commit seam the chunk, the round and the fold share; `warm()` records
  nothing. `sim/replay.py` replays a capture token for token;
  `debug_state()` is the one-read snapshot its triage bundle keeps.
  Capture files load in either package.
- **Block transfer and live migration** (`models/serve_xfer.py`):
  `export_blocks` / `import_blocks` ship ready prefix blocks by content
  hash, `export_resident` / `import_resident` move accepted requests
  between engines mid-stream, in the JAX engine's JSON-safe payload
  (the two packages import each other's). With the drain surface a
  router polls (`queue_depth`, `draining`, `drain_stats`,
  `drain_new_tokens`, `drain_latencies`, `decode_ready_rids`,
  `admission_stall_s`, `seconds_since_last_dispatch`), a replica can be
  drained without dropping work.

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
- The sp lane keeps the lane's fixed shape: fanned rows take lane rows
  that would otherwise run idle, over the full table width (JAX sizes
  the lane to the rows in use and truncates the table). Its wide
  chunks keep the dense attention tail on both devices, where JAX
  streams over cache tiles on its accelerator: on the H100 the streamed
  tail (`ops/sp_prefill.py`, plain PyTorch) was the slower (PERF.md).
- Telemetry (`self.obs`, an `obs/serving.ServingObs`): the engine writes
  the registry series and trace events the JAX engine writes, at the
  same points, host-side at its sync points; `obs=False` builds the
  no-op bundle and the views flag their zeros `obs_disabled`, a
  `ServingObs` passed in is shared. A dispatch's trace event carries its
  host assembly time (assembly start to the return of its launches) and
  the time the host blocked at the sync the engine already makes.
- At that sync `obs/attrib.DispatchAttribution` records the split by
  composition class against the dispatch's analytic HBM floor (the
  served weights' storage bytes plus the resident KV, every step, at
  the card's published bandwidth; no floor on the CPU), and
  `obs/slo.SloTracker` advances the windowed TTFT / TPOT / dispatch
  views (`slo_window_s`, `slo_objectives` as in JAX) and the composed
  saturation signal: `attrib_stats()`, `slo_stats()`, `saturation`,
  `slo_ok` and `debug_state()`'s `attrib` and `slo` blocks, what the
  fleet router (`router/`) reads. `tp_stats` and `debug_state()`'s `tp`
  block wait for tensor parallelism.
- `prompt_bucket` is fingerprinted in paged mode, where, as in JAX, the
  lane does not read it.
- The weights digest of `config_fingerprint()` covers the tree the
  engine serves, read off its `DecoderLM` under the flax leaf names
  (`models/convert.py`): with an f32 model the same leaves, dtypes and
  bytes as the JAX engine's tree, so the two fingerprints are equal; a
  bf16 model digests its bf16 leaves.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from collections.abc import Mapping

import numpy as np
import torch

from walkai_nos_tpu_torch.models.block_pool import BlockPool
from walkai_nos_tpu_torch.models.convert import served_tree
from walkai_nos_tpu_torch.models.lora import adapter_tag
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
from walkai_nos_tpu_torch.models.serve_xfer import BlockTransfer
from walkai_nos_tpu_torch.obs.attrib import (
    DispatchAttribution,
    classify_dispatch,
    kv_hbm_bytes_per_token,
    params_hbm_bytes,
    tp_ici_bytes_per_token,
)
from walkai_nos_tpu_torch.obs.capture import (
    CaptureLog,
    fingerprint_id,
    token_digest,
    tree_crc32,
)
from walkai_nos_tpu_torch.obs.serving import ServingObs
from walkai_nos_tpu_torch.obs.slo import SloTracker
from walkai_nos_tpu_torch.ops.decode_attention import MAX_KERNEL_STEPS, PAGE_ROWS
from walkai_nos_tpu_torch.utils.flops import hbm_bytes_per_s

__all__ = ["ContinuousBatcher"]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


def _busy(snapshot) -> int:
    """Slots holding a request in a dispatch's slot snapshot."""
    return sum(1 for r in snapshot if r is not None)


def _dtype_name(dtype: torch.dtype) -> str:
    """A storage dtype under the JAX engine's label ("bfloat16", "int8")."""
    return str(dtype).removeprefix("torch.")


class ContinuousBatcher(BlockTransfer):
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
        obs: bool | ServingObs = True,
        slo_window_s: float = 30.0,
        slo_objectives: dict | None = None,
        capture=None,
        adapters=None,
        device=None,
    ) -> None:
        # Config-fingerprint snapshot of the caller's config, taken before
        # any replace (JAX :393-406): replay rebuilds from these fields and
        # the engine re-derives the ones it owns.
        self._fp_cfg = {
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg)
            if f.name not in (
                "ragged_decode", "paged_decode", "paged_blocks", "cache_len",
            )
        }
        self._fingerprint: dict | None = None
        # Validated up front; the log attaches at the end of the build,
        # once the weights digest can cover the tree the engine serves.
        self._capture = CaptureLog.coerce(capture)
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
        # The registry is the one source of every cumulative count the
        # views read; `obs=False` builds the no-op bundle (JAX :632-635).
        self.obs = obs if isinstance(obs, ServingObs) else ServingObs(
            enabled=bool(obs)
        )
        if paged:
            self.pool_blocks = pool_blocks or slots * self._nlog + 1
            if self.pool_blocks < 2:
                raise ValueError(
                    f"pool_blocks must be >= 2 (block 0 is the reserved "
                    f"scratch block); got {self.pool_blocks}"
                )
            self.prefill_chunk = max(1, min(prefill_chunk, cache_len))
            self.prefill_lanes = max(1, prefill_lanes)
            # JAX `walkai_nos_tpu/models/serve.py:459-465`.
            if sp_min_tokens < 1:
                raise ValueError(
                    f"sp_min_tokens must be >= 1; got {sp_min_tokens}"
                )
            if sp_span < 0:
                raise ValueError(
                    f"sp_span must be >= 0 (0 = auto); got {sp_span}"
                )
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
        # The sequence-parallel prefill lane (JAX :523-531): long prompts
        # fan their chunk windows over up to `sp_span` lane rows; 0 sizes
        # the span to max(2, tp), 2 on one card.
        if sp_prefill and not paged:
            raise ValueError(
                "sp_prefill requires the paged engine (the "
                "sequence-parallel lane is a fan-out of the chunked "
                "prefill lane; the dense path has no lane)"
            )
        self.sp_prefill = bool(sp_prefill)
        self.sp_min_tokens = int(sp_min_tokens)
        self.sp_span = int(sp_span) or 2
        # Multi-LoRA (paged only: the per-slot ids are paged slot state).
        if adapters is not None:
            if not paged:
                raise ValueError(
                    "adapters require the paged engine (per-slot adapter "
                    "ids ride the paged slot state)"
                )
            if not adapters.compatible(self.cfg):
                raise ValueError(
                    "AdapterSet dimensions do not match the engine config "
                    "(build the set from the same LMConfig handed to the "
                    "engine)"
                )
        self._adapters = adapters
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
        self.obs.quant_seconds.inc(time.monotonic() - t_quant)
        self.model = DecoderLM.from_params(self.cfg, params, device)
        self.device = self.model.device
        cache = (
            PagedCache.zeros(self.cfg, self.device) if paged
            else DenseCache.zeros(self.cfg, slots, self.device)
        )
        self._state = SlotState.zeros(
            cache, slots, self.device, armed=adapters is not None
        )
        # The device copy of the set's stacks: fixed tensors, rewritten in
        # place by `_upload_adapters` (the folds' graphs read them).
        self._lora = None
        if adapters is not None:
            self._lora = {
                blk: {
                    proj: {
                        name: torch.tensor(arr, device=self.device)
                        for name, arr in pair.items()
                    }
                    for proj, pair in projs.items()
                }
                for blk, projs in adapters.host_tree().items()
            }
            self.obs.lora_resident.set(len(adapters.resident()))
        self._draft = self._d_cache = None
        if self._spec:
            self._draft = DecoderLM.from_params(
                self._draft_cfg, draft_params, self.device
            )
            self._d_cache = PagedCache.zeros(self._draft_cfg, self.device)
            self.obs.spec_k_gauge.set(spec_k)
            self.obs.spec_disabled.set(0)
        self._record_kv_backing_bytes()
        # Device-time attribution (JAX :667-702): each dispatch's host
        # assembly against the wait at its sync, beside its analytic HBM
        # floor. The cost model reads the served weights' storage bytes
        # and the pool's KV bytes per token; the card's bandwidth comes
        # from its name, and on the CPU there is none, so the roofline
        # gauge stays unset there, as on JAX's CPU.
        bw = (
            hbm_bytes_per_s(torch.cuda.get_device_name(self.device))
            if self.device.type == "cuda" else None
        )
        self._param_bytes = params_hbm_bytes(self.model)
        self._attrib = DispatchAttribution(
            self.obs,
            param_bytes=self._param_bytes,
            kv_bytes_per_token=self._kv_bytes_per_token(),
            hbm_bytes_per_s=bw,
            ici_bytes_per_token=tp_ici_bytes_per_token(self.cfg),
        )
        # The sliding-window SLO layer and the composed saturation
        # signal (JAX :703-711); an unknown objective raises its
        # ValueError here.
        self._slo = SloTracker(
            self.obs,
            slots=slots,
            window_s=slo_window_s,
            objectives=slo_objectives,
        )
        self._loop = None
        if loop_steps > 1:
            self._loop = DecodeLoop(
                self.model, self._state, slots=slots, nlog=self._nlog,
                loop_steps=loop_steps, chunk_steps=chunk_steps,
                draft=self._draft, d_cache=self._d_cache,
                spec_k=spec_k if self._spec else 0, lora=self._lora,
            )
        # Trailing run averages behind the cb_loop_steps_per_sync gauge.
        self._loop_sync_n = 0
        self._loop_steps_acc = 0
        self._requests: dict[int, _Request] = {}
        self._latencies: deque[float] = deque(maxlen=4096)
        self._last_dispatch_mono: float | None = None
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
        # Armed last: the header pins the fingerprint, weights digest
        # included; an unarmed engine never reads its weights back.
        if self._capture is not None:
            self._capture.attach(self.config_fingerprint(), obs=self.obs)

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
        adapter: int | None = 0,
    ) -> int:
        """Queue a generation; returns a request id. Greedy at
        temperature 0, else seeded sampling (`seed` defaults to the
        request id); `adapter` names a resident adapter of an armed
        engine (0, or None: the base model). Rejections raise ValueError
        and count under the JAX engine's reasons: bad_request |
        oversize_reject | pool_overflow | draining."""
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
        adapter = int(adapter) if adapter else 0
        if adapter:
            # Unknown ids fail here, per request: the device gather would
            # serve them some other adapter's deltas.
            if self._adapters is None:
                raise self._reject(
                    "bad_request",
                    f"adapter {adapter} requested but the engine has no "
                    f"adapter set (construct with adapters=)",
                )
            if not self._adapters.has(adapter):
                raise self._reject(
                    "bad_request",
                    f"adapter {adapter} is not loaded (resident: "
                    f"{sorted(self._adapters.resident())})",
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
            adapter=adapter,
        )
        self._requests[rid] = req
        self._pending.append(req)
        self.obs.submitted.inc()
        if self._adapters is not None:
            self.obs.lora_requests.inc(labels={"adapter": str(adapter)})
        self.obs.queue_depth.set(len(self._pending))
        # The span clock is the request's own stored timestamp, so
        # trace-derived ttft/wall equal drain_done_records exactly.
        self.obs.trace.submit(
            rid, req.submitted_at, len(prompt), max_new_tokens,
            trace_id=req.trace_id,
        )
        if self._capture is not None:
            # The EFFECTIVE seed: a replay under fresh rids reproduces the
            # original sampling streams.
            self._capture.record_submit(
                rid=rid, trace_id=req.trace_id, prompt=prompt.tolist(),
                max_new_tokens=max_new_tokens, eos_id=eos_id,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=req.seed,
                arrival_s=round(
                    self._capture.arrival_offset(req.submitted_at), 6
                ),
                # Armed engines pin the adapter id; unarmed captures stay
                # byte-identical to adapter-free ones.
                **({"adapter": adapter} if self._adapters is not None else {}),
            )
        return rid

    def _reject(self, reason: str, message: str) -> ValueError:
        self.obs.errors.inc(labels={"reason": reason})
        self.obs.trace.error(time.monotonic(), reason)
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
        the prefix index is untouched. The capture plane records none of
        it: warm-up traffic is not served traffic."""
        cap, self._capture = self._capture, None
        try:
            width = 1
            while width <= min(self.slots, self.prefill_lanes):
                for _ in range(width):
                    self.submit([1], max_new_tokens=max_new_tokens)
                self.run()
                width *= 2
        finally:
            self._capture = cap

    def drain(self) -> None:
        """Reject every further submit (reason `draining`) while all
        accepted work runs to completion. One-way."""
        if self._draining:
            return
        self._draining = True
        self.obs.trace.event("drain", time.monotonic())

    def drain_done(self) -> dict[int, list[int]]:
        """Pop every finished request's tokens."""
        return {
            rid: rec["tokens"]
            for rid, rec in self.drain_done_records().items()
        }

    def drain_done_records(self) -> dict[int, dict]:
        """Pop every finished request with its serving record: tokens,
        ttft_s (submit -> first token known to the host), wall_s,
        truncated, trace_id, fingerprint (the config fingerprint's id,
        None until `config_fingerprint()` ran: the capture that can replay
        the request) and adapter."""
        done = {
            rid: {
                "tokens": r.tokens,
                "ttft_s": r.first_token_at - r.submitted_at,
                "wall_s": r.completed_at - r.submitted_at,
                "truncated": r.truncated,
                "trace_id": r.trace_id,
                "fingerprint": self.fingerprint_id,
                "adapter": r.adapter,
            }
            for rid, r in self._requests.items()
            if r.done
        }
        for rid in done:
            self._latencies.append(done[rid]["wall_s"])
            del self._requests[rid]
        return done

    def drain_new_tokens(self) -> dict[int, list[int]]:
        """Tokens newly visible since the last call, per request (active
        and just-finished alike): the streaming feed. Never removes a
        request."""
        out = {}
        for rid, r in self._requests.items():
            if len(r.tokens) > r.streamed:
                out[rid] = r.tokens[r.streamed:]
                r.streamed = len(r.tokens)
        return out

    def drain_latencies(self) -> list[float]:
        """Pop the submit -> completion wall seconds of the requests
        `drain_done_records` has handed out so far."""
        out = list(self._latencies)
        self._latencies.clear()
        return out

    # -- what a router polls -------------------------------------------------

    @property
    def draining(self) -> bool:
        """True once `drain()` has been called."""
        return self._draining

    @property
    def queue_depth(self) -> int:
        """Requests submitted but not yet admitted to a slot."""
        return len(self._pending)

    @property
    def admission_stall_s(self) -> float:
        """Cumulative host seconds inside admission work."""
        return self.obs.stall.value()

    @property
    def seconds_since_last_dispatch(self) -> float | None:
        """Host seconds since the engine last dispatched a device
        program; None before the first."""
        if self._last_dispatch_mono is None:
            return None
        return time.monotonic() - self._last_dispatch_mono

    def drain_stats(self) -> dict:
        """Drain-down progress: resident slots, prefilling and queued
        counts, and the blocks live requests still hold; all reach zero
        as a drain or an `export_resident` empties the engine."""
        return {
            "draining": self._draining,
            "resident_slots": sum(
                1 for r in self._slot_req if r is not None and not r.done
            ),
            "prefilling": len(self._prefilling),
            "queued": len(self._pending),
            "blocks_remaining": (
                self.pool.blocks_allocated() if self.paged else 0
            ),
        }

    def decode_ready_rids(self) -> list[int]:
        """Live requests that have committed at least one token: done
        with prefill, migratable as whole slots (`export_resident`)."""
        return [
            req.rid for req in self._slot_req
            if req is not None and not req.done and req.tokens
        ]

    # -- stats ---------------------------------------------------------------

    def occupancy(self) -> dict:
        busy = int(self.obs.busy_steps.value())
        total = int(self.obs.total_steps.value())
        return {
            "busy_slot_steps": busy,
            "total_slot_steps": total,
            "occupancy": round(busy / max(1, total), 4),
            **self._off(),
        }

    def _off(self) -> dict:
        """`{"obs_disabled": True}` with telemetry off, else empty: the
        views flag their zeros as not recorded, not a measured idle
        engine (JAX's convention)."""
        return {} if self.obs.enabled else {"obs_disabled": True}

    def _kv_bytes_per_token(self) -> int:
        """Cache bytes one resident token takes
        (`obs/attrib.kv_hbm_bytes_per_token`)."""
        return kv_hbm_bytes_per_token(self.cfg)

    def _record_kv_backing_bytes(self) -> None:
        """One-shot `cb_kv_cache_bytes_total{dtype}` (JAX :2861-2884): the
        paged pools' backing bytes by storage dtype, the draft's mirrored
        pools included, a quantized pool's f32 scale pools apart."""
        if not self.paged:
            return
        tokens = self.pool_blocks * PAGE_ROWS
        for c in (self.cfg, self._draft_cfg) if self._spec else (self.cfg,):
            per_head = c.num_layers * 2 * c.kv_heads
            item = torch.empty((), dtype=c.kv_storage_dtype).element_size()
            self.obs.kv_cache_bytes.inc(
                tokens * per_head * c.head_dim * item,
                {"dtype": _dtype_name(c.kv_storage_dtype)},
            )
            if c.kv_quant:
                self.obs.kv_cache_bytes.inc(
                    tokens * per_head * 4, {"dtype": "scale-f32"}
                )

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
            **self._off(),
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
        """Quantization view (the JAX engine's `quant_stats()`): the
        configured dtypes, the per-token KV bytes, the served weights'
        bytes, and the registry's quant series: the paged pools' backing
        bytes by storage dtype (the draft's included) with the f32 scale
        pools apart, and the seconds the build spent quantizing weights."""
        c = self.cfg
        name = _dtype_name(c.kv_storage_dtype)
        kv_cache_bytes = {}
        for label in (name, "scale-f32"):
            value = self.obs.kv_cache_bytes.value({"dtype": label})
            if value:
                kv_cache_bytes[label] = int(value)
        return {
            **self._off(),
            "enabled": bool(c.kv_quant or c.w_quant),
            "kv_dtype": c.kv_dtype,
            "w_dtype": c.w_dtype,
            "kv_storage_dtype": name,
            "kv_bytes_per_token": self._kv_bytes_per_token(),
            "param_bytes": sum(
                p.numel() * p.element_size() for p in self.model.parameters()
            ),
            "kv_cache_bytes": kv_cache_bytes,
            "weight_quant_seconds": round(self.obs.quant_seconds.value(), 6),
        }

    def prefix_stats(self) -> dict:
        hits = int(self.obs.prefix_hits.value())
        misses = int(self.obs.prefix_misses.value())
        lookups = hits + misses
        saved = int(self.obs.prefix_saved.value())
        prompt_tokens = int(self.obs.prefix_prompt_tokens.value())
        idx = self.pool.prefix if self.paged else None
        return {
            **self._off(),
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
            **self._off(),
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
                round((accepted + slot_rounds) / slot_rounds, 4)
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
            **self._off(),
            "loop_steps": self.loop_steps,
            "enabled": self.loop_steps > 1,
            "dispatches": int(self.obs.loop_dispatches.value()),
            "chunks_folded": int(self.obs.loop_chunks.value()),
            "steps_per_sync": self.obs.loop_steps_per_sync.value(),
            "exits": exits,
        }

    def sp_stats(self) -> dict:
        """Sequence-parallel prefill view (the JAX engine's `sp_stats()`):
        the knobs in force, the long entries prefilling now, and the
        admitted long requests, fanned lane rows and admission turns a
        long waited."""
        return {
            **self._off(),
            "enabled": self.sp_prefill,
            "sp_min_tokens": self.sp_min_tokens,
            "sp_span": self.sp_span,
            "active": sum(1 for p in self._prefilling if p.sp),
            "requests_total": int(self.obs.sp_requests.value()),
            "rows_total": int(self.obs.sp_rows.value()),
            "holds_total": int(self.obs.sp_holds.value()),
        }

    def lora_stats(self) -> dict:
        """Multi-LoRA view (the JAX engine's `lora_stats()`): the set's
        geometry, the resident adapters, and the per-adapter request,
        gather-dispatch and load-time counters."""
        if self._adapters is None:
            return {"enabled": False}
        aset = self._adapters
        adapters = aset.resident()
        return {
            **self._off(),
            "enabled": True,
            "capacity": aset.capacity,
            "rank": aset.rank,
            "adapters": adapters,
            "requests_total": {
                aid: int(self.obs.lora_requests.value({"adapter": aid}))
                for aid in adapters
            },
            "gather_dispatches_total": int(self.obs.lora_gather.value()),
            "load_seconds_total": round(
                float(self.obs.lora_load_seconds.value()), 6
            ),
        }

    def slo_stats(self) -> dict:
        """Sliding-window SLO view (`obs/slo.py`): windowed TTFT / TPOT /
        dispatch quantiles, per-objective compliance and burn rate, and
        the composed saturation signal. The same shape with telemetry
        off, flagged `obs_disabled`."""
        return self._slo.stats(time.monotonic())

    def attrib_stats(self) -> dict:
        """Device-time attribution view (`obs/attrib.py`): per-kind
        dispatch / device / host totals and the trailing window's
        device-step, host-overhead and roofline gauges. The same shape
        with telemetry off, flagged `obs_disabled`."""
        return self._attrib.stats()

    @property
    def saturation(self) -> float | None:
        """Composed scale signal in [0, 1] from the SLO layer's last
        refresh (the max of busy / queue / queue-trend / pool pressure);
        None before the first dispatch or with telemetry off."""
        return self._slo.saturation

    @property
    def slo_ok(self) -> bool | None:
        """Overall SLO compliance, live over the current window: False
        iff a configured objective measurably breached its error budget;
        None before the first dispatch or with telemetry off."""
        return self._slo.ok_at(time.monotonic())

    def debug_state(self) -> dict:
        """One JSON-safe snapshot of the engine (the JAX engine's
        `debug_state()`, without its `tp` block): slots, prefilling
        entries, the pool's books, and the prefix, spec, loop, quant, sp,
        capture, attribution, SLO and LoRA views. The pool's
        `in_use` is derived from the free and parked counts it is
        reported beside, so the counts always sum to the pool."""
        pool = self.pool
        if self.paged:
            free, parked = len(pool.free_blocks), pool.parked_count()
            books = {
                "blocks_total": self.pool_blocks,
                "scratch_blocks": 1,
                "free": free,
                "parked": parked,
                "in_use": self.pool_blocks - 1 - free - parked,
                "reserved_virtual": int(pool.reserved),
                "min_free_watermark": self.obs.pool_min_free.value(),
            }
        else:
            books = {"blocks_total": 0, "scratch_blocks": 0, "free": 0,
                     "parked": 0, "in_use": 0, "reserved_virtual": 0,
                     "min_free_watermark": None}
        slot_rows = []
        for s in range(self.slots):
            req = self._slot_req[s]
            slot_rows.append({
                "slot": s,
                "rid": req.rid if req is not None else None,
                "tokens_emitted": len(req.tokens) if req is not None else 0,
                "budget_remaining": int(self._budget[s]),
                "write_head": int(pool.slot_pos[s]) if self.paged else None,
                "blocks": len(pool.slot_blocks[s]) if self.paged else None,
            })
        prefilling = [
            {"rid": p.req.rid, "slot": p.slot, "consumed": p.consumed,
             "prompt_len": len(p.req.prompt), "cached": p.cached, "sp": p.sp}
            for p in self._prefilling
        ]
        return {
            "paged": self.paged,
            "queue_depth": len(self._pending),
            "has_work": self.has_work,
            "slots": slot_rows,
            "prefilling": prefilling,
            "pool": books,
            "prefix": self.prefix_stats(),
            "spec": self.spec_stats(),
            "loop": self.loop_stats(),
            "quant": self.quant_stats(),
            "sp": self.sp_stats(),
            "capture": self.capture_stats(),
            "attrib": self.attrib_stats(),
            "slo": self.slo_stats(),
            "lora": self.lora_stats(),
        }

    # -- the capture plane -----------------------------------------------------

    def config_fingerprint(self) -> dict:
        """The engine's config fingerprint (the JAX engine's, field for
        field): the caller's LMConfig fields, the engine's knobs, a CRC-32
        of the weights it serves (and the draft's, with spec on) and the
        adapter set's block; `id` is a short hash of the rest. The header
        of every capture file; `sim/replay.py` rebuilds an engine from it.
        Computed once and cached: the digest reads every weight back to
        the host."""
        if self._fingerprint is not None:
            return self._fingerprint
        fp = {
            "version": 1,
            "cfg": dict(self._fp_cfg),
            "engine": {
                "slots": self.slots,
                "cache_len": self.cache_len,
                "prompt_bucket": self.prompt_bucket,
                "chunk_steps": self.chunk_steps,
                "loop_steps": self.loop_steps,
                "paged": self.paged,
                "pool_blocks": self.pool_blocks,
                # The dense engine has no lane (JAX records 0 for both).
                "prefill_chunk": self.prefill_chunk if self.paged else 0,
                "prefill_lanes": self.prefill_lanes if self.paged else 0,
                "sp_prefill": self.sp_prefill,
                "sp_min_tokens": self.sp_min_tokens,
                "sp_span": self.sp_span,
                "prefix_cache": self.paged and self.pool.prefix is not None,
                "spec": self._spec,
                "spec_k": self._spec_k,
                "spec_min_accept": self._spec_min_accept,
                "spec_warmup_rounds": self._spec_warmup,
                "spec_ema_alpha": self._spec_alpha,
            },
            "weights_crc32": tree_crc32(served_tree(self.model)),
        }
        if self._spec:
            d = self._draft_cfg
            fp["draft"] = {
                "weights_crc32": tree_crc32(served_tree(self._draft)),
                "num_layers": d.num_layers,
                "hidden_dim": d.hidden_dim,
                "num_heads": d.num_heads,
                "vocab_size": d.vocab_size,
                "max_seq_len": d.max_seq_len,
            }
        if self._adapters is not None:
            fp["lora"] = self._adapters.fingerprint()
        fp["id"] = fingerprint_id(fp)
        self._fingerprint = fp
        return fp

    @property
    def fingerprint_id(self) -> str | None:
        """Short id of the computed fingerprint; None until
        `config_fingerprint()` ran (at build when capture is armed)."""
        return self._fingerprint["id"] if self._fingerprint is not None else None

    @property
    def capture(self) -> CaptureLog | None:
        """The armed capture log (None when capture is off)."""
        return self._capture

    def capture_stats(self) -> dict:
        """Capture-plane status: the ring's files, record and byte tallies
        and drop counts, and the fingerprint id completion records carry."""
        if self._capture is None:
            return {"enabled": False, "fingerprint": None}
        return {
            "enabled": True,
            "fingerprint": self.fingerprint_id,
            **self._capture.stats(),
        }

    # -- multi-LoRA adapter plane ----------------------------------------------

    def _upload_adapters(self) -> None:
        """Write the set's host stacks into the device tensors in place:
        every later dispatch, and every fold graph captured earlier,
        computes with the new values."""
        for blk, projs in self._adapters.host_tree().items():
            for proj, pair in projs.items():
                for name, arr in pair.items():
                    self._lora[blk][proj][name].copy_(torch.from_numpy(arr))

    def load_adapter(
        self, adapter: int, tree, *, name: str = "", alpha: float | None = None,
    ) -> None:
        """Hot-load low-rank deltas into adapter id `adapter` between
        dispatches (refused while a queued, prefilling or live request
        uses the id): requests submitted after it decode under the new
        deltas. The id's cached prefix blocks are dropped."""
        self._require_adapter_idle(adapter)
        t0 = time.monotonic()
        self._adapters.load(adapter, tree, name=name, alpha=alpha)
        self._upload_adapters()
        self.pool.drop_tagged(adapter_tag(adapter))
        self.obs.lora_load_seconds.inc(time.monotonic() - t0)
        self.obs.lora_resident.set(len(self._adapters.resident()))
        # The fingerprint pins the adapter digests: recomputed on demand.
        self._fingerprint = None
        self.obs.trace.event(
            "lora_load", time.monotonic(), adapter=adapter,
            adapter_name=name,
        )

    def unload_adapter(self, adapter: int) -> None:
        """Evict adapter `adapter` (back to the all-zero identity; its id
        is free again). Refused while a request uses it."""
        self._require_adapter_idle(adapter)
        self._adapters.unload(adapter)
        self._upload_adapters()
        self.pool.drop_tagged(adapter_tag(adapter))
        self.obs.lora_resident.set(len(self._adapters.resident()))
        self._fingerprint = None
        self.obs.trace.event(
            "lora_unload", time.monotonic(), adapter=adapter,
        )

    def _require_adapter_idle(self, adapter: int) -> None:
        if self._adapters is None:
            raise RuntimeError(
                "engine is not adapter-armed (construct with adapters=)"
            )
        if any(r.adapter == adapter for r in self._requests.values() if not r.done):
            raise RuntimeError(
                f"adapter {adapter} has in-flight requests; drain them "
                f"before swapping its weights"
            )

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
            self.obs.queue_depth.set(len(self._pending))
            self.obs.trace.admitted(req.rid, time.monotonic(), s, 0)

    def _admit_paged(self) -> None:
        """Assign pending requests to free slots and pool blocks and
        queue them on the prefill lane (host bookkeeping only): the
        prefix trie is walked first and matched blocks are shared;
        only the prompt's own new blocks allocate now, while the worst
        case is reserved virtually. Head-of-line: a request that does
        not fit waits, with one exception under `sp_prefill` (JAX
        :3998-4130): a long prompt admits only while no other long entry
        prefills, and a long head held so is jumped by the first request
        behind it that the lane may take. A long never jumps anything."""
        busy = {p.slot for p in self._prefilling}
        prefix = self.pool.prefix
        held_long = False
        for s in range(self.slots):
            if len(self._prefilling) >= self.prefill_lanes or not self._pending:
                break
            if self._slot_req[s] is not None or s in busy:
                continue
            long_busy = any(p.sp for p in self._prefilling)
            pick = None
            for i, cand in enumerate(self._pending):
                if long_busy and self._is_long(cand):
                    held_long = True
                    continue
                pick = i
                break
            if pick is None:
                break
            req = self._pending[pick]
            true_len = len(req.prompt)
            total = self.pool.blocks_needed(true_len, req.max_new_tokens)
            # K/V rows are functions of the adapter's deltas: the tag
            # namespaces the request's whole trie path.
            tag = adapter_tag(req.adapter)
            matched = prefix.match(req.prompt, tag) if prefix is not None else []
            new_need = total - len(matched)
            matched_parked = sum(1 for n in matched if n.refcount == 0)
            if self.pool.available(excluding_parked=matched_parked) < new_need:
                break
            del self._pending[pick]
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
                sp=self._is_long(req),
            )
            if prefix is not None:
                walkable = prefix.matchable_blocks(true_len)
                inserted = prefix.insert(
                    req.prompt, matched[-1] if matched else None,
                    blocks[len(matched):walkable], tag,
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
            if entry.sp:
                self.obs.sp_requests.inc()
            self.obs.queue_depth.set(len(self._pending))
            self.obs.lane_active.set(len(self._prefilling))
            self.obs.sp_active.set(sum(1 for p in self._prefilling if p.sp))
            self.pool.set_gauges()
            self.obs.trace.admitted(
                req.rid, time.monotonic(), s, len(blocks), cached=cached
            )
        if held_long:
            # Once per admission turn in which a long waited for the lane.
            self.obs.sp_holds.inc()

    def _is_long(self, req: _Request) -> bool:
        """A long prompt of the sequence-parallel lane: `sp_prefill` on
        and at least `sp_min_tokens` tokens."""
        return self.sp_prefill and len(req.prompt) >= self.sp_min_tokens

    # -- dispatch --------------------------------------------------------------

    def _dispatch(self):
        """Paged: back the chunk's decode rows, snapshot the table, run
        the decode chunk and the prefill lane, flip finished prefills
        live. Dense: run the decode chunk. Returns the in-flight handle:
        (host tokens, ready event, snapshot, fresh, dispatch time, the
        trace context)."""
        t_host0 = time.monotonic()
        table, lane, finished, lane_rows = None, None, [], 0
        if self.paged:
            (t0, table, lane, finished, lane_rows,
             resident) = self._paged_prologue(self.chunk_steps, advance=True)
        else:
            resident = self._record_kv_snapshot()
            self.obs.profile.on_dispatch()
            t0 = time.monotonic()
        emitted = decode_chunk(
            self.model, self._state, table, self.chunk_steps, self._lora
        )
        if lane is not None:
            run_lane(self.model, self._state, lane, self._lora)
        host, ready = self._to_host(emitted)
        snapshot, fresh = self._epilogue(finished, t0, self.chunk_steps)
        ctx = self._attrib_ctx(
            _busy(snapshot), lane_rows, False, self.chunk_steps, t_host0,
            resident,
        )
        return host, ready, snapshot, fresh, t0, ctx

    def _paged_prologue(self, steps: int, advance: bool):
        """Back the rows this dispatch writes before the table snapshot
        names them, record the KV gauges, tick the profile hook, upload
        the table and assemble the prefill lane. Returns (dispatch time,
        table, lane or None, finished, lane rows in use, resident tokens:
        the cost model's cache-read term)."""
        self._ensure_decode_blocks(steps, advance=advance)
        resident = self._record_kv_snapshot()
        self.obs.profile.on_dispatch()
        if self._adapters is not None:
            # One per armed dispatch: every program gathers the stacks
            # once per projection, whatever the batch's adapter mix.
            self.obs.lora_gather.inc()
        t0 = time.monotonic()
        # int32, the kernels' index type: no per-layer conversion.
        table = to_device(self.pool.table.astype(np.int32), self.device)
        if self._prefilling:
            lane, finished, lane_rows = self._prepare_lane(t0)
            return t0, table, lane, finished, lane_rows, resident
        return t0, table, None, [], 0, resident

    def _epilogue(self, finished: list[_Prefill], t0: float, steps: int):
        """Snapshot the slots before finished prefills flip live (their
        first token rides the next dispatch's input column), then count
        the dispatch. Returns (snapshot, fresh)."""
        snapshot = list(self._slot_req)
        fresh = list(self._slot_new)
        self._slot_new = [False] * self.slots
        if self.paged:
            self._flip_finished(finished)
        self._mark_dispatch(_busy(snapshot), t0, steps)
        return snapshot, fresh

    def _mark_dispatch(self, busy: int, t0: float, steps: int) -> None:
        """`steps` is the dispatch's per-slot step window: chunk_steps, k+1
        for a round, the steps a fold ran."""
        self._last_dispatch_mono = t0
        obs = self.obs
        obs.dispatches.inc()
        obs.last_dispatch.set(time.time())
        obs.slots_active.set(busy)
        obs.busy_steps.inc(busy * steps)
        obs.total_steps.inc(self.slots * steps)

    @staticmethod
    def _attrib_ctx(busy: int, lane_rows: int, spec: bool, steps: int,
                    t_host0: float, resident: int) -> dict:
        """What the dispatch's attribution and trace event need at its
        sync (JAX :3302-3317): its composition class, step window, busy
        slots, host assembly seconds (from the start of assembly to the
        return of its launches) and resident tokens."""
        return {
            "kind": classify_dispatch(busy, lane_rows, spec),
            "steps": steps,
            "busy": busy,
            "host_s": time.monotonic() - t_host0,
            "resident": resident,
        }

    def _dispatch_spec(self):
        """One speculative round: back every live slot's k+1 verify rows
        (the head mirror is exact here: rounds are synchronous), then the
        round, and the prefill lane with its draft mirror when admissions
        ride along."""
        t_host0 = time.monotonic()
        k = self._k_now
        t0, table, lane, finished, lane_rows, resident = self._paged_prologue(
            k + 1, advance=False
        )
        emitted, n_emit = spec_round(
            self.model, self._draft, self._state, self._d_cache, table, k,
            self._lora,
        )
        if lane is not None:
            run_lane(self.model, self._state, lane, self._lora)
            mirror_lane(self._draft, self._d_cache, lane)
        out = torch.cat([emitted, n_emit[:, None]], dim=1)
        snapshot, fresh = self._epilogue(finished, t0, k + 1)
        ctx = self._attrib_ctx(
            _busy(snapshot), lane_rows, True, k + 1, t_host0, resident
        )
        return out, snapshot, fresh, t0, ctx

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

    def _prepare_lane(self, t0: float):
        """Host-side lane assembly: [prefill_lanes, prefill_chunk]
        token and table arrays, each admitted request writing its next
        chunk (the final chunk aligned to the prompt's end, clamped to
        its cached prefix), plus the finishing rows. Marks the request's
        own index nodes ready once their writing chunk is dispatched.

        Sequence-parallel fan-out (JAX :3363-3507): every entry gets one
        row first; then a long (`sp`) entry claims up to `sp_span` - 1
        of the rows left spare, never more than its remaining windows,
        row j carrying its j-th next window. Only its last row can carry
        the finishing operands (first-token sampling, slot flip, adapter
        id). The final window is end-aligned, so it rewrites up to
        W - remaining positions the row before it writes in the same
        dispatch, with equal values (a row's computation does not depend
        on its row index; the scatter writes in row order).

        JAX runs a lane of `rows` rows: those in use, rounded up to a
        power of two, capped at `prefill_lanes`; its pad rows carry
        token 0 at position 0 through the scratch table. The port's
        first `rows` rows are the same, and only they route through the
        MoE layers (`moe_rows`); the rows past them start at the table's
        capacity, so their K/V writes go to the dump block and the
        scratch block holds what JAX's does (the last of its writers in
        row order, as XLA's scatter writes them). On an armed engine every
        chunk of a prompt runs under its request's adapter (`adapter`,
        pad rows 0). Returns (lane, finished, rows in use); `t0` stamps
        each entry's prefill_chunk trace event."""
        W, P = self.prefill_chunk, self.prefill_lanes
        spans = [1] * len(self._prefilling)
        spare = P - len(self._prefilling)
        for i, entry in enumerate(self._prefilling):
            if not entry.sp or spare <= 0:
                continue
            windows = -(-(len(entry.req.prompt) - entry.consumed) // W)
            extra = min(self.sp_span - 1, spare, windows - 1)
            if extra > 0:
                spans[i] += extra
                spare -= extra
        n_rows = sum(spans)
        # Lane utilization: rows carrying a real admission against the
        # configured lane width, summed over lane dispatches.
        self.obs.lane_rows.inc(n_rows)
        self.obs.lane_capacity.inc(P)
        rows = min(1 << (n_rows - 1).bit_length(), P)
        tok = np.zeros((P, W), np.int64)
        start = np.zeros(P, np.int32)
        start[rows:] = self._nlog * PAGE_ROWS
        tbl = np.zeros((P, self._nlog), np.int32)
        true_len = np.ones(P, np.int32)
        temp = np.zeros(P, np.float32)
        topk = np.zeros(P, np.int64)
        topp = np.ones(P, np.float32)
        seed = np.zeros(P, np.int64)
        adapter = np.zeros(P, np.int64)
        fin_rows, fin_slots, finished = [], [], []
        r = 0
        for entry, span in zip(self._prefilling, spans):
            req = entry.req
            n = len(req.prompt)
            if entry.sp and span > 1:
                self.obs.sp_rows.inc(span)
            for _ in range(span):
                adapter[r] = req.adapter
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
                r += 1
            while (
                entry.pending
                and entry.pending[0].depth * PAGE_ROWS <= entry.consumed
            ):
                self.pool.prefix.mark_ready(entry.pending.pop(0))
            self.obs.trace.prefill_chunk(req.rid, t0, entry.consumed, n)
        dev = self.device
        lane = {
            name: to_device(a, dev) for name, a in (
                ("tok", tok), ("start", start), ("table", tbl),
                ("true_len", true_len), ("temp", temp), ("topk", topk),
                ("topp", topp), ("seed", seed), ("adapter", adapter),
                ("fin_rows", np.asarray(fin_rows, np.int64)),
                ("fin_slots", np.asarray(fin_slots, np.int64)),
            )
        }
        lane["rows"] = rows
        return lane, finished, n_rows

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
        self.obs.lane_active.set(len(self._prefilling))
        self.obs.sp_active.set(sum(1 for p in self._prefilling if p.sp))

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

    def _record_kv_snapshot(self) -> int:
        """Per-dispatch KV gauges; returns the resident-token count (the
        attribution cost model's cache-read term)."""
        live = [r for r in self._slot_req if r is not None]
        resident = sum(len(r.prompt) + len(r.tokens) for r in live)
        resident += sum(p.consumed for p in self._prefilling)
        if resident <= 0:
            return 0
        backing = self._kv_backing_bytes()
        self.obs.kv_ratio.set(round(backing / resident, 1))
        self.obs.kv_bytes.inc(float(backing))
        self.obs.kv_resident.inc(resident)
        return resident

    # -- sync and commit -------------------------------------------------------

    def _process(self, host, ready, snapshot, fresh, t_dispatch, ctx) -> None:
        # The blocked device time: the wait for the chunk's tokens to
        # land on the host (the residual the pipelining did not hide).
        t_sync0 = time.monotonic()
        if ready is not None:
            ready.synchronize()
        tokens = host.numpy()
        # One clock read serves every record of the chunk: the trace, the
        # histograms and the done records agree exactly.
        now = time.monotonic()
        self.obs.dispatch_latency.observe(now - t_dispatch)
        n_emitted = 0
        for s, req in enumerate(snapshot):
            if req is None or req.done:
                continue
            emit = tokens[s] if fresh[s] else tokens[s, 1:]
            n_emitted += self._commit_tokens(s, req, emit, now)
        if n_emitted:
            self.obs.tokens.inc(n_emitted)
        self._finish_sync(now, ctx, now - t_sync0)

    def _finish_sync(self, now: float, ctx: dict, device_s: float) -> None:
        """At a dispatch's sync (JAX :3680-3705): its host / device split
        and composition to the attribution layer and the trace, then a
        tick of the SLO layer with the live pressure signals (the paged
        pool's headroom, None on the dense engine)."""
        self._attrib.record(
            kind=ctx["kind"], steps=ctx["steps"],
            host_s=ctx["host_s"], device_s=device_s,
            resident_tokens=ctx["resident"],
            busy_slots=ctx["busy"],
        )
        self.obs.trace.dispatch(
            now, ctx["kind"], ctx["steps"], ctx["host_s"], device_s
        )
        headroom = None
        if self.paged:
            pool = self.pool
            headroom = (
                len(pool.free_blocks) + pool.parked_count()
            ) / max(1, self.pool_blocks - 1)
        self._slo.on_sync(
            now,
            queue_depth=len(self._pending),
            busy_slots=ctx["busy"],
            headroom_frac=headroom,
        )

    def _process_spec(self, out, snapshot, fresh, t_dispatch, ctx) -> None:
        """Sync one round and commit it: per live slot, advance the head
        mirror by the committed count, commit `[input?] + chosen[:n]`,
        return the verify-window blocks the rejections left unused; then
        the counters and the acceptance controller."""
        # Rounds are synchronous: the blocked fetch is the whole round.
        t_sync0 = time.monotonic()
        out = out.cpu().numpy()  # the round's one sync
        tokens, counts = out[:, :-1], out[:, -1]
        now = time.monotonic()
        self.obs.dispatch_latency.observe(now - t_dispatch)
        live = np.array([r is not None and not r.done for r in snapshot], bool)
        n_emitted = 0
        for s in np.flatnonzero(live):
            c = int(counts[s])
            self.pool.slot_pos[s] += c
            emit = tokens[s, :1 + c] if fresh[s] else tokens[s, 1:1 + c]
            n_emitted += self._commit_tokens(s, snapshot[s], emit, now)
            self._rollback_spec_blocks(s)
        if n_emitted:
            self.obs.tokens.inc(n_emitted)
        self._account_round(counts, live, self._k_now, now)
        self.pool.set_gauges()
        self._finish_sync(now, ctx, now - t_sync0)

    def _account_round(self, counts, live, k: int, now: float) -> None:
        """The counters, the trace markers and the controller for one
        speculative round of k drafts: counts [slots] tokens committed per
        slot, live [slots] the slots that were live in it."""
        obs = self.obs
        obs.spec_verify.inc()
        obs.spec_draft.inc(k + 1)
        n = int(live.sum())
        if not n:
            return
        for c in counts[live]:
            obs.spec_emitted.observe(int(c))
        accepted = int(counts[live].sum()) - n
        obs.spec_rounds.inc(n)
        obs.spec_proposed.inc(k * n)
        obs.spec_accepted.inc(accepted)
        obs.trace.spec_round(now, k, n, accepted)
        self._spec_controller(accepted / n)

    def _step_loop(self) -> None:
        """One device-resident fold, dispatch and sync (synchronous: the
        next turn's admissions, backing and k depend on what it
        committed). Pre-back every live slot to the fold's horizon
        (`loop_steps` x chunk_steps rows, or x (k+1) for rounds), upload
        the exit inputs beside the table, run the fold, and replay what
        it surfaced through `_commit_tokens`, the controller and the
        counters as if each chunk or round had synced on its own."""
        t_host0 = time.monotonic()
        pool = self.pool
        spec = self._spec_on
        k = self._k_now
        kstep = (k + 1) if spec else self.chunk_steps
        self._ensure_decode_blocks(self.loop_steps * kstep, advance=False)
        resident = self._record_kv_snapshot()
        self.obs.profile.on_dispatch()
        if self._adapters is not None:
            self.obs.lora_gather.inc()
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
        t0 = time.monotonic()
        tokens, t_run, code, counts = self._loop.run(
            pool.table, live_mask, eos, owed, backed, spec_k=k if spec else 0
        )
        now = time.monotonic()
        steps = t_run * kstep
        # Host seconds: assembly to the fold's launch; device seconds: the
        # time blocked at its one sync (`DecodeLoop.sync_t0` / `sync_s`).
        ctx = self._attrib_ctx(busy, 0, spec, steps, t_host0, resident)
        ctx["host_s"] = self._loop.sync_t0 - t_host0
        obs = self.obs
        obs.dispatch_latency.observe(now - t0)
        n_emitted = 0
        for s, req in enumerate(snapshot):
            if req is None or req.done:
                continue
            adv = int(counts[:t_run, s].sum()) if spec else steps
            pool.slot_pos[s] += adv
            emit = tokens[s, :1 + adv] if fresh[s] else tokens[s, 1:1 + adv]
            n_emitted += self._commit_tokens(s, req, emit, now)
            if spec:
                self._rollback_spec_blocks(s)
        if n_emitted:
            obs.tokens.inc(n_emitted)
        if spec:
            for r in range(t_run):
                self._account_round(counts[r], live_mask, k, now)
            pool.set_gauges()
        self._mark_dispatch(busy, t0, steps)
        obs.loop_dispatches.inc()
        obs.loop_chunks.inc(t_run)
        obs.loop_exits.inc(labels={"reason": LOOP_EXITS[code]})
        self._loop_sync_n += 1
        self._loop_steps_acc += steps
        obs.loop_steps_per_sync.set(
            round(self._loop_steps_acc / self._loop_sync_n, 2)
        )
        self._finish_sync(now, ctx, self._loop.sync_s)

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
            self.obs.trace.event(
                "spec_k_drop", time.monotonic(), k=self._k_now
            )
        else:
            self._spec_on = False
            self.obs.spec_disabled.set(1)
            self.obs.trace.event("spec_disabled", time.monotonic())

    def _commit_tokens(self, s: int, req: _Request, emit, now) -> int:
        """Feed one slot's newly visible tokens into its request: TTFT,
        EOS and budget termination, slot release. Returns the number
        committed."""
        obs = self.obs
        n = 0
        for t in emit:
            if not req.tokens:
                req.first_token_at = now
                obs.ttft.observe(now - req.submitted_at)
                obs.trace.first_token(req.rid, now)
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
                obs.completed.inc(labels={"reason": reason})
                obs.wall.observe(now - req.submitted_at)
                if len(req.tokens) > 1 and now > req.first_token_at:
                    # A request done within its first sync has no
                    # host-visible decode pace.
                    obs.tpot.observe(
                        (now - req.first_token_at) / (len(req.tokens) - 1)
                    )
                obs.trace.done(req.rid, now, reason, len(req.tokens))
                if self._capture is not None:
                    # The one completion seam the chunk, the round and the
                    # fold share: one done record per request.
                    self._capture.record_done(
                        rid=req.rid, trace_id=req.trace_id,
                        tokens=list(req.tokens), n_tokens=len(req.tokens),
                        digest=token_digest(req.tokens),
                        ttft_s=round(req.first_token_at - req.submitted_at, 6),
                        wall_s=round(now - req.submitted_at, 6),
                        truncated=req.truncated, reason=reason,
                        **({"adapter": req.adapter}
                           if self._adapters is not None else {}),
                    )
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
