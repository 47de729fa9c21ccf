"""Host-side paged KV block-pool bookkeeping for the serving engine
(port copy of `walkai_nos_tpu/models/block_pool.py`, same behaviour;
`PAGE_ROWS` comes from the port's `ops/decode_attention.py`).

The continuous batcher (`models/serve.py`) stores KV in a shared pool
of 128-row physical blocks per layer; everything the DEVICE sees is a
per-slot block table uploaded per dispatch. Everything the HOST owns —
the free list, the per-slot block lists and table rows, the lazy
decode-block backing, the virtual worst-case reservation, and the
refcount/park/evict glue around the shared-prefix radix index — lives
here, extracted verbatim from serve.py (ROADMAP's "extract the pool
module before the device-resident loop" item) so the loop-horizon
pre-backing logic is reviewable in one place.

Semantics (unchanged from the in-engine version):

- **Block 0 is the reserved scratch block**: never allocated; idle or
  freed slots keep stepping with their table row parked there, so
  their writes land in garbage no live slot ever reads.
- **Lazy decode backing**: admission allocates only the prompt's
  uncached blocks; `back_slot` grabs each decode block as the write
  head is about to cross a 128-row boundary. The worst case is
  reserved VIRTUALLY (`reserved`): admission guarantees free + parked
  blocks cover every admitted request's remaining worst case, so a
  mid-flight grab can always be satisfied — from the free list or by
  LRU-evicting a parked prefix block.
- **Refcount/park/evict**: released prompt-prefix blocks PARK in the
  prefix index (refcount 0, LRU) instead of returning to the free
  list; `grab_block` evicts parked blocks only when the free list is
  dry. With `prefix=None` the pool is a plain exclusive allocator
  (match/park/evict never run).
- **Dtype-polymorphic by construction**: the pool books BLOCKS, never
  bytes, so `LMConfig.kv_dtype="int8"` changes nothing here — a
  physical block id simultaneously names the int8 K/V tiles AND their
  parallel per-row f32 scale tiles (and, under speculation, the draft
  model's mirror of both), so allocation, refcounting, parking, and
  the prefix index's content addressing are one set of books for
  every storage dtype. Byte accounting lives where the dtypes are
  known: `kv_stats()` / `obs/attrib.kv_hbm_bytes_per_token`.

The pool records its own gauges (`cb_kv_pool_blocks{state}`,
`cb_kv_pool_blocks_min_free`, `cb_prefix_evictions_total`,
`cb_prefix_cached_tokens`) through the engine's telemetry bundle
(`obs/serving.ServingObs`);
request/budget decisions (truncation, completion reasons) stay in the
engine — the pool never sees a request.
"""

from __future__ import annotations

import numpy as np

from walkai_nos_tpu_torch.models.prefix_cache import PrefixIndex
from walkai_nos_tpu_torch.ops.decode_attention import PAGE_ROWS

__all__ = ["BlockPool"]


class BlockPool:
    """Allocator state for `pool_blocks` physical 128-row cache blocks
    shared by `slots` serving slots (`pool_blocks=0` builds the empty
    pool the dense engine carries for shape compatibility)."""

    def __init__(
        self,
        *,
        slots: int,
        cache_len: int,
        pool_blocks: int,
        prefix: PrefixIndex | None,
        obs,
    ) -> None:
        self.slots = slots
        self.cache_len = cache_len
        self.nlog = -(-cache_len // PAGE_ROWS)
        self.pool_blocks = pool_blocks
        self.prefix = prefix
        self.obs = obs
        # Host-owned device view: logical cache block j of slot s lives
        # in pool block table[s, j] (0 = the scratch block).
        self.table = np.zeros((slots, self.nlog), np.int32)
        self.slot_blocks: list[list[int]] = [[] for _ in range(slots)]
        self.free_blocks: list[int] = list(range(pool_blocks - 1, 0, -1))
        # Prefix-index pins: slot_nodes[s] pins the FIRST len(nodes)
        # entries of slot_blocks[s] (matched + self-inserted prefix
        # nodes, a contiguous front run); everything after is private.
        self.slot_nodes: list[list] = [[] for _ in range(slots)]
        # Write-head mirror of each LIVE slot's device cache_index, the
        # lazy-backing cursor; and the virtual reservation books.
        self.slot_pos = np.zeros(slots, np.int64)
        self.slot_resv = np.zeros(slots, np.int64)
        self.reserved = 0

    # -- views ---------------------------------------------------------

    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Worst-case physical blocks a request's footprint (prompt +
        budget) covers. Lane pad rows past the footprint never force
        extra blocks: positions beyond the owned table entries map to
        the scratch block, whose garbage no live row ever reads."""
        return -(-min(prompt_len + max_new, self.cache_len) // PAGE_ROWS)

    def parked_count(self) -> int:
        """Blocks held only by the prefix index (refcount 0, evictable
        on demand) — the ONE definition the admission check, the
        residency views, and the pool gauges all share."""
        return self.prefix.parked_blocks if self.prefix is not None else 0

    def blocks_allocated(self) -> int:
        """Distinct pool blocks held by live requests — actual
        residency: shared prefix blocks count once, parked (refcount-0
        cached) blocks don't count at all."""
        return (
            self.pool_blocks - 1 - len(self.free_blocks)
            - self.parked_count()
        )

    def available(self, *, excluding_parked: int = 0) -> int:
        """Blocks an admission may still claim: free + parked, minus
        parked blocks the caller is about to pin itself, minus the
        outstanding virtual reservation."""
        return (
            len(self.free_blocks) + self.parked_count()
            - excluding_parked - self.reserved
        )

    def backed_rows(self, s: int) -> int:
        """Cache rows slot `s`'s allocated blocks physically back —
        the device-resident loop's per-slot exit bound (a write head
        must never cross into an unbacked block mid-loop)."""
        return len(self.slot_blocks[s]) * PAGE_ROWS

    # -- allocation ----------------------------------------------------

    def grab_block(self) -> int | None:
        """One physical block: the free list first, then LRU eviction
        of a parked prefix-index block; None only when the pool is
        truly dry (no free, nothing evictable)."""
        if self.free_blocks:
            return self.free_blocks.pop()
        if self.prefix is not None:
            block = self.prefix.evict_lru()
            if block is not None:
                self.obs.prefix_evictions.inc()
                self.obs.prefix_cached_tokens.set(
                    self.prefix.cached_tokens
                )
                return block
        return None

    def back_slot(self, s: int, end: int) -> bool:
        """Back slot `s`'s cache rows up to position `end`, grabbing
        decode blocks as needed (each grab consumes one unit of the
        slot's virtual reservation). Returns False when the pool ran
        dry mid-backing (the engine truncates the request); the blocks
        grabbed before the dry hit stay allocated."""
        need = -(-end // PAGE_ROWS)
        while len(self.slot_blocks[s]) < need:
            block = self.grab_block()
            if block is None:
                return False
            self.slot_blocks[s].append(block)
            self.table[s, len(self.slot_blocks[s]) - 1] = block
            if self.slot_resv[s] > 0:
                self.slot_resv[s] -= 1
                self.reserved -= 1
        return True

    def bind_slot(
        self, s: int, blocks: list[int], nodes: list, resv: int,
        pos: int,
    ) -> None:
        """Hand a freshly flipped-live slot its blocks, prefix pins,
        remaining virtual reservation, and write-head mirror."""
        self.slot_blocks[s] = blocks
        self.slot_nodes[s] = nodes
        self.slot_resv[s] = resv
        self.slot_pos[s] = pos
        self.table[s, :len(blocks)] = blocks

    def rollback_unused(self, s: int, keep: int) -> None:
        """Return slot `s`'s trailing blocks beyond the first `keep` —
        blocks grabbed for speculative/loop lookahead whose rows were
        never committed. Each returned block goes back to the free
        list (usable by any admission this very turn) and grows the
        slot's virtual reservation back by one, so the admission
        invariant (free + parked >= reserved) is untouched on both
        sides. Garbage writes in a returned block are harmless: any
        block handed to a new owner is rewritten position-by-position
        before those positions become visible (the pad-row
        invariant)."""
        while len(self.slot_blocks[s]) > keep:
            block = self.slot_blocks[s].pop()
            self.table[s, len(self.slot_blocks[s])] = 0
            self.free_blocks.append(block)
            self.slot_resv[s] += 1
            self.reserved += 1

    def release_slot(self, s: int) -> None:
        """Return a freed slot's PRIVATE blocks to the pool, release
        its pins on shared prefix-index nodes (refcount--; at zero the
        node PARKS in the index instead of freeing), drop its virtual
        reservation, and park its table row on the scratch block."""
        nodes = self.slot_nodes[s]
        if nodes:
            for node in nodes:
                self.prefix.release(node)
            self.obs.prefix_cached_tokens.set(self.prefix.cached_tokens)
        self.free_blocks.extend(self.slot_blocks[s][len(nodes):])
        self.slot_blocks[s] = []
        self.slot_nodes[s] = []
        self.reserved -= int(self.slot_resv[s])
        self.slot_resv[s] = 0
        self.table[s, :] = 0
        self.set_gauges()

    def drop_tagged(self, tag: bytes) -> None:
        """Free every parked prefix-index block under an adapter's tag
        (`PrefixIndex.drop_tagged`): a reloaded or unloaded adapter's
        cached rows must never be matched again."""
        if self.prefix is None:
            return
        self.free_blocks.extend(self.prefix.drop_tagged(tag))
        self.obs.prefix_cached_tokens.set(self.prefix.cached_tokens)
        self.set_gauges()

    def set_gauges(self) -> None:
        """Block-pool watermark gauges: free/used/parked split plus
        the low watermark of reclaimable blocks (free + evictable
        parked) since engine start. No-op for the dense engine's
        empty pool."""
        if self.pool_blocks <= 0:
            return
        free = len(self.free_blocks)
        parked = self.parked_count()
        self.obs.pool_blocks.set(free, labels={"state": "free"})
        self.obs.pool_blocks.set(parked, labels={"state": "parked"})
        self.obs.pool_blocks.set(
            self.pool_blocks - 1 - free - parked,
            labels={"state": "used"},
        )
        self.obs.pool_min_free.set_min(free + parked)
