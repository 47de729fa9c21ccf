"""Refcounted radix index over prompt-prefix KV blocks (port copy of
`walkai_nos_tpu/models/prefix_cache.py`, same behaviour).

The sharing layer of the serving engine's paged KV pool
(`models/serve.py`): under templated traffic (the ROADMAP's
"millions of users" profile — few distinct system prompts, many
requests) most prompts open with a prefix some earlier request already
prefilled. RadixAttention (SGLang) and vLLM's prefix caching show that
refcounted sharing of **immutable, full prompt blocks** recovers that
cost with no change to attention math: the block-table indirection the
paged pool already threads through the decode kernel means a shared
physical block is read exactly like a private one.

This module is the host-side index only — pure bookkeeping, no jax:

- **Nodes are full 128-token blocks.** `key` is the raw bytes of one
  block of prompt tokens; the path from the root spells the entire
  prefix, so a node is content-addressed by (absolute position, every
  token before it) — exactly the invariant that makes K/V reuse EXACT
  (RoPE rotates by absolute position and each cached row depends on
  the whole prefix through the layer stack). Partial blocks are never
  indexed: two prompts that diverge inside a block share nothing.
- **Match is capped at `(prompt_len - 1) // block_tokens` blocks**, so
  at least the final prompt token is always recomputed — the prefill
  lane needs its logits to sample the first output token.
- **`ready` gates visibility.** A node registers at admission (so
  concurrent same-template requests dedup on one copy) but becomes
  matchable only once the chunk that writes its rows has been
  DISPATCHED: a later reader's chunks dispatch strictly after, and the
  device executes dispatches in order, so a match never reads rows
  still being written in its own dispatch.
- **Refcount 0 parks, it does not free.** Released prefix blocks stay
  in the index on an LRU order; `evict_lru` reclaims them leaf-first
  only when the engine's free list is dry. A request path refcounts
  every node it matched or inserted, so `refcount(parent) >=
  refcount(child)` by construction and a refcount-0 node's whole
  subtree is reclaimable — `parked_blocks` counts exactly the blocks
  eviction can hand back.
- **Storage-dtype independent.** Content addressing hashes prompt
  TOKEN bytes, never K/V bytes, so a quantized pool
  (`LMConfig.kv_dtype="int8"`) changes nothing here: the physical
  block id a node names simultaneously addresses the int8 K/V tiles
  and their parallel per-row scale tiles, so a shared block carries
  its scales with it and a cache hit reproduces the writer's
  quantized rows exactly (bit-for-bit the same stored bytes — the
  same exactness argument as full precision, one level down).

The engine owns physical allocation; this index never touches the
free list. Lifecycle of a pool block: free -> private (allocated to
one request) -> shared (indexed, refcount >= 1) -> parked (refcount
0, LRU) -> evicted (back to a private allocation) — see
docs/compute-runtime.md.
"""

from __future__ import annotations

import hashlib
import heapq

from walkai_nos_tpu_torch.models.block_key import block_key

__all__ = ["PrefixIndex", "PrefixNode"]


class PrefixNode:
    """One full block of prompt tokens backed by one physical pool
    block. `depth` is 1-based: node at depth d covers prompt tokens
    [(d-1) * block_tokens, d * block_tokens)."""

    __slots__ = (
        "key", "block", "parent", "children", "refcount", "ready",
        "depth", "last_used", "stamp",
    )

    def __init__(self, key: bytes, block: int, parent, depth: int,
                 tick: int):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict[bytes, PrefixNode] = {}
        self.refcount = 0
        self.ready = False
        self.depth = depth
        self.last_used = tick
        # Bumped on every park/unpark transition: a heap entry whose
        # stamp no longer matches is stale and skipped on pop.
        self.stamp = 0


class PrefixIndex:
    def __init__(self, block_tokens: int):
        self.block_tokens = block_tokens
        self._root = PrefixNode(b"", -1, None, 0, 0)
        self._clock = 0  # LRU tick (monotonic, bumped per acquire)
        self._seq = 0  # heap tiebreak (nodes never compared)
        self._nodes = 0
        self._parked = 0  # nodes with refcount == 0 (reclaimable)
        # Min-heap of (last_used, -depth, seq, stamp, node): oldest
        # access first, deepest first on ties — children always pop
        # before their parent (any touch of a child touches the whole
        # path, so parent.last_used >= child.last_used). `stamp` must
        # match node.stamp for the entry to be live; `seq` is a unique
        # tiebreak so nodes are never compared.
        self._heap: list = []

    # -- lookup --------------------------------------------------------

    def matchable_blocks(self, prompt_len: int) -> int:
        """Full blocks of a prompt eligible for sharing — capped so the
        final prompt token is always recomputed (its logits seed the
        first output token)."""
        return max(0, (prompt_len - 1) // self.block_tokens)

    def _keys(self, prompt, n: int, tag: bytes = b"") -> list[bytes]:
        # The shared key function (`models/block_key.py`): the SAME
        # canonical bytes the router's affinity key and the
        # block-transfer hashes are built from, so routing and
        # transfer identity can never drift from the trie's. `tag`
        # (the serving engine's adapter tag, `models/lora.py`)
        # prefixes EVERY key, so requests under different adapters can
        # never share a node for the same prompt — their K/V rows are
        # functions of different deltas. The empty tag (base traffic)
        # keeps keys byte-identical to an untagged index.
        bt = self.block_tokens
        return [
            tag + block_key(prompt[i * bt:(i + 1) * bt])
            for i in range(n)
        ]

    def match(self, prompt, tag: bytes = b"") -> list[PrefixNode]:
        """Longest READY path of full prompt blocks, root-first. Pure
        probe: refcounts and LRU order are untouched until
        `acquire`."""
        out: list[PrefixNode] = []
        node = self._root
        for key in self._keys(
            prompt, self.matchable_blocks(len(prompt)), tag
        ):
            child = node.children.get(key)
            if child is None or not child.ready:
                break
            out.append(child)
            node = child
        return out

    # -- lifecycle -----------------------------------------------------

    def acquire(self, nodes: list[PrefixNode]) -> None:
        """Pin a matched path for one request (refcount++ and LRU
        touch on every node — the whole path shares one tick, so
        parent order stays >= child order)."""
        t = self._tick()
        for node in nodes:
            if node.refcount == 0:
                self._parked -= 1
                node.stamp += 1  # invalidate any pending heap entry
            node.refcount += 1
            node.last_used = t

    def insert(self, prompt, parent: PrefixNode | None,
               blocks: list[int], tag: bytes = b"") -> list[PrefixNode]:
        """Register the prompt's next full blocks after `parent` (None
        = root) as new nodes owned by the caller (refcount 1, NOT
        ready — `mark_ready` flips each once its writing chunk is
        dispatched). Stops at the first already-present child: another
        in-flight request is writing the same content, its copy wins
        and the caller's remaining blocks stay private. `tag` must
        match the `match` probe's tag for the same request."""
        parent = parent or self._root
        t = self._tick()
        out: list[PrefixNode] = []
        keys = self._keys(prompt, parent.depth + len(blocks), tag)
        for key, block in zip(keys[parent.depth:], blocks):
            if key in parent.children:
                break
            node = PrefixNode(key, block, parent, parent.depth + 1, t)
            node.refcount = 1
            parent.children[key] = node
            self._nodes += 1
            out.append(node)
            parent = node
        return out

    def mark_ready(self, node: PrefixNode) -> None:
        node.ready = True

    def release(self, node: PrefixNode) -> None:
        """Drop one request's pin. At refcount 0 the node PARKS on the
        LRU order instead of freeing — the whole point of the index:
        the next request with this prefix re-acquires it for zero
        prefill work."""
        node.refcount -= 1
        if node.refcount == 0:
            self._parked += 1
            if not node.children:
                self._push(node)
            # With children: those are refcount 0 too (a pin always
            # covers the whole path) and already parked; this node
            # becomes pushable when its last child is evicted.

    def evict_lru(self) -> int | None:
        """Reclaim the least-recently-used parked LEAF block; None
        when nothing is evictable. Leaf-first keeps the trie
        consistent: an interior node only becomes evictable once its
        subtree is gone, so every surviving node's path stays
        intact."""
        while self._heap:
            _, _, _, stamp, node = heapq.heappop(self._heap)
            if (
                stamp != node.stamp
                or node.refcount != 0
                or node.children
                or node.parent is None
            ):
                continue  # stale: re-acquired, grew children, or gone
            parent = node.parent
            parent.children.pop(node.key, None)
            node.parent = None
            node.stamp += 1
            self._nodes -= 1
            self._parked -= 1
            if (
                parent is not self._root
                and parent.refcount == 0
                and not parent.children
            ):
                self._push(parent)
            return node.block
        return None

    # -- block transfer (export/import) --------------------------------

    def hashed_nodes(self):
        """Yield (path_hash, node) for every node, parents before
        children — the trie side of the transferable block identity
        (`models/block_key.py`): each hash is the cumulative digest
        of every key on the node's root path, so it names (absolute
        position, entire prefix) exactly like the node itself. Used
        by `export_blocks` to resolve requested hashes and by
        `import_blocks` to dedup against blocks already present."""
        stack = [(self._root, hashlib.sha1())]
        while stack:
            node, h = stack.pop()
            for key, child in node.children.items():
                ch = h.copy()
                ch.update(key)
                yield ch.hexdigest()[:16], child
                stack.append((child, ch))

    def graft(self, parent: PrefixNode | None, key: bytes,
              block: int) -> PrefixNode | None:
        """Attach ONE imported block under `parent` (None = root) as a
        node owned by the importer (refcount 1, NOT ready — the caller
        flips it with `mark_ready` once the K/V tiles have landed in
        the pool, then `release`s its pin so the node parks,
        matchable and evictable, indistinguishable from a
        locally-prefilled-then-released block). Returns None when the
        key is already present under `parent` (duplicate import — the
        caller returns its grabbed block to the free list)."""
        parent = parent or self._root
        if key in parent.children:
            return None
        node = PrefixNode(key, block, parent, parent.depth + 1,
                          self._tick())
        node.refcount = 1
        parent.children[key] = node
        self._nodes += 1
        return node

    def discard(self, node: PrefixNode) -> None:
        """Unlink a LEAF node the caller still owns (refcount 1, e.g.
        an inserted-but-never-written node of a prefill being migrated
        away) — the block returns to the caller, not the LRU order.
        Children-bearing nodes must be discarded leaf-first."""
        if node.children:
            raise ValueError("discard requires a leaf node")
        node.parent.children.pop(node.key, None)
        node.parent = None
        node.stamp += 1
        self._nodes -= 1
        if node.refcount == 0:
            self._parked -= 1

    def drop_tagged(self, tag: bytes) -> list[int]:
        """Unlink every node whose keys carry the adapter tag `tag` (not
        the base model's empty tag) and return their blocks: the K/V rows
        an adapter's replaced weights wrote. Every such node must be
        parked (refcount 0): the engine swaps an adapter only while no
        request uses it."""
        if not tag:
            raise ValueError("drop_tagged needs an adapter's tag, not b''")
        blocks: list[int] = []

        def drop(node: PrefixNode) -> None:
            for child in list(node.children.values()):
                drop(child)
            if node.refcount:
                raise RuntimeError(
                    f"prefix block {node.block} under the tag is still pinned"
                )
            self.discard(node)
            blocks.append(node.block)

        for key, node in list(self._root.children.items()):
            if key.startswith(tag):
                drop(node)
        return blocks

    # -- stats ---------------------------------------------------------

    @property
    def parked_blocks(self) -> int:
        """Blocks held only by the index (refcount 0) — exactly what
        repeated `evict_lru` calls can hand back."""
        return self._parked

    @property
    def cached_blocks(self) -> int:
        return self._nodes

    @property
    def cached_tokens(self) -> int:
        return self._nodes * self.block_tokens

    # -- internals -----------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _push(self, node: PrefixNode) -> None:
        node.stamp += 1
        self._seq += 1
        heapq.heappush(
            self._heap,
            (node.last_used, -node.depth, self._seq, node.stamp, node),
        )
        # Stale entries (re-acquired then re-parked nodes) are
        # normally dropped lazily on pop, but pops only happen when
        # the free list runs dry — a long-lived server that never
        # evicts would grow the heap without bound. Compact when dead
        # weight dominates.
        if len(self._heap) > 64 and len(self._heap) > 2 * self._parked:
            self._heap = [
                e for e in self._heap
                if e[3] == e[4].stamp
                and e[4].refcount == 0
                and not e[4].children
                and e[4].parent is not None
            ]
            heapq.heapify(self._heap)
