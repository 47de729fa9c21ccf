"""The port's copies of the host block books against the JAX package's.

`block_key`, `prefix_cache` and `block_pool` are numpy-only, but the
port may not import them from `walkai_nos_tpu` (its `models/__init__`
pulls in flax), so it keeps copies. These tests drive the same
engine-shaped operation sequences (match, acquire, allocate, insert,
bind, lazy decode backing, rollback, release, LRU eviction under
pressure) through both copies and require identical books after every
operation: hashes, tables, free lists, refcounts, reservations, and the
parked / LRU heap order.
"""

import numpy as np
import pytest

from walkai_nos_tpu.models import block_key as jbk
from walkai_nos_tpu.models import block_pool as jbp
from walkai_nos_tpu.models import prefix_cache as jpc
from walkai_nos_tpu.ops.decode_attention import PAGE_ROWS as J_PAGE_ROWS
from walkai_nos_tpu_torch.models import block_key as tbk
from walkai_nos_tpu_torch.models import block_pool as tbp
from walkai_nos_tpu_torch.models import prefix_cache as tpc
from walkai_nos_tpu_torch.obs.serving import ServingObs
from walkai_nos_tpu_torch.ops.decode_attention import PAGE_ROWS

SLOTS, CACHE_LEN, POOL_BLOCKS = 3, 512, 12


def test_constants_match():
    assert PAGE_ROWS == J_PAGE_ROWS == tbk.BLOCK_TOKENS == jbk.BLOCK_TOKENS


@pytest.mark.parametrize("seed", range(4))
def test_block_key_functions_match(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 127, 128, 129, 300, 513):
        p = rng.integers(0, 1000, n)
        assert tbk.block_key(p[:128]) == jbk.block_key(p[:128])
        assert tbk.chain_hashes(p) == jbk.chain_hashes(p)
        assert tbk.route_key(p) == jbk.route_key(p)
        assert tbk.matchable_blocks(n) == jbk.matchable_blocks(n)
        keys = [tbk.block_key(p[i:i + 128]) for i in range(0, n, 128)]
        assert tbk.block_hash(keys) == jbk.block_hash(keys)


class _Books:
    """One side's pool + index, driven the way the engine drives them."""

    def __init__(self, bp, pc):
        self.pool = bp.BlockPool(
            slots=SLOTS, cache_len=CACHE_LEN, pool_blocks=POOL_BLOCKS,
            prefix=pc.PrefixIndex(PAGE_ROWS), obs=ServingObs(),
        )
        self.grabbed: list[int] = []

    def admit(self, s, prompt, max_new):
        pool, prefix = self.pool, self.pool.prefix
        matched = prefix.match(prompt)
        need = pool.blocks_needed(len(prompt), max_new) - len(matched)
        parked = sum(1 for n in matched if n.refcount == 0)
        if pool.available(excluding_parked=parked) < need:
            return False
        prefix.acquire(matched)
        blocks = [n.block for n in matched]
        new_now = -(-len(prompt) // PAGE_ROWS) - len(matched)
        for _ in range(new_now):
            blocks.append(pool.grab_block())
        self.grabbed += blocks[len(matched):]
        inserted = prefix.insert(
            prompt, matched[-1] if matched else None,
            blocks[len(matched):prefix.matchable_blocks(len(prompt))],
        )
        for node in inserted:
            prefix.mark_ready(node)
        resv = need - new_now
        pool.reserved += resv
        pool.bind_slot(s, blocks, matched + inserted, resv, len(prompt))
        return True

    def advance(self, s, window):
        ok = self.pool.back_slot(s, int(self.pool.slot_pos[s]) + window)
        self.pool.slot_pos[s] += window
        return ok

    def snapshot(self):
        pool, prefix = self.pool, self.pool.prefix
        nodes = sorted(
            (h, n.block, n.refcount, n.ready, n.depth, n.last_used)
            for h, n in prefix.hashed_nodes()
        )
        heap = [(e[0], e[1], e[2], e[3], e[4].block) for e in prefix._heap]
        return {
            "table": pool.table.tolist(),
            "free": list(pool.free_blocks),
            "slot_blocks": [list(b) for b in pool.slot_blocks],
            "slot_nodes": [[n.block for n in ns] for ns in pool.slot_nodes],
            "slot_pos": pool.slot_pos.tolist(),
            "slot_resv": pool.slot_resv.tolist(),
            "reserved": pool.reserved,
            "parked": prefix.parked_blocks,
            "cached": prefix.cached_blocks,
            "nodes": nodes,
            "heap": heap,
            "grabbed": list(self.grabbed),
        }


@pytest.mark.parametrize("seed", range(6))
def test_books_identical_under_engine_traffic(seed):
    rng = np.random.default_rng(seed)
    # Templated traffic: a few shared prefixes, private tails.
    templates = [rng.integers(0, 50, 300) for _ in range(3)]
    jax_side, port_side = _Books(jbp, jpc), _Books(tbp, tpc)
    live = [False] * SLOTS
    for _ in range(60):
        s = int(rng.integers(SLOTS))
        op = rng.random()
        if not live[s]:
            t = templates[int(rng.integers(3))]
            n = int(rng.integers(100, 300))
            prompt = np.concatenate(
                [t[:n], rng.integers(0, 50, int(rng.integers(1, 60)))]
            ).astype(np.int32)
            max_new = int(rng.integers(1, 120))
            ok = [b.admit(s, prompt, max_new) for b in (jax_side, port_side)]
            assert ok[0] == ok[1]
            live[s] = ok[0]
        elif op < 0.5:
            w = int(rng.integers(1, 40))
            assert jax_side.advance(s, w) == port_side.advance(s, w)
        elif op < 0.65:
            keep = max(1, len(jax_side.pool.slot_nodes[s]))
            for b in (jax_side, port_side):
                b.pool.rollback_unused(s, keep)
        else:
            for b in (jax_side, port_side):
                b.pool.release_slot(s)
            live[s] = False
        assert port_side.snapshot() == jax_side.snapshot()
    # The traffic exercised sharing and the LRU order.
    assert jax_side.pool.prefix.cached_blocks > 0
