"""Port copy of `walkai_nos_tpu/models/block_key.py` (kept byte-for-byte
in behaviour; the port imports nothing of the JAX package).

The ONE definition of "a KV block's name" — shared by routing
affinity and block-transfer identity.

Two subsystems address prompt-prefix KV blocks by content:

- the engine's radix index (`models/prefix_cache.py`) keys each full
  128-token block by its raw token bytes, with the path from the root
  spelling the entire prefix;
- the fleet router (`router/core.py`) buckets requests by the SAME
  first full block so template traffic lands where its blocks are.

Before this module each side hand-rolled its own byte form (the router
hashed an int64 cast of the first block; the trie used native int32
bytes) — two copies of one identity that could silently drift. Now
both derive from `block_key`:

- `block_key(tokens)` — canonical int32 bytes of ONE block of prompt
  tokens; exactly the trie's node key.
- `block_hash(path_keys)` — hex content hash of a block's whole
  root->node PATH (cumulative over every ancestor's key bytes): the
  transferable identity `export_blocks`/`import_blocks` ship, because
  a cached K/V row depends on the entire prefix, not just its own
  block's tokens.
- `chain_hashes(prompt)` — the path hashes of every matchable full
  block of a prompt, root-first: what a router computes FROM A PROMPT
  ALONE to name the blocks worth shipping.
- `route_key(prompt)` — the affinity bucket: CRC-32 of the first full
  block's `block_key` bytes (None under one full block). Cheap (the
  router hashes every arrival), and aligned with the trie by
  construction: two prompts share a route key iff they share their
  first trie node's key.

Pure host code, no jax — importable by the router without pulling in
the engine.
"""

from __future__ import annotations

import hashlib
import zlib

import numpy as np

__all__ = [
    "BLOCK_TOKENS",
    "block_key",
    "block_hash",
    "chain_hashes",
    "matchable_blocks",
    "route_key",
]

# Token rows per physical KV block. MUST equal
# `ops/decode_attention.PAGE_ROWS` (pinned by a test); duplicated here
# so this module stays free of torch.
BLOCK_TOKENS = 128

# Hex digits of a path hash — 64 bits of SHA-1, plenty for a fleet's
# worth of distinct prefixes (collisions are an efficiency hazard
# only: an importer re-keys its trie from the actual token bytes, so
# a colliding ship lands as the wrong-but-valid block it names).
_HASH_HEX = 16


def block_key(tokens) -> bytes:
    """Canonical byte form of ONE block of prompt tokens — the radix
    index's node key, bit for bit: contiguous native int32."""
    return np.ascontiguousarray(
        np.asarray(tokens, np.int32).reshape(-1)
    ).tobytes()


def block_hash(path_keys) -> str:
    """Hex content hash of a block identified by its full root->node
    path (an iterable of `block_key` bytes, root-first)."""
    h = hashlib.sha1()
    for key in path_keys:
        h.update(key)
    return h.hexdigest()[:_HASH_HEX]


def matchable_blocks(prompt_len: int, block_tokens: int = BLOCK_TOKENS) -> int:
    """Full blocks of a prompt eligible for sharing — capped so the
    final prompt token is always recomputed (the trie's rule)."""
    return max(0, (prompt_len - 1) // block_tokens)


def chain_hashes(prompt, block_tokens: int = BLOCK_TOKENS) -> list[str]:
    """Path hashes of every matchable full block of `prompt`,
    root-first — computed from the prompt alone, no trie needed, and
    equal to `PrefixIndex.hashed_nodes()`'s hashes for the same
    prefix by construction."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    h = hashlib.sha1()
    out: list[str] = []
    for i in range(matchable_blocks(len(prompt), block_tokens)):
        h.update(block_key(prompt[i * block_tokens:(i + 1) * block_tokens]))
        out.append(h.hexdigest()[:_HASH_HEX])
    return out


def route_key(prompt, block_tokens: int = BLOCK_TOKENS) -> int | None:
    """Affinity bucket for a prompt: CRC-32 of its first full block's
    canonical bytes; None when the prompt has no full block (nothing
    shareable — let load balancing place it)."""
    prompt = np.asarray(prompt).reshape(-1)
    if len(prompt) < block_tokens:
        return None
    return zlib.crc32(block_key(prompt[:block_tokens]))
