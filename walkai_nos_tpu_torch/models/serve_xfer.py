"""KV block transfer and live request migration for the paged engine.

Port of the JAX engine's transfer plane (`walkai_nos_tpu/models/serve.py`
:2063-2842): `ContinuousBatcher` takes these methods from `BlockTransfer`.

- `export_blocks(hashes)` / `import_blocks(payload)`: ready prefix blocks
  leave one engine and land in another by content hash (the path hashes
  of `models/block_key.chain_hashes`), so a prompt template warmed on one
  replica serves from cache on every other. An imported block is grafted
  into the trie, written, marked ready and released: it parks, matchable
  and evictable like a block prefilled here.
- `export_resident(only=None)` / `import_resident(payload)`: a draining
  replica ships its accepted work to a peer. Requests with no committed
  token travel as resubmits; live slots travel whole: prompt, tokens,
  remaining budget, knobs, sampling state, write head and the K/V tiles
  of every block up to the head.

The payload is the JAX engine's, field for field, and JSON-safe: a
compatibility header (`_xfer_header`), block or request records, and per
pool leaf one record of base64 tile bytes tagged with its dtype name.
The two packages import each other's payloads. Leaves are serialized in
the order of JAX's flattened flax cache: blocks by their module names
`block{i}` sorted as strings (block0, block1, block10, ...), within a
block `cached_key`, `cached_key_scale`, `cached_value`,
`cached_value_scale` (the scale pools of int8 KV only). Tiles are
[n, kv_heads, 128(, head_dim)]; bf16 tiles are raw 2-byte words under
the tag "bfloat16" (JAX reads them through `ml_dtypes`; the port needs
no such package). Only table blocks travel: never the scratch block 0,
never the pools' dump block.

The sampling state differs from JAX's threefry key: a slot draws token n
with (seed, n) (`models/decode.py`). The payload keeps JAX's `key` field
(two uint32) and the port writes [seed mod 2**32, draw counter] into it;
a port import restores the seed from `seed` and the counter from
`key[1]`, so a port-to-port migration continues a sampled stream
exactly. Across the packages only greedy streams continue exactly (the
port's rule for sampled streams).

Every write into the engine's device state is in place: the CUDA-graph
folds (`models/serve_graph.py`) read the storage they captured, so a fold
after an import serves the imported slots.
"""

from __future__ import annotations

import base64
import time

import numpy as np
import torch

from walkai_nos_tpu_torch.models.block_key import block_key
from walkai_nos_tpu_torch.models.lm import PagedCache
from walkai_nos_tpu_torch.models.lora import adapter_tag
from walkai_nos_tpu_torch.models.serve_lane import _Request
from walkai_nos_tpu_torch.ops.decode_attention import PAGE_ROWS

__all__ = ["BlockTransfer", "kv_leaves"]


def kv_leaves(cache: PagedCache) -> list[tuple[str, torch.Tensor]]:
    """(name, pool) of every K/V pool leaf, data and scale, in the JAX
    cache's flatten order (module docstring)."""
    out = []
    for i in sorted(range(len(cache.k)), key=lambda i: f"block{i}"):
        out.append(("cached_key", cache.k[i]))
        if cache.ks is not None:
            out.append(("cached_key_scale", cache.ks[i]))
        out.append(("cached_value", cache.v[i]))
        if cache.vs is not None:
            out.append(("cached_value_scale", cache.vs[i]))
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _gather_tiles(cache: PagedCache, bids: list[int]) -> list[dict]:
    """Pool blocks `bids` of every leaf, one JSON-safe record per leaf
    ([n, kv_heads, 128(, head_dim)])."""
    out = []
    for name, pool in kv_leaves(cache):
        idx = torch.as_tensor(bids, dtype=torch.long, device=pool.device)
        tile = pool[idx].cpu().contiguous()
        if tile.dtype == torch.bfloat16:
            arr = tile.view(torch.int16).numpy()
        else:
            arr = tile.numpy()
        out.append({
            "name": name,
            "dtype": _dtype_name(tile.dtype),
            "shape": list(arr.shape),
            "data": base64.b64encode(arr.tobytes()).decode("ascii"),
        })
    return out


def _decode_tile(t: dict) -> torch.Tensor | None:
    """A payload tile record as a CPU tensor; None for a dtype name the
    port has no tensor type for."""
    name = str(t["dtype"])
    shape = [int(d) for d in t["shape"]]
    raw = base64.b64decode(t["data"])
    if name == "bfloat16":
        words = np.frombuffer(raw, np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    try:
        arr = np.frombuffer(raw, np.dtype(name)).reshape(shape)
        return torch.from_numpy(arr.copy())
    except TypeError:
        return None


def _scatter_tiles(cache: PagedCache, arrs: list, rows: list[int],
                   bids: list[int]) -> None:
    """Write tile rows `rows` of the decoded payload into pool blocks
    `bids` of every leaf, in place."""
    sel = torch.as_tensor(rows, dtype=torch.long)
    for (_, pool), arr in zip(kv_leaves(cache), arrs):
        idx = torch.as_tensor(bids, dtype=torch.long, device=pool.device)
        pool[idx] = arr[sel].to(pool.device)


def _tile_bytes(payload: dict) -> int:
    return sum(
        len(t["data"])
        for t in payload.get("tiles", []) + payload.get("draft_tiles", [])
    ) * 3 // 4


class BlockTransfer:
    """The transfer plane of `ContinuousBatcher` (module docstring)."""

    # -- the payload's header and tiles ----------------------------------

    def _xfer_header(self) -> dict:
        """The fields two engines must agree on for a block's bytes to
        mean the same thing in both pools (JAX's values: dtype names,
        the adapter set as "aid:crc,...")."""
        c = self.cfg
        return {
            "version": 1,
            "kv_dtype": _dtype_name(c.kv_storage_dtype),
            "kv_heads": c.kv_heads,
            "head_dim": c.head_dim,
            "layers": c.num_layers,
            "quant": bool(c.kv_quant),
            "block_tokens": PAGE_ROWS,
            "spec": self._spec,
            "lora": (
                None if self._adapters is None
                else ",".join(
                    f"{aid}:{crc}"
                    for aid, crc in sorted(self._adapters.digests().items())
                )
            ),
        }

    def _check_xfer_header(self, payload: dict) -> str | None:
        """The first mismatching header field's name, or None."""
        for name, value in self._xfer_header().items():
            if payload.get(name) != value:
                return name
        return None

    def _tiles_compatible(self, arrs: list, d_arrs: list, n: int) -> str | None:
        """Decoded tiles against this engine's pools (`n` blocks): a
        rejection reason (`shape`, `dtype`, `draft`) or None."""
        leaves = kv_leaves(self._state.cache)
        if len(arrs) != len(leaves):
            return "shape"
        for (_, pool), arr in zip(leaves, arrs):
            if arr is None:
                return "dtype"
            if tuple(arr.shape) != (n, self.cfg.kv_heads) + tuple(pool.shape[2:]):
                return "shape"
            if arr.dtype != pool.dtype:
                return "dtype"
        if self._spec:
            leaves = kv_leaves(self._d_cache)
            if len(d_arrs) != len(leaves):
                return "draft"
            for (_, pool), arr in zip(leaves, d_arrs):
                if (arr is None or tuple(arr.shape) != (n,) + tuple(pool.shape[1:])
                        or arr.dtype != pool.dtype):
                    return "draft"
        return None

    def _decode_payload_tiles(self, payload: dict, n: int):
        """(tiles, draft tiles, rejection reason or None)."""
        arrs = [_decode_tile(t) for t in payload.get("tiles", [])]
        d_arrs = [_decode_tile(t) for t in payload.get("draft_tiles", [])]
        return arrs, d_arrs, self._tiles_compatible(arrs, d_arrs, n)

    def _land_tiles(self, arrs, d_arrs, rows, bids) -> None:
        _scatter_tiles(self._state.cache, arrs, rows, bids)
        if self._spec:
            _scatter_tiles(self._d_cache, d_arrs, rows, bids)

    def _ship_tiles(self, payload: dict, bids: list[int]) -> None:
        payload["tiles"] = _gather_tiles(self._state.cache, bids)
        if self._spec:
            payload["draft_tiles"] = _gather_tiles(self._d_cache, bids)

    # -- prefix blocks ----------------------------------------------------

    def export_blocks(self, hashes) -> dict:
        """The ready prefix-index blocks named by `hashes` (path hashes:
        `chain_hashes` of a prompt, or another engine's) as a JSON-safe
        payload: per block its tokens, depth and parent hash, then the
        K/V (and scale) tiles of every layer. Unknown, unready and
        repeated hashes are left out."""
        prefix = self._require_prefix("export_blocks")
        by_hash, by_node = {}, {}
        for hx, node in prefix.hashed_nodes():
            by_hash[hx] = node
            by_node[id(node)] = hx
        records, bids, seen = [], [], set()
        for hx in hashes:
            node = by_hash.get(hx)
            if node is None or not node.ready or hx in seen:
                continue
            seen.add(hx)
            records.append({
                "hash": hx,
                "parent": by_node.get(id(node.parent)),
                "depth": node.depth,
                "tokens": np.frombuffer(node.key, np.int32).tolist(),
            })
            bids.append(node.block)
        payload = {
            **self._xfer_header(), "kind": "blocks", "blocks": records,
            "tiles": [], "draft_tiles": [],
        }
        if records:
            self._ship_tiles(payload, bids)
        self.obs.xfer_exported.inc(len(records))
        nbytes = _tile_bytes(payload)
        if nbytes:
            self.obs.xfer_bytes.inc(nbytes, {"dir": "out"})
        self.obs.trace.event(
            "export_blocks", time.monotonic(), blocks=len(records)
        )
        return payload

    def import_blocks(self, payload: dict) -> dict:
        """Land an `export_blocks` payload: each accepted block takes a
        pool block through `grab_block` (the free list, then eviction of
        a parked block: an import competes like an admission and never
        overflows the pool), is grafted under its parent, written, marked
        ready and released, so it parks. Returns {"imported": n,
        "rejected": {reason: count}}: `dup` (present here), `orphan` (no
        parent here), `dry` (the pool is exhausted), or a header field's
        name, `shape`, `dtype` or `draft`, which reject the payload
        whole."""
        prefix = self._require_prefix("import_blocks")
        rejected: dict[str, int] = {}

        def rej(reason: str, n: int = 1) -> None:
            rejected[reason] = rejected.get(reason, 0) + n

        records = payload.get("blocks", [])
        bad = self._check_xfer_header(payload)
        arrs, d_arrs = [], []
        if bad is None and records:
            arrs, d_arrs, bad = self._decode_payload_tiles(payload, len(records))
        if bad is not None:
            rej(bad, len(records))
            self._count_rejected(rejected)
            return {"imported": 0, "rejected": rejected}
        mine = dict(prefix.hashed_nodes())
        row_of = {r["hash"]: j for j, r in enumerate(records)}
        accepted = []
        for r in sorted(records, key=lambda r: r["depth"]):
            hx = r["hash"]
            if hx in mine:
                rej("dup")
                continue
            parent = None
            if r.get("parent") is not None:
                parent = mine.get(r["parent"])
                # Unknown here, or evicted by a grab of this very import
                # (a detached node has no parent).
                if parent is None or parent.parent is None:
                    rej("orphan")
                    continue
            elif r["depth"] != 1:
                rej("orphan")
                continue
            block = self.pool.grab_block()
            if block is None:
                rej("dry")
                continue
            node = prefix.graft(parent, block_key(r["tokens"]), block)
            if node is None:
                self.pool.free_blocks.append(block)
                rej("dup")
                continue
            mine[hx] = node
            accepted.append((row_of[hx], node, block))
        if accepted:
            self._land_tiles(arrs, d_arrs, [a[0] for a in accepted],
                             [a[2] for a in accepted])
            # Visible only once the tiles have landed; the release parks
            # each block like a released local prefix block.
            for _, node, _ in accepted:
                prefix.mark_ready(node)
                prefix.release(node)
            self.obs.prefix_cached_tokens.set(prefix.cached_tokens)
            self.pool.set_gauges()
            nbytes = _tile_bytes(payload)
            if nbytes:
                self.obs.xfer_bytes.inc(nbytes, {"dir": "in"})
        self.obs.xfer_imported.inc(len(accepted))
        self._count_rejected(rejected)
        self.obs.trace.event(
            "import_blocks", time.monotonic(), blocks=len(accepted)
        )
        return {"imported": len(accepted), "rejected": rejected}

    def _require_prefix(self, what: str):
        if not self.paged or self.pool.prefix is None:
            raise RuntimeError(
                f"{what} requires the paged engine with prefix_cache enabled"
            )
        return self.pool.prefix

    def _count_rejected(self, rejected: dict) -> None:
        for reason, n in rejected.items():
            self.obs.xfer_rejected.inc(n, {"reason": reason})

    # -- live requests ----------------------------------------------------

    @staticmethod
    def _resubmit_state(req: _Request) -> dict:
        return {
            "prompt": req.prompt.tolist(),
            "max_new_tokens": int(req.max_new_tokens),
            "eos_id": req.eos_id,
            "temperature": float(req.temperature),
            "top_k": int(req.top_k),
            "top_p": float(req.top_p),
            "seed": int(req.seed),
            "trace_id": req.trace_id,
            "adapter": int(req.adapter),
        }

    def _drop_prefill(self, entry) -> None:
        """Undo a mid-prefill admission: unlink its unwritten inserted
        index nodes and free their blocks, release its pins on written
        and matched nodes (they park), free its private tail and its
        reservation."""
        prefix = self.pool.prefix
        self._prefilling.remove(entry)
        self.obs.sp_active.set(sum(1 for p in self._prefilling if p.sp))
        nm = entry.cached // PAGE_ROWS
        ins = entry.nodes[nm:]
        n_ready = len(ins) - len(entry.pending)
        for node in reversed(ins[n_ready:]):
            prefix.discard(node)
            self.pool.free_blocks.append(node.block)
        for node in ins[:n_ready] + entry.nodes[:nm]:
            prefix.release(node)
        self.pool.free_blocks.extend(entry.blocks[nm + len(ins):])
        self.pool.reserved -= entry.resv

    def _vacate(self, s: int) -> None:
        req = self._slot_req[s]
        del self._requests[req.rid]
        self._slot_req[s] = None
        self._slot_new[s] = False
        self._budget[s] = 0
        self._release_slot(s)

    def export_resident(self, only=None) -> dict:
        """Evacuate accepted requests into a payload a peer restores with
        `import_resident`. The chunk in flight is processed first.
        Queued and mid-prefill requests, and live ones with no committed
        token, travel as resubmits (their streams are functions of the
        submit's inputs); live slots with committed tokens as migrations,
        with the tiles of every block up to the write head. `only` (rids)
        ships just those decode-ready slots and leaves the rest serving.
        The engine releases everything it ships."""
        if not self.paged:
            raise RuntimeError("export_resident requires the paged engine")
        self._drain_inflight()
        now = time.monotonic()
        only = None if only is None else set(only)
        resubmit, migrate = [], []
        if only is None:
            while self._pending:
                req = self._pending.popleft()
                resubmit.append(self._resubmit_state(req))
                del self._requests[req.rid]
            self.obs.queue_depth.set(0)
            for entry in list(self._prefilling):
                self._drop_prefill(entry)
                resubmit.append(self._resubmit_state(entry.req))
                del self._requests[entry.req.rid]
            self.obs.lane_active.set(0)
        st = self._state
        seeds = st.seeds.cpu().numpy()
        counters = st.counters.cpu().numpy()
        moving = []
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None or req.done:
                continue
            if only is not None and (req.rid not in only or not req.tokens):
                continue
            if not req.tokens:
                # Flipped live with no token committed yet.
                resubmit.append(self._resubmit_state(req))
                self._vacate(s)
                continue
            moving.append(s)
        bids = []
        for s in moving:
            req = self._slot_req[s]
            # The write head: the last committed token is the next input,
            # its row unwritten until fed.
            pos = len(req.prompt) + len(req.tokens) - 1
            # A truncated request never backs again: ship every block its
            # capped budget writes.
            rows = pos + int(self._budget[s]) if req.truncated else pos
            nblk = -(-rows // PAGE_ROWS)
            migrate.append({
                **self._resubmit_state(req),
                "tokens": [int(t) for t in req.tokens],
                "remaining": int(self._budget[s]),
                "truncated": bool(req.truncated),
                "age_s": round(now - req.submitted_at, 6),
                "ttft_s": round(req.first_token_at - req.submitted_at, 6),
                "key": [int(seeds[s]) & 0xFFFFFFFF,
                        int(counters[s]) & 0xFFFFFFFF],
                "tile_row": len(bids),
                "n_blocks": nblk,
            })
            bids.extend(self.pool.slot_blocks[s][:nblk])
        payload = {
            **self._xfer_header(), "kind": "resident",
            "resubmit": resubmit, "migrate": migrate,
            "tiles": [], "draft_tiles": [],
        }
        if bids:
            self._ship_tiles(payload, bids)
        # Released only after their tiles are on the host.
        for s in moving:
            self._vacate(s)
        n = len(resubmit) + len(migrate)
        if n:
            self.obs.xfer_migrated.inc(n, {"dir": "out"})
        self.obs.trace.event(
            "export_resident", time.monotonic(),
            requests=n, migrated=len(migrate),
        )
        return payload

    def import_resident(self, payload: dict) -> list[dict]:
        """Restore an `export_resident` payload. Resubmits go through
        `submit` (past the drain gate: this is accepted work, not new
        traffic); migrations land in free slots with their blocks, write
        head, knobs and sampling state, their tokens pre-filled and their
        prompt's full blocks registered in the trie (matched blocks are
        reused). All or nothing: free slots and blocks are checked before
        anything changes. Returns [{"rid", "trace_id", "migrated"}]."""
        if not self.paged:
            raise RuntimeError("import_resident requires the paged engine")
        bad = self._check_xfer_header(payload)
        migrate = payload.get("migrate", [])
        resubmit = payload.get("resubmit", [])
        arrs, d_arrs = [], []
        n_rows = sum(int(m["n_blocks"]) for m in migrate)
        if bad is None and n_rows:
            arrs, d_arrs, bad = self._decode_payload_tiles(payload, n_rows)
        if bad is not None:
            raise RuntimeError(f"incompatible resident payload: {bad}")
        busy = {p.slot for p in self._prefilling}
        free_slots = [
            s for s in range(self.slots)
            if self._slot_req[s] is None and s not in busy
        ]
        if len(free_slots) < len(migrate):
            raise RuntimeError(
                f"import_resident needs {len(migrate)} free slots; "
                f"{len(free_slots)} available"
            )
        pool, prefix = self.pool, self.pool.prefix
        need = sum(
            pool.blocks_needed(len(m["prompt"]), int(m["max_new_tokens"]))
            for m in migrate
        )
        if migrate and pool.available() < need:
            raise RuntimeError(
                f"import_resident needs {need} blocks; "
                f"{pool.available()} available"
            )
        out = []
        rows_sel, bids_sel, slots = [], [], []
        state = {k: [] for k in ("index", "tokens", "temps", "topks", "topps",
                                 "seeds", "counters", "adapters")}
        now = time.monotonic()
        drain_flag, self._draining = self._draining, False
        try:
            for m in resubmit:
                rid = self.submit(
                    m["prompt"], max_new_tokens=int(m["max_new_tokens"]),
                    eos_id=m["eos_id"], temperature=float(m["temperature"]),
                    top_k=int(m["top_k"]), top_p=float(m["top_p"]),
                    seed=int(m["seed"]), trace_id=m["trace_id"],
                    adapter=int(m.get("adapter", 0)),
                )
                out.append({"rid": rid, "trace_id": m["trace_id"],
                            "migrated": False})
            for m in migrate:
                s = free_slots.pop(0)
                prompt = np.asarray(m["prompt"], np.int32)
                tokens = [int(t) for t in m["tokens"]]
                pos = len(prompt) + len(tokens) - 1
                nblk = int(m["n_blocks"])
                aid = int(m.get("adapter", 0))
                tag = adapter_tag(aid)
                matched = (
                    prefix.match(prompt, tag)[:nblk] if prefix is not None
                    else []
                )
                if prefix is not None:
                    prefix.acquire(matched)
                blocks = [node.block for node in matched]
                while len(blocks) < nblk:
                    block = pool.grab_block()
                    if block is None:
                        raise RuntimeError(
                            "paged pool accounting violated during "
                            "import_resident"
                        )
                    blocks.append(block)
                total = pool.blocks_needed(len(prompt), int(m["max_new_tokens"]))
                resv = 0 if m.get("truncated") else max(0, total - nblk)
                nodes = list(matched)
                if prefix is not None:
                    walkable = prefix.matchable_blocks(len(prompt))
                    inserted = prefix.insert(
                        prompt, matched[-1] if matched else None,
                        blocks[len(matched):walkable], tag,
                    )
                    # Ready now: their tiles land before this call returns.
                    for node in inserted:
                        prefix.mark_ready(node)
                    nodes += inserted
                row0 = int(m["tile_row"])
                for j in range(len(matched), nblk):
                    rows_sel.append(row0 + j)
                    bids_sel.append(blocks[j])
                rid = self._next_rid
                self._next_rid += 1
                req = _Request(
                    rid, prompt, int(m["max_new_tokens"]), m["eos_id"],
                    temperature=float(m["temperature"]),
                    top_k=int(m["top_k"]), top_p=float(m["top_p"]),
                    seed=int(m["seed"]),
                    submitted_at=now - float(m["age_s"]),
                    trace_id=m["trace_id"], adapter=aid,
                )
                req.tokens = tokens
                req.streamed = len(tokens)
                req.first_token_at = req.submitted_at + float(m["ttft_s"])
                req.truncated = bool(m.get("truncated"))
                self._requests[rid] = req
                if self._capture is not None:
                    # A fresh-submit record with the effective seed
                    # (JAX :2740-2760): its replay runs the request from
                    # the prompt to the whole stream the done record pins.
                    # An armed engine adds the adapter id, which JAX's
                    # record leaves out.
                    self._capture.record_submit(
                        rid=rid, trace_id=req.trace_id,
                        prompt=prompt.tolist(),
                        max_new_tokens=int(m["max_new_tokens"]),
                        eos_id=m["eos_id"],
                        temperature=float(m["temperature"]),
                        top_k=int(m["top_k"]), top_p=float(m["top_p"]),
                        seed=int(m["seed"]),
                        arrival_s=round(
                            self._capture.arrival_offset(req.submitted_at), 6
                        ),
                        **({"adapter": aid}
                           if self._adapters is not None else {}),
                    )
                self.obs.trace.submit(
                    rid, req.submitted_at, len(prompt),
                    int(m["max_new_tokens"]), trace_id=req.trace_id,
                )
                self._slot_req[s] = req
                self._slot_new[s] = False
                self._budget[s] = int(m["remaining"])
                pool.bind_slot(s, blocks, nodes, resv, pos)
                pool.reserved += resv
                slots.append(s)
                for name, value in (
                    ("index", pos), ("tokens", tokens[-1]),
                    ("temps", float(m["temperature"])),
                    ("topks", int(m["top_k"])), ("topps", float(m["top_p"])),
                    ("seeds", int(m["seed"])), ("counters", int(m["key"][1])),
                    ("adapters", aid),
                ):
                    state[name].append(value)
                out.append({"rid": rid, "trace_id": req.trace_id,
                            "migrated": True})
        finally:
            self._draining = drain_flag
        if slots:
            if rows_sel:
                self._land_tiles(arrs, d_arrs, rows_sel, bids_sel)
            self._write_slot_state(slots, state)
            if prefix is not None:
                self.obs.prefix_cached_tokens.set(prefix.cached_tokens)
            pool.set_gauges()
        if out:
            self.obs.xfer_migrated.inc(len(out), {"dir": "in"})
        self.obs.trace.event(
            "import_resident", time.monotonic(),
            requests=len(out), migrated=len(slots),
        )
        return out

    def _write_slot_state(self, slots: list[int], values: dict) -> None:
        """Index writes into the persistent slot-state tensors (the
        folds' graphs read them)."""
        st = self._state
        sl = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        for name, vals in values.items():
            t = getattr(st, name)
            if t is None:  # per-slot adapter ids: armed engines only
                continue
            t[sl] = torch.as_tensor(vals, dtype=t.dtype).to(self.device)
