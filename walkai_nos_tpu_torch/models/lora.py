"""Batched multi-LoRA adapters for the paged serving engine.

Port of `walkai_nos_tpu/models/lora.py` (Punica / S-LoRA style
multi-tenant serving): K fine-tuned low-rank variants of one base model
ride ONE continuous batcher. Every targeted projection (`qkv`,
`out_proj`, `gate`, `fc1`, `fc2`: the five `_dense` sites of
`models/lm.py`) carries a stacked pair

    lora_a: [K, in_features, R]      lora_b: [K, R, out_features]

and each forward adds, per batch row,

    y += (x @ lora_a[ids]) @ lora_b[ids]

where `ids` is the per-slot (or per-lane-row) adapter id vector. The
registry keeps JAX's three invariants:

- adapter 0 is the identity: its `lora_b` slice is all zeros, so base
  rows add an exact zero and a mixed batch needs no masking;
- ragged ranks pad to one rank bucket: an adapter of rank r < R fills
  A's first r columns and B's first r rows, so every adapter shares the
  stacks' shapes (a hot load writes values, never reshapes);
- alpha / r folds into B at load time.

`AdapterSet` is the JAX registry over the same numpy host arrays (its
`digests()` equal JAX's bit for bit: `obs/capture.tree_crc32` writes
each leaf's path as `jax.tree_util.keystr` does). `lora_delta` is the apply,
on tensors: a gather of the id rows and two batched products in f32
(stock PyTorch, as JAX's are `jnp.einsum` outside any Pallas kernel).
The engine (`models/serve.py`) owns the device copy of the stacks and
the per-slot ids; `models/lm.py` calls `lora_delta` at its projection
sites. Tensor parallelism is not ported, so `lora_proj_dims` has no
kv-head expansion.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from walkai_nos_tpu_torch.obs.capture import tree_crc32

__all__ = [
    "AdapterSet",
    "adapter_tag",
    "lora_delta",
    "lora_proj_dims",
    "tree_crc32",
]


def lora_proj_dims(cfg) -> dict[str, tuple[int, int]]:
    """(in_features, out_features) per targeted projection for `cfg`."""
    d = cfg.hidden_dim
    kv_dim = cfg.kv_heads * (d // cfg.num_heads)
    dims = {
        "qkv": (d, d + 2 * kv_dim),
        "out_proj": (d, d),
        "fc1": (d, cfg.mlp_width),
        "fc2": (cfg.mlp_width, d),
    }
    if cfg.mlp == "swiglu":
        dims["gate"] = (d, cfg.mlp_width)
    return dims


def lora_delta(x: torch.Tensor, proj: Mapping, ids: torch.Tensor) -> torch.Tensor:
    """The batched per-row LoRA contribution of one projection:
    `(x @ A[ids]) @ B[ids]` in the stacks' dtype (f32). `x` is [batch,
    steps, in], `ids` [batch] integer; returns [batch, steps, out] (the
    caller casts onto its projection's output). alpha / r is already
    folded into the stored B slices."""
    a = torch.index_select(proj["lora_a"], 0, ids)
    b = torch.index_select(proj["lora_b"], 0, ids)
    return torch.bmm(torch.bmm(x.to(a.dtype), a), b)


def adapter_tag(adapter: int) -> bytes:
    """Prefix-index key tag of an adapter id: empty for adapter 0 (base
    keys stay those of a LoRA-free engine), the int32 bytes of -k for
    adapter k > 0. Every key under the tag then differs from every other
    adapter's keys for the same prompt, so two adapters never share
    cached K/V (an adapter rewrites every cached row through its own
    deltas); real token ids are >= 0, so no base key starts like a tag."""
    if adapter == 0:
        return b""
    return np.int32(-adapter).tobytes()


class AdapterSet:
    """Registry of up to `capacity` adapters (id 0 = the base-model
    identity) over stacked host arrays, one [K, in, R] / [K, R, out]
    pair per (block, projection). Loading or unloading an adapter
    writes values only; the shapes never change."""

    def __init__(self, cfg, *, capacity: int = 4, rank: int = 4):
        if capacity < 2:
            raise ValueError(
                f"capacity must be >= 2 (id 0 is the base identity); "
                f"got {capacity}"
            )
        if rank < 1:
            raise ValueError(f"rank must be >= 1; got {rank}")
        self.capacity = int(capacity)
        self.rank = int(rank)
        self.num_layers = int(cfg.num_layers)
        self._dims = lora_proj_dims(cfg)
        self._host: dict[str, dict] = {
            f"block{i}": {
                proj: {
                    "lora_a": np.zeros((self.capacity, din, self.rank), np.float32),
                    "lora_b": np.zeros((self.capacity, self.rank, dout), np.float32),
                }
                for proj, (din, dout) in self._dims.items()
            }
            for i in range(self.num_layers)
        }
        # id -> {"name", "rank", "alpha"}; id 0 is always resident.
        self._meta: dict[int, dict] = {0: {"name": "base", "rank": 0, "alpha": 0.0}}
        self._digests: dict[str, int] = {}
        # Set by `synthetic()`: a recipe that rebuilds the set.
        self.recipe: dict | None = None

    # -- registry ------------------------------------------------------

    def has(self, adapter: int) -> bool:
        return adapter in self._meta

    def resident(self) -> dict[str, dict]:
        """{str(id): {"name", "rank", "alpha"}} for every resident
        adapter, id 0 included."""
        return {str(aid): dict(meta) for aid, meta in sorted(self._meta.items())}

    def register(self, name: str, tree: dict, *, alpha: float | None = None) -> int:
        """Load `tree` into the lowest free id and return it. Raises when
        the set is full."""
        for aid in range(1, self.capacity):
            if aid not in self._meta:
                self.load(aid, tree, name=name, alpha=alpha)
                return aid
        raise ValueError(f"adapter set is full ({self.capacity - 1} loadable ids)")

    def load(self, adapter: int, tree: dict, *, name: str,
             alpha: float | None = None) -> None:
        """(Re)load adapter `adapter` from `tree` ("block{i}" ->
        projection -> {"a": [in, r], "b": [r, out]}, any subset; what is
        missing stays identity). A rank r under the set's bucket
        zero-pads; alpha (default: the tree's rank, unit scale) folds
        into the stored B slices. A bad tree leaves the slot untouched."""
        if not 1 <= adapter < self.capacity:
            raise ValueError(
                f"adapter id must be in [1, {self.capacity}); got {adapter} "
                f"(id 0 is the reserved base identity)"
            )
        rank_seen = 0
        staged: list[tuple[str, str, np.ndarray, np.ndarray]] = []
        for blk, projs in tree.items():
            if blk not in self._host:
                raise ValueError(f"unknown block {blk!r}")
            for proj, pair in projs.items():
                if proj not in self._dims:
                    raise ValueError(
                        f"unknown projection {proj!r} (targets: {sorted(self._dims)})"
                    )
                din, dout = self._dims[proj]
                a = np.asarray(pair["a"], np.float32)
                b = np.asarray(pair["b"], np.float32)
                r = a.shape[-1]
                if a.shape != (din, r) or b.shape != (r, dout):
                    raise ValueError(
                        f"{blk}/{proj}: A {a.shape} / B {b.shape} do not "
                        f"factor ({din}, {dout}) at a shared rank"
                    )
                if r > self.rank:
                    raise ValueError(
                        f"{blk}/{proj}: rank {r} exceeds the set's rank "
                        f"bucket {self.rank}"
                    )
                rank_seen = max(rank_seen, r)
                staged.append((blk, proj, a, b))
        self._wipe(adapter)
        eff_rank = rank_seen or self.rank
        scale = alpha if alpha is not None else float(eff_rank)
        for blk, proj, a, b in staged:
            r = a.shape[-1]
            pair = self._host[blk][proj]
            pair["lora_a"][adapter, :, :r] = a
            pair["lora_b"][adapter, :r, :] = b * (scale / r)
        self._meta[adapter] = {
            "name": str(name), "rank": int(eff_rank), "alpha": float(scale),
        }
        self._digests.pop(str(adapter), None)

    def unload(self, adapter: int) -> None:
        """Zero adapter `adapter` back to the identity and free its id.
        Id 0 is not unloadable."""
        if adapter == 0:
            raise ValueError("adapter 0 is the base identity")
        if adapter not in self._meta:
            raise ValueError(f"adapter {adapter} is not resident")
        self._wipe(adapter)
        del self._meta[adapter]
        self._digests.pop(str(adapter), None)

    def _wipe(self, adapter: int) -> None:
        for blk in self._host.values():
            for pair in blk.values():
                pair["lora_a"][adapter] = 0.0
                pair["lora_b"][adapter] = 0.0

    # -- engine surface ------------------------------------------------

    def host_tree(self) -> dict:
        """The stacked host arrays, the tree the engine copies onto the
        device."""
        return self._host

    def compatible(self, cfg) -> bool:
        """True when `cfg`'s projection dims and depth match this set's:
        the engine's constructor guard."""
        return (
            lora_proj_dims(cfg) == self._dims
            and int(cfg.num_layers) == self.num_layers
        )

    def digests(self) -> dict[str, int]:
        """Per-adapter `tree_crc32` over the effective (padded,
        alpha-folded) A/B slices, cached until the adapter is reloaded
        or unloaded."""
        for aid in self._meta:
            if aid == 0 or str(aid) in self._digests:
                continue
            sub = {
                blk: {
                    proj: {"lora_a": pair["lora_a"][aid], "lora_b": pair["lora_b"][aid]}
                    for proj, pair in projs.items()
                }
                for blk, projs in self._host.items()
            }
            self._digests[str(aid)] = tree_crc32(sub)
        return {
            str(aid): self._digests[str(aid)]
            for aid in sorted(self._meta) if aid != 0
        }

    def fingerprint(self) -> dict:
        """The set's geometry, residents, digests and (synthetic sets)
        recipe: JAX's capture-fingerprint "lora" block."""
        fp = {
            "capacity": self.capacity,
            "rank": self.rank,
            "adapters": self.resident(),
            "digests": self.digests(),
        }
        if self.recipe is not None:
            fp["recipe"] = dict(self.recipe)
        return fp

    # -- constructors --------------------------------------------------

    @classmethod
    def synthetic(cls, cfg, *, k: int = 4, rank: int = 4, seed: int = 0,
                  scale: float = 0.02) -> "AdapterSet":
        """Deterministic synthetic set of capacity `k`: ids 1..k-1 loaded
        with seeded Gaussian A/B pairs of ragged rank (adapter i gets
        rank 1 + (i - 1) % rank), seeded per (seed, adapter, block,
        projection), the arrays JAX's `synthetic` draws."""
        out = cls(cfg, capacity=k, rank=rank)
        proj_order = sorted(out._dims)
        for aid in range(1, k):
            r = 1 + (aid - 1) % rank
            tree: dict[str, dict] = {}
            for i in range(out.num_layers):
                blk = {}
                for j, proj in enumerate(proj_order):
                    din, dout = out._dims[proj]
                    rng = np.random.default_rng([int(seed), aid, i, j])
                    blk[proj] = {
                        "a": rng.standard_normal((din, r), np.float32) / np.sqrt(din),
                        "b": rng.standard_normal((r, dout), np.float32) * scale,
                    }
                tree[f"block{i}"] = blk
            out.load(aid, tree, name=f"synthetic-{aid}")
        out.recipe = {
            "kind": "synthetic", "k": int(k), "rank": int(rank),
            "seed": int(seed), "scale": float(scale),
        }
        return out
