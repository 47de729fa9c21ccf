"""Input pipeline: tokenized batches with device prefetch.

Port of `walkai_nos_tpu/models/data.py`. Host-side batching stays NumPy
(cheap, memmap-friendly for corpora bigger than RAM); the device boundary
is a prefetch that keeps `size` batches in flight: each batch is copied
into pinned (page-locked) host memory and sent with a `non_blocking`
copy, so step N+1's transfer overlaps step N's compute on the card (the
JAX version's asynchronous `device_put`).
"""

from __future__ import annotations

from collections import deque
from typing import Iterator

import numpy as np
import torch

from walkai_nos_tpu_torch.device import resolve_device

__all__ = ["prefetch_to_device", "to_device", "token_batches"]


def token_batches(
    tokens: np.ndarray,
    *,
    batch_size: int,
    seq_len: int,
    shuffle: bool = True,
    seed: int = 0,
    epochs: int | None = None,
) -> Iterator[np.ndarray]:
    """Yield [batch_size, seq_len] int32 windows from a flat token array.

    Non-overlapping windows, remainder dropped; `epochs=None` cycles
    forever with a fresh shuffle per epoch (deterministic in `seed`).
    `tokens` may be a np.memmap — windows are copied out lazily.
    Argument errors raise here, at the call site (not at first next()).
    """
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"expected a flat token array, got {tokens.shape}")
    n_windows = tokens.shape[0] // seq_len
    if n_windows < batch_size:
        raise ValueError(
            f"{tokens.shape[0]} tokens yield {n_windows} windows of "
            f"{seq_len}; need at least batch_size={batch_size}"
        )

    def generate() -> Iterator[np.ndarray]:
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = (
                rng.permutation(n_windows) if shuffle
                else np.arange(n_windows)
            )
            for start in range(0, n_windows - batch_size + 1, batch_size):
                idx = order[start : start + batch_size]
                batch = np.stack(
                    [tokens[i * seq_len : (i + 1) * seq_len] for i in idx]
                )
                yield batch.astype(np.int32)
            epoch += 1

    return generate()


def to_device(batch, device: torch.device):
    """A batch (an array or tensor, or a dict of them) on `device`; host
    arrays go through pinned memory when the device is a GPU, so the copy
    is asynchronous."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(np.asarray(batch))
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def prefetch_to_device(
    iterator: Iterator,
    *,
    device=None,
    size: int = 2,
) -> Iterator:
    """Keep `size` batches in flight on `device` (`cuda` unless the
    caller passes `device="cpu"`). Each enqueued transfer is an
    asynchronous copy from pinned memory, issued before the current batch
    is yielded, so H2D copies overlap compute. Argument errors raise
    here, at the call site (not at first next())."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)

    def generate() -> Iterator:
        buffer: deque = deque()
        for batch in iterator:
            buffer.append(to_device(batch, dev))
            if len(buffer) >= size:
                yield buffer.popleft()
        while buffer:
            yield buffer.popleft()

    return generate()
