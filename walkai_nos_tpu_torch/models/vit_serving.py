"""The ViT detector's serving core: a coalescing micro-batcher.

Port of the `/infer` path of `demos/tpu-sharing-comparison/app/main.py`
without its HTTP layer (`/infer`, `/stats` and the LM endpoints wait for
the torch demo app, ROADMAP "Fleet and tooling"):

- `ViTServer.submit(n)` queues a request for n images;
- one dispatcher thread (`_device_worker`) coalesces queued requests up
  to `max_batch` images within a short window, pads the batch to a
  power-of-two bucket (`_bucket`) and enqueues ONE forward on the card
  without waiting for it; at most `max_inflight` batches are in flight;
- a pool of fencer threads acks completed batches: each waits on the
  `torch.cuda.Event` recorded right after its batch's forward (a fence
  on the card's own completion, not a host fetch of a scalar), then
  fills in the requests' latencies and the counters (`_Stats`);
- `calibrate` measures the fence round trip and the flat-out images/s
  of the served model through the same dispatch + fence path.

As in the demo, inputs never leave the device: one input per bucket is
made once, on the device; here it is random from `seed` (the demo feeds
zeros) so the outputs can be checked. The weights are cast to bf16 once
at load (`cast_serving_weights`, the demo's serving policy) unless
`bf16_weights=False`. The interactive-QoS mode is the demo's: while
small requests (<= `interactive_max` images) arrive, buckets are capped
at `qos_bucket` and the coalescing hold shrinks.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import torch

from walkai_nos_tpu_torch.device import resolve_device
from walkai_nos_tpu_torch.models.train import make_infer_step
from walkai_nos_tpu_torch.models.vit import ViTConfig, ViTDetector, cast_serving_weights
from walkai_nos_tpu_torch.utils.flops import vit_flops_per_image

__all__ = ["ViTServer", "calibrate"]

# Interactive-QoS mode stays on this long after the last small request.
_QOS_IDLE_S = 1.0


@dataclass
class _Request:
    n_images: int
    arrived: float
    done: threading.Event = field(default_factory=threading.Event)
    elapsed: float = 0.0
    batched_with: int = 0


@dataclass
class _Dispatched:
    requests: list
    n_images: int
    bucket: int  # padded dispatch size (>= n_images)
    output: object  # the batch's outputs, kept alive until fenced
    fence: object  # torch.cuda.Event recorded after the forward, or None


class _Stats:
    """The demo's counters. `dispatcher_idle_s`: time the dispatcher
    waited for the first request of a batch (NOT device starvation:
    with deep pipelining the device stays fed meanwhile);
    `device_starved_s`: time with ZERO dispatched-but-unfenced batches,
    the device truly had nothing queued (slightly underestimated: a batch
    counts as in flight until its fencer acks it)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.images = 0
        self.requests = 0
        self.batches = 0
        self.flops = 0.0
        self.padded_images = 0
        self.dispatcher_idle_s = 0.0
        self.worker_waiting_since: float | None = None
        self.inflight = 0
        self.device_starved_s = 0.0
        self.device_idle_since: float | None = time.monotonic()

    def record(self, images, requests, padded, flops) -> None:
        with self._lock:
            self.images += images
            self.requests += requests
            self.batches += 1
            self.padded_images += padded
            self.flops += flops

    def wait_started(self) -> None:
        with self._lock:
            self.worker_waiting_since = time.monotonic()

    def wait_ended(self) -> None:
        with self._lock:
            if self.worker_waiting_since is not None:
                self.dispatcher_idle_s += time.monotonic() - self.worker_waiting_since
                self.worker_waiting_since = None

    def mark_dispatch(self) -> None:
        with self._lock:
            if self.inflight == 0 and self.device_idle_since is not None:
                self.device_starved_s += time.monotonic() - self.device_idle_since
                self.device_idle_since = None
            self.inflight += 1

    def mark_fenced(self, n: int) -> None:
        with self._lock:
            self.inflight -= n
            if self.inflight == 0:
                self.device_idle_since = time.monotonic()

    def snapshot(self) -> dict:
        with self._lock:
            now = time.monotonic()
            idle = self.dispatcher_idle_s
            if self.worker_waiting_since is not None:
                idle += now - self.worker_waiting_since
            starved = self.device_starved_s
            if self.inflight == 0 and self.device_idle_since is not None:
                starved += now - self.device_idle_since
            return {
                "images": self.images,
                "requests": self.requests,
                "batches": self.batches,
                "flops": self.flops,
                "padded_images": self.padded_images,
                "dispatcher_idle_s": idle,
                "device_starved_s": starved,
                "monotonic_s": now,
            }


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def _record_fence(device: torch.device):
    """A CUDA event recorded on the current stream after the work just
    enqueued; None on the CPU, where the forward has already run."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def _wait_fence(fence) -> None:
    if fence is not None:
        fence.synchronize()


def calibrate(infer, model, images, *, window_s: float = 4.0):
    """(fence_rtt_s, model_ceiling_images_per_s): the card's flat-out
    throughput on the served model through the dispatch + fence path the
    server uses: a chain of forwards dispatched back to back, fenced
    once, doubled until the window passes `window_s` (or 1024 batches);
    best of two windows when the window is long enough to matter."""
    device = images.device
    tiny = torch.zeros((), device=device)
    rtts = []
    for _ in range(6):
        t0 = time.perf_counter()
        tiny.add_(1.0)
        _wait_fence(_record_fence(device))
        rtts.append(time.perf_counter() - t0)
    rtt = sorted(rtts[1:])[len(rtts[1:]) // 2]

    infer(model, images)
    _wait_fence(_record_fence(device))  # warm
    n = 4
    while True:
        t0 = time.perf_counter()
        for _ in range(n):
            infer(model, images)
        _wait_fence(_record_fence(device))
        wall = time.perf_counter() - t0
        if wall > window_s or n >= 1024:
            break
        n *= 2
    best = max(wall - rtt, 1e-9)
    if wall > 0.5:
        t0 = time.perf_counter()
        for _ in range(n):
            infer(model, images)
        _wait_fence(_record_fence(device))
        best = min(best, max(time.perf_counter() - t0 - rtt, 1e-9))
    return rtt, images.shape[0] * n / best


class ViTServer:
    """Micro-batched ViT inference on one device (see the module doc).

    `ViTServer(cfg, model)` serves `model` on `device` (`cuda` unless the
    caller passes `device="cpu"`; with `bf16_weights=False` the model
    itself is moved there, else its bf16 copy); `start()` launches the
    dispatcher and the fencers, `submit` queues a request, `close()`
    stops every thread. Usable as a context manager."""

    def __init__(
        self,
        cfg: ViTConfig,
        model: ViTDetector,
        *,
        max_batch: int = 32,
        window_ms: float = 2.0,
        max_inflight: int = 8,
        bf16_weights: bool = True,
        seed: int = 0,
        interactive_max: int = 4,
        qos_bucket: int = 32,
        device=None,
    ):
        if max_batch < 1 or max_inflight < 1:
            raise ValueError("max_batch and max_inflight must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        served = cast_serving_weights(model) if bf16_weights else model
        self.model = served.to(self.device)
        self.infer = make_infer_step(cfg, device=self.device)
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.max_inflight = max_inflight
        self.seed = seed
        self.interactive_max = interactive_max
        self.qos_bucket = qos_bucket
        self.flops_per_image = vit_flops_per_image(cfg)
        self.stats = _Stats()
        # bucket -> the outputs of the last batch fenced at that bucket.
        self.last_outputs: dict[int, dict] = {}
        self._inputs: dict[int, torch.Tensor] = {}
        self._requests: queue.Queue = queue.Queue()
        self._fence_q: queue.Queue = queue.Queue()
        self._inflight = threading.Semaphore(max_inflight)
        self._last_interactive = float("-inf")
        self._threads: list[threading.Thread] = []
        self._fencers = min(8, max_inflight)

    def images_of(self, bucket: int) -> torch.Tensor:
        """The device-resident input of a bucket, made once from the
        seed (bf16, as the demo stages it: the model's first act is the
        cast anyway)."""
        if bucket not in self._inputs:
            gen = torch.Generator(device=self.device).manual_seed(self.seed * 1000 + bucket)
            s = self.cfg.image_size
            self._inputs[bucket] = torch.randn(
                (bucket, s, s, 3), generator=gen, device=self.device
            ).to(torch.bfloat16)
        return self._inputs[bucket]

    # -- threads ------------------------------------------------------------

    def _device_worker(self) -> None:
        """Single dispatcher: coalesce -> pad -> one async forward."""
        lone_wait_s = min(self.window_s, 1e-3)
        while True:
            self.stats.wait_started()
            first = self._requests.get()
            self.stats.wait_ended()
            if first is None:  # close(): serve what is still queued first
                if self._requests.empty():
                    return
                self._requests.put(None)
                continue
            qos = time.monotonic() - self._last_interactive < _QOS_IDLE_S
            eff_max = min(self.max_batch, self.qos_bucket) if qos else self.max_batch
            eff_window = min(self.window_s, 2e-3) if qos else self.window_s
            batch_reqs = [first]
            total = first.n_images
            deadline = time.monotonic() + lone_wait_s
            extended = False
            while total < eff_max:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._requests.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._requests.put(None)
                    break
                if total + nxt.n_images > eff_max:
                    self._requests.put(nxt)  # doesn't fit this tick
                    break
                batch_reqs.append(nxt)
                total += nxt.n_images
                if not extended:
                    # Company arrived: load is streaming, so it's worth
                    # holding the full window to fill the bucket.
                    deadline = time.monotonic() + eff_window
                    extended = True
            self._inflight.acquire()
            bucket = _bucket(total, self.max_batch)
            # In flight from its first launch: an eager forward queues its
            # kernels one by one while the host walks the model.
            self.stats.mark_dispatch()
            out = self.infer(self.model, self.images_of(bucket))
            fence = _record_fence(self.device)
            self._fence_q.put(_Dispatched(batch_reqs, total, bucket, out, fence))

    def _fencer(self) -> None:
        """Ack completed work, one dispatched batch per loop. A pool runs
        so the waits overlap: an ack costs the batch's own completion
        plus one wake-up, whatever else is in flight."""
        while True:
            d = self._fence_q.get()
            if d is None:
                return
            _wait_fence(d.fence)
            self.stats.mark_fenced(1)
            now = time.monotonic()
            self.last_outputs[d.bucket] = d.output
            self._inflight.release()
            self.stats.record(
                d.n_images, len(d.requests), d.bucket - d.n_images,
                self.flops_per_image * d.n_images,
            )
            for r in d.requests:
                r.elapsed = now - r.arrived
                r.batched_with = d.n_images
                r.done.set()

    def start(self) -> "ViTServer":
        if self._threads:
            raise RuntimeError("the server is already started")
        self._threads.append(threading.Thread(target=self._device_worker, daemon=True))
        for _ in range(self._fencers):
            self._threads.append(threading.Thread(target=self._fencer, daemon=True))
        for t in self._threads:
            t.start()
        return self

    def submit(self, n_images: int) -> _Request:
        """Queue a request for `n_images` (clamped to [1, max_batch], as
        the demo's handler does); wait on `.done`."""
        n = max(1, min(int(n_images), self.max_batch))
        req = _Request(n_images=n, arrived=time.monotonic())
        if n <= self.interactive_max:
            self._last_interactive = req.arrived
        self._requests.put(req)
        return req

    def close(self, timeout: float = 60.0) -> None:
        """Stop the dispatcher (after what it holds), then the fencers
        (after every batch in flight is acked)."""
        if not self._threads:
            return
        worker, fencers = self._threads[0], self._threads[1:]
        self._requests.put(None)
        worker.join(timeout)
        for _ in fencers:
            self._fence_q.put(None)
        for t in fencers:
            t.join(timeout)
        alive = [t for t in self._threads if t.is_alive()]
        self._threads = []
        if alive:
            raise RuntimeError(f"{len(alive)} serving threads did not stop")

    def __enter__(self) -> "ViTServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
