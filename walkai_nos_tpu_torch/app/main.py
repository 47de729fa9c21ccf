"""The demo inference server pod on the port (PyTorch, one NVIDIA GPU).

The torch counterpart of `demos/tpu-sharing-comparison/app/main.py`,
with its endpoints, knobs, status codes and payload keys: it serves the
YOLOS-style ViT detector over HTTP (`/infer`) and, with
`WALKAI_DEMO_LM=1`, text generation (`/generate`) on the continuous
batcher, on whatever device slice the pod was granted.

1. **Micro-batching.** Concurrent POST /infer requests are coalesced by
   `models/vit_serving.ViTServer`'s single dispatcher into one padded
   forward per tick, bucketed to powers of two.
2. **Fence-based completion.** A pool of fencers acks each batch once
   the card has finished it (a CUDA event recorded after its forward);
   every throughput counter counts only fenced work, and a startup
   calibration measures the fence round trip and the card's flat-out
   images/s on the served model through the same path.
3. **Continuous batching.** Greedy and sampled `/generate` requests join
   the paged `ContinuousBatcher` (`models/serve.py`), owned by one driver
   thread; `"stream": true` answers as server-sent events, one event per
   synced chunk; speculative requests and prompts the engine cache cannot
   hold take the serialized one-shot path (`make_generate_fn`,
   `make_speculative_generate_fn`).

Endpoints (as the JAX app's):
- POST /infer {"batch": N} -> {"inference_time_seconds", "batched_with",
  "slice"};
- POST /generate {"prompt": [...], knobs} -> tokens, or an SSE stream;
  the `X-Walkai-Trace` header is adopted and echoed;
- POST /blocks {"action": "export" | "import", ...}: KV block transfer,
  run on the engine's thread;
- GET /healthz, /stats, /metrics, /debug/trace, /debug/state, /debug/slo,
  /debug/capture, /debug/capture/download; GET and POST /debug/profile
  (a `torch.profiler` window over the engine's next N dispatches,
  `obs/profile.ProfileHook`); POST /debug/capture {"action": "rotate"}.
- GET /debug/kernels (the port's own): the kernel wrappers' launch
  counts, and those of the last completed /debug/profile window.

Knobs, each with the JAX app's default: WALKAI_DEMO_MODEL (tiny),
WALKAI_MAX_BATCH (32), WALKAI_BATCH_WINDOW_MS (2.0),
WALKAI_MAX_INFLIGHT (8), WALKAI_WARM_BUCKETS ("1,8,32"),
WALKAI_CALIB_BATCHES, WALKAI_CALIB_WINDOW_S (4.0),
WALKAI_QOS_INTERACTIVE_MAX (4), WALKAI_QOS_BUCKET (32), WALKAI_DEMO_LM,
WALKAI_LM_MODEL, WALKAI_LM_VOCAB, WALKAI_LM_SEQ, WALKAI_LM_MAX_NEW (64),
WALKAI_DEMO_SPEC, WALKAI_SPEC_K (6), WALKAI_DEMO_CB (1), WALKAI_CB_SLOTS
(4), WALKAI_CB_BUCKET (64), WALKAI_CB_CHUNK (16), WALKAI_CB_LOOP (1),
WALKAI_CB_LOOP_STEPS (8), WALKAI_CB_PAGED (1), WALKAI_CB_LANES (4),
WALKAI_CB_PFCHUNK (64), WALKAI_CB_SP, WALKAI_CB_SP_MIN (2048),
WALKAI_CB_SP_SPAN (0), WALKAI_CB_PREFIX_CACHE (1), WALKAI_CB_LORA,
WALKAI_CB_LORA_RANK (4), WALKAI_CB_SPEC, WALKAI_CB_SPEC_K (3),
WALKAI_CB_SPEC_DRAFT (tiny), WALKAI_CB_KV_DTYPE, WALKAI_LM_W_DTYPE,
WALKAI_SLO_WINDOW_S, WALKAI_SLO_TTFT_P99_S, WALKAI_SLO_TPOT_P99_S,
WALKAI_CAPTURE_DIR (+ _MAX_BYTES, _MAX_FILES), WALKAI_OBS (1),
WALKAI_PROFILE_DIR, TPU_SLICE_ID and PORT (8000).

The port's own rules: the server runs on `cuda` unless
`WALKAI_DEVICE=cpu`; without a GPU it raises at startup. Tensor
parallelism is not ported: `WALKAI_CB_TP > 1` and `WALKAI_TP_EMULATE`
raise NotImplementedError at startup. Weights are random from fixed
seeds (the ViT and the LM from 0, the speculative draft from 1, the
engine's tiny draft from 2), so a capture the server writes replays with
`python -m walkai_nos_tpu_torch.cmd.replay CAPTURE --init-seed 0` on the
same device. `DemoServer` builds the whole pod from an environment
mapping; it also takes prebuilt LM weights, and `start(port=0)` serves it
from a thread of the calling process until `stop()`.

    WALKAI_DEVICE=cpu python -m walkai_nos_tpu_torch.app.main
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import tempfile
import threading
import time
import uuid
from collections.abc import Mapping
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from walkai_nos_tpu_torch.device import resolve_device
from walkai_nos_tpu_torch.models.convert import flax_params_from_model
from walkai_nos_tpu_torch.models.vit_serving import (  # noqa: F401
    ViTServer,
    _bucket,
    _Dispatched,
    _Request,
    _Stats,
    calibrate,
)
from walkai_nos_tpu_torch.obs.profile import ProfileHook
from walkai_nos_tpu_torch.obs.serving import ServingObs
from walkai_nos_tpu_torch.obs.trace import valid_trace_id
from walkai_nos_tpu_torch.ops import attention as fa
from walkai_nos_tpu_torch.ops import decode_attention as da

__all__ = [
    "DemoServer",
    "engine_health",
    "kernel_launches",
    "main",
    "request_trace_id",
]

_STOP = None  # the driver queue's stop sentinel


def engine_health(engine, alive: bool) -> dict | None:
    """The /healthz readiness payload's engine block: liveness of the
    driver loop, queue depth, staleness of the last dispatch, the drain
    flag and progress, and the two scale signals an autoscaler reads
    without scraping Prometheus text (`saturation`, `slo_ok`; None before
    the first dispatch or with telemetry off). None when continuous
    batching is not enabled."""
    if engine is None:
        return None
    age = engine.seconds_since_last_dispatch
    saturation = engine.saturation
    payload = {
        "alive": bool(alive),
        "queue_depth": engine.queue_depth,
        "seconds_since_last_dispatch": (
            None if age is None else round(age, 3)
        ),
        "has_work": engine.has_work,
        "draining": getattr(engine, "draining", False),
        "slots": engine.slots,
        "saturation": (
            None if saturation is None else round(saturation, 4)
        ),
        "slo_ok": engine.slo_ok,
    }
    drain_stats = getattr(engine, "drain_stats", None)
    if drain_stats is not None:
        payload["drain"] = drain_stats()
    return payload


def request_trace_id(*candidates) -> str:
    """First well-formed candidate (header value, body field), else a
    freshly minted local id: every /generate response carries an id
    (`obs/trace.valid_trace_id` is the one charset contract shared with
    the router)."""
    for candidate in candidates:
        adopted = valid_trace_id(candidate)
        if adopted is not None:
            return adopted
    return "d" + uuid.uuid4().hex[:15]


def kernel_launches() -> dict:
    """The kernel wrappers' running launch counts (K1, K2, K7 and their
    int8 arms; K3-K6)."""
    return {**da.LAUNCHES, **fa.LAUNCHES}


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _not_ported(knob: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob} is not ported yet (ROADMAP: parallelism); the port "
        f"serves one device"
    )


class DemoServer:
    """The demo pod: the ViT micro-batcher, the optional LM paths and
    the HTTP surface, built from `env` (default `os.environ`).

    `device` overrides WALKAI_DEVICE. Prebuilt LM weights: `lm_params`
    (a `DecoderLM` or the JAX package's flax tree) for `lm_cfg` (default
    the WALKAI_LM_MODEL choice); the ViT and both drafts are drawn from
    their fixed seeds (0, 1 and 2). `log` receives the startup lines
    (print).
    `start(port)` binds and serves from a thread; `stop()` shuts the
    server, the engine driver and the ViT threads down."""

    def __init__(
        self,
        env: Mapping | None = None,
        *,
        device=None,
        lm_cfg=None,
        lm_params=None,
        log=None,
    ):
        env = os.environ if env is None else env
        self.env = env
        self.log = log or (lambda line: print(line, flush=True))
        if env.get("WALKAI_TP_EMULATE"):
            raise _not_ported("WALKAI_TP_EMULATE (tensor-parallel emulation)")
        if int(env.get("WALKAI_CB_TP", "1")) > 1:
            raise _not_ported("WALKAI_CB_TP > 1")
        self.device = dev = resolve_device(
            device if device is not None else (env.get("WALKAI_DEVICE") or None)
        )
        self.httpd = None
        self._serve_thread = None
        self._driver = None
        self.cb_engine = None
        self.cb_enabled = False
        self._build_vit(env, dev)
        # Telemetry bundle: the registry behind /metrics, the lifecycle
        # trace behind /debug/trace and the profiler hook behind
        # /debug/profile. WALKAI_OBS=0 builds the no-op bundle.
        obs_on = env.get("WALKAI_OBS", "1") == "1"
        self.obs = ServingObs(
            enabled=obs_on,
            profile=ProfileHook.from_env(env) if obs_on else ProfileHook(),
        )
        self.obs.profile.counters = kernel_launches
        self.lm_lock = threading.Lock()
        self.lm_max_new = int(env.get("WALKAI_LM_MAX_NEW", "64"))
        self.lm_cfg = self.lm_model = self.lm_generate = None
        self.lm_spec_generate = self.spec_draft = None
        self.spec_k = 0
        self.cb_slots = self.cb_bucket = 0
        if env.get("WALKAI_DEMO_LM") == "1":
            self._build_lm(env, dev, lm_cfg, lm_params)

    # -- the vision path ----------------------------------------------------

    def _build_vit(self, env, dev) -> None:
        from walkai_nos_tpu_torch.models.vit import (
            VIT_SMALL,
            VIT_TINY,
            ViTDetector,
        )
        from walkai_nos_tpu_torch.utils.flops import (
            peak_bf16_flops,
            roofline,
            vit_flops_per_image,
        )

        cfg = VIT_TINY if env.get("WALKAI_DEMO_MODEL") == "tiny" else VIT_SMALL
        self.vit_cfg = cfg
        self.max_batch = int(env.get("WALKAI_MAX_BATCH", "32"))
        # bf16 serving weights, cast once at load (the demo's policy).
        self.vit = ViTServer(
            cfg,
            ViTDetector(cfg, device=dev, seed=0),
            max_batch=self.max_batch,
            window_ms=float(env.get("WALKAI_BATCH_WINDOW_MS", "2.0")),
            max_inflight=int(env.get("WALKAI_MAX_INFLIGHT", "8")),
            interactive_max=int(env.get("WALKAI_QOS_INTERACTIVE_MAX", "4")),
            qos_bucket=int(env.get("WALKAI_QOS_BUCKET", "32")),
            device=dev,
        )
        flops_per_image = vit_flops_per_image(cfg)
        fence_rtt, ceiling = calibrate(
            self.vit.infer, self.vit.model, self.vit.images_of(self.max_batch),
            window_s=float(env.get("WALKAI_CALIB_WINDOW_S", "4.0")),
            batches=int(env.get("WALKAI_CALIB_BATCHES", "0")) or 4,
        )
        warm = env.get("WALKAI_WARM_BUCKETS", "1,8,32")
        for b in sorted({int(x) for x in warm.split(",") if x.strip()}):
            if 1 <= b <= self.max_batch:
                self.vit.infer(self.vit.model, self.vit.images_of(b))
                _fence(dev)
        self.vit.start()
        if dev.type == "cuda":
            kind = torch.cuda.get_device_name(dev)
            count = torch.cuda.device_count()
        else:
            kind, count = "cpu", 1
        self.slice_id = env.get("TPU_SLICE_ID", "whole-host")
        # No compiler cost analysis on this side: as the JAX app's
        # fallback, the analytic FLOP count with no byte estimate (so no
        # roofline).
        bytes_per_image = 0.0
        self.device_info = {
            "device_kind": kind,
            "device_count": count,
            "peak_bf16_flops": peak_bf16_flops(kind),
            "model_ceiling_images_per_s": ceiling,
            "fence_rtt_s": fence_rtt,
            "flops_per_image": flops_per_image,
            "bytes_per_image": bytes_per_image,
            "roofline": roofline(flops_per_image, bytes_per_image, kind),
            "max_batch": self.max_batch,
            "slice": self.slice_id,
        }
        self.log(
            f"serving on slice {self.slice_id} with {count} {kind} "
            f"device(s), max_batch={self.max_batch}, "
            f"fence_rtt={fence_rtt * 1e3:.1f}ms, "
            f"model_ceiling={ceiling:.0f} img/s"
        )

    # -- the LM paths ---------------------------------------------------------

    def _weights(self, cfg, model, given, seed: int):
        """The weights an engine built for `cfg` takes: `model` when it
        was built for `cfg`; else the caller's weights as a flax tree (the
        engine quantizes a tree for its own int8 config), or the seeded
        draw for `cfg` (what `cmd/replay.py --init-seed` rebuilds)."""
        from walkai_nos_tpu_torch.models.lm import DecoderLM

        if model.cfg == cfg:
            return model
        if given is not None:
            return given if isinstance(given, Mapping) else flax_params_from_model(given)
        return DecoderLM(cfg, device=self.device, seed=seed)

    def _build_lm(self, env, dev, lm_cfg, lm_params) -> None:
        from walkai_nos_tpu_torch.models.decode import make_generate_fn
        from walkai_nos_tpu_torch.models.lm import LM_SMALL, LM_TINY, DecoderLM

        if lm_cfg is None:
            choice = env.get(
                "WALKAI_LM_MODEL",
                "tiny" if env.get("WALKAI_DEMO_MODEL") == "tiny" else "small",
            )
            lm_cfg = LM_TINY if choice == "tiny" else LM_SMALL
        if env.get("WALKAI_LM_VOCAB") or env.get("WALKAI_LM_SEQ"):
            lm_cfg = dataclasses.replace(
                lm_cfg,
                vocab_size=int(env.get("WALKAI_LM_VOCAB") or lm_cfg.vocab_size),
                max_seq_len=int(env.get("WALKAI_LM_SEQ") or lm_cfg.max_seq_len),
            )
        self.lm_cfg = cfg = lm_cfg
        self.lm_model = (
            DecoderLM(cfg, device=dev, seed=0) if lm_params is None
            else DecoderLM.from_params(cfg, lm_params, dev)
        )
        self.lm_generate = make_generate_fn(cfg, device=dev)
        warm_prompt = np.zeros((1, 16), np.int32)
        self.lm_generate(
            self.lm_model, warm_prompt, max_new_tokens=self.lm_max_new
        ).cpu()
        self.log(
            f"lm generation enabled: {cfg.num_layers} layers, "
            f"max_new={self.lm_max_new}"
        )
        if env.get("WALKAI_DEMO_SPEC") == "1":
            # {"speculative": true}: a 1-layer draft proposes, the target
            # verifies; the output is the target's greedy sequence for any
            # draft weights.
            from walkai_nos_tpu_torch.models.speculative import (
                make_speculative_generate_fn,
            )

            self.spec_k = int(env.get("WALKAI_SPEC_K", "6"))
            draft_cfg = dataclasses.replace(
                cfg,
                num_layers=1,
                hidden_dim=max(32, cfg.hidden_dim // 4),
                num_heads=max(2, cfg.num_heads // 4),
            )
            self.spec_draft = DecoderLM(draft_cfg, device=dev, seed=1)
            self.lm_spec_generate = make_speculative_generate_fn(
                cfg, draft_cfg, k=self.spec_k, return_stats=True, device=dev,
            )
            out, _ = self.lm_spec_generate(
                self.lm_model, self.spec_draft, warm_prompt, self.lm_max_new
            )
            out.cpu()
            self.log(f"speculative generation enabled: k={self.spec_k}")
        if env.get("WALKAI_DEMO_CB", "1") == "1":
            self._build_engine(env, dev, cfg, lm_params)

    def _build_engine(self, env, dev, cfg, lm_params) -> None:
        from walkai_nos_tpu_torch.models.decode import cache_bucket
        from walkai_nos_tpu_torch.models.lm import DecoderLM, draft_config
        from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
        from walkai_nos_tpu_torch.obs.capture import CaptureLog

        self.cb_slots = int(env.get("WALKAI_CB_SLOTS", "4"))
        self.cb_bucket = int(env.get("WALKAI_CB_BUCKET", "64"))
        slo_kwargs = {}
        if env.get("WALKAI_SLO_WINDOW_S"):
            slo_kwargs["slo_window_s"] = float(env["WALKAI_SLO_WINDOW_S"])
        objectives = {}
        if env.get("WALKAI_SLO_TTFT_P99_S"):
            objectives["ttft_p99_s"] = float(env["WALKAI_SLO_TTFT_P99_S"])
        if env.get("WALKAI_SLO_TPOT_P99_S"):
            objectives["tpot_p99_s"] = float(env["WALKAI_SLO_TPOT_P99_S"])
        if objectives:
            slo_kwargs["slo_objectives"] = objectives
        # Quantized serving applies to the engine's config only; an
        # unknown value fails here, at LMConfig construction.
        cb_cfg = dataclasses.replace(
            cfg,
            kv_dtype=env.get("WALKAI_CB_KV_DTYPE", "model"),
            w_dtype=env.get("WALKAI_LM_W_DTYPE", "model"),
        )
        spec_kwargs = {}
        if env.get("WALKAI_CB_SPEC") == "1":
            if env.get("WALKAI_CB_SPEC_DRAFT", "tiny") == "self":
                d_cfg, d_model, d_given, d_seed = cfg, self.lm_model, lm_params, 0
            else:
                d_cfg, d_given, d_seed = draft_config(cfg), None, 2
                d_model = DecoderLM(d_cfg, device=dev, seed=d_seed)
            d_cfg_q = dataclasses.replace(
                d_cfg, kv_dtype=cb_cfg.kv_dtype, w_dtype=cb_cfg.w_dtype
            )
            spec_kwargs = {
                "spec": True,
                "spec_k": int(env.get("WALKAI_CB_SPEC_K", "3")),
                "draft_cfg": d_cfg_q,
                "draft_params": self._weights(d_cfg_q, d_model, d_given, d_seed),
            }
        lora_kwargs = {}
        lora_k = int(env.get("WALKAI_CB_LORA", "0"))
        if lora_k > 0:
            from walkai_nos_tpu_torch.models.lora import AdapterSet

            lora_kwargs["adapters"] = AdapterSet.synthetic(
                cb_cfg, k=lora_k, rank=int(env.get("WALKAI_CB_LORA_RANK", "4"))
            )
        paged = env.get("WALKAI_CB_PAGED", "1") == "1"
        engine = ContinuousBatcher(
            cb_cfg,
            self._weights(cb_cfg, self.lm_model, lm_params, 0),
            capture=CaptureLog.from_env(env),
            slots=self.cb_slots,
            cache_len=cache_bucket(self.cb_bucket + self.lm_max_new, cfg.max_seq_len),
            prompt_bucket=self.cb_bucket,
            chunk_steps=int(env.get("WALKAI_CB_CHUNK", "16")),
            loop_steps=(
                int(env.get("WALKAI_CB_LOOP_STEPS", "8"))
                if env.get("WALKAI_CB_LOOP", "1") == "1" and paged else 1
            ),
            paged=paged,
            prefill_lanes=int(env.get("WALKAI_CB_LANES", "4")),
            prefill_chunk=int(env.get("WALKAI_CB_PFCHUNK", "64")),
            sp_prefill=env.get("WALKAI_CB_SP") == "1",
            sp_min_tokens=int(env.get("WALKAI_CB_SP_MIN", "2048")),
            sp_span=int(env.get("WALKAI_CB_SP_SPAN", "0")),
            prefix_cache=env.get("WALKAI_CB_PREFIX_CACHE", "1") == "1",
            **spec_kwargs,
            **slo_kwargs,
            **lora_kwargs,
            obs=self.obs,
            device=dev,
        )
        # Every lane width's programs (and the fold) run now, off the
        # request path.
        engine.warm(max_new_tokens=min(2, self.lm_max_new))
        self.cb_engine = engine
        self.cb_queue = queue.Queue()
        self.cb_waiters: dict[int, dict] = {}
        self.cb_enabled = True
        self._driver = threading.Thread(
            target=self._cb_driver, daemon=True, name="cb-driver"
        )
        self._driver.start()
        self.log(
            f"continuous batching enabled: {self.cb_slots} slots, "
            f"prompt bucket {self.cb_bucket}"
        )

    def _cb_fail_waiter(self, holder, error=None) -> None:
        """tokens=None (the handlers' failure marker), the optional
        error text, the end-of-stream sentinel for SSE waiters, then wake.
        Failures without error text (the engine died) count as
        engine_failure."""
        if error is not None:
            holder["error"] = error
        else:
            self.obs.errors.inc(labels={"reason": "engine_failure"})
        holder["tokens"] = None
        if holder.get("queue") is not None:
            holder["queue"].put(None)
        holder["done"].set()

    def _cb_driver(self) -> None:
        """The one thread owning the engine: drains submissions (blocking
        when idle), steps the batch and fulfils waiters as requests
        finish. Engine-plane jobs (/blocks) run here, between steps. A
        bad per-request knob fails that request; an engine fault fails
        every waiter and disables continuous batching."""
        engine, cbq, waiters = self.cb_engine, self.cb_queue, self.cb_waiters
        try:
            while True:
                try:
                    item = cbq.get(block=not engine.has_work)
                    while True:
                        if item is _STOP:
                            return
                        prompt, max_new, knobs, holder = item
                        if isinstance(prompt, str) and prompt == "__job__":
                            # `max_new` carries the job's callable.
                            try:
                                holder["result"] = max_new(engine)
                            except Exception as err:  # noqa: BLE001
                                holder["error"] = str(err)
                            holder["done"].set()
                            item = cbq.get_nowait()
                            continue
                        try:
                            rid = engine.submit(
                                prompt, max_new_tokens=max_new, **knobs
                            )
                        except ValueError as bad:
                            self._cb_fail_waiter(holder, str(bad))
                        else:
                            waiters[rid] = holder
                        item = cbq.get_nowait()
                except queue.Empty:
                    pass
                if engine.has_work:
                    # Streaming waiters want per-chunk cadence: fold only
                    # while every waiter is a whole-response waiter.
                    engine.step(allow_loop=not any(
                        w.get("queue") is not None for w in waiters.values()
                    ))
                for rid, delta in engine.drain_new_tokens().items():
                    w = waiters.get(rid)
                    if w is not None and w.get("queue") is not None:
                        w["queue"].put(delta)
                for rid, rec in engine.drain_done_records().items():
                    waiter = waiters.pop(rid)
                    waiter["tokens"] = rec["tokens"]
                    waiter["ttft_s"] = rec["ttft_s"]
                    waiter["wall_s"] = rec["wall_s"]
                    waiter["truncated"] = rec.get("truncated", False)
                    waiter["adapter"] = rec.get("adapter", 0)
                    if waiter.get("queue") is not None:
                        waiter["queue"].put(None)  # end of stream
                    waiter["done"].set()
        except Exception as e:  # noqa: BLE001
            self.cb_enabled = False
            self.log(f"continuous batching disabled: {e!r}")
            for waiter in waiters.values():
                self._cb_fail_waiter(waiter)
            waiters.clear()
            while True:  # fail late submissions too
                try:
                    item = cbq.get_nowait()
                except queue.Empty:
                    break
                if item is not _STOP:
                    self._cb_fail_waiter(item[3])

    # -- the server -----------------------------------------------------------

    def bind(self, port: int = 0, host: str = "0.0.0.0") -> "DemoServer":
        handler = type("Handler", (_Handler,), {"app": self})
        self.httpd = _Server((host, port), handler)
        return self

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self, port: int = 0, host: str = "127.0.0.1") -> "DemoServer":
        """Bind and serve from a daemon thread of this process."""
        self.bind(port, host)
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="demo-http"
        )
        self._serve_thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop serving, then the engine driver (waiters still parked
        fail) and the ViT threads; raises if a thread outlives
        `timeout`."""
        alive = []
        if self.httpd is not None:
            if self._serve_thread is not None:
                self.httpd.shutdown()
                self._serve_thread.join(timeout)
                if self._serve_thread.is_alive():
                    alive.append(self._serve_thread.name)
                self._serve_thread = None
            self.httpd.server_close()
            self.httpd = None
        if self._driver is not None:
            self.cb_queue.put(_STOP)
            self._driver.join(timeout)
            if self._driver.is_alive():
                alive.append(self._driver.name)
            self.cb_enabled = False
            for waiter in list(self.cb_waiters.values()):
                self._cb_fail_waiter(waiter)
            self.cb_waiters.clear()
            self._driver = None
        self.vit.close(timeout)
        if alive:
            raise RuntimeError(f"threads did not stop: {alive}")

    def stats(self) -> dict:
        """The /stats payload."""
        payload = {**self.vit.stats.snapshot(), **self.device_info}
        eng = self.cb_engine
        if eng is not None:
            payload["cb_occupancy"] = eng.occupancy()
            payload["cb_kv"] = eng.kv_stats()
            payload["cb_prefix"] = eng.prefix_stats()
            payload["cb_spec"] = eng.spec_stats()
            payload["cb_slo"] = eng.slo_stats()
            payload["cb_attrib"] = eng.attrib_stats()
            payload["cb_loop"] = eng.loop_stats()
            payload["cb_quant"] = eng.quant_stats()
            payload["cb_tp"] = eng.tp_stats()
            payload["cb_sp"] = eng.sp_stats()
            payload["cb_lora"] = eng.lora_stats()
        return payload


class _Server(ThreadingHTTPServer):
    # Many clients reconnect per request; the stdlib backlog of 5 drops
    # connections under burst load.
    request_queue_size = 128
    daemon_threads = True


class _Handler(BaseHTTPRequestHandler):
    # Keep-alive: every response carries Content-Length (SSE closes its
    # connection at the end of its stream).
    protocol_version = "HTTP/1.1"
    app: DemoServer

    def do_POST(self):
        app = self.app
        if self.path == "/generate":
            self._generate()
            return
        if self.path == "/blocks":
            self._blocks()
            return
        if self.path == "/debug/capture":
            cap = app.cb_engine.capture if app.cb_engine is not None else None
            if cap is None:
                self.send_error(404, "no capture armed (set WALKAI_CAPTURE_DIR)")
                return
            from walkai_nos_tpu_torch.obs.capture import rotate_action_from_body

            n = int(self.headers.get("Content-Length", 0))
            try:
                rotate_action_from_body(self.rfile.read(n))
            except (TypeError, ValueError) as e:
                self.send_error(400, str(e))
                return
            cap.rotate()
            self._json(200, {"engine": app.cb_engine.capture_stats()})
            return
        if self.path == "/debug/profile":
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                app.obs.profile.arm(
                    int(body.get("dispatches", 20)),
                    body.get("logdir") or app.env.get(
                        "WALKAI_PROFILE_DIR",
                        os.path.join(tempfile.gettempdir(), "walkai-profile"),
                    ),
                )
            except (TypeError, ValueError, RuntimeError) as e:
                self.send_error(400, str(e))
                return
            self._json(200, app.obs.profile.status())
            return
        if self.path != "/infer":
            self.send_error(404)
            return
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n) or b"{}")
        req = app.vit.submit(int(body.get("batch", 1)))
        if not req.done.wait(timeout=120.0):
            self.send_error(503, "inference timed out")
            return
        self._json(200, {
            "inference_time_seconds": req.elapsed,
            "batched_with": req.batched_with,
            "slice": app.slice_id,
        })

    def _wait_engine(self, holder, what: str) -> bool:
        """Wait for a driver-thread holder, re-checking the engine's
        health each second; on failure sends the 503 and returns False."""
        t0 = time.perf_counter()
        while not holder["done"].wait(timeout=1.0):
            if not self.app.cb_enabled:
                self.send_error(503, "batch engine failed; retry")
                return False
            if time.perf_counter() - t0 > 120.0:
                if what == "generation":
                    self.app.obs.errors.inc(labels={"reason": "generation_timeout"})
                self.send_error(503, f"{what} timed out")
                return False
        return True

    def _blocks(self):
        """KV block transfer: export named prefix blocks out of this pod's
        trie, or import a peer's export, as jobs on the engine's thread."""
        app = self.app
        if app.cb_engine is None or not app.cb_enabled:
            self.send_error(404, "continuous batching not enabled")
            return
        n = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            action = body.get("action")
            if action == "export":
                hashes = body.get("hashes")
                if not isinstance(hashes, list):
                    raise ValueError("hashes must be a list")

                def job(eng, hashes=hashes):
                    return eng.export_blocks(hashes)
            elif action == "import":
                payload = body.get("payload")
                if not isinstance(payload, dict):
                    raise ValueError("payload must be a JSON object")

                def job(eng, payload=payload):
                    return eng.import_blocks(payload)
            else:
                raise ValueError("action must be 'export' or 'import'")
        except (TypeError, ValueError) as e:
            self.send_error(400, str(e))
            return
        holder = {"done": threading.Event()}
        app.cb_queue.put(("__job__", job, None, holder))
        if not self._wait_engine(holder, "block transfer"):
            return
        if holder.get("error"):
            self.send_error(400, holder["error"])
            return
        if "result" not in holder:  # the driver died mid-job
            self.send_error(503, "batch engine failed; retry")
            return
        self._json(200, holder["result"])

    def _generate(self):
        app = self.app
        if app.lm_generate is None:
            self.send_error(404, "set WALKAI_DEMO_LM=1 to enable")
            return
        cfg = app.lm_cfg
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n) or b"{}")
        trace_id = request_trace_id(
            self.headers.get("X-Walkai-Trace"), body.get("trace_id")
        )
        prompt = body.get("prompt")
        speculative = bool(body.get("speculative"))
        if speculative and app.lm_spec_generate is None:
            self.send_error(404, "set WALKAI_DEMO_SPEC=1 to enable")
            return
        if not isinstance(prompt, list) or not prompt:
            self.send_error(400, "prompt must be a non-empty list")
            return
        # A speculative round verifies up to k positions past the last
        # emitted token, so its position budget is tighter.
        budget = app.lm_max_new + (app.spec_k if speculative else 0)
        if len(prompt) + budget > cfg.max_seq_len:
            self.send_error(
                400,
                f"prompt {len(prompt)} + {budget} positions "
                f"exceeds max_seq_len {cfg.max_seq_len}",
            )
            return
        if any(
            not isinstance(t, int) or not 0 <= t < cfg.vocab_size
            for t in prompt
        ):
            self.send_error(400, "prompt tokens out of vocab range")
            return
        try:
            knobs = {
                "temperature": float(body.get("temperature", 0.0)),
                "top_k": int(body.get("top_k", 0)),
                "top_p": float(body.get("top_p", 1.0)),
            }
            if body.get("seed") is not None:
                knobs["seed"] = int(body["seed"])
            if body.get("adapter") is not None:
                knobs["adapter"] = int(body["adapter"])
            req_max_new = (
                int(body["max_new_tokens"])
                if body.get("max_new_tokens") is not None else None
            )
            req_eos = (
                int(body["eos_id"]) if body.get("eos_id") is not None else None
            )
        except (TypeError, ValueError):
            self.send_error(400, "malformed sampling knobs")
            return
        if req_max_new is not None and not 1 <= req_max_new <= app.lm_max_new:
            self.send_error(
                400, f"max_new_tokens must be in [1, {app.lm_max_new}]"
            )
            return
        if req_eos is not None and not 0 <= req_eos < cfg.vocab_size:
            self.send_error(400, "eos_id out of vocab range")
            return
        req_stream = bool(body.get("stream"))
        wants_sampling = (
            knobs["temperature"] != 0.0
            or knobs["top_k"] != 0
            or knobs["top_p"] != 1.0
            or "seed" in knobs
            # Adapters, per-request budgets, EOS and streaming exist only
            # on the batched engine.
            or "adapter" in knobs
            or req_max_new is not None
            or req_eos is not None
            or req_stream
        )
        on_batched_path = (
            not speculative
            and app.cb_engine is not None
            and app.cb_enabled
            and len(prompt) + (req_max_new or app.lm_max_new)
            <= app.cb_engine.cache_len
        )
        if wants_sampling and not on_batched_path:
            self.send_error(
                400,
                "sampling knobs are served by the batched path "
                "only (greedy fallback: speculative, over-bucket "
                "prompt, or batching disabled)",
            )
            return
        if on_batched_path:
            if req_eos is not None:
                knobs["eos_id"] = req_eos
            knobs["trace_id"] = trace_id
            if req_stream:
                self._generate_stream(prompt, knobs, req_max_new, trace_id)
                return
            waiter = {"done": threading.Event()}
            t0 = time.perf_counter()
            app.cb_queue.put((prompt, req_max_new or app.lm_max_new, knobs, waiter))
            if not self._wait_engine(waiter, "generation"):
                return
            if waiter["tokens"] is None:
                if waiter.get("error"):  # rejected knobs
                    self.send_error(400, waiter["error"])
                    return
                self.send_error(503, "batch engine failed; retry")
                return
            dt = time.perf_counter() - t0
            try:
                self._json(200, {
                    "trace_id": trace_id,
                    "fingerprint": app.cb_engine.fingerprint_id,
                    "tokens": waiter["tokens"],
                    "generate_time_seconds": round(dt, 6),
                    "ttft_seconds": round(waiter.get("ttft_s", 0.0), 6),
                    "engine_wall_seconds": round(waiter.get("wall_s", 0.0), 6),
                    "tokens_per_second": round(len(waiter["tokens"]) / dt, 1),
                    "slice": app.slice_id,
                    "batched": True,
                    "cb_slots": app.cb_slots,
                    "truncated": waiter.get("truncated", False),
                    "adapter": waiter.get("adapter", 0),
                }, headers={"X-Walkai-Trace": trace_id})
            except (BrokenPipeError, ConnectionResetError):
                app.obs.errors.inc(labels={"reason": "client_disconnect"})
            return
        # Serialized: one generation at a time next to the vision
        # dispatcher.
        arr = np.asarray([prompt], np.int32)
        extra = {}
        with app.lm_lock:
            t0 = time.perf_counter()
            if speculative:
                out, sstats = app.lm_spec_generate(
                    app.lm_model, app.spec_draft, arr, app.lm_max_new
                )
                hist = sstats["acceptance_hist"].cpu().numpy()
                rounds = int(hist.sum())
                accepted = float((np.arange(app.spec_k + 1) * hist).sum())
                extra = {
                    "speculative": True,
                    "spec_k": app.spec_k,
                    "acceptance_rate": round(
                        accepted / max(1, rounds * app.spec_k), 4
                    ),
                    "tokens_per_round": round(
                        (accepted + rounds) / max(1, rounds), 2
                    ),
                }
            else:
                out = app.lm_generate(
                    app.lm_model, arr, max_new_tokens=app.lm_max_new
                )
            tokens = out.cpu()[0].tolist()  # fenced by the copy
            dt = time.perf_counter() - t0
        self._json(200, {
            "trace_id": trace_id,
            "tokens": tokens,
            "generate_time_seconds": round(dt, 6),
            "tokens_per_second": round(app.lm_max_new / dt, 1),
            "slice": app.slice_id,
            **extra,
        }, headers={"X-Walkai-Trace": trace_id})

    def _generate_stream(self, prompt, knobs, req_max_new, trace_id):
        """Server-sent events: tokens as each engine chunk syncs, then a
        final event with the request telemetry; the connection closes at
        the end of the stream."""
        app = self.app
        waiter = {"done": threading.Event(), "queue": queue.SimpleQueue()}
        t0 = time.perf_counter()
        app.cb_queue.put((prompt, req_max_new or app.lm_max_new, knobs, waiter))
        # The status line waits for the first queue item: a request the
        # engine rejects gets the non-streaming path's 400.
        while True:
            try:
                item = waiter["queue"].get(timeout=1.0)
                break
            except queue.Empty:
                if not app.cb_enabled:
                    self.send_error(503, "batch engine failed; retry")
                    return
                if time.perf_counter() - t0 > 120.0:
                    app.obs.errors.inc(labels={"reason": "generation_timeout"})
                    self.send_error(503, "generation timed out")
                    return
        if item is None and waiter.get("error"):
            self.send_error(400, waiter["error"])
            return
        if item is None and waiter.get("tokens") is None:
            self.send_error(503, "batch engine failed; retry")
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.send_header("X-Walkai-Trace", trace_id)
        self.end_headers()
        self.close_connection = True

        def event(payload: dict) -> None:
            self.wfile.write(b"data: " + json.dumps(payload).encode() + b"\n\n")
            self.wfile.flush()

        try:
            while True:
                if item is None:  # end of stream (or failure)
                    if waiter.get("tokens") is None:
                        event({"error": "batch engine failed; retry"})
                    else:
                        event({
                            "done": True,
                            "trace_id": trace_id,
                            "fingerprint": app.cb_engine.fingerprint_id,
                            "n_tokens": len(waiter["tokens"]),
                            "ttft_seconds": round(waiter.get("ttft_s", 0.0), 6),
                            "engine_wall_seconds": round(
                                waiter.get("wall_s", 0.0), 6
                            ),
                            "slice": app.slice_id,
                            "batched": True,
                            "truncated": waiter.get("truncated", False),
                            "adapter": waiter.get("adapter", 0),
                        })
                    return
                event({"tokens": item})
                while True:
                    try:
                        item = waiter["queue"].get(timeout=1.0)
                        break
                    except queue.Empty:
                        if not app.cb_enabled:
                            event({"error": "batch engine failed; retry"})
                            return
                        if time.perf_counter() - t0 > 120.0:
                            app.obs.errors.inc(
                                labels={"reason": "generation_timeout"}
                            )
                            event({"error": "generation timed out"})
                            return
        except (BrokenPipeError, ConnectionResetError):
            # The engine finishes the request on its own.
            app.obs.errors.inc(labels={"reason": "client_disconnect"})

    def do_GET(self):
        app = self.app
        eng = app.cb_engine
        if self.path == "/healthz":
            self._json(200, {
                "ok": True,
                "monotonic_s": time.monotonic(),
                "engine": engine_health(eng, app.cb_enabled),
            })
        elif self.path == "/metrics":
            self._text(200, app.obs.registry.render().encode(),
                       "text/plain; version=0.0.4")
        elif self.path == "/debug/trace":
            self._json(200, app.obs.trace.chrome_trace())
        elif self.path == "/debug/profile":
            self._json(200, app.obs.profile.status())
        elif self.path == "/debug/kernels":
            self._json(200, {
                "launches": kernel_launches(),
                "profile_window": app.obs.profile.window_launches(),
            })
        elif self.path == "/debug/state":
            self._json(200, {
                "engine": eng.debug_state() if eng is not None else None,
            })
        elif self.path == "/debug/slo":
            self._json(200, {
                "engine": eng.slo_stats() if eng is not None else None,
            })
        elif self.path == "/debug/capture":
            self._json(200, {
                "engine": eng.capture_stats() if eng is not None else None,
            })
        elif self.path == "/debug/capture/download":
            cap = eng.capture if eng is not None else None
            if cap is None:
                self.send_error(404, "no capture armed (set WALKAI_CAPTURE_DIR)")
                return
            # Every retained file, oldest first: one capture for
            # `python -m walkai_nos_tpu_torch.cmd.replay`.
            self._text(200, cap.read_text().encode(), "application/x-ndjson")
        elif self.path == "/stats":
            self._json(200, app.stats())
        else:
            self.send_error(404)

    def _text(self, code, data: bytes, content_type: str):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, code, payload, headers=None):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


def main() -> None:
    server = DemoServer().bind(int(os.environ.get("PORT", "8000")))
    server.httpd.serve_forever()


if __name__ == "__main__":
    main()
