"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository on a machine with one CUDA GPU and
the CUDA toolkit (`nvcc`). It:

1. builds the port's kernels from `walkai_nos_tpu_torch/csrc/` (nvcc,
   sm_90a) and prints the build seconds, the ptxas resource report per
   kernel and, from `cuobjdump -sass`, the tensor-core instructions
   (HGMMA, HMMA) of each attention and QKV kernel, failing if a bf16
   forward or backward kernel (K3/K4, K5, K6) holds no HGMMA or a bf16 or
   int8-pool decode kernel (K1, K7) or a bf16 or int8-weight QKV kernel
   (K2) no HMMA; then checks, under
   `torch.profiler` (this process's only profiler session), that three
   attention backward calls at the ViT's shape run exactly K5, K6, K5,
   K6, K5, K6 on the device;
2. holds each LM kernel (K1 paged attention, K2 QKV projection + RoPE) and
   the fused composition against its plain PyTorch version at the
   serving shapes of TinyLlama-1.1B (bf16, 32 heads, 4 kv heads,
   head_dim 64, 8 slots, steps 1 and 8, shuffled tables, ragged indices
   including a block edge and one past the table's capacity), and times
   kernel, plain version and a PyTorch library yardstick with CUDA
   events;
3. holds K7 (dense-cache decode attention) against its plain version in
   bf16 and f32 at the generate step's shape (8 rows, 32 heads over 4 kv
   heads, 1024-row cache, shared index 1000), the dense engine's (2048-row
   cache, per-row indices 0, 127, 128 and past the cache), the speculative
   verify's (5 steps, batch 1), an MHA shape, rows at 0, 63, 64 and past a
   2048-row cache, and an 8192-row cache, and times kernel, plain version
   and SDPA over the masked cache; then, in a child process, counts the
   device kernels of each K1 / K7 / K2 call under the profiler (1 where
   the cell's last CTA combines the splits, 2 where a second kernel does;
   K2 always 1, at steps 1 and 8, bf16 and int8 weights);
4. serves 8 greedy requests (prompts of 40-600 tokens, two sharing a
   256-token prefix, 32 new tokens each) through the port's
   `ContinuousBatcher` at TinyLlama-1.1B width (22 layers, random bf16
   weights from --seed), checks every request, the kernels' launch
   counts, a prefix-cache hit, and that one request re-served alone on
   a fresh engine gives the same tokens; then a profiled window (below,
   at WINDOW_LAYERS layers);
4a. serves them again with 256 new tokens each, with `loop_steps` 1 and
   with `loop_steps` 4 (`chunk_steps` 8): the device-resident loop, each
   fold one CUDA graph launch (chunks in conditional nodes,
   `csrc/graph_fold.cu`) and one blocking sync; the tokens must be equal
   and folds must run most of the decode steps; a profiled window
   (`--window loop_serving`) must see every K1 and K2 launch the folds
   counted and, inside each fold, exactly one graph launch, one copy
   each way, one stream synchronize and no host kernel launch;
4b. serves the 32-token batch with batched speculative rounds (`spec_k`
   4, drafting pinned on) with a random `draft_config` draft and with the
   target as its own draft, the latter also with `loop_steps` 4 (the
   spec graph): every leg must give the same tokens and launch K2 and K1
   at steps k+1 = 5 exactly verify rounds x layers times, the self draft
   must emit at least 0.8 (k+1) a round; reported: tokens/s, acceptance,
   the share of tokens equal to step 4's (bf16 verifies round apart from
   one-step decodes at near-ties) with the first diverging positions and
   logit gaps; an untimed second run must repeat the tokens, and K2 and
   K1 at steps 5 are held to their plain versions on one verify call's
   inputs; a profiled window (`--window spec_serving`, self draft, loop
   4) must see every K1 and K2 launch and K1's combine kernel once per
   verify round and layer; in f32 at 4 layers (and with "int8-sim" KV and
   weights) every loop and spec leg must give the loop-off, spec-off
   tokens exactly;
4c. (run right after 4) serves two long prompts (1536 and 1901 tokens)
   and the six shortest serving prompts, 32 new tokens each, with
   `sp_prefill` on and off (`sp_min_tokens` 1024, `sp_span` 4): the
   tokens must be equal, `sp_stats()` must count 2 long requests, more
   than 2 fanned rows and at least one hold; reported: the lane
   dispatches and TTFT of each long prompt and the lane's span between
   CUDA events; K2 and K1 checked and timed on one captured decode call
   of the sp run (a long prompt's context); the streamed wide-prefill
   tail (`ops/sp_prefill.py`) on one captured wide lane call's inputs
   must equal itself over every tile bitwise and the dense tail the
   engine runs within the bf16 rule, both timed;
4d. moves KV blocks and live requests between engines over the serving
   model (`models/serve_xfer.py`): two prompt blocks shipped by hash give
   a 2-block prefix hit and the exporter's tokens; the 8 serving requests
   exported after the first decode chunk (migrations and resubmits)
   finish on a second engine with the serving phase's tokens and leave
   the first empty; the same at temperature 0.8 with fixed seeds equals
   an uninterrupted run; a `loop_steps` 4 target whose fold was captured
   before the import serves them with folds; an int8-KV pair migrates
   exactly; an int8 engine refuses a bf16 payload (`kv_dtype`); payload
   MB and export / import seconds reported; K2 and K1 checked and timed
   on one captured decode call of the target after the import;
4e. captures the serving prompts (four greedy, four sampled at
   temperature 0.8 / top_k 40, then prompts 0 and 7 again for prefix
   hits) through `ContinuousBatcher(capture=...)` (`obs/capture.py`,
   `loop_steps` 4, a ring that must rotate at least twice and drop
   nothing, every file behind its header) beside an uncaptured run of the
   same traffic, and replays the capture (`sim/replay.py`) on fresh
   engines: as captured, `loop_steps` 1, prefix cache off, original
   timing and "int8-sim" KV, every digest verified; weights from another
   seed must diverge on every request and triage `config_dependent` with
   a bundle that reads back (at WINDOW_LAYERS layers, on a model of
   its own); in f32 at 4 layers a spec capture (self
   draft) replays spec off and with a random draft; reported: records,
   bytes, files, the fingerprint's seconds, step time and TTFT captured
   and not, each replay's wall and K1/K2 launches; K2 and K1 checked and
   timed on one decode call of a replay;
4f. (run right after 4) the telemetry leg: on the serving phase's
   engine, which ran with telemetry on, the request trace's ttft / wall
   equal the records', the histograms count the records, every
   exposition line parses, the request counters equal the records, the
   pool drained back to free and parked blocks, and the Chrome export
   holds one done per request and one dispatch event per dispatch; the
   same prompts then go through an `obs=False` engine (greedy tokens
   equal, views flagged `obs_disabled`, an empty trace), the two arms
   run on, off, on, off and report their step times and
   `obs_overhead_pct` (not gated); then a child window (`--window
   obs_profile`, WINDOW_LAYERS layers) arms the engine's own
   `ProfileHook` for OBS_PROFILE_DISPATCHES dispatches of steady decode:
   one completed window, no error, a trace file whose K1 and K2 kernel
   events equal the launches their wrappers counted between the hook's
   start and stop (layers x chunk steps x the dispatches in between);
   the same leg checks the SLO and attribution layers of the serving
   engine (built with a TTFT objective of 120 s and a TPOT objective of
   0.1 ms, over a window longer than the leg): the windows count every
   request and dispatch the registry counted, the TTFT objective is met
   and the TPOT one breached with a burn rate above 1, `slo_ok` is
   False, the saturation lies in [0, 1], the dispatches by composition
   class add up to the dispatches, and the cost model's bytes per step
   less the weights' bytes are a whole number of resident tokens' KV
   bytes, at most slots x cache_len of them; it prints the roofline
   fraction and host-overhead share (the loop leg prints its own);
4g. the fleet leg (`fleet_phase`, at WINDOW_LAYERS layers on one model
   every engine shares): two `EngineReplica`s (paged, 4 slots,
   cache_len 1024) behind an affinity `FleetRouter(seed=0)` with one
   spare in a `StaticSliceProvider`; 16 greedy requests x 16 new tokens
   in waves, on 4 templates (a shared 128-token block plus an 8-64-token
   suffix, Zipf 1.1 from --seed); a TTFT objective the waves breach makes
   the reconciler scale up once, and a migrating drain of a replica
   with resident requests scales the fleet down. Every request's tokens
   equal a solo engine's, none is dropped, the affinity fleet's prefix
   hit rate beats a round-robin rerun's, the federated exposition
   carries each replica's `cb_*` series under `replica`, the fleet trace
   merges, K2 / K1 launches are counted per replica, and K2 / K1 are
   held to their plain versions on one decode call of a replica;
4h. the demo server leg (`server_phase`): `python -m
   walkai_nos_tpu_torch.app.main` in a child process on the card (started
   once leg 4g has ended, beside the leg's own in-process reference) at the
   demo's widths (YOLOS-small behind /infer; `WALKAI_DEMO_LM=1`, LM_SMALL
   on the paged engine with the app's default knobs, `loop_steps` 8,
   capture armed; weights from seed 0). Concurrent /infer requests
   coalesce into fewer batches than requests and /stats counts exactly
   the fenced images (12 K3 launches a batch, whatever its bucket); 8
   concurrent greedy /generate requests (two sharing a prefix) give the
   tokens of the same seed's engine served in this process, a streamed
   request its non-streamed twin's, an over-cache prompt the one-shot
   path's (no K7 at MHA, as JAX routes it); a /debug/profile window writes a trace holding exactly
   the K1 and K2 launches counted between its start and stop;
   /healthz, /metrics, /debug/state and /debug/slo read as they should;
   the downloaded capture replays token-identically through
   `cmd/replay.py`; a `FleetRouter` over one `HttpReplica` of the child
   gives the same tokens with no scrape error. K2 / K1 are held to their
   plain versions on a decode call of the in-process engine;
5. generates 128 tokens for 8 prompts through `make_generate_fn` at
   TinyLlama-1.1B width (dense cache, chunks of 16 steps): 22 K7
   launches per decode step, two runs give the same tokens, tokens/s,
   step time, peak memory and a profiled window; then speculative
   decoding of 64 tokens (batch 1, a `draft_config` draft, k 4): 22 K7
   launches per verify round and the acceptance histogram; then the
   dense engine (`paged=False`, 8 slots, cache_len 2048) on the serving
   prompts, with a request re-served alone; then, in f32 at 4 layers,
   the same greedy tokens from all three entry points;
6. serves 2 requests through the unfused route (`fused_qkv=False`, 4
   layers), which runs K1 without fresh-row injection and no K2;
6a. holds the int8 arms of K1 (int8 pools + f32 scale pools) and K2
   (int8 weight + scale row) and their fused composition against their
   plain versions at the LM serving shapes (bf16 and f32), the "sim" arms
   (unit scales) bitwise against the unquantized arms, times them beside
   their bounds, plain versions and library yardsticks, and times the
   int8 `QuantDense` projections of one layer beside bf16 `Dense`;
6b. serves the 8 requests again with int8 KV and int8 weights (the bf16
   model's draws quantized): both int8 arms launched, 11,968 KV bytes per
   token, the share of tokens equal to the bf16 engine's, and a profiled
   window; then with speculative rounds, the model as its own draft (the
   int8 arms of K2 and K1 at steps 5, held as in 4b);
6c. in bf16 at 4 layers, "int8-sim" KV and weights give the unquantized
   engine's tokens on the fused route and on the unfused one;
6d. holds K2's bias arm and K1 at group 1 against their plain versions
   at GPT-2 small's serving shape; imports random HF-named TinyLlama-1.1B
   and GPT-2 small checkpoints (`models/hf.py`) and serves them through
   the paged engine (GPT-2 also the dense one), then an 8-expert
   TinyLlama-width MoE model (8 layers) at capacity 1.25 and 4.0 through both
   engines, `make_generate_fn` and speculative decoding, with a profiled
   window. Each timed run is followed by an untimed second run of the
   same batch that must repeat its tokens (at 1.25 under drops, with
   idle slots and pad lane rows) and records the first-token logits
   (held to f32 forwards written from HF's model code), the tokens the
   MoE capacity dropped, and one kernel call's inputs, on which K2 + K1
   (K7 on the MoE model's dense paths) are checked and timed; one MoE
   decode step through K2 + K1 is held to the plain route with the
   routers pinned and with the random routers;
6e. (run right after 6) serves the 8 requests x 32 new tokens at
   TinyLlama-1.1B width (8 of its 22 layers) under adapters (0, 1, 2, 3, 0, 1, 2, 3) of
   `AdapterSet.synthetic(k=4,
   rank=8, scale=0.5)` (`lora_serving_phase`): armed forwards take the
   unfused route (K1 without injection, no K2: K1 launched exactly
   layers x decode steps); adapter-0 requests must equal a LoRA-free
   `fused_qkv=False` engine's tokens and every other request differ from
   them; one request per adapter alone repeats its tokens; no prefix hit
   across adapters and two within one; each adapter's first-token logits
   from the armed engine run in f32 within F32_REL of a plain
   f32 forward over its merged weights (W + A B), the bf16 engine's
   reported against it; `loop_steps` 4 gives loop 1's tokens, and a hot load into id 2
   after the fold graphs were captured reaches the folds (a fresh engine
   built with the new tree gives the same tokens); speculative rounds
   with the base model as draft give the same tokens at loop 1 and 4 (K1
   at steps 5 = verify rounds x layers, no K2); int8 KV serves every
   budget and "int8-sim" KV the bf16 tokens; tokens/s, step and folded
   step times beside the LoRA-free engines' (fused and unfused),
   `lora_stats()`, and K1
   checked and timed on one armed decode call's and one verify call's
   inputs;
7. holds K3 (packed ViT attention), K4 (flash forward + lse), K5 (dq and
   the row term D') and K6 (dk/dv) against their plain versions at the
   ViT's shapes (batch 32, 296 tokens, 6 heads of 64) in bf16 and f32,
   plus causal sq < sk, causal sq > sk (rows that see no key), kv_len <
   sk with and without the causal mask, and head_dim 128 (K3 too); checks
   that two backward runs give bitwise-identical gradients; times kernel,
   plain version and SDPA, and for the backward also the K5 + K6 pair
   against SDPA's backward and the eager D' pass K5 absorbed, at the
   ViT's shape and at LM-training width (causal, batch 2, 2048 tokens, 32
   heads of 64), where K4 is also checked and timed against SDPA's causal
   forward;
8. serves 64 requests of 1-8 images (sizes from --seed, 8 client
   threads) through the ViT micro-batcher at YOLOS-small width (12
   layers, random weights cast to bf16 once), checks every request, each
   bucket's output against the plain attention path on the same input
   and 12 K3 launches per batch, and prints fenced images/s, p50/p99
   latency, padded images, device starvation, the calibrated ceiling and
   the device-busy share of a profiled window;
9. trains YOLOS-small (f32 masters, bf16 compute, batch 32): the step-1
   gradient of every parameter through K3-K6 against the plain
   attention's, 20 steps through `fit` on a repeated synthetic batch
   with a checkpoint at step 10 (the loss must fall), a resume from step
   10 that must replay the same losses, 12 launches per step of each of
   K3-K6, then step time, images/s and a profiled window of 3 steps in
   which the profiler must see those 12 launches per step;
10. trains an LM at TinyLlama-1.1B width (f32 masters, bf16 compute,
    batch 2 x 2048 tokens from the port's `token_batches`): at 2 layers
    the step-1 gradient of every parameter through K4-K6 against the
    plain attention's, 20 steps through `fit` with a checkpoint at step
    10 (the loss must fall) and a resume that must replay the losses; at
    22 layers 3 warm-up and 10 timed steps (22 launches each of K4, K5
    and K6 a step), then one step with `remat` (44 K4, 22 K5, 22 K6, the
    same loss); step time, tokens/s, peak memory and the model-FLOP
    share, with its formula; a profiled window of 3 steps in which the
    profiler must see every K4, K5 and K6 launch; then an MoE model (4
    layers, 8 experts on every second block, top-2) that must train for
    5 steps; K4, K5 and K6 are also checked on the path's inputs (K/V
    repeated from 4 kv heads) in phase 7;
11. prints the card's name and power limit, one JSON line with every
    kernel's numbers, and as the last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Each profiled window (the decode kernels' launches, LM serving, the
loop, generation, int8 serving, ViT serving, ViT training, LM training,
the telemetry profile hook) runs
in a child process of its own (`--window NAME`: the
script starts itself once per window and fails if a child fails); the
profiler there must see every launch of the window's sentinel kernels
that their wrappers counted, else the window fails. Its device-busy
share and top kernels join the phase's report. Every window but the
MoE, ViT and LM training ones, and the LoRA and capture legs, run at 8
layers (`WINDOW_LAYERS`); the others at their phase's depth.

Any failed phase raises and the script exits non-zero; without a GPU it
exits non-zero before printing any result. Long outputs also go to
`chiprun_out/chip_smoke.json`.
"""

from __future__ import annotations

import argparse
import atexit
import bisect
import contextlib
import gc
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12           # dense bf16 tensor-core peak, same source
# Tolerances, per slot: max |kernel - plain| over a slot's outputs must
# stay within REL * max |plain| over that slot + ABS. Scaling by the
# slot's own outputs matters: at 1024 resident tokens an attention output
# is ~0.05 rms, so a fixed bound sized for O(1) outputs would pass a
# kernel that drops a position. bf16: storage in bf16 on both sides, f32
# accumulation in both, but other summation orders and rounding points
# (probabilities round to bf16 before or after the division by their sum,
# or stay f32 on one side): a few bf16 ulps (2**-8 relative). f32:
# summation order only.
TOL = {torch.bfloat16: (2e-2, 4e-3), torch.float32: (1e-4, 1e-5)}
ROTATE = 8  # input copies cycled while timing, to keep L2 (50 MB) cold


def _fail(msg: str) -> None:
    raise RuntimeError(msg)


def _kernel_name(mangled: str) -> str:
    """`name<template args>` of a mangled kernel symbol, for reports."""
    m = re.search(r"\d+([A-Za-z_]\w*?)(?:I(\w+?)EE|Ev|EP|$)", mangled.split("_cu_")[-1])
    if not m:
        return mangled[:60]
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def _demangled_name(name: str) -> str:
    """`name<template args>` of a profiler's demangled kernel name."""
    m = re.search(r"(?:^|::|\s)(\w+(?:<[^>]*>)?)\(", name)
    return m.group(1) if m else name[:60]


def _ptxas_report(log: str) -> list:
    """One line per kernel of a ptxas -v log: registers, shared memory,
    spills, and any wgmma the assembler had to serialize."""
    lines, name = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1])
        elif any(w in line for w in ("registers", "smem", "spill", "Performance Loss")):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


def _tensor_core_counts(lib_path: str) -> dict:
    """{kernel: {"HGMMA": n, "HMMA": n}} in a built library's SASS (the
    products that run on tensor cores), or the reason there is none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                              text=True, timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return {"not available": str(e)[:200]}
    counts, name = {}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :")[1].strip())
        for op in ("HGMMA", "HMMA"):
            if f" {op}." in line:
                counts.setdefault(name, {}).setdefault(op, 0)
                counts[name][op] += 1
    return counts


def _timed(fn, iters: int, warm: int = 2) -> float:
    """Mean DEVICE milliseconds per call: `iters` calls captured in one
    CUDA graph, the graph replayed 3 times between CUDA events. Host
    launch overhead is excluded (a plain Python loop of small launches
    measures the host, not the card)."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def _host_timed(fn, iters: int) -> float:
    """Mean wall milliseconds per call of an eager loop (host launch
    overhead included: what one call costs the serving loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _err(got, want, dtype):
    """(max |got - want|, worst per-row error over its tolerance): row i
    of each output (a slot, an image, a (batch) entry) is held to REL *
    max |want row i| + ABS."""
    rel, floor = TOL[dtype]
    worst, ratio = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs().flatten(1).amax(1)
        # A NaN on either side is an infinite error (max() would skip it).
        d = torch.where(torch.isnan(d), torch.inf, d)
        tol = rel * w.float().abs().flatten(1).amax(1) + floor
        worst = max(worst, float(d.max()))
        ratio = max(ratio, float((d / tol).max()))
    return worst, ratio


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def kernel_phase(da, seed: int) -> tuple[list, list]:
    """K1, K2 and the fused composition against their plain versions.
    Returns (checks, timing rows)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, kvh, hd, dm = 8, 32, 4, 64, 2048
    nlog, nb = 16, 129  # cache_len 2048, pool of 8 * 16 blocks + scratch
    dout = dm + 2 * kvh * hd
    bf = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf)

    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    table = perm[: b * nlog].reshape(b, nlog).to(torch.int32)
    ragged = torch.tensor(
        [0, 127, 128, 500, 1023, 1500, 2040, 2100], device=dev,
        dtype=torch.int32,
    )  # 2100 is past the table's capacity of 2048 rows
    steady = torch.full((b,), 1024, device=dev, dtype=torch.int32)
    pools = [(rnd(nb, kvh, 128, hd), rnd(nb, kvh, 128, hd)) for _ in range(ROTATE)]
    ws = [rnd(dm, dout, std=0.02) for _ in range(ROTATE)]
    checks, rows = [], []

    err = _err

    f32 = {"w": ws[0].float()}
    f32["kp"], f32["vp"] = (p.float() for p in pools[0])
    for steps in (1, 8):
        q = rnd(b, h, steps, hd)
        x = rnd(b, steps, dm)
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == bf:
                q_, x_, w_, (kp, vp) = q, x, ws[0], pools[0]
            else:  # the same inputs in f32: checks the arithmetic tightly
                q_, x_, w_ = q.float(), x.float(), f32["w"]
                kp, vp = f32["kp"], f32["vp"]
            for name, index in (("ragged", ragged), ("steady", steady)):
                e1 = err(
                    [da.paged_decode_attention(q_, kp, vp, table, index)],
                    [da.paged_decode_attention_reference(
                        q_, kp, vp, table, index)],
                    dtype,
                )
                e2 = err(
                    da.qkv_rope_projection(
                        x_, w_, None, index, num_heads=h, kv_heads=kvh,
                        rope_theta=10000.0,
                    ),
                    da.qkv_rope_reference(
                        x_, w_, None, index, num_heads=h, kv_heads=kvh,
                        rope_theta=10000.0,
                    ),
                    dtype,
                )
                e3 = err(
                    da.fused_qkv_paged_attention(
                        x_, w_, None, kp, vp, table, index, num_heads=h,
                        rope_theta=10000.0,
                    ),
                    da.fused_qkv_paged_reference(
                        x_, w_, None, kp, vp, table, index, num_heads=h,
                        rope_theta=10000.0,
                    ),
                    dtype,
                )
                for kname, (e, ratio) in (
                    ("paged_attention", e1), ("qkv_rope", e2), ("fused", e3),
                ):
                    checks.append({
                        "kernel": kname, "steps": steps, "index": name,
                        "dtype": str(dtype).split(".")[-1],
                        "max_abs_err": e, "err_over_tol": ratio,
                        "tol": "%g * max|plain| per slot + %g" % TOL[dtype],
                    })
                    if not ratio <= 1.0:
                        _fail(
                            f"{kname} {dtype} steps={steps} {name}: max err "
                            f"{e}, {ratio:.3g}x its per-slot tolerance"
                        )
        torch.cuda.synchronize()
        kp, vp = pools[0]

        # Timing at the steady index (8 slots x ~1024 resident tokens).
        idx = steady
        vis = torch.clamp(idx.long() + steps, max=nlog * 128)
        kv_bytes = float(vis.sum()) * kvh * hd * 2 * 2
        qo_bytes = 2 * b * h * steps * hd * 2
        k1_flops = float(vis.sum()) * h * steps * hd * 4
        k2_bytes = (
            b * steps * dm * 2 + dm * dout * 2 + b * steps * hd * 4 * 2
            + b * steps * dout * 2
        )
        k2_flops = 2.0 * b * steps * dm * dout
        tbl_bytes = b * nlog * 4 + b * 4

        def k1(i):
            kp_, vp_ = pools[i % ROTATE]
            da.paged_decode_attention(q, kp_, vp_, table, idx)

        def k1_plain(i):
            kp_, vp_ = pools[i % ROTATE]
            da.paged_decode_attention_reference(q, kp_, vp_, table, idx)

        gathered = []
        for kp_, vp_ in pools:
            kg = da.gather_paged_cache(kp_, table).repeat_interleave(h // kvh, 1)
            vg = da.gather_paged_cache(vp_, table).repeat_interleave(h // kvh, 1)
            gathered.append((kg, vg))
        pos = torch.arange(nlog * 128, device=dev)
        qpos = idx.long()[:, None] + torch.arange(steps, device=dev)
        mask = (pos[None, None] <= qpos[..., None])[:, None]

        def k1_lib(i):
            kg, vg = gathered[i % ROTATE]
            torch.nn.functional.scaled_dot_product_attention(
                q, kg, vg, attn_mask=mask
            )

        def k2(i):
            da.qkv_rope_projection(
                x, ws[i % ROTATE], None, idx, num_heads=h, kv_heads=kvh,
                rope_theta=10000.0,
            )

        def k2_plain(i):
            da.qkv_rope_reference(
                x, ws[i % ROTATE], None, idx, num_heads=h, kv_heads=kvh,
                rope_theta=10000.0,
            )

        def k2_lib(i):
            # cuBLAS product, then split and rotary in PyTorch ops (the
            # config has no bias): the same function as K2 here.
            da.split_qkv(
                torch.matmul(x, ws[i % ROTATE]), idx, num_heads=h,
                kv_heads=kvh, rope_theta=10000.0,
            )

        def fused(i):
            kp_, vp_ = pools[i % ROTATE]
            da.fused_qkv_paged_attention(
                x, ws[i % ROTATE], None, kp_, vp_, table, idx, num_heads=h,
                rope_theta=10000.0,
            )

        def fused_plain(i):
            kp_, vp_ = pools[i % ROTATE]
            da.fused_qkv_paged_reference(
                x, ws[i % ROTATE], None, kp_, vp_, table, idx, num_heads=h,
                rope_theta=10000.0,
            )

        for name, fn, plain, lib, nbytes, flops in (
            ("paged_attention", k1, k1_plain, k1_lib,
             kv_bytes + qo_bytes + tbl_bytes, k1_flops),
            ("qkv_rope", k2, k2_plain, k2_lib, k2_bytes, k2_flops),
            ("fused", fused, fused_plain, None,
             k2_bytes + kv_bytes + tbl_bytes,
             k1_flops + k2_flops),
        ):
            bound_ms, bound_by = _bound(nbytes, flops)
            rows.append({
                "kernel": name, "steps": steps,
                "ms": _timed(fn, 20),
                "plain_ms": _timed(plain, 5),
                "library_ms": None if lib is None else _timed(lib, 20),
                "host_call_ms": _host_timed(fn, 50),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": nbytes, "flops": flops,
            })
    return checks, rows


def int8_kernel_phase(da, lm_mod, seed: int) -> tuple[list, list, dict]:
    """The int8 arms of K1 (int8 pools + f32 scale pools) and K2 (int8
    weight + scale row) and their fused composition against their plain
    versions at the serving shapes of TinyLlama-1.1B (as `kernel_phase`,
    with pools and weight quantized from bf16 draws), q/x in bf16 and f32;
    the "sim" arms (full-precision pools and weight with unit scales)
    bitwise against the unquantized arms; times of kernel, plain version
    and library yardstick; and the per-layer cost of the four `QuantDense`
    projections the fused route runs (out_proj, gate, fc1, fc2) beside
    bf16 `Dense`. Returns (checks, timing rows, QuantDense times)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    b, h, kvh, hd, dm, mlp = 8, 32, 4, 64, 2048, 5632
    nlog, nb = 16, 129
    dout = dm + 2 * kvh * hd
    bf = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf)

    table = (torch.randperm(nb - 1, generator=gen, device=dev) + 1)[
        : b * nlog].reshape(b, nlog).to(torch.int32)
    ragged = torch.tensor([0, 127, 128, 500, 1023, 1500, 2040, 2100],
                          device=dev, dtype=torch.int32)
    steady = torch.full((b,), 1024, device=dev, dtype=torch.int32)
    pools, wts = [], []
    for _ in range(ROTATE):
        kq, ks = da.quantize_kv_rows(rnd(nb, kvh, 128, hd), "int8")
        vq, vs = da.quantize_kv_rows(rnd(nb, kvh, 128, hd), "int8")
        pools.append((kq, vq, ks, vs))
        wts.append(lm_mod.quantize_kernel(rnd(dm, dout, std=0.02)))
    checks, rows = [], []

    def check(kernel, steps, index, dtype, got, want):
        e, ratio = _err(got, want, dtype)
        checks.append({
            "kernel": kernel, "steps": steps, "index": index,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": e,
            "err_over_tol": ratio,
            "tol": "%g * max|plain| per slot + %g" % TOL[dtype],
        })
        if not ratio <= 1.0:
            _fail(f"{kernel} {dtype} steps={steps} {index}: max err {e}, "
                  f"{ratio:.3g}x its per-slot tolerance")

    kq, vq, ks, vs = pools[0]
    wq, wsc = wts[0]
    rope = dict(rope_theta=10000.0)
    for steps in (1, 8):
        q = rnd(b, h, steps, hd)
        x = rnd(b, steps, dm)
        for dtype in (bf, torch.float32):
            q_, x_ = q.to(dtype), x.to(dtype)
            for name, idx in (("ragged", ragged), ("steady", steady)):
                sc = dict(k_scales=ks, v_scales=vs)
                check("paged_attention_int8", steps, name, dtype,
                      [da.paged_decode_attention(q_, kq, vq, table, idx, **sc)],
                      [da.paged_decode_attention_reference(
                          q_, kq, vq, table, idx, ks, vs)])
                proj = dict(num_heads=h, kv_heads=kvh, w_scale=wsc, **rope)
                check("qkv_rope_int8", steps, name, dtype,
                      da.qkv_rope_projection(x_, wq, None, idx, **proj),
                      da.qkv_rope_reference(x_, wq, None, idx, **proj))
                fz = dict(num_heads=h, w_scale=wsc, **sc, **rope)
                check("fused_int8", steps, name, dtype,
                      da.fused_qkv_paged_attention(
                          x_, wq, None, kq, vq, table, idx, **fz),
                      da.fused_qkv_paged_reference(
                          x_, wq, None, kq, vq, table, idx, **fz))
        # The sim arms: bf16 pools and weight with unit scales, bitwise.
        kp, vp = (rnd(nb, kvh, 128, hd) for _ in range(2))
        w = rnd(dm, dout, std=0.02)
        ones = torch.ones(nb, kvh, 128, device=dev)
        ones_w = torch.ones(dout, device=dev)
        same = torch.equal(
            da.paged_decode_attention(q, kp, vp, table, ragged),
            da.paged_decode_attention(q, kp, vp, table, ragged,
                                      k_scales=ones, v_scales=ones),
        ) and all(
            torch.equal(a, s) for a, s in zip(
                da.fused_qkv_paged_attention(
                    x, w, None, kp, vp, table, ragged, num_heads=h, **rope),
                da.fused_qkv_paged_attention(
                    x, w, None, kp, vp, table, ragged, num_heads=h,
                    w_scale=ones_w, k_scales=ones, v_scales=ones, **rope),
            )
        )
        checks.append({"kernel": "paged_attention+qkv_rope sim arms",
                       "steps": steps, "dtype": "bfloat16",
                       "bitwise_equal_unquantized": same})
        if not same:
            _fail(f"the sim arms differ from the unquantized arms, steps={steps}")
        torch.cuda.synchronize()

        # Timing at the steady index (8 slots x ~1024 resident tokens).
        idx = steady
        vis = float(torch.clamp(idx.long() + steps, max=nlog * 128).sum())
        kv_bytes = vis * kvh * (hd * 1 + 4) * 2  # int8 rows + f32 scales
        qo_bytes = 2 * b * h * steps * hd * 2
        tbl_bytes = b * nlog * 4 + b * 4
        k1_flops = vis * h * steps * hd * 4
        k2_bytes = (b * steps * dm * 2 + dm * dout * 1 + dout * 4
                    + b * steps * hd * 4 * 2 + b * steps * dout * 2)
        k2_flops = 2.0 * b * steps * dm * dout
        pos = torch.arange(nlog * 128, device=dev)
        qpos = idx.long()[:, None] + torch.arange(steps, device=dev)
        mask = (pos[None, None] <= qpos[..., None])[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def k1(i):
            kq_, vq_, ks_, vs_ = pools[i % ROTATE]
            da.paged_decode_attention(q, kq_, vq_, table, idx, k_scales=ks_,
                                      v_scales=vs_)

        def k1_plain(i):
            kq_, vq_, ks_, vs_ = pools[i % ROTATE]
            da.paged_decode_attention_reference(q, kq_, vq_, table, idx, ks_, vs_)

        def k1_lib(i):
            # SDPA over the dequantized views, the dequantize counted.
            kq_, vq_, ks_, vs_ = pools[i % ROTATE]
            sdpa(q, da.dequantize_gathered(kq_, ks_, table, bf),
                 da.dequantize_gathered(vq_, vs_, table, bf),
                 attn_mask=mask, enable_gqa=True)

        def k2(i):
            wq_, ws_ = wts[i % ROTATE]
            da.qkv_rope_projection(x, wq_, None, idx, num_heads=h, kv_heads=kvh,
                                   w_scale=ws_, **rope)

        def k2_plain(i):
            wq_, ws_ = wts[i % ROTATE]
            da.qkv_rope_reference(x, wq_, None, idx, num_heads=h, kv_heads=kvh,
                                  w_scale=ws_, **rope)

        def k2_lib(i):
            # The conversion counted, then cuBLAS, the scale, split, rotary.
            wq_, ws_ = wts[i % ROTATE]
            y = (torch.matmul(x, wq_.to(bf)).float() * ws_).to(bf)
            da.split_qkv(y, idx, num_heads=h, kv_heads=kvh, **rope)

        def fused(i):
            kq_, vq_, ks_, vs_ = pools[i % ROTATE]
            wq_, ws_ = wts[i % ROTATE]
            da.fused_qkv_paged_attention(
                x, wq_, None, kq_, vq_, table, idx, num_heads=h, w_scale=ws_,
                k_scales=ks_, v_scales=vs_, **rope)

        def fused_plain(i):
            kq_, vq_, ks_, vs_ = pools[i % ROTATE]
            wq_, ws_ = wts[i % ROTATE]
            da.fused_qkv_paged_reference(
                x, wq_, None, kq_, vq_, table, idx, num_heads=h, w_scale=ws_,
                k_scales=ks_, v_scales=vs_, **rope)

        for name, fn, plain, lib, nbytes, flops in (
            ("paged_attention_int8", k1, k1_plain, k1_lib,
             kv_bytes + qo_bytes + tbl_bytes, k1_flops),
            ("qkv_rope_int8", k2, k2_plain, k2_lib, k2_bytes, k2_flops),
            ("fused_int8", fused, fused_plain, None,
             k2_bytes + kv_bytes + tbl_bytes, k1_flops + k2_flops),
        ):
            bound_ms, bound_by = _bound(nbytes, flops)
            rows.append({
                "kernel": name, "steps": steps,
                "ms": _timed(fn, 20),
                "plain_ms": _timed(plain, 5),
                "library_ms": None if lib is None else _timed(lib, 20),
                "host_call_ms": _host_timed(fn, 50),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": nbytes, "flops": flops,
            })

    # QuantDense per layer, at the decode step's 8 rows: the four
    # projections of the fused route, int8 (f32 copy + cuBLAS f32 product
    # per call) beside bf16 Dense.
    x = rnd(b, 1, dm)
    xm = rnd(b, 1, mlp)
    layers = {}
    for kind in ("int8", "bf16"):
        mods = []
        for d_in, d_out in ((dm, dm), (dm, mlp), (dm, mlp), (mlp, dm)):
            kw = dict(bias=False, dtype=bf, device=dev, gen=gen)
            mods.append(lm_mod.QuantDense(d_in, d_out, sim=False, **kw)
                        if kind == "int8" else lm_mod.Dense(d_in, d_out, **kw))

        def layer(i, mods=mods):
            for m in mods:
                m(xm if m.kernel.shape[0] == mlp else x)

        layers[kind] = _timed(layer, 10)
    quant_dense = {
        "shape": f"8 rows; out_proj {dm}x{dm}, gate/fc1 {dm}x{mlp}, fc2 {mlp}x{dm}",
        "int8_ms_per_layer": layers["int8"], "bf16_ms_per_layer": layers["bf16"],
    }
    del pools, wts
    torch.cuda.empty_cache()
    return checks, rows, quant_dense


def _tinyllama_cfg(LMConfig):
    """TinyLlama-1.1B's widths, 22 layers, bf16."""
    return LMConfig(
        vocab_size=32000, hidden_dim=2048, num_layers=22, num_heads=32,
        num_kv_heads=4, mlp_dim=5632, max_seq_len=2048, dtype="bfloat16",
        norm="rmsnorm", mlp="swiglu", rope=True, rope_theta=10000.0,
        use_bias=False, head_bias=False, layer_norm_eps=1e-5,
    )


# The paged engine of the LM serving phases.
LM_ENGINE_KW = dict(slots=8, cache_len=2048, prefill_chunk=64, prefill_lanes=4)


def _serving_prompts(cfg, seed: int) -> list:
    """The LM serving phases' 8 prompts (40-600 tokens, two sharing a
    256-token prefix)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, 256)
    return [
        np.concatenate([shared, rng.integers(0, cfg.vocab_size, 44)]),
        rng.integers(0, cfg.vocab_size, 40),
        rng.integers(0, cfg.vocab_size, 60),
        rng.integers(0, cfg.vocab_size, 128),
        rng.integers(0, cfg.vocab_size, 600),
        rng.integers(0, cfg.vocab_size, 450),
        rng.integers(0, cfg.vocab_size, 200),
        np.concatenate([shared, rng.integers(0, cfg.vocab_size, 80)]),
    ]


@contextlib.contextmanager
def _first_token_logits(engine, sink: dict):
    """Records into `sink`, per request id, the logits the paged engine's
    prefill lane samples each request's first token from (on the card,
    no sync)."""
    from walkai_nos_tpu_torch.models import serve as serve_mod
    from walkai_nos_tpu_torch.models import serve_lane

    run_lane, sample_rows = serve_mod.run_lane, serve_lane.sample_rows

    def recording_run_lane(model, st, lane, *rest):
        # The finishing entries, in lane-row order: the rows of `fl`.
        fin = [p.req.rid for p in engine._prefilling
               if p.consumed == len(p.req.prompt)]

        def sample(fl, *args):
            for rid, row in zip(fin, fl):
                sink[rid] = row.float().clone()
            return sample_rows(fl, *args)

        serve_lane.sample_rows = sample
        try:
            return run_lane(model, st, lane, *rest)
        finally:
            serve_lane.sample_rows = sample_rows

    serve_mod.run_lane = recording_run_lane
    try:
        yield
    finally:
        serve_mod.run_lane = run_lane


def _serve_timed(engine, prompts, new: int, da, ids=None) -> dict:
    """Serves `prompts` (new tokens each, under the adapter ids `ids`, or
    the base model) through a warmed engine with the launch counts set to
    0 just before and read just after; returns its records, wall,
    launches and dispatches. An engine with telemetry off counts no
    dispatch: its dispatches, decode steps and step time are None."""
    torch.cuda.synchronize()
    da.reset_launch_counts()
    d0 = engine.obs.dispatches.value()
    t0 = time.monotonic()
    rids = [engine.submit(p, max_new_tokens=new, adapter=a)
            for p, a in zip(prompts, ids or [0] * len(prompts))]
    records = {}
    while engine.has_work:
        engine.step()
        records.update(engine.drain_done_records())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(da.LAUNCHES)
    at_steps = {f"{name} steps {n}": c
                for (name, n), c in sorted(da.LAUNCHES_AT_STEPS.items())}
    dispatches = int(engine.obs.dispatches.value() - d0)
    for r in rids:
        if len(records[r]["tokens"]) != new:
            _fail(f"request {r} returned {len(records[r]['tokens'])} tokens")
    decode_steps = max(1, dispatches * engine.chunk_steps)
    if not engine.obs.enabled:
        dispatches = decode_steps = None
    return {"rids": rids, "records": records, "wall_s": wall,
            "launches": launches, "launches_at_steps": at_steps,
            "dispatches": dispatches,
            "decode_steps": decode_steps,
            "decode_tokens_per_s": new * len(rids) / wall,
            "step_ms": decode_steps and wall / decode_steps * 1e3}


def _public(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("rids", "records")}


@contextlib.contextmanager
def _captured(module, name: str, at: int, sink: dict, steps: int = 1):
    """Swaps `module.name` (a kernel entry point the model calls through
    its module's global) for a pass-through that keeps copies of the
    arguments of the `at`-th call (from 0) whose query positions number
    `steps`: the inputs one launch of a path had, to check and time the
    kernel on. For untimed runs only."""
    fn, seen = getattr(module, name), [0]

    def keep(*args, **kwargs):
        # x [b, steps, d] for the fused entry, q [b, h, steps, hd] for K7.
        n = args[0].shape[1] if args[0].dim() == 3 else args[0].shape[2]
        if n == steps:
            if seen[0] == at:
                copy = lambda a: a.clone() if torch.is_tensor(a) else a  # noqa: E731
                sink["args"] = [copy(a) for a in args]
                sink["kwargs"] = {k: copy(v) for k, v in kwargs.items()}
            seen[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, keep)
    try:
        yield
    finally:
        setattr(module, name, fn)
    if "args" not in sink:
        _fail(f"{name}: the run made {seen[0]} calls of {steps} steps, not {at + 1}")


def _path_paged_kernels(da, cap: dict, what: str) -> dict:
    """K2 and K1 (its injection arm) on the inputs of one K2 + K1 call a
    serving path made (`_captured` on `fused_qkv_paged_attention`): each
    against its plain version (the bf16 rule, per slot), then timed
    beside its plain version, its library call and its bound, cycling
    through ROTATE copies of the weight and pools. K1's plain version and
    library call read each slot's own dense view of its table with its
    own fresh rows written in, which the kernel injects: slots parked on
    the scratch block share its rows in the pool, and each attends to
    its own fresh row. A quantized call (int8 weight + scale row, int8
    pools + scale pools) takes the int8 arms: the views are the
    dequantized pools with the fresh rows at full precision, and the
    library calls count their conversions. Returns {kernel: numbers}."""
    x, w, bias, kp, vp, table, idx = cap["args"]
    kw = cap["kwargs"]
    wsc, ks, vs = kw.get("w_scale"), kw.get("k_scales"), kw.get("v_scales")
    if (wsc is None) != (ks is None):
        _fail(f"{what}: int8 weights with full-precision pools, or the other way")
    int8 = wsc is not None
    h, theta = kw["num_heads"], kw["rope_theta"]
    b, steps, dm = x.shape
    kvh, hd, dout, nlog = kp.shape[1], kp.shape[3], w.shape[1], table.shape[1]
    bf = torch.bfloat16
    proj = dict(num_heads=h, kv_heads=kvh, rope_theta=theta, w_scale=wsc)
    q, kn, vn = da.qkv_rope_reference(x, w, bias, idx, **proj)
    cap_rows = nlog * 128
    qpos = idx.long()[:, None] + torch.arange(steps, device=x.device)
    slot = torch.arange(b, device=x.device)[:, None]

    def views(kp_, vp_, ks_=None, vs_=None):
        out = []
        for pool, scales, new in ((kp_, ks_, kn), (vp_, vs_, vn)):
            view = (da.dequantize_gathered(pool, scales, table, x.dtype) if int8
                    else da.gather_paged_cache(pool, table))
            # One spare row past capacity takes the rows dropped there.
            view = torch.cat([view, view.new_zeros(b, kvh, 1, hd)], dim=2)
            view[slot, :, torch.clamp(qpos, max=cap_rows), :] = new.permute(0, 2, 1, 3)
            out.append(view[:, :, :cap_rows])
        return out

    e2 = _err(da.qkv_rope_projection(x, w, bias, idx, **proj), (q, kn, vn), bf)
    e1 = _err([da._paged_attention_cuda(q, kp, vp, table, idx, kn, vn, ks, vs)],
              [da.decode_attention_reference(q, *views(kp, vp, ks, vs), idx)], bf)
    arm = "_int8" if int8 else ""
    for name, (e, ratio) in (("qkv_rope" + arm, e2), ("paged_attention" + arm, e1)):
        if not ratio <= 1.0:
            _fail(f"{what}: {name} {e} from its plain version, {ratio:.3g}x "
                  f"its per-slot tolerance")
    ws = [w] + [w.clone() for _ in range(ROTATE - 1)]
    pools = [(kp, vp, ks, vs)] + [
        tuple(None if t is None else t.clone() for t in (kp, vp, ks, vs))
        for _ in range(ROTATE - 1)]
    dense = [views(*four) for four in pools]
    gathered = [tuple(t.repeat_interleave(h // kvh, 1) for t in pair) for pair in dense]
    mask = (torch.arange(cap_rows, device=x.device) <= qpos[..., None])[:, None]
    vis = float(torch.clamp(qpos[:, -1] + 1, max=cap_rows).sum())
    row_bytes = hd + 4 if int8 else hd * 2  # int8 rows carry an f32 scale
    k1_bytes = vis * kvh * row_bytes * 2 + 2 * b * h * steps * hd * 2 + b * nlog * 4 + b * 4
    k1_flops = vis * h * steps * hd * 4
    k2_bytes = (b * steps * dm * 2 + dm * dout * w.element_size() + b * steps * dout * 2
                + b * 4 + (0 if bias is None else dout * 2) + (dout * 4 if int8 else 0))
    k2_flops = 2.0 * b * steps * dm * dout

    def k2_lib(i):
        flat = x.reshape(b * steps, dm)
        wi = ws[i % ROTATE]
        if int8:  # the conversion counted, then cuBLAS and the scale
            y = (flat @ wi.to(x.dtype)).float() * wsc
            y = (y if bias is None else y + bias.float()).to(x.dtype)
        else:
            y = flat @ wi if bias is None else torch.addmm(bias, flat, wi)
        da.split_qkv(y.reshape(b, steps, dout), idx, num_heads=h, kv_heads=kvh,
                     rope_theta=theta)

    def k1_lib(i):
        kv = gathered[i % ROTATE]
        if int8:  # the dequantize counted
            kp_, vp_, ks_, vs_ = pools[i % ROTATE]
            kv = tuple(t.repeat_interleave(h // kvh, 1) for t in views(kp_, vp_, ks_, vs_))
        return torch.nn.functional.scaled_dot_product_attention(q, *kv, attn_mask=mask)

    out = {}
    for name, (e, ratio), fn, plain, lib, nbytes, flops in (
        ("qkv_rope" + arm, e2,
         lambda i: da.qkv_rope_projection(x, ws[i % ROTATE], bias, idx, **proj),
         lambda i: da.qkv_rope_reference(x, ws[i % ROTATE], bias, idx, **proj),
         k2_lib, k2_bytes, k2_flops),
        ("paged_attention" + arm, e1,
         lambda i: da._paged_attention_cuda(q, *pools[i % ROTATE][:2], table, idx, kn,
                                            vn, *pools[i % ROTATE][2:]),
         lambda i: da.decode_attention_reference(q, *dense[i % ROTATE], idx),
         k1_lib, k1_bytes, k1_flops),
    ):
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = {
            "inputs": what, "shape": f"b{b} steps{steps} d{dm} h{h} kvh{kvh} "
                                     f"hd{hd} nlog{nlog} bias {bias is not None}"
                                     f"{' int8' if int8 else ''}",
            "max_abs_err": e, "err_over_tol": ratio,
            "tol": "%g * max|plain| per slot + %g" % TOL[bf],
            "ms": _timed(fn, 20), "plain_ms": _timed(plain, 5),
            "library_ms": _timed(lib, 20), "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        }
    return out


def _recorded_serve(ContinuousBatcher, cfg, model, kw, prompts, new, lm_mod,
                    want_tokens, what, first=None, moe_calls=None,
                    capture=("fused_qkv_paged_attention", 48), ids=None) -> dict:
    """An untimed second run of a timed serving run on a fresh engine
    over the same model: it must give the timed run's tokens (output is
    a function of weights, prompts and knobs; under MoE capacity drops the
    same batch must give the same tokens), and it records what the timed
    run must not pay for: the first-token logits (`first`), each MoE
    call's inputs (`moe_calls`) and the inputs of layer 0's kernel call
    (`capture`: the entry point, the decode step); `want_tokens` None
    makes it a first run, whose tokens the caller checks. Returns the
    capture."""
    engine = ContinuousBatcher(cfg, model, **kw)
    engine.warm()
    cap, handles = {}, []
    if moe_calls is not None:
        handles = _record_moe_inputs(engine.model, moe_calls)
    ctx = (_first_token_logits(engine, first) if first is not None
           else contextlib.nullcontext())
    try:
        with ctx, _captured(lm_mod, capture[0], capture[1] * cfg.num_layers, cap):
            rids = [engine.submit(p, max_new_tokens=new, adapter=a)
                    for p, a in zip(prompts, ids or [0] * len(prompts))]
            out = engine.run()
    finally:
        for hnd in handles:
            hnd.remove()
    if want_tokens is not None and [out[r] for r in rids] != want_tokens:
        _fail(f"{what}: a second run of the same batch gave other tokens")
    cap["rids"], cap["records"] = rids, {r: {"tokens": out[r]} for r in rids}
    return cap


def serving_phase(ContinuousBatcher, LMConfig, DecoderLM, da, seed: int) -> dict:
    cfg = _tinyllama_cfg(LMConfig)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = DecoderLM(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    prompts = _serving_prompts(cfg, seed)
    new = 32
    engine = ContinuousBatcher(cfg, model, slo_window_s=OBS_SLO_WINDOW_S,
                               slo_objectives=OBS_SLO_OBJECTIVES, **LM_ENGINE_KW)
    engine.warm()
    obs0 = _obs_snapshot(engine)
    run = _serve_timed(engine, prompts, new, da)
    rids, records, launches = run["rids"], run["records"], run["launches"]
    for name in ("paged_attention", "qkv_rope"):
        if launches[name] <= 0:
            _fail(f"kernel {name} was not launched on the serving path")
    if launches["decode_attention"]:
        _fail(f"the paged engine launched the dense kernel: {launches}")
    prefix = engine.prefix_stats()
    if prefix["block_hits"] < 1:
        _fail(f"no prefix-cache hit: {prefix}")
    # The prefix-hit request alone, cold, on a fresh engine.
    alone = ContinuousBatcher(cfg, model, **LM_ENGINE_KW)
    rid = alone.submit(prompts[-1], max_new_tokens=new)
    alone_tokens = alone.run()[rid]
    if alone_tokens != records[rids[-1]]["tokens"]:
        _fail("the request alone gave other tokens than in the batch")
    ttft = sorted(records[r]["ttft_s"] for r in rids)
    return {
        "model": "TinyLlama-1.1B widths, 22 layers, random bf16 weights",
        "weights_init_s": init_s,
        "requests": len(rids), "new_tokens_each": new,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        **_public(run),
        "ttft_p50_s": ttft[len(ttft) // 2],
        "launches_per_decode_step": {
            k: v / run["decode_steps"] for k, v in launches.items()
        },
        "prefix": {
            k: prefix[k]
            for k in ("block_hits", "hit_rate", "prefill_tokens_saved")
        },
        "alone_equals_batched": True,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "_model": model,
        "_cfg": cfg,
        "_prompts": prompts,
        "_tokens": [records[r]["tokens"] for r in rids],
        # The telemetry leg's "on" arm: this engine, its run, and the
        # registry just before the run.
        "_obs_on": (engine, run, obs0),
    }


# The telemetry leg (4f): the Prometheus sample-line grammar
# (`tests/test_obs.py`'s), the profile hook's window in dispatches and the
# new tokens of the window's requests (none finishes inside it).
PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_+][a-zA-Z0-9_]*="[^"]*")*\})?'
    r" -?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?$"
)
OBS_PROFILE_DISPATCHES = 4
OBS_WINDOW_NEW = 128
# The serving engine's SLO layer: a TTFT objective every request meets and
# a TPOT objective (0.1 ms) every paced request breaches, over a window
# longer than the leg, so the windows hold every sample the registry has.
OBS_SLO_OBJECTIVES = {"ttft_p99_s": 120.0, "tpot_p99_s": 1e-4}
OBS_SLO_WINDOW_S = 3600.0


def _obs_snapshot(engine) -> dict:
    """The registry values the telemetry leg differences around a run."""
    o = engine.obs
    return {
        "submitted": o.submitted.value(),
        "completed_budget": o.completed.value({"reason": "budget"}),
        "tokens": o.tokens.value(), "dispatches": o.dispatches.value(),
        "ttft": o.ttft.count(), "tpot": o.tpot.count(), "wall": o.wall.count(),
        "dispatch_latency": o.dispatch_latency.count(),
        "t": time.monotonic(),
    }


def _slo_attrib_checks(engine, run: dict, obs0: dict) -> dict:
    """Leg 4f's checks of the SLO and attribution layers after the
    serving run: the windows (longer than the leg) count every sample the
    registry holds, the warm-up's and the run's; the TTFT objective met,
    the TPOT one breached; the dispatches by composition class add up;
    the cost model's last bytes per step are the weights' bytes plus a
    whole number of resident tokens' KV bytes, at most slots x cache_len."""
    obs, n = engine.obs, len(run["rids"])
    slo, at = engine.slo_stats(), engine.attrib_stats()
    counts = {k: w["count"] for k, w in slo["windows"].items()}
    want = {"ttft": obs.ttft.count(), "tpot": obs.tpot.count(),
            "dispatch": obs.dispatch_latency.count()}
    if (counts != want or counts["ttft"] != obs0["ttft"] + n
            or counts["dispatch"] != obs0["dispatch_latency"] + run["dispatches"]):
        _fail(f"slo leg: window counts {counts}, the registry {want}, the run "
              f"{n} requests and {run['dispatches']} dispatches after {obs0}")
    if (slo["slo_ok"] != {"ttft_p99_s": True, "tpot_p99_s": False}
            or not slo["burn_rate"]["tpot_p99_s"] > 1.0
            or slo["burn_rate"]["ttft_p99_s"] != 0.0 or engine.slo_ok is not False):
        _fail(f"slo leg: compliance {slo['slo_ok']}, burn {slo['burn_rate']}, "
              f"slo_ok {engine.slo_ok}")
    sat = engine.saturation
    if sat is None or not 0.0 <= sat <= 1.0:
        _fail(f"slo leg: saturation {sat}, {slo['saturation']}")
    kinds = {k: v["dispatches"] for k, v in at["kinds"].items()}
    if sum(kinds.values()) != obs.dispatches.value():
        _fail(f"attribution: kinds {kinds} for {obs.dispatches.value()} dispatches")
    per_tok = engine._kv_bytes_per_token()
    resident = (at["hbm_bytes_per_step"] - engine._param_bytes) / per_tok
    if (resident != int(resident)
            or not 0 <= resident <= engine.slots * engine.cache_len):
        _fail(f"attribution: {at['hbm_bytes_per_step']} bytes a step less "
              f"{engine._param_bytes} of weights is {resident} tokens of {per_tok} B")
    frac, host = at["roofline_fraction"], at["host_overhead_frac"]
    if frac is None or not 0.0 < frac <= 1.0 or not 0.0 <= host <= 1.0:
        _fail(f"attribution: roofline fraction {frac}, host overhead {host}")
    return {"window_counts": counts, "slo_ok": slo["slo_ok"],
            "burn_rate": slo["burn_rate"], "saturation": sat,
            "components": slo["saturation"]["components"],
            "windows": slo["windows"], "kinds": kinds,
            "param_bytes": engine._param_bytes, "kv_bytes_per_token": per_tok,
            "hbm_bytes_per_step": at["hbm_bytes_per_step"],
            "resident_tokens_last_dispatch": int(resident),
            "roofline_fraction": frac, "host_overhead_frac": host,
            "device_step_ms": at["device_step_ms"],
            "window_dispatches": at["window_dispatches"]}


def _obs_on_checks(engine, run: dict, obs0: dict) -> dict:
    """Leg 4f's checks of the telemetry the serving phase's run wrote."""
    obs, rids, records = engine.obs, run["rids"], run["records"]
    n, new = len(rids), len(records[rids[0]]["tokens"])
    d = {k: v - obs0[k] for k, v in _obs_snapshot(engine).items() if k != "t"}
    for rid in rids:
        rec = records[rid]
        if (obs.trace.ttft_s(rid), obs.trace.wall_s(rid)) != (rec["ttft_s"], rec["wall_s"]):
            _fail(f"obs leg: request {rid}'s trace gives ttft/wall "
                  f"{obs.trace.ttft_s(rid)}/{obs.trace.wall_s(rid)}, its record "
                  f"{rec['ttft_s']}/{rec['wall_s']}")
    # A decode pace only where the last token came at a later sync.
    paced = sum(1 for r in records.values()
                if len(r["tokens"]) > 1 and r["wall_s"] > r["ttft_s"])
    want = {"submitted": n, "completed_budget": n, "tokens": n * new,
            "ttft": n, "wall": n, "tpot": paced, "dispatches": run["dispatches"],
            "dispatch_latency": run["dispatches"]}
    if d != want:
        _fail(f"obs leg: registry deltas {d}, the records say {want}")
    text = obs.render()
    lines = [ln for ln in text.splitlines() if not ln.startswith("#")]
    bad = [ln for ln in lines if not PROM_SAMPLE.match(ln)]
    if bad or not lines:
        _fail(f"obs leg: {len(bad)} exposition lines do not parse: {bad[:3]}")
    free = obs.pool_blocks.value({"state": "free"})
    parked = obs.pool_blocks.value({"state": "parked"})
    used = obs.pool_blocks.value({"state": "used"})
    if used != 0 or free + parked != engine.pool_blocks - 1:
        _fail(f"obs leg: pool not drained: free {free}, parked {parked}, used {used}")
    chrome = json.loads(json.dumps(obs.trace.chrome_trace()))
    ring = [e for e in obs.trace.ring.snapshot() if e["t"] >= obs0["t"]]
    done = [e for e in ring if e["name"] == "done" and e.get("rid") in records]
    dispatch = [e for e in ring if e["name"] == "dispatch"]
    device = [e for e in chrome["traceEvents"] if e["name"].startswith("device:")]
    decode = {e["tid"] for e in chrome["traceEvents"] if e["name"] == "decode"}
    all_dispatch = sum(1 for e in obs.trace.ring.snapshot() if e["name"] == "dispatch")
    if (len(done) != n or len(dispatch) != run["dispatches"]
            or len(device) != all_dispatch or not set(rids) <= decode
            or obs.trace.ring.dropped):
        _fail(f"obs leg: trace holds {len(done)} done of {n} requests, "
              f"{len(dispatch)} dispatch events for {run['dispatches']} "
              f"dispatches, {len(device)} device spans for {all_dispatch}, "
              f"decode spans {sorted(decode)}, {obs.trace.ring.dropped} dropped")
    kinds = {}
    for e in dispatch:
        kinds[e["args"]["kind"]] = kinds.get(e["args"]["kind"], 0) + 1
    host = sorted(e["args"]["host_ms"] for e in dispatch)
    dev = sorted(e["args"]["device_ms"] for e in dispatch)
    return {"registry_deltas": d, "exposition_lines": len(lines),
            "exposition_bytes": len(text), "dispatch_kinds": kinds,
            "host_ms_p50": host[len(host) // 2], "device_ms_p50": dev[len(dev) // 2],
            "chrome_events": len(chrome["traceEvents"]),
            "pool": {"free": free, "parked": parked}}


def obs_phase(ContinuousBatcher, da, model, cfg, prompts, tokens, on) -> dict:
    """Leg 4f: the serving phase's engine (telemetry on) checked, then an
    `obs=False` engine on the same model and prompts; the arms run on
    (the serving phase's run), off, on, off, and each arm's step time and
    the overhead of telemetry are reported (not gated)."""
    engine, run_on, obs0 = on
    new = len(tokens[0])
    checks = _obs_on_checks(engine, run_on, obs0)
    slo_attrib = _slo_attrib_checks(engine, run_on, obs0)
    off = ContinuousBatcher(cfg, model, obs=False, **LM_ENGINE_KW)
    off.warm()
    runs = {"on": [run_on], "off": []}
    for arm, eng in (("off", off), ("on", engine), ("off", off)):
        runs[arm].append(_serve_timed(eng, prompts, new, da))
    for i, (a, b) in enumerate(zip(runs["on"], runs["off"])):
        if [b["records"][r]["tokens"] for r in b["rids"]] != tokens:
            _fail(f"obs leg: obs=False run {i} gave other tokens than the on arm")
        if [a["records"][r]["tokens"] for r in a["rids"]] != tokens:
            _fail(f"obs leg: on run {i} gave other tokens")
        # The same work: the off arm counts no dispatch, so its step time
        # takes the on arm's decode steps once the launches agree.
        if a["launches"] != b["launches"]:
            _fail(f"obs leg: run {i} launched {b['launches']} off, {a['launches']} on")
        b["decode_steps"] = a["decode_steps"]
        b["step_ms"] = b["wall_s"] / a["decode_steps"] * 1e3
    occ, kv = off.occupancy(), off.kv_stats()
    if not (occ.get("obs_disabled") and kv.get("obs_disabled")
            and occ["total_slot_steps"] == 0):
        _fail(f"obs leg: obs=False views {occ}, {kv}")
    if (off.obs.trace.ring.snapshot() or off.obs.trace.chrome_trace()["traceEvents"]
            or off.obs.render() != "\n"):
        _fail("obs leg: the obs=False engine recorded telemetry")
    on_ms = [r["step_ms"] for r in runs["on"]]
    off_ms = [r["step_ms"] for r in runs["off"]]
    launches = {k: sum(r["launches"][k] for r in runs["on"][1:] + runs["off"])
                for k in ("paged_attention", "qkv_rope")}
    return {
        "checks": checks, "slo_attrib": slo_attrib, "new_tokens_each": new,
        "requests": len(tokens), "order": "on off on off",
        "step_ms": {"on": on_ms, "off": off_ms},
        "wall_s": {"on": [r["wall_s"] for r in runs["on"]],
                   "off": [r["wall_s"] for r in runs["off"]]},
        "obs_overhead_pct": (sum(on_ms) / sum(off_ms) - 1) * 100,
        # Per pair: run 1 cold (the on arm first in the process at full
        # prompt lengths), run 2 with the prefix cache warm.
        "pair_overhead_pct": [(a / b - 1) * 100 for a, b in zip(on_ms, off_ms)],
        "launches": launches, "decode_steps": runs["on"][0]["decode_steps"],
    }


def window_obs_profile(seed: int) -> dict:
    """The engine's own `ProfileHook` (`obs/profile.py`) armed for
    OBS_PROFILE_DISPATCHES dispatches of steady decode on a warmed paged
    engine at TinyLlama-1.1B widths and WINDOW_LAYERS layers: one
    completed window, no error, a trace file, and in it as many K1 and K2
    kernel events as their wrappers counted between the hook's profiler
    start and stop. The hook's window spans the launches between its
    first tick and its last (the last tick stops the profiler before its
    dispatch launches): dispatches - 1 decode chunks."""
    import dataclasses

    from walkai_nos_tpu_torch.models.lm import DecoderLM, LMConfig
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
    from walkai_nos_tpu_torch.ops import decode_attention as da

    cfg = dataclasses.replace(_tinyllama_cfg(LMConfig), num_layers=WINDOW_LAYERS)
    engine = ContinuousBatcher(cfg, DecoderLM(cfg, device="cuda", seed=seed),
                               **LM_ENGINE_KW)
    engine.warm()
    rids = [engine.submit(p, max_new_tokens=OBS_WINDOW_NEW)
            for p in _serving_prompts(cfg, seed)[:4]]
    while engine._pending or engine._prefilling:
        engine.step()
    hook = engine.obs.profile
    snaps = {}
    start, stop = hook._start, hook._stop

    def counted_start(logdir):
        snaps["start"] = dict(da.LAUNCHES)
        return start(logdir)

    def counted_stop():
        snaps["stop"] = dict(da.LAUNCHES)
        stop()

    hook._start, hook._stop = counted_start, counted_stop
    # The trace (~27 MB at 8 layers, CPU activity included) is read here
    # and deleted.
    logdir = os.path.join("chip_smoke_work", "obs_profile")
    shutil.rmtree(logdir, ignore_errors=True)
    hook.arm(OBS_PROFILE_DISPATCHES, logdir)
    d0 = engine.obs.dispatches.value()
    t0 = time.monotonic()
    while engine.has_work and not hook.status()["completed_windows"]:
        engine.step()
    wall = time.monotonic() - t0
    dispatches = int(engine.obs.dispatches.value() - d0)
    status = hook.status()
    out = engine.run()
    if any(len(out[r]) != OBS_WINDOW_NEW for r in rids):
        _fail("obs profile window: a request came back short")
    path = status["last_trace"]
    if (status["completed_windows"] != 1 or status["last_error"] is not None
            or status["active"] or not path or not os.path.exists(path)):
        _fail(f"obs profile window: hook status {status}")
    launches = {k: v - snaps["start"].get(k, 0) for k, v in snaps["stop"].items()}
    want = WINDOW_LAYERS * engine.chunk_steps * (OBS_PROFILE_DISPATCHES - 1)
    if (launches["paged_attention"], launches["qkv_rope"]) != (want, want):
        _fail(f"obs profile window: wrappers counted {launches}, want {want} "
              f"each of K1 and K2 ({WINDOW_LAYERS} layers x {engine.chunk_steps} "
              f"steps x {OBS_PROFILE_DISPATCHES - 1} dispatches)")
    trace_bytes = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(logdir, ignore_errors=True)
    rows = [(e.get("dur", 0), 1, e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]
    seen = _check_window(rows, launches, {"paged_attention": "decode_mma_kernel",
                                          "qkv_rope": "qkv_mma_kernel"})
    return {"dispatches_armed": OBS_PROFILE_DISPATCHES,
            "dispatches_stepped": dispatches, "layers": WINDOW_LAYERS,
            "wall_s": wall, "status": status, "trace_bytes": trace_bytes,
            "trace_events": len(events), "kernel_events": len(rows),
            "device_kernel_ms": sum(r[0] for r in rows) / 1e3,
            "sentinel_launches": seen}


# The device-resident loop's and the speculative rounds' legs (TinyLlama
# width, the serving prompts, 8 slots, cache_len 2048). The loop leg's
# budget lets folds do most of the decode steps (admission stays eager).
LOOP_STEPS = 4
LOOP_NEW = 256
# The loop window's new tokens a request: enough folds that most only
# replay their graph, half the leg's 256, to keep the profiled trace (and
# the child's reading of it) short.
LOOP_WINDOW_NEW = 128
SPEC_K = 4
SPEC_NEW = 32
# The depth of the LM serving, loop, spec, int8 serving, generate and
# obs_profile windows and of the LoRA and capture legs (a child's start-up
# and the trace it reads grow with the layers; the script's time budget).
WINDOW_LAYERS = 8


def _serve_legged(engine, prompts, new: int, da, ids=None) -> dict:
    """`_serve_timed` for an engine that folds or drafts: decode steps
    from the engine's slot-step counter (a fold counts the steps it ran,
    a round k+1), and the wall inside `_step_loop` (the folds: upload,
    graph launch, download and sync each) apart."""
    fold_wall = [0.0]
    step_loop = engine._step_loop

    def timed_loop():
        t0 = time.monotonic()
        step_loop()
        fold_wall[0] += time.monotonic() - t0

    engine._step_loop = timed_loop
    total0 = engine.obs.total_steps.value()
    verify0 = engine.obs.spec_verify.value()
    stats0 = engine.loop_stats()
    try:
        run = _serve_timed(engine, prompts, new, da, ids)
    finally:
        engine._step_loop = step_loop
    steps = (engine.obs.total_steps.value() - total0) / engine.slots
    run["decode_steps"] = steps
    run["step_ms"] = run["wall_s"] / steps * 1e3
    run["verify_rounds"] = int(engine.obs.spec_verify.value() - verify0)
    stats = engine.loop_stats()
    folded = stats["chunks_folded"] - stats0["chunks_folded"]
    run["folds"] = stats["dispatches"] - stats0["dispatches"]
    run["fold_wall_s"] = fold_wall[0]
    if folded:
        kstep = engine._k_now + 1 if engine._spec_on else engine.chunk_steps
        run["fold_chunks_or_rounds"] = folded
        run["folded_steps"] = folded * kstep
        run["fold_ms_per_step"] = fold_wall[0] / (folded * kstep) * 1e3
        run["captures"] = engine._loop.captures
    return run


def loop_serving_phase(ContinuousBatcher, da, model, cfg, prompts) -> dict:
    """The serving prompts x LOOP_NEW new tokens with `loop_steps` 4
    (`chunk_steps` 8) and, timed beside it, with `loop_steps` 1: the
    greedy tokens must be equal, and folds must do most of the decode
    steps. One graph launch and one sync per fold are read from the
    profiler's trace in `--window loop_serving`."""
    runs = {}
    for loop in (1, LOOP_STEPS):
        engine = ContinuousBatcher(cfg, model, loop_steps=loop, **LM_ENGINE_KW)
        engine.warm()
        runs[loop] = _serve_legged(engine, prompts, LOOP_NEW, da)
        chunk_steps, loop_stats = engine.chunk_steps, engine.loop_stats()
        attrib = engine.attrib_stats()
        del engine
    tokens = {loop: [run["records"][r]["tokens"] for r in run["rids"]]
              for loop, run in runs.items()}
    if tokens[LOOP_STEPS] != tokens[1]:
        _fail("loop serving: tokens differ from loop_steps=1")
    run = runs[LOOP_STEPS]
    for name in ("paged_attention", "qkv_rope"):
        if run["launches"][name] <= 0:
            _fail(f"loop serving: {name} was not launched")
    share = run.get("folded_steps", 0) / run["decode_steps"]
    if not share > 0.5:
        _fail(f"loop serving: folds ran {share:.3f} of the decode steps, not most")
    off = runs[1]
    return {"loop_steps": LOOP_STEPS, "chunk_steps": chunk_steps,
            "new_tokens_each": LOOP_NEW, **_public(run),
            "folded_step_share": share, "loop_stats": loop_stats,
            "attrib": attrib,
            "loop_off": {k: off[k] for k in ("wall_s", "decode_steps", "step_ms",
                                             "decode_tokens_per_s")},
            "tokens_equal_loop_off": True}


SPEC_LEGS = (("random_draft", 1), ("self_draft", 1), ("self_draft", LOOP_STEPS))


def _first_divergence(model, prompts, got, want) -> dict:
    """Where spec-on tokens (`got`) first part from spec-off's (`want`):
    per request, the first differing position and the logit gap there,
    logit[want] - logit[got], from one full forward (no cache) over the
    prompt and the tokens both runs share. A near-tie shows as a gap
    near the dtype's rounding."""
    rows = []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        pos = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if pos is None:
            continue
        seq = torch.tensor([list(p) + w[:pos]], device=model.device)
        with torch.inference_mode():
            logits = model(seq)[0, -1].float()
        rows.append({"request": i, "position": pos,
                     "logit_gap": float(logits[w[pos]] - logits[g[pos]])})
    return {"requests_differing": len(rows), "requests": len(want),
            "first_position": min((r["position"] for r in rows), default=None),
            "max_abs_logit_gap": max((abs(r["logit_gap"]) for r in rows), default=None),
            "per_request": rows}


def spec_serving_phase(ContinuousBatcher, lm_mod, da, model, cfg, prompts,
                       want_tokens, seed: int, what: str, legs=SPEC_LEGS,
                       exact: bool = False) -> dict:
    """Batched speculative rounds, `spec_k` 4 pinned on (`spec_min_accept`
    0), the serving prompts x SPEC_NEW new tokens, one leg per (draft,
    loop_steps) of `legs`: a random `draft_config` draft (1 layer, 512
    wide, 8 MHA heads) or the target as its own draft, with loop_steps 1
    or 4 (the spec graph). Every leg's verifies run the same shapes
    (k fixed), so every leg must give the first leg's tokens; each must
    launch K2 and K1 at steps k+1 exactly verify rounds x layers times
    (the wrappers' count by steps), and a self draft must emit close to
    k+1 tokens a round. `exact` (f32): the tokens must also equal
    `want_tokens` (spec off, same model and prompts). Else (bf16, int8):
    a verify over k+1 positions runs its GEMMs and kernels at other
    shapes than a one-step decode, which round apart, so tokens may part
    at a near-tie; where they first part and the logit gap there are
    reported. Then an untimed second run of the first leg must repeat its
    tokens, and K2 and K1 at steps k+1 are held to their plain versions
    on the inputs of one of its verify calls."""
    dcfg = lm_mod.draft_config(cfg)
    drafts = {
        "random_draft": (dcfg, lm_mod.DecoderLM(dcfg, device=model.device, seed=seed + 5)),
        "self_draft": (cfg, model),
    }
    arms = {"qkv_rope": "_int8" if cfg.w_quant == "int8" else "",
            "paged_attention": "_int8" if cfg.kv_quant == "int8" else ""}
    n_tok = SPEC_NEW * len(prompts)
    out, first = {}, None
    for name, loop in legs:
        d_cfg, d_model = drafts[name]
        kw = dict(LM_ENGINE_KW, spec=True, spec_k=SPEC_K, spec_min_accept=0.0,
                  draft_cfg=d_cfg, draft_params=d_model, loop_steps=loop)
        engine = ContinuousBatcher(cfg, model, **kw)
        engine.warm()
        run = _serve_legged(engine, prompts, SPEC_NEW, da)
        tokens = [run["records"][r]["tokens"] for r in run["rids"]]
        same = sum(a == b for t, u in zip(tokens, want_tokens) for a, b in zip(t, u))
        want_launches = run["verify_rounds"] * cfg.num_layers
        verify = {k: run["launches_at_steps"].get(f"{k}{arm} steps {SPEC_K + 1}", 0)
                  for k, arm in arms.items()}
        leg = {"loop_steps": loop, **_public(run), "spec_stats": engine.spec_stats(),
               "verify_launches": verify,
               "tokens_equal_spec_off_share": same / n_tok}
        engine_graphs = sorted(engine._loop._graphs) if loop > 1 else []
        if loop > 1:
            leg["loop_stats"] = engine.loop_stats()
        out[f"{name}_loop{loop}"] = leg
        del engine
        tag = f"{what} {name} loop {loop}"
        stats = leg["spec_stats"]
        if stats["k"] != SPEC_K or stats["drafting_disabled"] or (
                loop > 1 and SPEC_K not in engine_graphs):
            _fail(f"{tag}: k {stats['k']}, drafting disabled "
                  f"{stats['drafting_disabled']}, fold graphs {engine_graphs}")
        if any(n != want_launches for n in verify.values()):
            _fail(f"{tag}: K2/K1 at steps {SPEC_K + 1} launched {verify}, not "
                  f"{run['verify_rounds']} verify rounds x {cfg.num_layers} layers")
        if first is None:
            first = tokens
        elif tokens != first:
            div = _first_divergence(model, prompts, tokens, first)
            _fail(f"{tag}: tokens differ from the {legs[0][0]} leg's: {div}")
        if exact and tokens != want_tokens:
            _fail(f"{tag}: tokens differ from spec off ({same} of {n_tok} equal)")
        emitted = leg["spec_stats"]["emitted_per_round"]
        floor = (0.9 if exact else 0.8) * (SPEC_K + 1)
        if name == "self_draft" and not emitted >= floor:
            _fail(f"{tag}: the self draft emitted {emitted} a round, under "
                  f"{floor} (k+1 = {SPEC_K + 1})")
    out["tokens_equal_across_legs"] = True
    if exact:
        return out
    out["divergence_from_spec_off"] = _first_divergence(model, prompts, first,
                                                        want_tokens)
    # An untimed second run of the first leg: its tokens again, and the
    # inputs of layer 0's K2 + K1 call in the fourth verify round.
    d_cfg, d_model = drafts[legs[0][0]]
    engine = ContinuousBatcher(cfg, model, **LM_ENGINE_KW, spec=True, spec_k=SPEC_K,
                               spec_min_accept=0.0, draft_cfg=d_cfg,
                               draft_params=d_model, loop_steps=legs[0][1])
    engine.warm()
    cap = {}
    with _captured(lm_mod, "fused_qkv_paged_attention", 3 * cfg.num_layers, cap,
                   steps=SPEC_K + 1):
        rids = [engine.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
        res = engine.run()
    if [res[r] for r in rids] != first:
        _fail(f"{what}: a second run of the first leg gave other tokens")
    out["kernels"] = _path_paged_kernels(da, cap, f"{what} verify, steps {SPEC_K + 1}")
    del engine
    return out


def spec_exactness_phase(ContinuousBatcher, lm_mod, da, cfg, prompts,
                         seed: int) -> dict:
    """TinyLlama width, 4 layers, f32 (where a verify and a one-step
    decode round alike): `loop_steps` 4 and every speculative leg must
    give the spec-off, loop-off tokens; then the same with "int8-sim" KV
    and weights (unit scales: every scale path, lossless), self-drafted.
    Real int8 is left out: a verify reads its own fresh rows at full
    precision (K1 injects them; they quantize at the scatter after),
    where a one-step decode reads the earlier ones quantized, so int8
    spec-on and spec-off differ by design, in JAX's kernel route too."""
    import dataclasses

    out = {"layers": 4, "dtype": "float32"}
    for kind in ("model", "int8-sim"):
        cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32",
                                    kv_dtype=kind, w_dtype=kind)
        model = lm_mod.DecoderLM(cfg32, device="cuda", seed=seed + 6)
        want = None
        for loop in (1, LOOP_STEPS):
            engine = ContinuousBatcher(cfg32, model, loop_steps=loop, **LM_ENGINE_KW)
            rids = [engine.submit(p, max_new_tokens=32) for p in prompts]
            res = engine.run()
            tokens = [res[r] for r in rids]
            want = tokens if want is None else want
            if tokens != want:
                _fail(f"f32 {kind}: loop_steps {loop} gave other tokens than 1")
        legs = SPEC_LEGS if kind == "model" else (("self_draft", 1),
                                                  ("self_draft", LOOP_STEPS))
        out[kind] = spec_serving_phase(
            ContinuousBatcher, lm_mod, da, model, cfg32, prompts, want, seed,
            f"f32 {kind} spec", legs=legs, exact=True)
        del model
        torch.cuda.empty_cache()
    out["identical"] = True
    return out


def int8_serving_phase(ContinuousBatcher, DecoderLM, lm_mod, da, cfg, prompts,
                       bf16_tokens, seed: int) -> dict:
    """The paged engine with int8 KV and int8 weights at TinyLlama-1.1B
    width: the weights are the bf16 serving model's draws (same seed),
    quantized per output channel; 8 slots, cache_len 2048, the serving
    phase's 8 requests x 32 new tokens. Checks every request, launches of
    both int8 arms and of neither full-precision arm, and 11,968 KV bytes
    per token; reports the share of tokens equal to the bf16 engine's.
    Then the int8 leg of the speculative rounds (`spec_serving_phase`),
    held to these tokens."""
    import dataclasses

    cfg8 = dataclasses.replace(cfg, kv_dtype="int8", w_dtype="int8")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = DecoderLM(cfg8, device="cuda", seed=seed)
    new = 32
    engine = ContinuousBatcher(cfg8, model, **LM_ENGINE_KW)
    engine.warm()
    run = _serve_timed(engine, prompts, new, da)
    rids, records, launches = run["rids"], run["records"], run["launches"]
    tokens = [records[r]["tokens"] for r in rids]
    if min(min(t) for t in tokens) < 0 or max(max(t) for t in tokens) >= cfg.vocab_size:
        _fail("int8 serving: a token outside the vocabulary")
    for name in ("paged_attention_int8", "qkv_rope_int8"):
        if launches[name] <= 0:
            _fail(f"int8 serving: {name} was not launched: {launches}")
    if launches["paged_attention"] or launches["qkv_rope"] or launches["decode_attention"]:
        _fail(f"int8 serving launched a full-precision arm: {launches}")
    stats = engine.quant_stats()
    if stats["kv_bytes_per_token"] != 11968:
        _fail(f"int8 serving: {stats['kv_bytes_per_token']} KV bytes per token")
    agree = sum(a == b for t, u in zip(tokens, bf16_tokens) for a, b in zip(t, u))
    ttft = sorted(records[r]["ttft_s"] for r in rids)
    out = {
        "model": "TinyLlama-1.1B widths, 22 layers, the bf16 phase's random "
                 "weights quantized to int8, int8 KV",
        "requests": len(rids), "new_tokens_each": new, **_public(run),
        "ttft_p50_s": ttft[len(ttft) // 2],
        "launches_per_decode_step": {
            k: v / run["decode_steps"] for k, v in launches.items()
        },
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "quant": stats,
        "kv_backing_bytes": engine.kv_stats()["kv_backing_bytes"],
        "tokens_equal_to_bf16_share": agree / (new * len(rids)),
    }
    del engine
    # The int8 arms of K2 and K1 at steps k+1: the model as its own draft.
    out["spec_serving"] = spec_serving_phase(
        ContinuousBatcher, lm_mod, da, model, cfg8, prompts, tokens, seed,
        "int8 spec serving", legs=(("self_draft", 1),))
    del model
    torch.cuda.empty_cache()
    return out


def sim_exactness_phase(ContinuousBatcher, DecoderLM, da, cfg, prompts,
                        seed: int) -> dict:
    """bf16 at TinyLlama width, 4 layers: "int8-sim" KV and weights run
    every scale path (K1 with scale pools, K2 with a unit scale row,
    QuantDense, the quantizing scatter) and must give the unquantized
    engine's tokens, on the fused route and on the unfused one."""
    import dataclasses

    new = 16
    picks = [prompts[i] for i in (1, 3, 6)]
    out = {"layers": 4, "dtype": "bfloat16", "requests": len(picks),
           "new_tokens_each": new}
    for fused in (True, False):
        runs = {}
        for q in ("model", "int8-sim"):
            c = dataclasses.replace(cfg, num_layers=4, fused_qkv=fused,
                                    kv_dtype=q, w_dtype=q)
            model = DecoderLM(c, device="cuda", seed=seed + 6)
            engine = ContinuousBatcher(c, model, slots=4, cache_len=1024)
            da.reset_launch_counts()
            rids = [engine.submit(p, max_new_tokens=new) for p in picks]
            served = engine.run()
            torch.cuda.synchronize()
            runs[q] = ([served[r] for r in rids], dict(da.LAUNCHES))
            del model, engine
        route = "fused" if fused else "unfused"
        if runs["model"][0] != runs["int8-sim"][0]:
            _fail(f"int8-sim differs from the unquantized engine on the "
                  f"{route} route: {runs['int8-sim'][0]} vs {runs['model'][0]}")
        launches = runs["int8-sim"][1]
        if launches["paged_attention"] <= 0 or (launches["qkv_rope"] > 0) != fused:
            _fail(f"int8-sim {route} route launched {launches}")
        out[route] = {"identical": True, "sim_launches": launches}
    torch.cuda.empty_cache()
    return out


def _k7_case(da, case, q, kvs, idx, dtypes) -> tuple[list, dict]:
    """K7 on one case: against its plain version in each of `dtypes`
    (the inputs cast), then timed in q's dtype beside the plain version
    and SDPA over the same masked cache (GQA enabled), cycling through
    the ROTATE cache copies `kvs`, with the byte bound of the rows this
    case's indices make visible. Returns (checks, timing row)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, steps, hd = q.shape
    kvh, S = kvs[0][0].shape[1], kvs[0][0].shape[2]
    dev = q.device
    checks = []
    for dtype in dtypes:
        q_, (k_, v_) = q.to(dtype), (t.to(dtype) for t in kvs[0])
        e, ratio = _err([da.decode_attention(q_, k_, v_, idx)],
                        [da.decode_attention_reference(q_, k_, v_, idx)], dtype)
        checks.append({
            "kernel": "decode_attention", "case": case,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": e,
            "err_over_tol": ratio,
            "tol": "%g * max|plain| per row + %g" % TOL[dtype],
        })
        if not ratio <= 1.0:
            _fail(f"decode_attention {case} {dtype}: max err {e}, "
                  f"{ratio:.3g}x its tolerance")
    # Rows each query of this case's data sees (clamped to the cache).
    top = idx.long().reshape(-1).expand(b) + steps
    vis = float(torch.clamp(top, max=S).sum())
    nbytes = vis * kvh * hd * 2 * 2 + 2 * b * h * steps * hd * 2 + idx.numel() * 4
    flops = 4.0 * vis * h * steps * hd
    pos = torch.arange(S, device=dev)
    qpos = idx.long().reshape(-1, 1) + torch.arange(steps, device=dev)
    mask = (pos <= qpos[..., None])[:, None]  # [b or 1, 1, steps, S]

    def kern(i):
        da.decode_attention(q, *kvs[i % len(kvs)], idx)

    def plain(i):
        da.decode_attention_reference(q, *kvs[i % len(kvs)], idx)

    def lib(i):
        sdpa(q, *kvs[i % len(kvs)], attn_mask=mask, enable_gqa=kvh != h)

    bound_ms, bound_by = _bound(nbytes, flops)
    return checks, {
        "kernel": "decode_attention", "case": case,
        "shape": f"b{b} h{h} kvh{kvh} d{hd} S{S} steps{steps} "
                 f"{str(q.dtype).split('.')[-1]}",
        "ms": _timed(kern, 20), "plain_ms": _timed(plain, 5),
        "library_ms": _timed(lib, 20), "host_call_ms": _host_timed(kern, 50),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops,
    }


def dense_kernel_phase(da, seed: int) -> tuple[list, list]:
    """K7 (dense-cache decode attention) against its plain version in
    bf16 and f32 at the dense decode path's shapes: the generate step
    (TinyLlama, 8 rows over a 1024-row bucket, shared index 1000), the
    dense engine's step (2048-row cache, per-row indices at the edges and
    past the cache), the speculative verify (5 steps, batch 1), an MHA
    model (32 heads over 32 kv heads), rows that see far less than the
    cache (indices 0, 63, 64 and past a 2048-row cache) and an 8192-row
    cache (many tiles a split). Times kernel, plain version and
    SDPA over the same masked cache (GQA enabled) in bf16, each against
    the byte bound of this case's visible rows. Returns (checks, rows)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    bf = torch.bfloat16
    ragged = [0, 127, 128, 1000, 1500, 2047, 2048, 2100]  # S = 2048
    # Rows whose visible range is much shorter than S (most splits empty)
    # beside one past the cache.
    short = [0, 63, 64, 2100] * 2
    # (case, b, h, kvh, S, steps, index)
    cases = (
        ("generate", 8, 32, 4, 1024, 1, 1000),
        ("ragged_2048", 8, 32, 4, 2048, 1, ragged),
        ("verify", 1, 32, 4, 1024, 5, 900),
        ("mha", 8, 32, 32, 1024, 1, 1000),
        ("short_2048", 8, 32, 4, 2048, 1, short),
        ("long_8192", 8, 32, 4, 8192, 1, 8000),
    )
    checks, rows = [], []
    for case, b, h, kvh, S, steps, index in cases:
        hd = 64
        idx = torch.tensor(index, device=dev, dtype=torch.int32)
        q = torch.randn(b, h, steps, hd, generator=gen, device=dev).to(bf)
        kvs = [
            tuple(torch.randn(b, kvh, S, hd, generator=gen, device=dev).to(bf)
                  for _ in range(2))
            for _ in range(ROTATE)
        ]
        c, r = _k7_case(da, case, q, kvs, idx, (bf, torch.float32))
        checks += c
        rows.append(r)
    torch.cuda.empty_cache()
    return checks, rows


GENERATE_NEW, GENERATE_CHUNK = 128, 16
GENERATE_WINDOW_NEW = 64  # the profiled window's tokens (the script's time)


def _generate_prompts(cfg, seed: int) -> np.ndarray:
    """8 prompts of one length drawn from 769-896 tokens (the cache
    bucket is then 1024 rows, K7's timed shape)."""
    rng = np.random.default_rng(seed + 3)
    length = int(rng.integers(769, 897))
    return rng.integers(0, cfg.vocab_size, (8, length))


def generate_phase(make_generate_fn, da, model, cfg, seed: int) -> dict:
    """One-shot generation (`make_generate_fn`, dense cache) at TinyLlama
    width, bf16: 8 prompts of one length drawn from 769-896 tokens (the
    cache bucket is then 1024 rows, K7's timed shape), 128 new tokens in
    chunks of 16 steps. Checks 22 K7 launches per decode step, no paged
    kernel, finite well-formed tokens and two identical runs."""
    prompts = _generate_prompts(cfg, seed)
    length = prompts.shape[1]
    new, chunk = GENERATE_NEW, GENERATE_CHUNK
    gen = make_generate_fn(cfg, tokens_per_dispatch=chunk)
    gen(model, prompts[:, :16], 2)  # first calls allocate: warm them
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.reset_launch_counts()
    t0 = time.monotonic()
    first = gen(model, prompts, new)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(da.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = -(-(new - 1) // chunk) * chunk  # decode steps after the prefill
    if launches["decode_attention"] != cfg.num_layers * steps:
        _fail(f"generate: {launches} for {steps} decode steps")
    if launches["paged_attention"] or launches["qkv_rope"]:
        _fail(f"generate launched paged kernels: {launches}")
    tokens = first.cpu().numpy()
    if tokens.shape != (8, new) or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        _fail(f"generate: tokens of shape {tokens.shape}")
    # Prefill alone, to split the wall time.
    t0 = time.monotonic()
    gen(model, prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    again = gen(model, prompts, new)
    if not torch.equal(again, first):
        _fail("generate: two runs gave different tokens")
    return {
        "model": "TinyLlama-1.1B widths, 22 layers, random bf16 weights",
        "batch": 8, "prompt_len": length, "new_tokens": new,
        "tokens_per_dispatch": chunk,
        "cache_bucket": -(-(length + new) // 128) * 128,
        "wall_s": wall, "prefill_s": prefill_s,
        "decode_tokens_per_s": 8 * (new - 1) / (wall - prefill_s),
        "step_ms": (wall - prefill_s) / steps * 1e3,
        "launches": launches, "decode_steps": steps,
        "two_runs_identical": True, "peak_mem_gb": peak,
        "_prompts": prompts,
    }


def speculative_phase(spec_mod, lm_mod, da, model, cfg, prompt, seed: int) -> dict:
    """Standalone speculative decoding at TinyLlama width, bf16, batch 1:
    a `draft_config` draft (1 layer, 512 wide, 8 MHA heads, random
    weights from --seed), k 4, 64 new tokens. Checks 22 K7 launches per
    verify round (the target's 5-position verify; the MHA draft and the
    prefills take the masked path)."""
    k, new = 4, 64
    draft_cfg = lm_mod.draft_config(cfg)
    draft = lm_mod.DecoderLM(draft_cfg, device="cuda", seed=seed + 4)
    gen = spec_mod.make_speculative_generate_fn(cfg, draft_cfg, k=k, return_stats=True)
    gen(model, draft, prompt[None, :16], 6)  # warm
    torch.cuda.synchronize()
    da.reset_launch_counts()
    t0 = time.monotonic()
    tokens, stats = gen(model, draft, prompt[None], new)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(da.LAUNCHES)
    hist = stats["acceptance_hist"].tolist()
    rounds = sum(hist)
    if tokens.shape != (1, new):
        _fail(f"speculative: tokens of shape {tuple(tokens.shape)}")
    if launches["decode_attention"] != cfg.num_layers * rounds:
        _fail(f"speculative: {launches} for {rounds} verify rounds")
    return {
        "target": "TinyLlama-1.1B widths, 22 layers, random bf16 weights",
        "draft": {f: getattr(draft_cfg, f) for f in
                  ("num_layers", "hidden_dim", "num_heads", "mlp_width")},
        "k": k, "prompt_len": int(len(prompt)), "new_tokens": new,
        "acceptance_hist": hist, "rounds": rounds,
        "mean_tokens_per_round": new / max(1, rounds),
        "wall_s": wall, "tokens_per_s": new / wall, "launches": launches,
    }


def dense_serving_phase(ContinuousBatcher, da, model, cfg, prompts) -> dict:
    """The dense engine (`paged=False`) at TinyLlama width, bf16: 8 slots,
    cache_len 2048, the serving phase's 8 prompts, 32 new tokens each.
    Checks every request, K7 launches (its per-row arm), no paged kernel,
    and one request alone on a fresh engine giving the same tokens."""
    new = 32
    kw = dict(slots=8, cache_len=2048, paged=False)
    engine = ContinuousBatcher(cfg, model, **kw)
    engine.warm()
    torch.cuda.synchronize()
    da.reset_launch_counts()
    d0 = engine.obs.dispatches.value()
    t0 = time.monotonic()
    rids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    out = engine.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(da.LAUNCHES)
    dispatches = int(engine.obs.dispatches.value() - d0)
    if any(len(out[r]) != new for r in rids):
        _fail("dense engine: a request came back short")
    if launches["decode_attention"] <= 0 or launches["paged_attention"] or launches["qkv_rope"]:
        _fail(f"dense engine launched {launches}")
    alone = ContinuousBatcher(cfg, model, **kw)
    rid = alone.submit(prompts[4], max_new_tokens=new)
    if alone.run()[rid] != out[rids[4]]:
        _fail("dense engine: the request alone gave other tokens than in the batch")
    return {
        "slots": 8, "cache_len": 2048, "requests": len(rids),
        "new_tokens_each": new, "wall_s": wall,
        "decode_tokens_per_s": new * len(rids) / wall,
        "dispatches": dispatches, "launches": launches,
        "alone_equals_batched": True, "kv": engine.kv_stats(),
        "occupancy": engine.occupancy(),
    }


def exactness_phase(ContinuousBatcher, make_generate_fn, spec_mod, lm_mod, da,
                    cfg, prompts, seed: int) -> dict:
    """The three dense entry points at TinyLlama width, 4 layers, f32
    (bf16 GEMMs of other shapes round differently): greedy tokens of
    `make_generate_fn`, the speculative generator with the target as its
    own draft, and the dense engine must be identical, request by
    request."""
    import dataclasses

    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    model = lm_mod.DecoderLM(cfg32, device="cuda", seed=seed + 5)
    new = 32
    picks = [prompts[i] for i in (1, 3, 6)]
    gen = make_generate_fn(cfg32)
    spec = spec_mod.make_speculative_generate_fn(cfg32, cfg32, k=4)
    engine = ContinuousBatcher(cfg32, model, slots=2, cache_len=1024, paged=False)
    da.reset_launch_counts()
    rids = [engine.submit(p, max_new_tokens=new) for p in picks]
    served = engine.run()
    for p, rid in zip(picks, rids):
        one = gen(model, p[None], new)[0].tolist()
        sp = spec(model, model, p[None], new)[0].tolist()
        if not one == sp == served[rid]:
            _fail(f"f32 entry points disagree on a {len(p)}-token prompt: "
                  f"generate {one}, speculative {sp}, dense engine {served[rid]}")
    torch.cuda.synchronize()
    launches = dict(da.LAUNCHES)
    if launches["decode_attention"] <= 0:
        _fail(f"f32 exactness: K7 was not launched: {launches}")
    del model, engine
    torch.cuda.empty_cache()
    return {"layers": 4, "dtype": "float32", "requests": len(picks),
            "new_tokens_each": new, "identical": True, "launches": launches}


# -- profiled windows ---------------------------------------------------------
#
# Each profiled window runs in a child process of its own (`--window NAME`,
# started by `run_window`): within one process, torch.profiler sessions that
# came after the LM serving windows' sessions recorded only part of the
# device kernels (with or without TEARDOWN_CUPTI=0; the cause is not known),
# so a window's busy share could not be trusted. Each window also checks
# itself: for every sentinel kernel, the profiler must count as many device
# launches as the kernel's wrapper counted in the window (`_check_window`),
# so a window that loses kernels fails the run.


def _profiled(fn):
    """fn() under torch.profiler, between two synchronizes: (profiler,
    wall seconds, fn's result). Device activity only: the windows read
    device kernels, and host-op tracing of a 22-layer decode window
    multiplied the events (and the minutes spent aggregating them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        result = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return prof, wall, result


def _kernel_counts(rows) -> dict:
    """{kernel name<template args>: [device launches, device ms]} of a
    profile's `_device_rows`."""
    counts = {}
    for us, n, key in rows:
        c = counts.setdefault(_demangled_name(key), [0, 0.0])
        c[0] += n
        c[1] += us / 1e3
    return counts


def _check_window(rows, launches: dict, sentinels: dict) -> dict:
    """Each sentinel (launch counter, or "+"-joined counters of wrappers
    sharing one kernel -> the kernel's name up to its template arguments)
    must have launched, and the profiler must have seen exactly as many
    launches as the wrappers counted. Returns {sentinel: {"launches": n,
    "device_ms": their device time}}; rows: the profile's `_device_rows`."""
    counts = _kernel_counts(rows)
    seen = {}
    for counters, kernel in sentinels.items():
        counted = sum(launches[c] for c in counters.split("+"))
        mine = [c for name, c in counts.items() if name.split("<")[0] == kernel]
        n = sum(c[0] for c in mine)
        if n == 0 or n != counted:
            _fail(f"profiled window: {counters} counted {counted} launches, "
                  f"the profiler saw {n} of {kernel}: {counts}")
        seen[counters] = {"launches": n, "device_ms": sum(c[1] for c in mine)}
    return seen


def window_lm_serving(seed: int, quant: str | None = None) -> dict:
    """4 of the serving prompts x 32 new tokens through a warmed paged
    engine at TinyLlama-1.1B widths and WINDOW_LAYERS layers (bf16, or
    int8 KV + weights; the depth is the script's time);
    sentinels K1 and K2 (their int8 arms for int8)."""
    import dataclasses

    from walkai_nos_tpu_torch.models.lm import DecoderLM, LMConfig
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
    from walkai_nos_tpu_torch.ops import decode_attention as da

    cfg = dataclasses.replace(_tinyllama_cfg(LMConfig), num_layers=WINDOW_LAYERS)
    if quant:
        cfg = dataclasses.replace(cfg, kv_dtype=quant, w_dtype=quant)
    engine = ContinuousBatcher(cfg, DecoderLM(cfg, device="cuda", seed=seed),
                               **LM_ENGINE_KW)
    engine.warm()
    new = 32
    rids = [engine.submit(p, max_new_tokens=new)
            for p in _serving_prompts(cfg, seed)[:4]]
    da.reset_launch_counts()
    prof, wall, out = _profiled(engine.run)
    if any(len(out[r]) != new for r in rids):
        _fail("profiled window: a request came back short")
    arm = "_int8" if quant else ""
    return _profile_summary(
        prof, wall, ("int8_" if quant else "") + "profile.txt", da.LAUNCHES,
        {"paged_attention" + arm: "decode_mma_kernel",
         "qkv_rope" + arm: "qkv_mma_kernel"},
    )


def _in_ranges(events, ranges) -> list:
    """Per range (start, end) of `ranges`, sorted: the events of `events`
    that start inside it."""
    starts = sorted(e.time_range.start for e in events)
    return [bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
            for a, b in ranges]


def window_loop_serving(seed: int) -> dict:
    """4 of the serving prompts x LOOP_WINDOW_NEW new tokens through a warmed
    paged engine with `loop_steps` 4 at TinyLlama-1.1B widths and
    WINDOW_LAYERS layers, CPU and CUDA activity, each
    `_step_loop` under a profiler range "fold". The profiler must see as
    many K1 and K2 launches as the wrappers counted (at capture) and the
    folds added at each replay; and inside each fold's range exactly one
    graph launch (`cudaGraphLaunch`), one host->device copy (the table and
    exit inputs), one device->host copy (the outputs), one stream
    synchronize and no kernel launched from the host (a copy counted at
    the host call that issued it). Reports the
    device-busy share of the window and of the folds' ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from walkai_nos_tpu_torch.models.lm import DecoderLM, LMConfig
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
    from walkai_nos_tpu_torch.ops import decode_attention as da
    import dataclasses

    cfg = dataclasses.replace(_tinyllama_cfg(LMConfig), num_layers=WINDOW_LAYERS)
    engine = ContinuousBatcher(cfg, DecoderLM(cfg, device="cuda", seed=seed),
                               loop_steps=LOOP_STEPS, **LM_ENGINE_KW)
    engine.warm()
    rids = [engine.submit(p, max_new_tokens=LOOP_WINDOW_NEW)
            for p in _serving_prompts(cfg, seed)[:4]]
    step_loop = engine._step_loop
    captured = []  # per fold: whether it captured its graph (not replayed)

    def ranged():
        before = engine._loop.captures
        with record_function("fold"):
            step_loop()
        captured.append(engine._loop.captures != before)

    engine._step_loop = ranged
    folds0 = engine.loop_stats()["dispatches"]
    da.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = engine.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    engine._step_loop = step_loop
    if any(len(out[r]) != LOOP_WINDOW_NEW for r in rids):
        _fail("profiled window: a request came back short")
    summary = _profile_summary(
        prof, wall, "loop_profile.txt", da.LAUNCHES,
        {"paged_attention": "decode_mma_kernel", "qkv_rope": "qkv_mma_kernel"},
    )
    folds = engine.loop_stats()["dispatches"] - folds0
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in host if e.name == "fold")
    if len(ranges) != folds or folds < 1:
        _fail(f"profiled window: {len(ranges)} fold ranges for {folds} folds")
    # A copy is placed by the host call that issued it (the device event
    # carries that call's correlation id): the device clock, converted to
    # the host's, can put a copy's start before the range of its fold.
    issued = {e.id: e for e in host if e.id}

    def issuers(prefix):
        return [issued[e.id] for e in device
                if e.name.startswith(prefix) and e.id in issued]

    kinds = {
        "graph_launches": [e for e in host if e.name.startswith("cudaGraphLaunch")],
        "stream_syncs": [e for e in host if e.name.startswith("cudaStreamSynchronize")],
        "host_kernel_launches": [e for e in host if e.name.startswith(
            ("cudaLaunchKernel", "cuLaunchKernel"))],
        "copies_to_device": issuers("Memcpy HtoD"),
        "copies_to_host": issuers("Memcpy DtoH"),
    }
    # A fold that captures its graph first records its kernels through
    # the host; the others only replay.
    per_fold = {k: [c for c, cap in zip(_in_ranges(v, ranges), captured) if not cap]
                for k, v in kinds.items()}
    want = {k: 0 if k == "host_kernel_launches" else 1 for k in kinds}
    if not per_fold["graph_launches"]:
        _fail("profiled window: every fold captured, none only replayed")
    for k, counts in per_fold.items():
        if any(c != want[k] for c in counts):
            _fail(f"profiled window: {k} per fold {counts}, want {want[k]} each")
    fold_s = sum(b - a for a, b in ranges) / 1e6
    starts = [(e.time_range.start, e.time_range.end - e.time_range.start)
              for e in device]
    busy = sum(d for t, d in starts if any(a <= t <= b for a, b in ranges)) / 1e6
    summary.update({
        "folds": folds, "folds_capturing": sum(captured),
        "per_fold": {k: want[k] for k in kinds},
        "fold_wall_s": fold_s, "fold_device_s": busy,
        "fold_device_busy_share": busy / fold_s if fold_s else None,
    })
    return summary


def window_spec_serving(seed: int) -> dict:
    """The target as its own draft, `spec_k` 4 pinned on, `loop_steps` 4:
    4 of the serving prompts x SPEC_NEW new tokens, admission in eager
    rounds, then the spec graph's folds. The profiler must see as many K1
    and K2 launches as the wrappers counted (eager, and at capture times
    the rounds each replay ran), and as many launches of K1's combine
    kernel as K1 and K2 calls at steps k+1 counted and as verify rounds x
    layers: at this shape only a multi-step K1 call launches it (a
    one-step call's last CTA of each cell combines), so the device shows
    the verify's K1 calls apart from the draft's. WINDOW_LAYERS layers."""
    import dataclasses

    from walkai_nos_tpu_torch.models.lm import DecoderLM, LMConfig
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
    from walkai_nos_tpu_torch.ops import decode_attention as da

    cfg = dataclasses.replace(_tinyllama_cfg(LMConfig), num_layers=WINDOW_LAYERS)
    model = DecoderLM(cfg, device="cuda", seed=seed)
    engine = ContinuousBatcher(cfg, model, loop_steps=LOOP_STEPS, spec=True,
                               spec_k=SPEC_K, spec_min_accept=0.0, draft_cfg=cfg,
                               draft_params=model, **LM_ENGINE_KW)
    engine.warm()
    rids = [engine.submit(p, max_new_tokens=SPEC_NEW)
            for p in _serving_prompts(cfg, seed)[:4]]
    folds0 = engine.loop_stats()["dispatches"]
    rounds0 = engine.obs.spec_verify.value()
    da.reset_launch_counts()
    prof, wall, out = _profiled(engine.run)
    if any(len(out[r]) != SPEC_NEW for r in rids):
        _fail("profiled window: a request came back short")
    summary = _profile_summary(
        prof, wall, "spec_profile.txt", da.LAUNCHES,
        {"paged_attention": "decode_mma_kernel", "qkv_rope": "qkv_mma_kernel"},
    )
    rounds = int(engine.obs.spec_verify.value() - rounds0)
    folds = engine.loop_stats()["dispatches"] - folds0
    counts = _kernel_counts(_device_rows(prof.key_averages()))
    combine = sum(c[0] for name, c in counts.items()
                  if name.split("<")[0] == "decode_combine_kernel")
    verify = {name: da.LAUNCHES_AT_STEPS.get((name, SPEC_K + 1), 0)
              for name in ("paged_attention", "qkv_rope")}
    want = rounds * cfg.num_layers
    if rounds < 1 or SPEC_K not in engine._loop._graphs or not engine._spec_on:
        _fail(f"profiled window: {rounds} verify rounds, spec graphs for k in "
              f"{sorted(engine._loop._graphs)}, drafting on {engine._spec_on}")
    if folds < 1 or not (combine == want and all(n == want for n in verify.values())):
        _fail(f"profiled window: {folds} folds; {rounds} verify rounds x "
              f"{cfg.num_layers} layers = {want}; K1's combine kernel seen "
              f"{combine} times, steps-{SPEC_K + 1} calls counted {verify}")
    summary.update({"folds": folds, "verify_rounds": rounds,
                    "verify_launches_counted": verify,
                    "k1_combine_launches_seen": combine})
    return summary


def window_generate(seed: int) -> dict:
    """One `make_generate_fn` run of the generate phase's 8 prompts
    (GENERATE_WINDOW_NEW new tokens, chunks of 16) at WINDOW_LAYERS layers
    after a warm-up; sentinel K7."""
    import dataclasses

    from walkai_nos_tpu_torch.models.decode import make_generate_fn
    from walkai_nos_tpu_torch.models.lm import DecoderLM, LMConfig
    from walkai_nos_tpu_torch.ops import decode_attention as da

    cfg = dataclasses.replace(_tinyllama_cfg(LMConfig), num_layers=WINDOW_LAYERS)
    model = DecoderLM(cfg, device="cuda", seed=seed)
    prompts = _generate_prompts(cfg, seed)
    gen = make_generate_fn(cfg, tokens_per_dispatch=GENERATE_CHUNK)
    gen(model, prompts[:, :16], 2)
    da.reset_launch_counts()
    prof, wall, _ = _profiled(lambda: gen(model, prompts, GENERATE_WINDOW_NEW))
    return _profile_summary(prof, wall, "generate_profile.txt", da.LAUNCHES,
                            {"decode_attention": "decode_mma_kernel"})


def window_decode_launches(seed: int) -> dict:
    """Device kernels per K1 / K7 / K2 call: for K1 and K7, 1 where the
    cell's last CTA combines (a one-step call, at most 512 outputs a
    cell), 2 where a second kernel does (a multi-step call); for K2 (bf16
    and int8 weights, steps 1 and 8) always 1, its heads' last CTAs
    adding the splits. Three calls of each case at the serving and
    generate shapes between ~1 ms spin kernels, which are left out of the
    count and keep the calls away from the edges of the recording (where
    the profiler was seen to drop a launch); the profiler must see each
    wrapper's launch count."""
    from walkai_nos_tpu_torch.models.lm import quantize_kernel as lm_quantize
    from walkai_nos_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    b, h, kvh, hd, nlog, nb = 8, 32, 4, 64, 16, 129
    table = (torch.randperm(nb - 1, generator=gen, device=dev) + 1)[
        : b * nlog].reshape(b, nlog).to(torch.int32)
    steady = torch.full((b,), 1024, device=dev, dtype=torch.int32)
    kp, vp = rnd(nb, kvh, 128, hd), rnd(nb, kvh, 128, hd)
    kq, ks = da.quantize_kv_rows(kp, "int8")
    vq, vs = da.quantize_kv_rows(vp, "int8")
    k7 = rnd(b, kvh, 1024, hd), rnd(b, kvh, 1024, hd)
    q1, q8, qv = rnd(b, h, 1, hd), rnd(b, h, 8, hd), rnd(1, h, 5, hd)
    idx = torch.tensor(1000, device=dev, dtype=torch.int32)
    dm = h * hd
    w = rnd(dm, dm + 2 * kvh * hd) * 0.02
    wq, wsc = lm_quantize(w)
    xs = {1: rnd(b, 1, dm), 8: rnd(b, 8, dm)}

    def k2(steps, int8):
        return lambda: da.qkv_rope_projection(
            xs[steps], wq if int8 else w, None, steady, num_heads=h,
            kv_heads=kvh, rope_theta=10000.0, w_scale=wsc if int8 else None)

    mma = "decode_mma_kernel"
    cases = {  # name: (call, launch counter, device kernels a call, kernel)
        "paged_attention steps 1": (
            lambda: da.paged_decode_attention(q1, kp, vp, table, steady),
            "paged_attention", 1, mma),
        "paged_attention steps 8": (
            lambda: da.paged_decode_attention(q8, kp, vp, table, steady),
            "paged_attention", 2, mma),
        "paged_attention_int8 steps 1": (
            lambda: da.paged_decode_attention(q1, kq, vq, table, steady,
                                              k_scales=ks, v_scales=vs),
            "paged_attention_int8", 1, mma),
        "decode_attention generate": (
            lambda: da.decode_attention(q1, *k7, idx), "decode_attention", 1,
            mma),
        "decode_attention verify": (
            lambda: da.decode_attention(qv, k7[0][:1], k7[1][:1], idx),
            "decode_attention", 2, mma),
    }
    for steps in (1, 8):
        for int8 in (False, True):
            arm = "qkv_rope_int8" if int8 else "qkv_rope"
            cases[f"{arm} steps {steps}"] = (k2(steps, int8), arm, 1,
                                             "qkv_mma_kernel")
    for call, _, _, _ in cases.values():
        call()
    torch.cuda.synchronize()
    calls = 3
    da.reset_launch_counts()
    counted = []

    def run():
        for call, counter, _, _ in cases.values():
            before = da.LAUNCHES[counter]
            torch.cuda._sleep(2_000_000)
            for _ in range(calls):
                call()
            counted.append(da.LAUNCHES[counter] - before)
        torch.cuda._sleep(2_000_000)

    prof = _profiled(run)[0]
    events = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start)
    segments, current = [], None
    for e in events:
        if "spin_kernel" in e.name:
            if current is not None:
                segments.append(current)
            current = []
        elif current is not None:
            current.append(_demangled_name(e.name).split("<")[0])
    out = {}
    for (name, (_, _, want, kernel)), seen, n in zip(cases.items(), segments,
                                                     counted):
        out[name] = {"device_kernels_per_call": len(seen) / calls,
                     "kernels": sorted(set(seen)), "wrapper_launches": n}
        if n != calls or len(seen) != want * calls or seen.count(kernel) != calls:
            _fail(f"{name}: {n} wrapper launches, device kernels {seen}; "
                  f"want {want} a call")
    if len(segments) != len(cases):
        _fail(f"decode launch window: {len(segments)} segments for {len(cases)} cases")
    return out


def run_window(name: str, seed: int) -> dict:
    """Runs profiled window `name` in a child process of its own; fails
    if the child fails. Returns the window's summary. The children write
    and reuse bytecode under the gitignored kernel build directory: the
    card's machine sets PYTHONDONTWRITEBYTECODE, so each child would
    otherwise compile the Python sources of PyTorch and the port anew
    (~8 s a child there)."""
    pycache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "walkai_nos_tpu_torch", "_kernels_build", "pycache")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--window", name,
         "--seed", str(seed)],
        capture_output=True, text=True, timeout=600,
        env={**{k: v for k, v in os.environ.items() if k != "PYTHONDONTWRITEBYTECODE"},
             "PYTHONPYCACHEPREFIX": pycache},
    )
    if proc.returncode != 0:
        _fail(f"profiled window {name} exited {proc.returncode}:\n"
              f"{proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    summary["child_process_s"] = time.monotonic() - t0
    return summary


def _device_rows(averages) -> list:
    """(device us, calls, name) of each device-side event kind (kernels,
    copies, sets) of a profile's `key_averages()`, largest first. Host ops, autograd nodes
    and annotated ranges (an optimizer step) carry the device time of the
    kernels inside them too, and are left out."""
    from torch.autograd import DeviceType

    rows = []
    for ev in averages:
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us > 0 and ev.key:
            rows.append((dev_us, ev.count, ev.key))
    return sorted(rows, reverse=True)


def _profile_summary(prof, wall: float, table_name: str, launches: dict,
                     sentinels: dict) -> dict:
    """Device-busy share of a profiled window (device kernel time over
    wall time), the kernels that took the most device time, and the
    sentinels' launches as `_check_window` holds them against the
    wrappers' counts; the full table goes to chiprun_out/<table_name>."""
    averages = prof.key_averages()
    rows = _device_rows(averages)
    busy = sum(r[0] for r in rows) / 1e6
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", table_name), "w") as f:
        f.write(averages.table(sort_by="device_time_total", row_limit=40))
    return {
        "wall_s": wall, "device_kernel_s": busy,
        "device_busy_share": busy / wall if wall else None,
        "top": [
            {"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
            for us, n, k in rows[:12]
        ],
        "sentinel_launches": _check_window(rows, launches, sentinels),
    }


# The sequence-parallel prefill leg and the block-transfer leg (TinyLlama
# width, the LM serving phase's model, 8 slots, cache_len 2048).
SP_KW = dict(LM_ENGINE_KW, sp_min_tokens=1024, sp_span=4)
SP_LONG = (1536, 1901)  # 1901 is no block multiple
SP_NEW = 32


def _sp_prompts(cfg, prompts, seed: int) -> list:
    """The sp leg's requests: two long prompts, then the six shortest
    LM serving prompts."""
    rng = np.random.default_rng(seed + 14)
    longs = [rng.integers(0, cfg.vocab_size, n) for n in SP_LONG]
    return longs + sorted(prompts, key=len)[:6]


@contextlib.contextmanager
def _lane_log(engine, serve_mod, sink: dict):
    """Records, per prefill-lane dispatch of `engine`, the request ids
    on the lane (`sink["rids"]`) and CUDA events around the lane forward
    (`sink["events"]`): their span is the lane's device time plus any
    gap the device waited on the host's launches in it."""
    prepare, run_lane = engine._prepare_lane, serve_mod.run_lane
    sink.setdefault("rids", [])
    sink.setdefault("events", [])

    def logged(*args):
        sink["rids"].append([p.req.rid for p in engine._prefilling])
        return prepare(*args)

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_lane(*args)
        end.record()
        sink["events"].append((start, end))
        return out

    engine._prepare_lane, serve_mod.run_lane = logged, timed
    try:
        yield
    finally:
        engine._prepare_lane, serve_mod.run_lane = prepare, run_lane


def _lane_ms(sink: dict) -> list:
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in sink["events"]]


def _tail_check(lm_mod, sp_mod, cap: dict) -> dict:
    """The streamed tail on one captured wide lane call's inputs (the
    dense tail's, `_captured`): bitwise equal whatever tiles past the
    rows' largest query position it visits, held to the dense tail the
    engine ran with the bf16 rule, both timed (device ms)."""
    q, k_all, v_all, idx = cap["args"]
    steps, cache_len = q.shape[2], k_all.shape[2]
    horizon = min(int(idx.max()) + steps - 1, cache_len - 1)
    got = sp_mod.streamed_cache_attention(q, k_all, v_all, idx, horizon=horizon)
    every = sp_mod.streamed_cache_attention(q, k_all, v_all, idx)
    if not torch.equal(got, every):
        _fail("streamed tail: the host horizon changed the output")
    dense = lm_mod._masked_cache_attention(q, k_all, v_all, idx)
    err, ratio = _err([got], [dense], torch.bfloat16)
    if not ratio <= 1.0:
        _fail(f"streamed tail: {err} from the dense tail, {ratio:.3g}x its tolerance")
    return {
        "shape": f"q {list(q.shape)} k {list(k_all.shape)} horizon {horizon}",
        "tiles_visited": horizon // 128 + 1, "tiles": cache_len // 128,
        "max_abs_err_vs_dense": err, "err_over_tol": ratio,
        "tol": "%g * max|dense| per row + %g" % TOL[torch.bfloat16],
        "bitwise_equal_all_tiles": True,
        "streamed_ms": _timed(lambda i: sp_mod.streamed_cache_attention(
            q, k_all, v_all, idx, horizon=horizon), 5),
        "streamed_all_tiles_ms": _timed(lambda i: sp_mod.streamed_cache_attention(
            q, k_all, v_all, idx), 5),
        "dense_ms": _timed(lambda i: lm_mod._masked_cache_attention(
            q, k_all, v_all, idx), 5),
    }


# The sp-on run's captures: lane dispatch 16 (the 1901-token prompt's
# windows 20-23 on all four rows) and decode step 160 (that prompt
# decoding at a context past 1901), each at layer 0.
SP_TAIL_AT, SP_DECODE_AT = 16, 160


def sp_serving_phase(ContinuousBatcher, lm_mod, serve_mod, sp_mod, da, model,
                     cfg, prompts, seed: int) -> dict:
    """The sequence-parallel prefill lane at TinyLlama width: two long
    prompts (1536 and 1901 tokens) and the six shortest serving prompts,
    32 new tokens each, with `sp_prefill` on and off (`sp_min_tokens`
    1024, `sp_span` 4). Greedy tokens must be equal; `sp_stats()` must
    count 2 long requests, more than 2 fanned rows and a hold. Reports
    the lane dispatches and TTFT of each long prompt. The sp-on run keeps
    one decode call's and one wide lane call's inputs (one device copy
    each): K2 and K1 checked and timed on the first, the streamed tail
    against the dense one on the second."""
    picks = _sp_prompts(cfg, prompts, seed)
    L = cfg.num_layers
    runs, lanes, dec, wide = {}, {}, {}, {}
    for on in (False, True):
        engine = ContinuousBatcher(cfg, model, sp_prefill=on, **SP_KW)
        engine.warm()
        log = {}
        caps = ((_captured(lm_mod, "fused_qkv_paged_attention", SP_DECODE_AT * L, dec),
                 _captured(lm_mod, "_masked_cache_attention", SP_TAIL_AT * L, wide,
                           steps=SP_KW["prefill_chunk"]))
                if on else (contextlib.nullcontext(), contextlib.nullcontext()))
        with _lane_log(engine, serve_mod, log), caps[0], caps[1]:
            runs[on] = run = _serve_timed(engine, picks, SP_NEW, da)
        lane_ms = _lane_ms(log)
        for name in ("paged_attention", "qkv_rope"):
            if run["launches"][name] <= 0:
                _fail(f"sp serving (sp {on}): {name} was not launched")
        lanes[on] = {
            "lane_dispatches": len(log["rids"]),
            "lane_span_ms": sum(lane_ms),
            "long": [{
                "tokens": len(picks[i]),
                "lane_dispatches": sum(run["rids"][i] in r for r in log["rids"]),
                "ttft_s": run["records"][run["rids"][i]]["ttft_s"],
            } for i in range(len(SP_LONG))],
            "sp_stats": engine.sp_stats(),
        }
        del engine
    tokens = {on: [r["records"][rid]["tokens"] for rid in r["rids"]]
              for on, r in runs.items()}
    if tokens[True] != tokens[False]:
        _fail("sp serving: sp on gave other tokens than sp off")
    st = lanes[True]["sp_stats"]
    if st["requests_total"] != 2 or st["rows_total"] <= 2 or st["holds_total"] < 1:
        _fail(f"sp serving: sp_stats {st}")
    out = {"requests": len(picks), "new_tokens_each": SP_NEW,
           "engine": {k: v for k, v in SP_KW.items()},
           "tokens_equal_sp_off": True, "tail": _tail_check(lm_mod, sp_mod, wide),
           "kernels": _path_paged_kernels(
               da, dec, f"sp serving, decode step {SP_DECODE_AT}, layer 0")}
    for on, run in runs.items():
        out["sp_on" if on else "sp_off"] = {**_public(run), **lanes[on]}
    return out


def _xfer_serve(engine, prompts, new: int, **knobs) -> list:
    rids = [engine.submit(p, max_new_tokens=new, trace_id=str(i), **_knobs(knobs, i))
            for i, p in enumerate(prompts)]
    out = engine.run()
    return [out[r] for r in rids]


def _knobs(knobs: dict, i: int) -> dict:
    return dict(knobs, seed=1000 + i) if knobs else {}


def _migrate(src, dst, prompts, new: int, cap=None, **knobs) -> dict:
    """Serves `prompts` on `src` until its first decode chunk has
    committed, ships everything (`export_resident`) to `dst`, finishes
    there; returns the tokens in prompt order and the transfer's
    figures. `src` must end empty. `cap` (lm module, sink): keep the
    inputs of `dst`'s layer-0 K2 + K1 call of its fourth decode step."""
    rids = [src.submit(p, max_new_tokens=new, trace_id=str(i), **_knobs(knobs, i))
            for i, p in enumerate(prompts)]
    while not any(len(src._requests[r].tokens) > 1 for r in rids):
        src.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    payload = src.export_resident()
    export_s = time.monotonic() - t0
    wire = json.dumps(payload)
    t0 = time.monotonic()
    landed = dst.import_resident(json.loads(wire))
    torch.cuda.synchronize()
    import_s = time.monotonic() - t0
    empty = {"draining": False, "resident_slots": 0, "prefilling": 0,
             "queued": 0, "blocks_remaining": 0}
    if src.has_work or src.drain_stats() != empty:
        _fail(f"transfer: the source kept work: {src.drain_stats()}")
    by_trace = {o["trace_id"]: o["rid"] for o in landed}
    with (_captured(cap[0], "fused_qkv_paged_attention", 3 * dst.cfg.num_layers,
                    cap[1]) if cap else contextlib.nullcontext()):
        out = dst.run()
    return {
        "tokens": [out[by_trace[str(i)]] for i in range(len(prompts))],
        "migrated": len(payload["migrate"]), "resubmitted": len(payload["resubmit"]),
        "payload_mb": len(wire) / 1e6,
        "tile_mb": sum(len(t["data"]) for t in payload["tiles"]) * 3 / 4 / 1e6,
        "export_s": export_s, "import_s": import_s,
    }


def transfer_phase(ContinuousBatcher, DecoderLM, lm_mod, da, model, cfg, prompts,
                   serve_tokens, seed: int) -> dict:
    """KV block transfer and live migration at TinyLlama width, engines A
    and B over one model (8 slots, cache_len 2048): (a) A's two full
    blocks of a prompt shipped by hash make B serve it with a 2-block
    prefix hit and A's tokens; (b) the 8 serving requests shipped from A
    after its first decode chunk finish on B with the LM serving leg's
    tokens, A empty; (c) the first four sampled at temperature 0.8 with
    fixed seeds, exact against an uninterrupted run; (d) the 8 into a
    `loop_steps` 4 engine whose fold was captured before the import; (e)
    an int8-KV pair (the first four), exact against the uninterrupted
    int8 engine; (f) a bf16 payload
    rejected whole by an int8 engine (`kv_dtype`). K2 and K1 are checked
    and timed on one decode call B made after the import in (b)."""
    import dataclasses

    from walkai_nos_tpu_torch.models.block_key import chain_hashes

    out = {}
    a = ContinuousBatcher(cfg, model, **LM_ENGINE_KW)
    b = ContinuousBatcher(cfg, model, **LM_ENGINE_KW)
    p = prompts[0]  # 300 tokens: two full shareable blocks
    want = _xfer_serve(a, [p], SP_NEW)
    blocks = a.export_blocks(chain_hashes(p))
    got = b.import_blocks(json.loads(json.dumps(blocks)))
    if got != {"imported": 2, "rejected": {}}:
        _fail(f"transfer (a): import_blocks gave {got}")
    hits0 = b.prefix_stats()["block_hits"]
    if _xfer_serve(b, [p], SP_NEW) != want or b.prefix_stats()["block_hits"] - hits0 != 2:
        _fail("transfer (a): the imported prefix did not serve A's tokens with 2 hits")
    out["a_blocks"] = {"imported": 2, "prefix_hits": 2, "tokens_equal": True,
                       "tile_mb": sum(len(t["data"]) for t in blocks["tiles"]) * 3 / 4 / 1e6}
    da.reset_launch_counts()
    dec = {}
    moved = _migrate(a, b, prompts, SP_NEW, cap=(lm_mod, dec))
    torch.cuda.synchronize()
    launches = dict(da.LAUNCHES)
    if moved.pop("tokens") != serve_tokens:
        _fail("transfer (b): migrated streams gave other tokens than LM serving")
    if not moved["migrated"] or not moved["resubmitted"]:
        _fail(f"transfer (b): want migrations and resubmits: {moved}")
    for name in ("paged_attention", "qkv_rope"):
        if launches[name] <= 0:
            _fail(f"transfer (b): {name} was not launched")
    out["b_greedy"] = {**moved, "tokens_equal": True, "launches": launches}
    out["kernels"] = _path_paged_kernels(
        da, dec, "transfer (b), the target's decode step 3 after the import, layer 0")
    sampled, four = dict(temperature=0.8), prompts[:4]
    ref = _xfer_serve(ContinuousBatcher(cfg, model, **LM_ENGINE_KW), four,
                      SP_NEW, **sampled)
    moved = _migrate(a, b, four, SP_NEW, **sampled)
    if moved.pop("tokens") != ref:
        _fail("transfer (c): a migrated sampled stream left its draws")
    out["c_sampled"] = {**moved, "tokens_equal": True}
    b4 = ContinuousBatcher(cfg, model, loop_steps=4, **LM_ENGINE_KW)
    b4.warm()
    if not b4._loop.captures:
        _fail("transfer (d): warm() captured no fold")
    folds0 = b4.loop_stats()["dispatches"]
    moved = _migrate(a, b4, prompts, SP_NEW)
    if moved.pop("tokens") != serve_tokens:
        _fail("transfer (d): the folds served the imported slots other tokens")
    folds = b4.loop_stats()["dispatches"] - folds0
    if folds <= 0:
        _fail("transfer (d): no fold ran after the import")
    out["d_loop4"] = {**moved, "folds": folds, "tokens_equal": True}
    del a, b, b4
    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    model8 = DecoderLM(cfg8, device="cuda", seed=seed)
    a8 = ContinuousBatcher(cfg8, model8, **LM_ENGINE_KW)
    b8 = ContinuousBatcher(cfg8, model8, **LM_ENGINE_KW)
    ref = _xfer_serve(ContinuousBatcher(cfg8, model8, **LM_ENGINE_KW), four, SP_NEW)
    moved = _migrate(a8, b8, four, SP_NEW)
    if moved.pop("tokens") != ref:
        _fail("transfer (e): int8-KV migration gave other tokens")
    out["e_int8"] = {**moved, "tokens_equal": True}
    got = b8.import_blocks(blocks)
    if got != {"imported": 0, "rejected": {"kv_dtype": 2}}:
        _fail(f"transfer (f): a bf16 payload into int8 gave {got}")
    try:
        b8.import_resident({**blocks, "kind": "resident", "resubmit": [],
                            "migrate": [{"n_blocks": 1}]})
        _fail("transfer (f): an int8 engine took a bf16 resident payload")
    except RuntimeError as e:
        if "kv_dtype" not in str(e):
            raise
    out["f_rejected"] = {"import_blocks": got, "import_resident": "kv_dtype"}
    del a8, b8, model8
    torch.cuda.empty_cache()
    return out


# The capture leg (TinyLlama width, WINDOW_LAYERS layers, bf16): the serving prompts,
# four greedy and four sampled, then prompts 0 and 7 again (prefix hits),
# captured through a small ring and replayed on fresh engines.
CAPTURE_NEW = 32
CAPTURE_KW = dict(LM_ENGINE_KW, loop_steps=LOOP_STEPS)
CAPTURE_RING = dict(max_bytes=8192, max_files=64)  # rotates, prunes nothing
CAPTURE_SPEC_NEW = 16


def _capture_knobs(i: int) -> dict:
    """Prompts 0-3 greedy; 4-7 sampled at temperature 0.8, top_k 40, 4
    and 5 with explicit seeds, 6 and 7 with the default (the rid)."""
    if i < 4:
        return {}
    return dict(temperature=0.8, top_k=40, **({"seed": 100 + i} if i < 6 else {}))


def _capture_traffic(engine, prompts, new: int, da) -> dict:
    """The capture leg's traffic through `engine`: the 8 prompts, and once
    they drained, prompts 0 and 7 again. The launch counts are set to 0
    just before and read just after. Returns the records in submit
    order, the wall, the decode steps (slot steps over slots: a fold
    counts the steps it ran) and the launches."""
    torch.cuda.synchronize()
    da.reset_launch_counts()
    total0 = engine.obs.total_steps.value()
    t0 = time.monotonic()
    records, rids = {}, []
    for wave in (range(len(prompts)), (0, len(prompts) - 1)):
        rids += [engine.submit(prompts[i], max_new_tokens=new, **_capture_knobs(i))
                 for i in wave]
        while engine.has_work:
            engine.step()
            records.update(engine.drain_done_records())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    steps = (engine.obs.total_steps.value() - total0) / engine.slots
    for r in rids:
        if len(records[r]["tokens"]) != new:
            _fail(f"capture leg: request {r} returned {len(records[r]['tokens'])} tokens")
    ttft = sorted(records[r]["ttft_s"] for r in rids)
    return {"records": [records[r] for r in rids], "wall_s": wall,
            "decode_steps": steps, "step_ms": wall / steps * 1e3,
            "ttft_p50_s": ttft[len(ttft) // 2], "launches": dict(da.LAUNCHES)}


def _check_capture_files(log, n: int) -> dict:
    """Both packages' invariants of a finished ring: nothing dropped,
    every file behind its header, at least two rotations; `n` requests
    recorded each way."""
    stats = log.stats()
    if any(stats["dropped"].values()):
        _fail(f"capture leg: records dropped: {stats['dropped']}")
    if stats["records"] != {"submit": n, "done": n}:
        _fail(f"capture leg: records {stats['records']}, not {n} each way")
    files = log.files()
    if len(files) < 3:
        _fail(f"capture leg: the ring rotated {len(files) - 1} times, not twice")
    sizes = {}
    for path in files:
        with open(path) as f:
            lines = f.read().splitlines()
        if json.loads(lines[0]).get("kind") != "header":
            _fail(f"capture leg: {path} does not start with its header")
        for line in lines[1:]:
            kind = json.loads(line)["kind"]
            sizes.setdefault(kind, []).append(len(line) + 1)
    return {"records": stats["records"], "bytes": stats["bytes"],
            "files": len(files), "dropped": stats["dropped"],
            "submit_record_bytes": [min(sizes["submit"]), max(sizes["submit"])],
            "done_record_bytes": [min(sizes["done"]), max(sizes["done"])]}


def _replayed(replay_mod, cap, engine, what: str, params, overrides=None,
              **timing) -> dict:
    """One replay of `cap` on `engine`: every digest must verify, else the
    triage verdict and its coordinates are printed and the leg fails."""
    report = replay_mod.replay_capture(cap, engine=engine, overrides=overrides,
                                       **timing)
    if not report.ok or report.n_verified != len(cap.records):
        verdict = replay_mod.triage_divergence(
            cap, report, params, overrides=overrides, device="cuda",
            flight_dir=os.path.join("chiprun_out", "flight"))
        print(json.dumps({"capture_replay_triage": {"replay": what,
                                                    "verdict": verdict}}), flush=True)
        _fail(f"capture leg: replay {what}: {report.summary()}")
    return {"wall_s": report.replay_wall_s, "verified": report.n_verified,
            "requests": report.n_requests}


def capture_replay_phase(ContinuousBatcher, lm_mod, replay_mod, capture_mod, da,
                         cfg, prompts, seed: int) -> dict:
    """The capture plane at TinyLlama-1.1B widths and WINDOW_LAYERS layers,
    on a model of its own (`obs/capture.py`, `sim/replay.py`): one uncaptured and one captured run of the leg's
    traffic on `CAPTURE_KW` engines (loop_steps 4, prefix cache on, the
    fused route: K2 + K1), the second recorded through a ring that must
    rotate and drop nothing; then replays on fresh `build_engine` engines,
    all 10 digests verified each: (a) as captured, (b) loop_steps 1, (c)
    prefix cache off, (d) original timing at speed 1, (e) "int8-sim" KV
    (a token-preserving delta by `classify_config_delta`); a negative
    control against weights from another seed (every request diverges,
    triage says config_dependent, the bundle reads back); and in f32 at
    4 layers a capture with spec on (self draft) replayed spec off and
    spec on with a random draft. K2 and K1 are checked and timed on one
    decode call of replay (b)."""
    import dataclasses
    import tempfile

    # WINDOW_LAYERS layers: the script's time.
    cfg = dataclasses.replace(cfg, num_layers=WINDOW_LAYERS)
    model = lm_mod.DecoderLM(cfg, device="cuda", seed=seed)
    out = {"requests": len(prompts) + 2, "new_tokens_each": CAPTURE_NEW,
           "layers": cfg.num_layers, "engine": dict(CAPTURE_KW)}
    plain = ContinuousBatcher(cfg, model, **CAPTURE_KW)
    plain.warm()
    out["uncaptured"] = _public(_capture_traffic(plain, prompts, CAPTURE_NEW, da))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    plain.config_fingerprint()
    out["fingerprint_s"] = time.monotonic() - t0
    del plain
    os.makedirs("chip_smoke_work", exist_ok=True)
    work = tempfile.mkdtemp(prefix="capture-", dir=os.path.abspath("chip_smoke_work"))
    try:
        log = capture_mod.CaptureLog(os.path.join(work, "ring"), **CAPTURE_RING)
        t0 = time.monotonic()
        engine = ContinuousBatcher(cfg, model, capture=log, **CAPTURE_KW)
        out["captured_build_s"] = time.monotonic() - t0
        engine.warm()
        if engine.capture_stats()["records"] != {"submit": 0, "done": 0}:
            _fail("capture leg: warm() wrote capture records")
        run = _capture_traffic(engine, prompts, CAPTURE_NEW, da)
        out["captured"] = _public(run)
        for name in ("paged_attention", "qkv_rope"):
            if run["launches"][name] <= 0:
                _fail(f"capture leg: {name} was not launched in the captured run")
        if engine.prefix_stats()["block_hits"] < 4:
            _fail(f"capture leg: prefix hits {engine.prefix_stats()}")
        fp = engine.config_fingerprint()
        if any(r["fingerprint"] != fp["id"] for r in run["records"]):
            _fail("capture leg: a completion record lacks the fingerprint id")
        state = json.loads(json.dumps(engine.debug_state()))
        if state["capture"]["fingerprint"] != fp["id"] or state["has_work"]:
            _fail(f"capture leg: debug_state {state['capture']}")
        out["ring"] = _check_capture_files(log, len(prompts) + 2)
        out["fingerprint_id"] = fp["id"]
        del engine
        cap = replay_mod.load_capture(log.dir)
        if cap.fingerprint != fp or cap.skipped or len(cap.records) != len(prompts) + 2:
            _fail(f"capture leg: the ring loads as {len(cap.records)} records, "
                  f"{cap.skipped} skipped")
        for rec, got in zip(cap.records, run["records"]):
            if rec.tokens != got["tokens"]:
                _fail(f"capture leg: record {rec.rid} holds other tokens than served")

        replays = {}
        for what, overrides, timing in (
            ("a_as_captured", None, {}),
            ("b_loop_steps_1", {"loop_steps": 1}, {}),
            ("c_prefix_off", {"prefix_cache": False}, {}),
            ("d_original_timing", None, {"timing": "original", "speed": 1.0}),
            ("e_int8_sim_kv", {"kv_dtype": "int8-sim"}, {}),
        ):
            eng = replay_mod.build_engine(fp, model, overrides=overrides, device="cuda")
            if what == "e_int8_sim_kv":
                delta = replay_mod.classify_config_delta(fp, eng.config_fingerprint())
                if not delta["token_preserving"] or not delta["delta"]:
                    _fail(f"capture leg: int8-sim classified {delta}")
                replays["e_delta"] = delta["delta"]
            torch.cuda.synchronize()
            da.reset_launch_counts()
            kcap = {}
            with (_captured(lm_mod, "fused_qkv_paged_attention", 8 * cfg.num_layers,
                            kcap) if what == "b_loop_steps_1"
                  else contextlib.nullcontext()):
                replays[what] = _replayed(replay_mod, cap, eng, what, model,
                                          overrides, **timing)
            torch.cuda.synchronize()
            replays[what]["launches"] = {k: da.LAUNCHES[k]
                                         for k in ("paged_attention", "qkv_rope")}
            if kcap:
                out["kernels"] = _path_paged_kernels(da, kcap, "capture replay (b)")
            del eng
        out["replays"] = replays

        other = lm_mod.DecoderLM(cfg, device="cuda", seed=seed + 99)
        report = replay_mod.replay_capture(cap, other, device="cuda")
        flight = os.path.join(work, "flight")
        verdict = replay_mod.triage_divergence(cap, report, other, device="cuda",
                                               flight_dir=flight)
        del other
        if len(report.divergent) != len(cap.records) or verdict is None:
            _fail(f"capture leg: other weights diverged {len(report.divergent)} of "
                  f"{len(cap.records)} requests")
        if verdict["classification"] != "config_dependent":
            _fail(f"capture leg: negative control triaged {verdict}")
        with open(verdict["bundle_path"]) as f:
            bundle = json.load(f)
        if (bundle["trigger"] != "replay_divergence"
                or bundle["capture_fingerprint"]["id"] != fp["id"]
                or bundle["replay_fingerprint"]["weights_crc32"] == fp["weights_crc32"]
                or bundle["record"]["rid"] != verdict["rid"]
                or "debug_state" not in bundle):
            _fail("capture leg: the negative control's bundle does not read back")
        out["negative_control"] = {
            "divergent": len(report.divergent), "wall_s": report.replay_wall_s,
            "verdict": {k: verdict[k] for k in ("rid", "token_index", "expected_token",
                                                "got_token", "classification")},
            "bundle_bytes": os.path.getsize(verdict["bundle_path"]),
        }

        # Spec: exact arithmetic only (a bf16 verify rounds apart from a
        # one-step decode at near-ties, in both packages).
        cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
        m32 = lm_mod.DecoderLM(cfg32, device="cuda", seed=seed + 7)
        log32 = capture_mod.CaptureLog(os.path.join(work, "spec"))
        eng = ContinuousBatcher(cfg32, m32, capture=log32, spec=True, spec_k=SPEC_K,
                                spec_min_accept=0.0, draft_cfg=cfg32, draft_params=m32,
                                **LM_ENGINE_KW)
        spec_run = _capture_traffic(eng, prompts, CAPTURE_SPEC_NEW, da)
        stats = eng.spec_stats()
        if not stats["verify_dispatches"] or stats["drafting_disabled"]:
            _fail(f"capture leg: the spec capture ran no rounds: {stats}")
        del eng
        cap32 = replay_mod.load_capture(log32.dir)
        spec = {"layers": 4, "dtype": "float32", "spec_stats": stats,
                "new_tokens_each": CAPTURE_SPEC_NEW, "capture_wall_s": spec_run["wall_s"]}
        for what, overrides in (("spec_off", {"spec": False}),
                                ("spec_random_draft", None)):
            # Telemetry on: the random-draft replay reports its spec_stats().
            eng = replay_mod.build_engine(cap32.fingerprint, m32, overrides=overrides,
                                          device="cuda", draft_seed=seed + 5, obs=True)
            spec[what] = _replayed(replay_mod, cap32, eng, f"f32 {what}", m32, overrides)
            if overrides is None:
                spec[what]["spec_stats"] = eng.spec_stats()
            del eng
        out["spec_f32"] = spec
        del m32
    finally:
        del model
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# The fleet leg (4g): two replicas and a spare of FLEET_KW engines on one
# model (prefill_lanes 1, as the JAX traffic harness's engines: a request
# admitted behind a same-template writer finds its blocks ready, so the
# hit rate measures routing, not admission collisions); 16 requests in
# waves of FLEET_WAVES; a TTFT objective the waves' queueing breaches, so
# the reconciler (ticks: one per router step) scales up once.
FLEET_KW = dict(slots=4, cache_len=1024, prefill_chunk=64, prefill_lanes=1)
FLEET_NEW = 16
FLEET_WAVES = (8, 6, 2)
FLEET_TEMPLATES = 4
FLEET_SLO = {"ttft_p99_s": 0.01}
FLEET_POLICY = dict(min_replicas=1, max_replicas=3, breach_ticks=2,
                    idle_ticks=10_000, cooldown_ticks=4)


def _fleet_prompts(cfg, seed: int) -> list:
    """FLEET_TEMPLATES shared 128-token blocks, each request one of them
    (Zipf 1.1) plus an 8-64-token suffix."""
    rng = np.random.default_rng(seed + 4)
    bases = [rng.integers(0, cfg.vocab_size, 128) for _ in range(FLEET_TEMPLATES)]
    return [
        np.concatenate([bases[min(int(rng.zipf(1.1)), FLEET_TEMPLATES) - 1],
                        rng.integers(0, cfg.vocab_size, int(rng.integers(8, 65)))])
        .astype(np.int32)
        for _ in range(sum(FLEET_WAVES))
    ]


def _fleet_serve(router, prompts, drain=None) -> tuple[dict, list]:
    """Submits `prompts` in FLEET_WAVES, three router steps after each
    wave, then steps until the fleet is empty. `drain(router)` runs after
    the second wave's steps. Returns (records by router rid, rids in
    prompt order)."""
    records, rids, i = {}, [], 0
    for w, size in enumerate(FLEET_WAVES):
        rids += [router.submit(p, max_new_tokens=FLEET_NEW)
                 for p in prompts[i:i + size]]
        i += size
        for _ in range(3):
            router.step()
            records.update(router.drain_done_records())
        if w == 1 and drain is not None:
            drain(router)
    while router.has_work:
        router.step()
        records.update(router.drain_done_records())
    router.step()  # the reconciler retires what drained empty
    records.update(router.drain_done_records())
    return records, rids


def fleet_phase(ContinuousBatcher, lm_mod, router_mod, fed_mod, anomaly_mod, da,
                cfg, seed: int) -> dict:
    """Leg 4g: the fleet router (`router/`) over in-process replicas that
    share one model at TinyLlama-1.1B widths and WINDOW_LAYERS layers.
    An affinity `FleetRouter(seed=0)` over two replicas, with one spare
    in a `StaticSliceProvider` and a `ScalePolicy` in router ticks, serves
    the leg's 16 requests in waves: the TTFT objective's breach scales
    the fleet up once; after the second wave a migrating drain of a
    replica with resident requests scales it down (the reconciler
    retires and releases it once empty). Checked: every request's tokens
    equal a solo engine's, no request dropped or failed, one scale-up,
    the drained replica released; a round-robin fleet on the same waves
    has the lower prefix hit rate; the federated exposition carries each
    live replica's `cb_*` series under `replica` and none of the retired
    one; the merged fleet trace holds the router and each live replica,
    time-ordered, with a route event per request; an SLO-breach flight
    bundle reads back; K2 and K1 launches counted per replica (the
    wrappers' counts, read around each replica's step) add up to the
    fleet's, and K2 / K1 are held to their plain versions on one decode
    call of a replica."""
    import dataclasses
    import tempfile

    cfg = dataclasses.replace(cfg, num_layers=WINDOW_LAYERS)
    model = lm_mod.DecoderLM(cfg, device="cuda", seed=seed)
    prompts = _fleet_prompts(cfg, seed)
    per_replica = {}

    class Counted(router_mod.EngineReplica):
        """A replica whose steps add the K1 / K2 launches they make to
        its own count."""

        def step(self):
            before = dict(da.LAUNCHES)
            super().step()
            for k, n in per_replica[self.name].items():
                per_replica[self.name][k] = n + da.LAUNCHES[k] - before[k]

    def make(name: str, **kw):
        engine = ContinuousBatcher(cfg, model, **FLEET_KW, **kw)
        engine.warm()
        per_replica[name] = {"paged_attention": 0, "qkv_rope": 0}
        return Counted(engine, name=name)

    solo = make("solo")
    t0 = time.monotonic()
    rid_of = [solo.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
    out = solo.engine.run()
    solo_wall = time.monotonic() - t0
    want = [out[r] for r in rid_of]
    del solo
    os.makedirs("chip_smoke_work", exist_ok=True)
    work = tempfile.mkdtemp(prefix="fleet-", dir=os.path.abspath("chip_smoke_work"))
    try:
        replicas = [make(f"r{i}", slo_objectives=FLEET_SLO) for i in range(2)]
        spare = make("spare", slo_objectives=FLEET_SLO)
        provider = router_mod.StaticSliceProvider([spare])
        flight = anomaly_mod.FlightRecorder(work, keep=64, min_interval_s=0.0)
        router = router_mod.FleetRouter(
            replicas, seed=0, provider=provider, fleet_refresh_s=0.0,
            scale_policy=router_mod.ScalePolicy(**FLEET_POLICY), flight=flight,
        )
        drained = {}

        def drain(router):
            # The first pair's replica holding the most resident requests,
            # migrating (the admitted spare keeps serving).
            handle = max((h for h in router.active_handles() if h.name != "spare"),
                         key=lambda h: h.replica.engine.drain_stats()["resident_slots"])
            drained["name"] = handle.name
            drained["resident"] = handle.replica.engine.drain_stats()
            router.start_drain(handle, migrate=True)
            if handle.replica.has_work:
                _fail(f"fleet leg: the migrating drain left work on {handle.name}")

        cap = {}
        torch.cuda.synchronize()
        da.reset_launch_counts()
        for counts in per_replica.values():
            for k in counts:
                counts[k] = 0
        t0 = time.monotonic()
        with _captured(lm_mod, "fused_qkv_paged_attention", 12 * cfg.num_layers, cap):
            records, rids = _fleet_serve(router, prompts, drain)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(da.LAUNCHES)
        if sorted(records) != sorted(rids):
            _fail(f"fleet leg: {len(records)} records for {len(rids)} requests")
        got = [records[r]["tokens"] for r in rids]
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            _fail(f"fleet leg: requests {bad} gave other tokens than a solo engine")
        if any(router.obs.failed.value(labels) for labels in router.obs.failed.labelsets()):
            _fail("fleet leg: the router counted failed requests")
        events = router.scale_events()
        released = [r.name for r in provider.released]
        if events["up"] != 1 or released != [drained.get("name")]:
            _fail(f"fleet leg: scale events {events}, released {released}, "
                  f"drained {drained}")
        served = {}
        for rec in records.values():
            served[rec["replica"]] = served.get(rec["replica"], 0) + 1
        if served.get("spare", 0) < 1:
            _fail(f"fleet leg: the admitted spare served nothing: {served}")
        for name, counts in per_replica.items():
            if name in served and min(counts.values()) <= 0:
                _fail(f"fleet leg: replica {name} served {served[name]} requests "
                      f"with K1/K2 launches {counts}")
        total = {k: sum(c[k] for c in per_replica.values())
                 for k in ("paged_attention", "qkv_rope")}
        if total != {k: launches[k] for k in total} or launches["decode_attention"]:
            _fail(f"fleet leg: per-replica launches {per_replica} against the "
                  f"wrappers' {launches}")
        live = sorted(h.name for h in router._handles)
        text = router.federated_metrics()
        fams = fed_mod.parse_exposition(text)
        labelled = {lab.get("replica") for name, fam in fams.items()
                    if name.startswith("cb_") for _, lab, _ in fam["samples"]}
        if labelled != set(live) or "router_requests_total" not in fams:
            _fail(f"fleet leg: federated replicas {labelled}, the fleet {live}")
        merged = router.fleet_trace()
        procs = set(merged["otherData"]["processes"].values())
        evs = [e for e in merged["traceEvents"] if e.get("ph") != "M"]
        routes = {e["args"]["trace_id"] for e in evs if e["name"] == "route"}
        if (procs != {"router"} | {f"replica {n}" for n in live}
                or [e["ts"] for e in evs] != sorted(e["ts"] for e in evs)
                or not {records[r]["trace_id"] for r in rids} <= routes):
            _fail(f"fleet leg: merged trace processes {procs}, {len(routes)} routes")
        bundles = flight.bundles()
        slo_dumps = [b for b in bundles if b["trigger"] == "slo_breach"]
        if not slo_dumps or not all("debug_state" in b for b in slo_dumps):
            _fail(f"fleet leg: SLO-breach bundles {[b['trigger'] for b in bundles]}")
        affinity = {"prefix_hit_rate": router.prefix_hit_rate,
                    "stats": router.stats(), "trace_events": len(evs),
                    "flight_triggers": sorted({b["trigger"] for b in bundles})}
        del router, replicas, spare, provider
        rr_reps = [make(f"rr{i}") for i in range(2)]
        rr = router_mod.FleetRouter(rr_reps, policy="round_robin", seed=0)
        t1 = time.monotonic()
        rr_records, rr_rids = _fleet_serve(rr, prompts)
        rr_wall = time.monotonic() - t1
        if [rr_records[r]["tokens"] for r in rr_rids] != want:
            _fail("fleet leg: the round-robin fleet gave other tokens")
        if not affinity["prefix_hit_rate"] > rr.prefix_hit_rate:
            _fail(f"fleet leg: affinity hit rate {affinity['prefix_hit_rate']} "
                  f"not above round-robin's {rr.prefix_hit_rate}")
        rr_rate = rr.prefix_hit_rate
        del rr, rr_reps
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # The leg's engines are garbage now: collect them here, not inside a
    # later leg's CUDA-graph capture (which is global: a CUDA object freed
    # by the collector mid-capture invalidates it).
    gc.collect()
    stats = affinity.pop("stats")
    return {
        "layers": cfg.num_layers, "engine": dict(FLEET_KW), "waves": FLEET_WAVES,
        "requests": len(prompts), "new_tokens_each": FLEET_NEW,
        "templates": FLEET_TEMPLATES, "slo_objectives": FLEET_SLO,
        "policy": FLEET_POLICY, "wall_s": wall, "solo_wall_s": solo_wall,
        "round_robin_wall_s": rr_wall, "served_by": served,
        "scale_events": events, "drained": drained, "released": released,
        "launches": launches, "launches_per_replica": per_replica,
        **affinity, "round_robin_prefix_hit_rate": rr_rate,
        "xfer_bytes": stats["xfer_bytes"], "anomaly_flagged": stats["anomaly_flagged"],
        "kernels": _path_paged_kernels(da, cap, "fleet decode step 12"),
    }


# The demo server leg (4h): the port's HTTP serving surface on the card.
SERVER_LENS = (9, 17, 24, 33, 40, 48, 56, 60)  # all within the 64-token bucket
SERVER_SHARED = 24  # prompts 0 and 1 share their first 24 tokens
SERVER_INFER = (8, 4, 4)  # client threads, requests each, images a request
SERVER_BUCKETS = (1, 8, 32)
SERVER_PROFILE_DISPATCHES = 2  # the trace holds the first dispatch's launches
SERVER_FALLBACK_LEN = 100  # + 64 new tokens overflows the 128-row engine cache
# The app's engine at its default knobs, less the fold (bitwise the eager path).
SERVER_ENGINE_KW = dict(slots=4, cache_len=128, prompt_bucket=64, chunk_steps=16,
                        prefill_lanes=4, prefill_chunk=64)


def _server_prompts(vocab: int, seed: int) -> list:
    rng = np.random.default_rng(seed + 19)
    prompts = [rng.integers(0, vocab, n).tolist() for n in SERVER_LENS]
    prompts[1][:SERVER_SHARED] = prompts[0][:SERVER_SHARED]
    return prompts


def _sse(base: str, payload: dict) -> tuple[list, float]:
    """POSTs a streaming /generate; returns (events, seconds from the
    request to the first token event)."""
    import http.client
    from urllib.parse import urlparse

    conn = http.client.HTTPConnection(urlparse(base).netloc, timeout=120)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/generate", json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            _fail(f"server leg: streaming /generate -> {resp.status}")
        events, first = [], None
        while True:
            line = resp.fp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
                if first is None and "tokens" in events[-1]:
                    first = time.perf_counter() - t0
        return events, first
    finally:
        conn.close()


def _concurrently(fn, items) -> tuple[list, float]:
    """fn(item) for every item, one thread each; (results, wall s)."""
    out, errors = [None] * len(items), []

    def run(i):
        try:
            out[i] = fn(items[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(items))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        _fail(f"server leg: client errors {errors[:3]}")
    return out, wall


def server_boot() -> dict:
    """Starts leg 4h's demo server child (`python -m
    walkai_nos_tpu_torch.app.main` at the demo's widths: YOLOS-small and,
    with `WALKAI_DEMO_LM=1`, LM_SMALL on the paged engine at the app's
    default knobs, capture armed) and returns at once: a thread waits for
    its /healthz while `server_phase` serves its in-process reference. An
    exit handler kills the child if the script ends before the leg does."""
    from walkai_nos_tpu_torch.utils import httpbench as hb

    work = os.path.abspath(os.path.join("chip_smoke_work", "server"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    pycache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "walkai_nos_tpu_torch", "_kernels_build", "pycache")
    env = {"WALKAI_DEMO_LM": "1", "WALKAI_CALIB_WINDOW_S": "0.2",
           "WALKAI_CAPTURE_DIR": os.path.join(work, "capture"),
           "PYTHONDONTWRITEBYTECODE": "", "PYTHONPYCACHEPREFIX": pycache}
    booted = {"work": work, "log_path": os.path.join(work, "server.log")}

    def boot():
        t0 = time.monotonic()
        try:
            booted["proc"], booted["base"] = hb.spawn_server(
                env, startup_timeout_s=300.0, log_path=booted["log_path"],
                poll_s=0.1)
        except Exception as e:  # noqa: BLE001 — reported by server_phase
            booted["error"] = e
        booted["startup_s"] = time.monotonic() - t0

    def reap():
        booted["thread"].join(330)
        if booted.get("proc") is not None:
            hb.kill_server(booted["proc"])

    booted["thread"] = threading.Thread(target=boot, daemon=True)
    booted["thread"].start()
    atexit.register(reap)
    return booted


def server_phase(ContinuousBatcher, lm_mod, da, router_mod, seed: int) -> dict:
    """Leg 4h: the port's demo server (`walkai_nos_tpu_torch/app/main.py`)
    in a child process on the card (`server_boot`), at the demo's widths:
    YOLOS-small behind /infer and LM_SMALL (d 512, 8 layers, 8 heads of
    64, bias, no rotary) on the paged engine with the app's default knobs
    (4 slots, prompt bucket 64, chunk 16, `loop_steps` 8, capture armed),
    weights from seed 0. While the child starts, the same-seed engine is
    served in this process (`loop_steps` 1: the fold is bitwise the eager
    path) and one of its decode calls is kept; that run only gives the
    reference tokens. Once the child is up (and idle), K2 / K1 are timed
    on the kept call. Then: concurrent /infer requests coalesce into fewer
    batches than requests and /stats counts exactly the fenced images; K3
    launches per bucket; 8 concurrent greedy /generate requests (prompts 0
    and 1 share a prefix) give the in-process engine's tokens, a streamed
    one the same tokens as its non-streamed twin, and an over-cache prompt
    the one-shot path's (MHA: the plain masked attention, as JAX routes
    it, no K7); a /debug/profile window over SERVER_PROFILE_DISPATCHES
    dispatches writes a trace holding exactly the K1 and K2 launches
    counted between its start and stop; /healthz, /metrics, /debug/state
    and /debug/slo read as they should; a `FleetRouter` over one
    `HttpReplica` of the child gives the same tokens with no scrape error;
    once the child is stopped, the capture downloaded after the first
    wave replays token-identically through `cmd/replay.py`. Prints
    startup seconds, /infer images/s and latency, /generate tokens/s and
    TTFT over HTTP, and the kernels' launches."""
    import urllib.request

    from walkai_nos_tpu_torch.cmd.replay import main as replay_main
    from walkai_nos_tpu_torch.models.decode import make_generate_fn
    from walkai_nos_tpu_torch.utils import httpbench as hb

    booted = server_boot()
    work, log_path = booted["work"], booted["log_path"]
    proc = None
    try:
        # The same seed's engine, in this process.
        cfg = lm_mod.LM_SMALL
        model = lm_mod.DecoderLM(cfg, device="cuda", seed=0)
        prompts = _server_prompts(cfg.vocab_size, seed)
        engine = ContinuousBatcher(cfg, model, **SERVER_ENGINE_KW)
        cap = {}
        with _captured(lm_mod, "fused_qkv_paged_attention", 12 * cfg.num_layers, cap):
            rids = [engine.submit(p, max_new_tokens=64) for p in prompts]
            ref = engine.run()
        want = [ref[r] for r in rids]
        rng = np.random.default_rng(seed + 23)
        long_prompt = rng.integers(0, cfg.vocab_size, SERVER_FALLBACK_LEN).tolist()
        want_long = make_generate_fn(cfg)(model, np.asarray([long_prompt], np.int32),
                                          max_new_tokens=64).cpu()[0].tolist()
        del engine
        t0 = time.monotonic()
        booted["thread"].join(330)
        waited_s = time.monotonic() - t0
        if "error" in booted or "base" not in booted:
            _fail(f"server leg: the server did not start: {booted.get('error')}")
        proc, base = booted["proc"], booted["base"]
        kernels = _path_paged_kernels(da, cap, "server reference decode step 12")
        del cap

        def launches():
            return hb.get_json(f"{base}/debug/kernels", timeout=30)["launches"]

        def stats():
            return hb.get_json(f"{base}/stats", timeout=30)

        # /infer: client threads with keep-alive connections.
        streams, per, batch = SERVER_INFER
        s0, k0 = stats(), launches()

        def infer_stream(_):
            client = hb.InferClient(base, timeout=120)
            lat = []
            try:
                for _ in range(per):
                    t0 = time.perf_counter()
                    client.post_infer(batch)
                    lat.append(time.perf_counter() - t0)
            finally:
                client.close()
            return lat

        lats, infer_wall = _concurrently(infer_stream, list(range(streams)))
        s1, k1 = stats(), launches()
        lat = sorted(x for stream in lats for x in stream)
        n_req, n_img = streams * per, streams * per * batch
        d_img, d_req = s1["images"] - s0["images"], s1["requests"] - s0["requests"]
        d_batches = s1["batches"] - s0["batches"]
        if (d_img, d_req) != (n_img, n_req) or not 0 < d_batches < n_req:
            _fail(f"server leg: /stats counted {d_img} images, {d_req} requests in "
                  f"{d_batches} batches for {n_req} requests of {batch}")
        per_bucket = {}
        for b in SERVER_BUCKETS:
            before = launches()["packed_attention"]
            out = hb.post_infer(base, b, timeout=120)
            per_bucket[b] = launches()["packed_attention"] - before
            if out["batched_with"] != b:
                _fail(f"server leg: a lone /infer of {b} batched with {out['batched_with']}")
        k3 = launches()["packed_attention"] - k0["packed_attention"]
        if set(per_bucket.values()) != {12} or k1["packed_attention"] - k0[
                "packed_attention"] != 12 * d_batches:
            _fail(f"server leg: K3 launches per bucket {per_bucket}, "
                  f"{k1['packed_attention'] - k0['packed_attention']} for {d_batches} batches")
        infer = {"requests": n_req, "images": n_img, "batches": d_batches,
                 "padded_images": s1["padded_images"] - s0["padded_images"],
                 "images_per_s": n_img / infer_wall, "wall_s": infer_wall,
                 "p50_s": lat[len(lat) // 2], "p99_s": lat[min(len(lat) - 1,
                                                              int(0.99 * len(lat)))],
                 "k3_per_bucket": per_bucket, "k3_launches": k3,
                 "model_ceiling_images_per_s": s1["model_ceiling_images_per_s"],
                 "fence_rtt_s": s1["fence_rtt_s"]}

        # /generate: 8 concurrent greedy requests, one streamed, one over the
        # engine's cache (the one-shot path).
        g0 = launches()
        outs, gen_wall = _concurrently(
            lambda p: hb.post_json(f"{base}/generate", {"prompt": p}, timeout=120),
            prompts)
        got = [o["tokens"] for o in outs]
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            _fail(f"server leg: /generate requests {bad} gave other tokens than the "
                  f"in-process engine")
        if not all(o["batched"] and o["fingerprint"] for o in outs):
            _fail("server leg: a /generate response not batched or without fingerprint")
        g1 = launches()
        events, sse_first_s = _sse(base, {"prompt": prompts[0], "stream": True})
        streamed = [t for e in events if "tokens" in e for t in e["tokens"]]
        if streamed != got[0] or events[-1].get("n_tokens") != 64:
            _fail(f"server leg: the streamed tokens differ from the non-streamed "
                  f"({len(streamed)} tokens, last event {events[-1]})")
        k7_0 = launches()["decode_attention"]
        long_out = hb.post_json(f"{base}/generate", {"prompt": long_prompt}, timeout=120)
        k7 = launches()["decode_attention"] - k7_0
        # LM_SMALL is MHA without `decode_kernel`: its dense cache takes the
        # plain masked attention, as JAX's takes XLA's, and K7 stays idle.
        if long_out["tokens"] != want_long or "batched" in long_out or k7 != 0:
            _fail(f"server leg: the one-shot path gave other tokens or launched "
                  f"{k7} K7")
        # The capture of that traffic, replayed once the child is stopped.
        with urllib.request.urlopen(f"{base}/debug/capture/download", timeout=60) as resp:
            blob = resp.read()
        cap_path = os.path.join(work, "capture-download.jsonl")
        with open(cap_path, "wb") as f:
            f.write(blob)
        generate, profile, path_launches = _server_checks(
            base, hb, router_mod, prompts, want, outs, got, gen_wall,
            sse_first_s, events, k7, g0, g1, work)
    finally:
        booted["thread"].join(330)
        if proc is None:
            proc = booted.get("proc")
        if proc is not None:
            hb.kill_server(proc)
        os.makedirs("chiprun_out", exist_ok=True)
        if os.path.exists(log_path):
            shutil.copy(log_path, os.path.join("chiprun_out", "server.log"))
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):  # the CLI's summary line
        rc = replay_main([cap_path, "--init-seed", "0", "--json",
                          "--flight-dir", os.path.join(work, "flight")])
    replay_s = time.monotonic() - t0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or summary["divergent"] != 0:
        _fail(f"server leg: the downloaded capture did not replay: {summary}")
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return {
        "model": {"vit": "YOLOS-small (VIT_SMALL)", "lm": "LM_SMALL", "layers": cfg.num_layers},
        "startup_s": booted["startup_s"], "startup_waited_s": waited_s,
        "infer": infer, "generate": generate, "profile": profile,
        "router_tokens_equal": True,
        "capture": {"bytes": len(blob), "replay_s": replay_s, "summary": summary},
        "launches": {**path_launches, "decode_attention": k7,
                     "packed_attention": k3},
        "kernels": kernels,
    }


def _server_checks(base, hb, router_mod, prompts, want, outs, got, gen_wall,
                   sse_first_s, events, k7, g0, g1, work):
    """The server leg after its first /generate wave: the wave's figures,
    the profile window, the read endpoints and the router over an
    `HttpReplica`. Returns (generate, profile, K1 / K2 launches of the
    leg's /generate traffic)."""
    import urllib.request

    def launches():
        return hb.get_json(f"{base}/debug/kernels", timeout=30)["launches"]

    def stats():
        return hb.get_json(f"{base}/stats", timeout=30)

    ttft = sorted(o["ttft_seconds"] for o in outs)
    generate = {
        "requests": len(prompts), "new_tokens_each": 64,
        "tokens_per_s": sum(len(t) for t in got) / gen_wall, "wall_s": gen_wall,
        "ttft_engine_p50_s": ttft[len(ttft) // 2], "ttft_engine_max_s": ttft[-1],
        "http_s": sorted(o["generate_time_seconds"] for o in outs),
        "sse_first_token_s": sse_first_s, "sse_events": len(events),
        "k1_k2_first_wave": {k: g1[k] - g0[k] for k in ("paged_attention", "qkv_rope")},
        "k7_one_shot": k7,
    }

    # A profile window over the next dispatches.
    prof_dir = os.path.join(work, "profile")
    armed = hb.post_json(f"{base}/debug/profile",
                         {"dispatches": SERVER_PROFILE_DISPATCHES,
                          "logdir": prof_dir}, timeout=30)
    if armed["remaining_dispatches"] != SERVER_PROFILE_DISPATCHES:
        _fail(f"server leg: /debug/profile armed {armed}")
    outs, _ = _concurrently(
        lambda p: hb.post_json(f"{base}/generate", {"prompt": p}, timeout=120),
        prompts[:4])
    if [o["tokens"] for o in outs] != want[:4]:
        _fail("server leg: the profiled requests gave other tokens")
    deadline = time.monotonic() + 60
    while True:
        status = hb.get_json(f"{base}/debug/profile", timeout=30)
        if status["completed_windows"] >= 1 or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    window = hb.get_json(f"{base}/debug/kernels", timeout=30)["profile_window"]
    path = status["last_trace"]
    if (status["completed_windows"] != 1 or status["last_error"] is not None
            or not path or not os.path.exists(path) or window is None
            or window["decode_attention"]):
        _fail(f"server leg: profile status {status}, window {window}")
    trace_bytes = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rows = [(e.get("dur", 0), 1, e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]
    seen = _check_window(rows, window, {"paged_attention": "decode_mma_kernel",
                                        "qkv_rope": "qkv_mma_kernel"})
    del events, rows
    profile = {"dispatches": SERVER_PROFILE_DISPATCHES, "trace_bytes": trace_bytes,
               "sentinel_launches": seen,
               "window_launches": {k: window[k] for k in ("paged_attention",
                                                          "qkv_rope")}}

    # The read endpoints.
    health = hb.get_json(f"{base}/healthz", timeout=30)
    eng = health["engine"]
    if not (health["ok"] and isinstance(health["monotonic_s"], float)
            and eng["alive"] and eng["slots"] == 4 and not eng["has_work"]):
        _fail(f"server leg: /healthz {health}")
    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
        text = resp.read().decode()
    bad = [ln for ln in text.splitlines()
           if ln and not ln.startswith("#") and not PROM_SAMPLE.match(ln)]
    if bad or "# TYPE cb_requests_submitted_total counter" not in text:
        _fail(f"server leg: /metrics lines {bad[:3]}")
    state = hb.get_json(f"{base}/debug/state", timeout=30)["engine"]
    pool = state["pool"]
    if (pool["free"] + pool["parked"] + pool["in_use"]
            != pool["blocks_total"] - pool["scratch_blocks"]
            or state["tp"]["tp_devices"] != 1 or not state["attrib"]["kinds"]):
        _fail(f"server leg: /debug/state pool {pool}, tp {state['tp']}")
    slo = hb.get_json(f"{base}/debug/slo", timeout=30)["engine"]
    if set(slo["windows"]) != {"ttft", "tpot", "dispatch"}:
        _fail(f"server leg: /debug/slo {slo}")
    final = stats()
    if (final["device_kind"] != torch.cuda.get_device_name(0)
            or final["cb_tp"]["enabled"] or not final["peak_bf16_flops"]):
        _fail(f"server leg: /stats device {final['device_kind']}, cb_tp {final['cb_tp']}")

    # The fleet router over one HTTP replica of the child.
    replica = router_mod.HttpReplica(base, name="server", workers=4)
    try:
        router = router_mod.FleetRouter([replica], seed=0)
        r_ids = [router.submit(p, max_new_tokens=64) for p in prompts[:4]]
        records, deadline = {}, time.monotonic() + 120
        while len(records) < len(r_ids) and time.monotonic() < deadline:
            router.step()
            records.update(router.drain_done_records())
            time.sleep(0.005)  # remote work: the driver need not spin
        scrape = replica.scrape_error_stats()
    finally:
        replica.close()
    if [records.get(r, {}).get("tokens") for r in r_ids] != want[:4]:
        _fail("server leg: the router over HttpReplica gave other tokens")
    if any(scrape["counts"].values()):
        _fail(f"server leg: scrape errors {scrape}")
    k_end = launches()
    path_launches = {k: k_end[k] - g0[k] for k in ("paged_attention", "qkv_rope")}
    if min(path_launches.values()) <= 0:
        _fail(f"server leg: K1/K2 launches {path_launches}")

    return generate, profile, path_launches


def unfused_phase(ContinuousBatcher, DecoderLM, da, cfg, seed: int) -> dict:
    import dataclasses

    cfg4 = dataclasses.replace(cfg, num_layers=4, fused_qkv=False)
    model = DecoderLM(cfg4, device="cuda", seed=seed)
    engine = ContinuousBatcher(cfg4, model, slots=8, cache_len=2048)
    rng = np.random.default_rng(seed + 1)
    da.reset_launch_counts()
    rids = [
        engine.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=16)
        for n in (70, 300)
    ]
    out = engine.run()
    torch.cuda.synchronize()
    launches = dict(da.LAUNCHES)
    if any(len(out[r]) != 16 for r in rids):
        _fail("unfused route: a request came back short")
    if launches["paged_attention"] <= 0 or launches["qkv_rope"] != 0:
        _fail(f"unfused route launched {launches}")
    return {"requests": len(rids), "launches": launches}


# -- Multi-LoRA serving --------------------------------------------------------
#
# The paged engine armed with four synthetic adapters (`models/lora.py`; id 0
# the base model, ids 1-3 ragged ranks 1-3 in a rank-8 bucket, scale 0.5 so
# that adapters change tokens) at TinyLlama-1.1B width. An armed forward
# leaves the fused route: its decode steps and verifies run K1 without
# injection (no K2), and the deltas are stock PyTorch products.

LORA_IDS = (0, 1, 2, 3, 0, 1, 2, 3)  # the serving prompts' adapters
LORA_NEW = 32
LORA_SHORT = 16  # new tokens of the alone and KV legs (held to the prefix)


def _lora_tree(dims: dict, layers: int, rank: int, seed: int) -> dict:
    """A full adapter tree (every block and projection) of rank `rank`,
    seeded, scaled as `AdapterSet.synthetic(scale=0.5)` draws."""
    rng = np.random.default_rng(seed)
    return {
        f"block{i}": {
            proj: {"a": rng.standard_normal((din, rank), np.float32) / np.sqrt(din),
                   "b": rng.standard_normal((rank, dout), np.float32) * 0.5}
            for proj, (din, dout) in sorted(dims.items())
        }
        for i in range(layers)
    }


def _merged_llama_sd(model, tree: dict, k: int) -> dict:
    """HF-named f32 tensors of a port llama's weights with adapter k's
    deltas merged, W + A B (`tree`: an AdapterSet's host stacks), for
    `_llama_reference_logits`: plain tensor ops, nothing of the port's
    LoRA code. Port kernels are [in, out], HF Linear weights [out, in]."""
    c = model.cfg
    d, kv = c.hidden_dim, c.kv_heads * c.head_dim

    def merged(kernel, blk: str, proj: str):
        pair = tree[blk][proj]
        a = torch.from_numpy(pair["lora_a"][k]).cuda()
        b = torch.from_numpy(pair["lora_b"][k]).cuda()
        return (kernel.detach().float() + a @ b).T

    sd = {"model.embed_tokens.weight": model.embed.embedding.detach().float(),
          "model.norm.weight": model.norm.scale.detach().float(),
          "lm_head.weight": model.head.kernel.detach().float().T}
    for i, block in enumerate(model.blocks):
        p, name = f"model.layers.{i}.", f"block{i}"
        qkv = merged(block.attn.qkv.kernel, name, "qkv")
        sd.update({
            p + "input_layernorm.weight": block.norm1.scale.detach().float(),
            p + "self_attn.q_proj.weight": qkv[:d],
            p + "self_attn.k_proj.weight": qkv[d:d + kv],
            p + "self_attn.v_proj.weight": qkv[d + kv:],
            p + "self_attn.o_proj.weight": merged(block.attn.out_proj.kernel, name,
                                                  "out_proj"),
            p + "post_attention_layernorm.weight": block.norm2.scale.detach().float(),
            p + "mlp.gate_proj.weight": merged(block.gate.kernel, name, "gate"),
            p + "mlp.up_proj.weight": merged(block.fc1.kernel, name, "fc1"),
            p + "mlp.down_proj.weight": merged(block.fc2.kernel, name, "fc2"),
        })
    return sd


# A plain f32 forward against the armed engine run in f32 (the bf16
# weights converted exactly): summation order only, through the layers.
# A delta on a wrong projection or under a wrong id moves logits by O(1).
F32_REL = 1e-3


def _lora_reference_check(ContinuousBatcher, lm_mod, model, armed_kw, prompts,
                          bf16_first: dict) -> dict:
    """Check 7: request k (prompt k under adapter k, k = 0..3) on an armed
    engine run in f32 at full width, its first-token logits within F32_REL
    x max |ref| of `_llama_reference_logits` over the model's weights with
    adapter k's deltas merged, and its greedy token the reference's where
    the reference's top-2 margin exceeds that. The bf16 engine's logits
    (`bf16_first`, per k) are reported against the same reference in units
    of HF_REL x max |ref|: bf16 rounding alone, which grows with the
    deltas' size (the base model takes ~0.56 of HF_REL here, a rank-3
    adapter at scale 0.5 more than 1)."""
    import dataclasses

    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    m32 = lm_mod.DecoderLM(cfg32, device="cuda", seed=0)
    m32.load_state_dict(model.state_dict())
    kw = armed_kw()
    host = kw["adapters"].host_tree()
    engine = ContinuousBatcher(cfg32, m32, **kw)
    first, rids = {}, []
    with _first_token_logits(engine, first):
        for k in range(4):
            rids.append(engine.submit(prompts[k], max_new_tokens=1, adapter=k))
            engine.run()
    del engine, m32
    hcfg = _tinyllama_hf_config()
    hcfg.num_hidden_layers = model.cfg.num_layers
    out = {"tol": f"f32 engine: {F32_REL:g} * max|ref|; bf16 reported over "
                  f"{HF_REL:g} * max|ref|"}
    for k, rid in enumerate(rids):
        sd = _merged_llama_sd(model, host, k)
        ref = _llama_reference_logits(sd, hcfg, prompts[k])
        del sd
        top = float(ref.abs().max())
        err = float((first[rid] - ref).abs().max())
        top2 = torch.topk(ref, 2).values
        margin = float(top2[0] - top2[1])
        if not err <= F32_REL * top:
            _fail(f"lora reference: adapter {k}'s f32 first-token logits {err} from "
                  f"the merged-weight forward (tolerance {F32_REL * top})")
        if margin > F32_REL * top and int(first[rid].argmax()) != int(ref.argmax()):
            _fail(f"lora reference: adapter {k}'s f32 first token "
                  f"{int(first[rid].argmax())}, the reference's {int(ref.argmax())}")
        out[str(k)] = {
            "f32_err_over_tol": err / (F32_REL * top), "ref_top2_margin": margin,
            "bf16_err_over_hf_tol": float((bf16_first[k] - ref).abs().max())
                                    / (HF_REL * top),
        }
    torch.cuda.empty_cache()
    return out


def _path_k1(da, cap: dict, what: str) -> dict:
    """K1 without injection on the inputs of one call an armed path made
    (`_captured` on `paged_decode_attention`): against its plain version
    (per slot, the rule of q's dtype), then timed beside its plain
    version, SDPA over each slot's dense view (K/V repeated to every
    head, masked past its position) and its bound, cycling through
    ROTATE copies of the pools."""
    q, kp, vp, table, idx = cap["args"]
    kw = cap["kwargs"]
    ks, vs = kw.get("k_scales"), kw.get("v_scales")
    if ks is not None:
        _fail(f"{what}: a quantized pool; the LoRA leg checks K1's bf16 arm")
    b, h, steps, hd = q.shape
    kvh, nlog = kp.shape[1], table.shape[1]
    e, ratio = _err([da.paged_decode_attention(q, kp, vp, table, idx)],
                    [da.paged_decode_attention_reference(q, kp, vp, table, idx)],
                    q.dtype)
    if not ratio <= 1.0:
        _fail(f"{what}: K1 {e} from its plain version, {ratio:.3g}x its "
              f"per-slot tolerance")
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(ROTATE - 1)]
    gathered = [tuple(da.gather_paged_cache(t, table).repeat_interleave(h // kvh, 1)
                      for t in pair) for pair in pools]
    cap_rows = nlog * 128
    qpos = idx.long()[:, None] + torch.arange(steps, device=q.device)
    mask = (torch.arange(cap_rows, device=q.device) <= qpos[..., None])[:, None]
    vis = float(torch.clamp(qpos[:, -1] + 1, max=cap_rows).sum())
    nbytes = vis * kvh * hd * 2 * 2 + 2 * b * h * steps * hd * 2 + b * nlog * 4 + b * 4
    flops = vis * h * steps * hd * 4
    bound_ms, bound_by = _bound(nbytes, flops)
    return {
        "inputs": what, "shape": f"b{b} steps{steps} h{h} kvh{kvh} hd{hd} nlog{nlog}",
        "max_abs_err": e, "err_over_tol": ratio,
        "tol": "%g * max|plain| per slot + %g" % TOL[q.dtype],
        "ms": _timed(lambda i: da.paged_decode_attention(q, *pools[i % ROTATE], table, idx), 20),
        "plain_ms": _timed(
            lambda i: da.paged_decode_attention_reference(q, *pools[i % ROTATE], table, idx), 5),
        "library_ms": _timed(lambda i: torch.nn.functional.scaled_dot_product_attention(
            q, *gathered[i % ROTATE], attn_mask=mask), 20),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
    }


def lora_serving_phase(ContinuousBatcher, lm_mod, lora_mod, da, cfg, prompts,
                       seed: int) -> dict:
    """Multi-LoRA serving at TinyLlama-1.1B width (`WINDOW_LAYERS` = 8 of
    its 22 layers since the capture leg joined the script, bf16, 8 slots,
    cache_len 2048): the serving prompts x 32 new tokens under adapters
    LORA_IDS (the two prefix-sharing prompts under ids 0 and 3) on an armed
    engine, beside LoRA-free engines on the same weights (the spec and
    int8 legs serve requests 0-3, one per adapter; the alone and int8 legs
    LORA_SHORT new tokens, held to the batch's first LORA_SHORT). Fails, each with
    its own message, unless: (1) every request returns its budget; (2)
    every request under ids 1-3 differs from the base model's; (3) one
    request per adapter alone on a fresh armed engine repeats its tokens;
    (4) adapter-0 requests equal a LoRA-free `fused_qkv=False` engine's;
    (5) the armed engine launches no K2 and K1 exactly layers x decode
    steps; (6) no prefix hit across adapters and two within one; (7) each
    adapter's first-token logits from the armed engine run in f32 lie
    within F32_REL of a plain f32 forward over the weights with its deltas
    merged (the bf16 engine's reported against it); (8) `loop_steps` 4 gives loop 1's
    tokens, and after a hot load into id 2 (its graphs captured) a request
    under id 2 served by folds equals a fresh engine built with the new
    tree; (9) speculative rounds (k 4, the base model as draft) give the
    same tokens at loop 1 and 4, with K1 at steps 5 = verify rounds x
    layers and no K2 there; (10) int8 KV serves every budget and
    "int8-sim" KV gives the bf16 tokens. Reports tokens/s, step and folded
    step times of the armed and LoRA-free engines, the adapter-0 rows'
    agreement with the default fused LoRA-free engine on the same weights
    and `lora_stats()`; checks
    and times K1 on one armed decode call's and one verify call's
    inputs."""
    import dataclasses

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg, num_layers=WINDOW_LAYERS)
    model = lm_mod.DecoderLM(cfg, device="cuda", seed=seed)
    cfg_u = dataclasses.replace(cfg, fused_qkv=False)
    model_u = lm_mod.DecoderLM(cfg_u, device="cuda", seed=seed)
    model_u.load_state_dict(model.state_dict())
    ids = list(LORA_IDS)

    def armed_kw(**kw):
        aset = lora_mod.AdapterSet.synthetic(cfg, k=4, rank=8, seed=seed, scale=0.5)
        return dict(LM_ENGINE_KW, adapters=aset, **kw)

    def toks(run):
        return [run["records"][r]["tokens"] for r in run["rids"]]

    out = {"model": f"TinyLlama-1.1B widths, {cfg.num_layers} layers, random bf16 "
                    f"weights",
           "adapters": "AdapterSet.synthetic(k=4, rank=8, scale=0.5)",
           "ids": ids, "new_tokens_each": LORA_NEW, "seconds": {}}
    t_lap = [time.monotonic()]

    def lap(name):
        now = time.monotonic()
        out["seconds"][name] = now - t_lap[0]
        t_lap[0] = now

    # The spec and int8 legs serve requests 0-3 (one per adapter; a
    # request's tokens do not depend on the batch).
    four, four_ids = prompts[:4], ids[:4]
    # An untimed first run on an armed engine (the timed run below then
    # pays no first call of a shape): its tokens, the first-token logits
    # (check 7) and K1's inputs at decode step 48.
    first = {}
    cap = _recorded_serve(ContinuousBatcher, cfg, model, armed_kw(), prompts, LORA_NEW,
                          lm_mod, None, "lora serving", first=first,
                          capture=("paged_decode_attention", 48), ids=ids)
    tokens = [cap["records"][r]["tokens"] for r in cap["rids"]]
    lap("first_run")
    # The armed engine, timed (checks 1, 5, 6).
    engine = ContinuousBatcher(cfg, model, **armed_kw())
    engine.warm()
    armed = _serve_timed(engine, prompts, LORA_NEW, da, ids)
    if toks(armed) != tokens:
        _fail("lora serving: a second run of the same batch gave other tokens")
    launches = armed["launches"]
    want_k1 = cfg.num_layers * armed["decode_steps"]
    if (launches["qkv_rope"] or launches["decode_attention"]
            or launches["paged_attention"] != want_k1):
        _fail(f"lora serving: launches {launches}, not K1 = {cfg.num_layers} "
              f"layers x {armed['decode_steps']} decode steps and no K2 or K7")
    if engine.prefix_stats()["block_hits"]:
        _fail(f"lora serving: a prefix hit across adapters: {engine.prefix_stats()}")
    rid = engine.submit(prompts[0], max_new_tokens=LORA_NEW, adapter=ids[7])
    engine.run()
    hits = engine.prefix_stats()["block_hits"]
    if hits != 2:
        _fail(f"lora serving: {hits} prefix hits within adapter {ids[7]}, not 2")
    out["armed"] = _public(armed)
    out["prefix_hits_within_one_adapter"] = hits
    out["lora_stats"] = engine.lora_stats()
    del engine
    lap("timed_run")
    # LoRA-free engines on the same weights (checks 2, 4; the report).
    free = {}
    for route, c, m in (("unfused", cfg_u, model_u), ("fused", cfg, model)):
        e = ContinuousBatcher(c, m, **LM_ENGINE_KW)
        e.warm()
        free[route] = _serve_timed(e, prompts, LORA_NEW, da)
        del e
    fused = free["fused"]
    fused["tokens"] = toks(fused)
    lap("lora_free_engines")
    base = toks(free["unfused"])
    for i, k in enumerate(ids):
        if k == 0 and tokens[i] != base[i]:
            _fail(f"lora serving: adapter-0 request {i} differs from the LoRA-free "
                  f"fused_qkv=False engine")
        if k and tokens[i] == base[i]:
            _fail(f"lora serving: request {i} under adapter {k} gave the base tokens")
    zero = [i for i, k in enumerate(ids) if k == 0]
    same = sum(a == b for i in zero for a, b in zip(tokens[i], fused["tokens"][i]))
    out["lora_free"] = {route: _public(run) for route, run in free.items()}
    out["lora_free"]["fused"].pop("tokens")
    out["adapter0_equal_unfused_lora_free"] = True
    out["adapter0_vs_fused_lora_free"] = {
        "tokens_equal_share": same / (LORA_NEW * len(zero)),
        "divergence": _first_divergence(model, [prompts[i] for i in zero],
                                        [tokens[i] for i in zero],
                                        [fused["tokens"][i] for i in zero]),
    }
    out["reference"] = _lora_reference_check(
        ContinuousBatcher, lm_mod, model, armed_kw, prompts,
        {k: first[cap["rids"][k]] for k in range(4)})
    lap("reference_f32")
    k1_steps1 = _path_k1(da, cap, "lora serving: layer 0, decode step 48")
    del cap
    lap("k1_steps1")
    # One request per adapter alone on a fresh armed engine (check 3).
    alone = ContinuousBatcher(cfg, model, **armed_kw())
    for k in range(4):
        rid = alone.submit(prompts[k], max_new_tokens=LORA_SHORT, adapter=k)
        if alone.run()[rid] != tokens[k][:LORA_SHORT]:
            _fail(f"lora serving: request {k} alone under adapter {k} gave other "
                  f"tokens than in the batch")
    del alone
    lap("alone")
    # loop_steps 4, then a hot load into id 2 after the graphs (check 8).
    e = ContinuousBatcher(cfg, model, **armed_kw(loop_steps=LOOP_STEPS))
    e.warm()
    loop = _serve_legged(e, prompts, LORA_NEW, da, ids)
    if toks(loop) != tokens:
        _fail("lora serving: loop_steps 4 gave other tokens than loop_steps 1")
    captures = e._loop.captures
    if not captures or not loop.get("folded_steps"):
        _fail(f"lora serving: loop_steps 4 ran no fold ({loop.get('folds')} folds, "
              f"{captures} captures)")
    tree = _lora_tree(lora_mod.lora_proj_dims(cfg), cfg.num_layers, 8, seed + 31)
    e.load_adapter(2, tree, name="hot")
    folds0 = e.loop_stats()["dispatches"]
    rid = e.submit(prompts[2], max_new_tokens=LORA_NEW, adapter=2)
    hot = e.run()[rid]
    if e.loop_stats()["dispatches"] == folds0 or e._loop.captures != captures:
        _fail(f"lora serving: the reloaded adapter's request ran no fold of the "
              f"captured graphs ({e.loop_stats()}, {e._loop.captures} captures)")
    if hot == tokens[2]:
        _fail("lora serving: the hot load did not change adapter 2's tokens")
    out["armed_loop4"] = _public(loop)
    out["armed_loop4"]["lora_stats"] = e.lora_stats()
    del e
    kw = armed_kw()
    kw["adapters"].load(2, tree, name="hot")
    cold = ContinuousBatcher(cfg, model, **kw)
    rid = cold.submit(prompts[2], max_new_tokens=LORA_NEW, adapter=2)
    if cold.run()[rid] != hot:
        _fail("lora serving: after the hot load a fold gave other tokens than a "
              "fresh engine built with the new tree")
    del cold
    out["hot_load_in_fold_equals_fresh_engine"] = True
    lap("loop_and_hot_load")
    # Speculative rounds, the base model as draft, loop 1 and 4 (check 9).
    spec, cap5 = {}, {}
    for loop in (1, LOOP_STEPS):
        e = ContinuousBatcher(cfg, model, **armed_kw(
            spec=True, spec_k=SPEC_K, spec_min_accept=0.0, draft_cfg=cfg,
            draft_params=model, loop_steps=loop))
        e.warm()
        ctx = (_captured(lm_mod, "paged_decode_attention", 3 * cfg.num_layers, cap5,
                         steps=SPEC_K + 1) if loop == 1 else contextlib.nullcontext())
        with ctx:
            run = _serve_legged(e, four, LORA_NEW, da, four_ids)
        verify = {k: run["launches_at_steps"].get(f"{k} steps {SPEC_K + 1}", 0)
                  for k in ("paged_attention", "qkv_rope")}
        if (verify["qkv_rope"] or not run["verify_rounds"]
                or verify["paged_attention"] != run["verify_rounds"] * cfg.num_layers):
            _fail(f"lora spec loop {loop}: K1/K2 at steps {SPEC_K + 1} launched "
                  f"{verify}, not {run['verify_rounds']} verify rounds x "
                  f"{cfg.num_layers} layers of K1 and no K2")
        spec[f"loop{loop}"] = {**_public(run), "verify_launches": verify,
                               "spec_stats": e.spec_stats(), "tokens": toks(run)}
        del e
    if spec["loop1"]["tokens"] != spec[f"loop{LOOP_STEPS}"]["tokens"]:
        _fail("lora spec: loop_steps 4 gave other tokens than loop_steps 1")
    spec_tokens = spec["loop1"].pop("tokens")
    spec[f"loop{LOOP_STEPS}"].pop("tokens")
    spec["tokens_equal_spec_off_share"] = sum(
        a == b for t, u in zip(spec_tokens, tokens) for a, b in zip(t, u)
    ) / (LORA_NEW * len(four))
    out["spec"] = spec
    lap("spec")
    k1_steps5 = _path_k1(da, cap5, f"lora spec: layer 0, verify round 4, steps {SPEC_K + 1}")
    del cap5
    # int8 KV, and "int8-sim" KV against the bf16 tokens (check 10).
    out["kv"] = {}
    for kv in ("int8", "int8-sim"):
        c8 = dataclasses.replace(cfg, kv_dtype=kv)
        m8 = lm_mod.DecoderLM(c8, device="cuda", seed=seed)
        m8.load_state_dict(model.state_dict())
        e = ContinuousBatcher(c8, m8, **armed_kw())
        run = _serve_timed(e, four, LORA_SHORT, da, four_ids)
        got = toks(run)
        want = [t[:LORA_SHORT] for t in tokens[:4]]
        if kv == "int8":
            bad = run["launches"]["qkv_rope"] or run["launches"]["qkv_rope_int8"]
            if bad or not run["launches"]["paged_attention_int8"]:
                _fail(f"lora int8 KV launched {run['launches']}")
            if not all(0 <= t < cfg.vocab_size for seq in got for t in seq):
                _fail("lora int8 KV: a token outside the vocabulary")
            out["kv"][kv] = {"tokens_equal_bf16_share": sum(
                a == b for t, u in zip(got, want) for a, b in zip(t, u)
            ) / (LORA_SHORT * len(four)), "launches": run["launches"]}
        else:
            if got != want:
                _fail("lora int8-sim KV gave other tokens than bf16")
            out["kv"][kv] = {"tokens_equal_bf16": True}
        del e, m8
    lap("kv_int8")
    del model, model_u
    torch.cuda.empty_cache()
    k1_steps1["launches"] = launches["paged_attention"]
    k1_steps5["launches"] = spec["loop1"]["verify_launches"]["paged_attention"]
    out["kernels"] = {"paged_attention_lora": k1_steps1,
                      "paged_attention_lora_spec_verify": k1_steps5}
    return out


# -- HuggingFace import and MoE serving ---------------------------------------
#
# No `transformers` on the card's machine: the HF configs are namespaces with
# the HF attribute names and published values, the state dicts HF-named
# tensors drawn on the card from --seed. Each imported model's first-token
# logits are held against a plain f32 forward written from HF's own model
# definition over the HF-named tensors (`_llama_reference_logits`,
# `_gpt2_reference_logits`), which uses nothing of the port.

# Engine logits against the f32 reference: per prompt, max |engine - ref|
# <= HF_REL * max |ref|. The engine runs bf16 (every projection and the
# residual rounded to bf16, 2**-9 relative a rounding, through 22 or 12
# layers) and the reference f32; a few percent of the largest logit.
HF_REL = 5e-2


def _tinyllama_hf_config():
    """TinyLlama-1.1B's published config under `LlamaConfig`'s names."""
    return types.SimpleNamespace(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
        max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=10000.0,
        hidden_act="silu", rope_scaling=None, attention_bias=False,
        mlp_bias=False, tie_word_embeddings=False,
    )


def _gpt2_small_hf_config():
    """GPT-2 small's published config under `GPT2Config`'s names."""
    return types.SimpleNamespace(
        vocab_size=50257, n_embd=768, n_layer=12, n_head=12,
        n_positions=1024, layer_norm_epsilon=1e-5,
        activation_function="gelu_new", n_inner=None,
        tie_word_embeddings=True,
    )


def _llama_shapes(c) -> dict:
    hid, inter = c.hidden_size, c.intermediate_size
    kv = c.num_key_value_heads * hid // c.num_attention_heads
    shapes = {"model.embed_tokens.weight": (c.vocab_size, hid),
              "model.norm.weight": (hid,),
              "lm_head.weight": (c.vocab_size, hid)}
    for i in range(c.num_hidden_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (hid,),
            p + "self_attn.q_proj.weight": (hid, hid),
            p + "self_attn.k_proj.weight": (kv, hid),
            p + "self_attn.v_proj.weight": (kv, hid),
            p + "self_attn.o_proj.weight": (hid, hid),
            p + "post_attention_layernorm.weight": (hid,),
            p + "mlp.gate_proj.weight": (inter, hid),
            p + "mlp.up_proj.weight": (inter, hid),
            p + "mlp.down_proj.weight": (hid, inter),
        })
    return shapes


def _gpt2_shapes(c) -> dict:
    hid = c.n_embd
    inner = c.n_inner or 4 * hid
    shapes = {"transformer.wte.weight": (c.vocab_size, hid),
              "transformer.wpe.weight": (c.n_positions, hid),
              "transformer.ln_f.weight": (hid,), "transformer.ln_f.bias": (hid,)}
    for i in range(c.n_layer):
        p = f"transformer.h.{i}."
        for name, shape in (
            ("ln_1", (hid,)), ("attn.c_attn", (hid, 3 * hid)),
            ("attn.c_proj", (hid, hid)), ("ln_2", (hid,)),
            ("mlp.c_fc", (hid, inner)), ("mlp.c_proj", (inner, hid)),
        ):  # Conv1D weights are [in, out]
            shapes[p + name + ".weight"] = shape
            shapes[p + name + ".bias"] = (shape[-1],)
    return shapes


def _hf_state_dict(shapes: dict, seed: int) -> dict:
    """HF-named f32 tensors drawn on the card: normal(0, 0.02), plus 1 for
    the norms' weights."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=gen, device="cuda") * 0.02
        if len(shape) == 1 and name.endswith(".weight"):
            t += 1.0
        sd[name] = t
    return sd


def _causal_softmax(q, k):
    """softmax(q k^T / sqrt(d)) with the causal mask, [heads, T, T]."""
    t = q.shape[1]
    s = (q @ k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    mask = torch.ones(t, t, device=q.device, dtype=torch.bool).tril()
    return s.masked_fill(~mask, float("-inf")).softmax(-1)


@torch.no_grad()
def _llama_reference_logits(sd, c, tokens) -> torch.Tensor:
    """Last-position f32 logits of HF's LlamaForCausalLM, written out
    from its definition: RMSNorm, q/k/v/o `Linear` [out, in], rotary by
    `rotate_half` over cos/sin of position x inv_freq, `repeat_kv`,
    causal softmax attention, SwiGLU, untied head."""
    t, hid = len(tokens), c.hidden_size
    nh, nkv = c.num_attention_heads, c.num_key_value_heads
    hd = hid // nh
    dev = "cuda"
    x = sd["model.embed_tokens.weight"][torch.as_tensor(tokens, device=dev).long()]
    inv_freq = 1.0 / (c.rope_theta ** (
        torch.arange(0, hd, 2, device=dev).float() / hd))
    freqs = torch.outer(torch.arange(t, device=dev).float(), inv_freq)
    emb = torch.cat([freqs, freqs], -1)
    cos, sin = emb.cos(), emb.sin()

    def rotate_half(u):
        return torch.cat([-u[..., hd // 2:], u[..., :hd // 2]], -1)

    def rms(u, w):
        return w * (u * torch.rsqrt(u.pow(2).mean(-1, keepdim=True) + c.rms_norm_eps))

    def heads(u, n):
        return u.view(t, n, hd).transpose(0, 1)

    for i in range(c.num_hidden_layers):
        p = f"model.layers.{i}."
        h = rms(x, sd[p + "input_layernorm.weight"])
        q = heads(h @ sd[p + "self_attn.q_proj.weight"].T, nh)
        k = heads(h @ sd[p + "self_attn.k_proj.weight"].T, nkv)
        v = heads(h @ sd[p + "self_attn.v_proj.weight"].T, nkv)
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
        k = k.repeat_interleave(nh // nkv, 0)  # repeat_kv
        v = v.repeat_interleave(nh // nkv, 0)
        o = (_causal_softmax(q, k) @ v).transpose(0, 1).reshape(t, hid)
        x = x + o @ sd[p + "self_attn.o_proj.weight"].T
        h = rms(x, sd[p + "post_attention_layernorm.weight"])
        g = h @ sd[p + "mlp.gate_proj.weight"].T
        up = h @ sd[p + "mlp.up_proj.weight"].T
        x = x + (g * torch.sigmoid(g) * up) @ sd[p + "mlp.down_proj.weight"].T
    return (rms(x[-1], sd["model.norm.weight"]) @ sd["lm_head.weight"].T).float()


@torch.no_grad()
def _gpt2_reference_logits(sd, c, tokens) -> torch.Tensor:
    """Last-position f32 logits of HF's GPT2LMHeadModel, written out from
    its definition: learned positions, pre-LN blocks, Conv1D x @ W + b,
    fused c_attn split q | k | v, causal softmax attention, gelu_new
    (tanh), the head tied to wte."""
    t, hid, nh = len(tokens), c.n_embd, c.n_head
    hd = hid // nh

    def w(name):
        return sd["transformer." + name]

    def ln(u, name):
        return torch.nn.functional.layer_norm(
            u, (hid,), w(name + ".weight"), w(name + ".bias"), c.layer_norm_epsilon)

    def conv1d(u, name):
        return u @ w(name + ".weight") + w(name + ".bias")

    def gelu_new(u):
        return 0.5 * u * (1.0 + torch.tanh(
            math.sqrt(2.0 / math.pi) * (u + 0.044715 * u.pow(3))))

    ids = torch.as_tensor(tokens, device="cuda").long()
    x = w("wte.weight")[ids] + w("wpe.weight")[:t]
    for i in range(c.n_layer):
        p = f"h.{i}."
        qkv = conv1d(ln(x, p + "ln_1"), p + "attn.c_attn")
        q, k, v = (u.view(t, nh, hd).transpose(0, 1) for u in qkv.split(hid, -1))
        o = (_causal_softmax(q, k) @ v).transpose(0, 1).reshape(t, hid)
        x = x + conv1d(o, p + "attn.c_proj")
        x = x + conv1d(gelu_new(conv1d(ln(x, p + "ln_2"), p + "mlp.c_fc")),
                       p + "mlp.c_proj")
    return (ln(x[-1], "ln_f") @ w("wte.weight").T).float()


def _hold_to_reference(first: dict, records: dict, rids, prompts, reference) -> dict:
    """Each request's first-token logits from the engine against the
    reference forward: within HF_REL x max |ref|, and the greedy first
    token the reference's argmax wherever its top-2 margin exceeds that
    tolerance."""
    errs, margins, checked = [], [], 0
    for rid, prompt in zip(rids, prompts):
        ref = reference(prompt)
        got = first[rid]
        tol = HF_REL * float(ref.abs().max())
        err = float((got - ref).abs().max())
        top2 = torch.topk(ref, 2).values
        margin = float(top2[0] - top2[1])
        errs.append(err / tol)
        margins.append(margin)
        if not err <= tol:
            _fail(f"request {rid}: first-token logits {err} from the reference "
                  f"(tolerance {tol})")
        if margin > tol:
            checked += 1
            if records[rid]["tokens"][0] != int(ref.argmax()):
                _fail(f"request {rid}: first token {records[rid]['tokens'][0]}, "
                      f"the reference's {int(ref.argmax())} (margin {margin})")
    return {"tol": f"{HF_REL:g} * max|ref| per prompt",
            "max_err_over_tol": max(errs), "ref_top2_margins": margins,
            "greedy_checked": checked}


def _alone_equals_batched(ContinuousBatcher, cfg, model, kw, prompt, tokens, what):
    alone = ContinuousBatcher(cfg, model, **kw)
    rid = alone.submit(prompt, max_new_tokens=len(tokens))
    if alone.run()[rid] != tokens:
        _fail(f"{what}: the request alone gave other tokens than in the batch")


def hf_llama_phase(hf_mod, ContinuousBatcher, LMConfig, lm_mod, da, seed: int) -> dict:
    """A TinyLlama-1.1B HF checkpoint (random, HF names and shapes)
    through `config_from_llama` + `params_from_llama` into the paged
    engine at bf16: the serving prompts x 32 new tokens, K2 + K1 and not
    K7, the config equal to `_tinyllama_cfg` but for its dtype, and, from
    an untimed second run that must repeat the tokens, the first-token
    logits against `_llama_reference_logits` and K2 + K1 on one call's
    inputs."""
    import dataclasses

    hcfg = _tinyllama_hf_config()
    t0 = time.monotonic()
    sd = _hf_state_dict(_llama_shapes(hcfg), seed + 20)
    torch.cuda.synchronize()
    draw_s = time.monotonic() - t0
    t0 = time.monotonic()
    cfg = hf_mod.config_from_llama(hcfg)
    if dataclasses.replace(cfg, dtype="bfloat16") != _tinyllama_cfg(LMConfig):
        _fail(f"config_from_llama gave {cfg}")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = hf_mod.params_from_llama(sd, cfg)
    import_s = time.monotonic() - t0
    t0 = time.monotonic()
    engine = ContinuousBatcher(cfg, params, **LM_ENGINE_KW)
    del params
    build_s = time.monotonic() - t0
    engine.warm()
    prompts = _serving_prompts(cfg, seed)
    run = _serve_timed(engine, prompts, 32, da)
    launches = run["launches"]
    if launches["paged_attention"] <= 0 or launches["qkv_rope"] <= 0 or launches["decode_attention"]:
        _fail(f"HF llama serving launched {launches}")
    first = {}
    cap = _recorded_serve(ContinuousBatcher, cfg, engine.model, LM_ENGINE_KW, prompts, 32,
                          lm_mod, [run["records"][r]["tokens"] for r in run["rids"]],
                          "HF llama paged engine", first=first)
    held = _hold_to_reference(
        first, cap["records"], cap["rids"], prompts,
        lambda p: _llama_reference_logits(sd, hcfg, p))
    kernels = _path_paged_kernels(da, cap, "HF llama paged engine: layer 0, decode step 48")
    del sd, engine, cap
    torch.cuda.empty_cache()
    return {"model": "TinyLlama-1.1B config (HF names), random f32 checkpoint, "
                     "served bf16", "draw_on_card_s": draw_s,
            "config_and_params_from_llama_s": import_s,
            "engine_build_s": build_s, **_public(run), "reference": held,
            "repeatable": True, "kernels": kernels}


def hf_gpt2_phase(hf_mod, ContinuousBatcher, lm_mod, da, seed: int) -> dict:
    """A GPT-2-small HF checkpoint (random, Conv1D [in, out], tied head)
    through `config_from_gpt2` + `params_from_gpt2` into the paged engine
    (K2's bias arm without rotary, K1 at group 1) and the dense engine
    (no kernel: an MHA model's dense decode takes the masked attention,
    as JAX's `_decode_attention` routes it), bf16, cache_len 1024: the
    serving prompts x 32 new tokens; from an untimed second run that must
    repeat the tokens, the first-token logits against
    `_gpt2_reference_logits` and K2 + K1 on one call's inputs; and one
    request alone giving its batch tokens in both engines."""
    import dataclasses

    hcfg = _gpt2_small_hf_config()
    sd = _hf_state_dict(_gpt2_shapes(hcfg), seed + 21)
    t0 = time.monotonic()
    cfg = dataclasses.replace(hf_mod.config_from_gpt2(hcfg), dtype="bfloat16")
    params = hf_mod.params_from_gpt2(sd, cfg)
    import_s = time.monotonic() - t0
    kw = dict(LM_ENGINE_KW, cache_len=1024)
    engine = ContinuousBatcher(cfg, params, **kw)
    model = engine.model
    del params
    engine.warm()
    prompts = _serving_prompts(cfg, seed)
    paged = _serve_timed(engine, prompts, 32, da)
    launches = paged["launches"]
    if launches["paged_attention"] <= 0 or launches["qkv_rope"] <= 0 or launches["decode_attention"]:
        _fail(f"GPT-2 paged serving launched {launches}")
    tokens = [paged["records"][r]["tokens"] for r in paged["rids"]]
    first = {}
    cap = _recorded_serve(ContinuousBatcher, cfg, model, kw, prompts, 32, lm_mod, tokens,
                          "GPT-2 paged engine", first=first)
    held = _hold_to_reference(
        first, cap["records"], cap["rids"], prompts,
        lambda p: _gpt2_reference_logits(sd, hcfg, p))
    kernels = _path_paged_kernels(da, cap, "GPT-2 paged engine: layer 0, decode step 48")
    del cap
    _alone_equals_batched(ContinuousBatcher, cfg, model, kw, prompts[-1],
                          tokens[-1], "GPT-2 paged engine")
    dkw = dict(slots=8, cache_len=1024, paged=False)
    dense_engine = ContinuousBatcher(cfg, model, **dkw)
    dense_engine.warm()
    dense = _serve_timed(dense_engine, prompts, 32, da)
    if any(dense["launches"].values()):  # MHA: the masked attention, as in JAX
        _fail(f"GPT-2 dense serving launched {dense['launches']}")
    dtokens = [dense["records"][r]["tokens"] for r in dense["rids"]]
    _alone_equals_batched(ContinuousBatcher, cfg, model, dkw, prompts[4],
                          dtokens[4], "GPT-2 dense engine")
    same = sum(a == b for t, u in zip(tokens, dtokens) for a, b in zip(t, u))
    del sd, engine, dense_engine, model
    torch.cuda.empty_cache()
    return {"model": "GPT-2 small config (HF names), random f32 checkpoint, "
                     "tied head, served bf16", "config_and_params_from_gpt2_s": import_s,
            "paged": _public(paged), "dense": _public(dense),
            "reference": held, "alone_equals_batched": True, "repeatable": True,
            "kernels": kernels,
            "dense_tokens_equal_to_paged_share": same / (32 * len(prompts))}


def gpt2_kernel_phase(da, seed: int) -> tuple[list, list]:
    """K1 at group 1 and K2's bias arm without rotary, and the fused
    composition, at GPT-2 small's serving shape (8 slots, steps 1, 12
    heads of 64 over 12 kv heads, d_model 768, a 1024-row table with 512
    resident rows a slot) against their plain versions in bf16 and f32;
    bf16 timings beside their bounds, plain versions and library calls."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 22)
    b, h, hd, dm, nlog, nb = 8, 12, 64, 768, 8, 65
    kvh, dout, bf = h, 3 * dm, torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf)

    table = (torch.randperm(nb - 1, generator=gen, device=dev) + 1)[
        : b * nlog].reshape(b, nlog).to(torch.int32)
    idx = torch.full((b,), 512, device=dev, dtype=torch.int32)
    pools = [(rnd(nb, kvh, 128, hd), rnd(nb, kvh, 128, hd)) for _ in range(ROTATE)]
    ws = [rnd(dm, dout, std=0.02) for _ in range(ROTATE)]
    bias = rnd(dout, std=0.02)
    q, x = rnd(b, h, 1, hd), rnd(b, 1, dm)
    checks, rows = [], []
    kw = dict(num_heads=h, rope_theta=None)
    for dtype in (bf, torch.float32):
        q_, x_, w_, b_ = (t.to(dtype) for t in (q, x, ws[0], bias))
        kp, vp = (p.to(dtype) for p in pools[0])
        for kname, got, want in (
            ("paged_attention",
             [da.paged_decode_attention(q_, kp, vp, table, idx)],
             [da.paged_decode_attention_reference(q_, kp, vp, table, idx)]),
            ("qkv_rope",
             da.qkv_rope_projection(x_, w_, b_, idx, kv_heads=kvh, **kw),
             da.qkv_rope_reference(x_, w_, b_, idx, kv_heads=kvh, **kw)),
            ("fused",
             da.fused_qkv_paged_attention(x_, w_, b_, kp, vp, table, idx, **kw),
             da.fused_qkv_paged_reference(x_, w_, b_, kp, vp, table, idx, **kw)),
        ):
            e, ratio = _err(got, want, dtype)
            checks.append({"kernel": kname, "case": "gpt2_small",
                           "dtype": str(dtype).split(".")[-1],
                           "max_abs_err": e, "err_over_tol": ratio,
                           "tol": "%g * max|plain| per slot + %g" % TOL[dtype]})
            if not ratio <= 1.0:
                _fail(f"GPT-2 shape {kname} {dtype}: max err {e}, {ratio:.3g}x "
                      f"its per-slot tolerance")
    vis = float(idx.sum() + b)
    kv_bytes = vis * kvh * hd * 2 * 2
    k1_bytes = kv_bytes + 2 * b * h * hd * 2 + b * nlog * 4 + b * 4
    k1_flops = vis * h * hd * 4
    k2_bytes = b * dm * 2 + dm * dout * 2 + dout * 2 + b * dout * 2 + b * 4
    k2_flops = 2.0 * b * dm * dout
    gathered = [(da.gather_paged_cache(kp_, table), da.gather_paged_cache(vp_, table))
                for kp_, vp_ in pools]
    mask = (torch.arange(nlog * 128, device=dev)[None] <= idx.long()[:, None])[:, None, None]

    def k1(i):
        da.paged_decode_attention(q, *pools[i % ROTATE], table, idx)

    def k1_plain(i):
        da.paged_decode_attention_reference(q, *pools[i % ROTATE], table, idx)

    def k1_lib(i):
        torch.nn.functional.scaled_dot_product_attention(
            q, *gathered[i % ROTATE], attn_mask=mask)

    def k2(i):
        da.qkv_rope_projection(x, ws[i % ROTATE], bias, idx, kv_heads=kvh, **kw)

    def k2_plain(i):
        da.qkv_rope_reference(x, ws[i % ROTATE], bias, idx, kv_heads=kvh, **kw)

    def k2_lib(i):
        da.split_qkv(torch.addmm(bias, x[:, 0], ws[i % ROTATE])[:, None], idx,
                     num_heads=h, kv_heads=kvh)

    def fused(i):
        da.fused_qkv_paged_attention(x, ws[i % ROTATE], bias, *pools[i % ROTATE],
                                     table, idx, **kw)

    def fused_plain(i):
        da.fused_qkv_paged_reference(x, ws[i % ROTATE], bias, *pools[i % ROTATE],
                                     table, idx, **kw)

    for name, fn, plain, lib, nbytes, flops in (
        ("paged_attention", k1, k1_plain, k1_lib, k1_bytes, k1_flops),
        ("qkv_rope", k2, k2_plain, k2_lib, k2_bytes, k2_flops),
        ("fused", fused, fused_plain, None, k1_bytes + k2_bytes, k1_flops + k2_flops),
    ):
        bound_ms, bound_by = _bound(nbytes, flops)
        rows.append({
            "kernel": name, "case": "gpt2_small", "steps": 1,
            "ms": _timed(fn, 20), "plain_ms": _timed(plain, 5),
            "library_ms": None if lib is None else _timed(lib, 20),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops,
        })
    return checks, rows


MOE_FIELDS = dict(num_experts=8, moe_every=2, expert_top_k=2)
# The MoE leg's depth (cut from TinyLlama's 22 to keep the script inside
# its time budget; the widths stay TinyLlama-1.1B's).
MOE_LAYERS = 8
# Capacity factors of the MoE phase: the default, and E / k x 2, under
# which capacity = T and no token is ever dropped.
MOE_CAPACITIES = (1.25, 4.0)


def _moe_cfg(LMConfig, capacity_factor: float):
    """TinyLlama-1.1B widths, MOE_LAYERS layers, with 8 gelu experts on
    every second block, top-2."""
    import dataclasses

    return dataclasses.replace(_tinyllama_cfg(LMConfig), num_layers=MOE_LAYERS,
                               **MOE_FIELDS, capacity_factor=capacity_factor)


def _record_moe_inputs(model, sink: list):
    """Forward pre-hooks keeping each MoE call's (input, routed rows)."""
    from walkai_nos_tpu_torch.models.moe import MoEMlp

    handles = []
    for m in model.modules():
        if isinstance(m, MoEMlp):
            handles.append(m.register_forward_pre_hook(
                lambda mod, args: sink.append((mod, args[0], args[1] if len(args) > 1 else None))))
    return handles


def _drops(calls) -> dict:
    """Tokens the capacity formula dropped in the recorded MoE calls: each
    expert keeps min(its top-k assignments among the routed tokens,
    capacity); decode calls (one token a row) and lane calls apart."""
    out = {"decode_calls": 0, "decode_dropped": 0, "decode_assignments": 0,
           "lane_calls": 0, "lane_dropped": 0, "lane_assignments": 0}
    for mod, h, rows in calls:
        b, s, d = h.shape
        routed = (b if rows is None else rows) * s
        gates = torch.softmax(mod.router(h.reshape(-1, d)[:routed]), -1)
        chosen = torch.topk(gates, mod.top_k, dim=-1).indices.reshape(-1)
        per_expert = torch.bincount(chosen, minlength=mod.num_experts)
        kind = "decode" if s == 1 else "lane"
        out[kind + "_calls"] += 1
        out[kind + "_assignments"] += routed * mod.top_k
        out[kind + "_dropped"] += int(torch.clamp(per_expert - mod.capacity(routed), min=0).sum())
    return out


def _moe_step_check(lm_mod, da, model, cfg, seed: int) -> dict:
    """One paged decode step of the MoE model (after a 512-token prefill)
    through K2 + K1 against the same step through the plain route
    (`fused_qkv_paged_reference`) on the same card: per slot, max
    |kernel - plain| within TOL[bf16] of that slot's max |plain|. Twice:

    - "pinned": 8 slots, every router's bias set to 12 for expert 0 and
      8 for expert 1 (its products spread ~1), so each token's top-2 is
      experts 0 and 1 by margins far above bf16 noise and who is dropped
      depends on token order alone, the same on both routes;
    - "random_router": 8 slots and the model's own routers, on the first
      of up to 64 draws of the step's tokens in which no near-tie flips:
      in every MoE call both routes choose the same experts in the same
      order, so they route alike and differ only in bf16 rounding. The
      CPU bf16 test's rule (every gap between a token's three largest
      gates over 1e-2) cannot be met here: over 88 routed tokens the
      smallest gap falls far under the gate difference between the
      routes, which the check reports beside it. A flipped route moves
      a logit by O(1), many times TOL."""
    from walkai_nos_tpu_torch.models.moe import MoEMlp

    routers = [m.router for m in model.modules() if isinstance(m, MoEMlp)]
    saved = [r.bias.detach().clone() for r in routers]
    with torch.no_grad():
        for r in routers:
            r.bias.zero_()
            r.bias[0], r.bias[1] = 12.0, 8.0
    try:
        pinned = _kernel_and_plain_step(lm_mod, da, model, cfg, seed, b=8, draws=1)
    finally:
        with torch.no_grad():
            for r, b in zip(routers, saved):
                r.bias.copy_(b)
    return {"pinned": pinned,
            "random_router": _kernel_and_plain_step(lm_mod, da, model, cfg, seed,
                                                    b=8, draws=64)}


def _kernel_and_plain_step(lm_mod, da, model, cfg, seed: int, *, b: int, draws: int) -> dict:
    import dataclasses

    from walkai_nos_tpu_torch.models.moe import MoEMlp

    nlog = 8
    pcfg = dataclasses.replace(cfg, ragged_decode=True, paged_decode=True,
                               paged_blocks=b * nlog + 1, cache_len=nlog * 128)
    model = lm_mod.DecoderLM.from_params(pcfg, model)
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    table = (torch.randperm(b * nlog, generator=gen, device="cuda") + 1).reshape(
        b, nlog).to(torch.int32)
    prefix = torch.randint(0, cfg.vocab_size, (b, 512), generator=gen, device="cuda")
    cache = lm_mod.PagedCache.zeros(pcfg, "cuda")
    index = torch.zeros(b, dtype=torch.int32, device="cuda")
    gates = []
    handles = [m.register_forward_pre_hook(
        lambda mod, args: gates.append(torch.softmax(mod.router(args[0].reshape(
            -1, args[0].shape[-1])), -1)))
        for m in model.modules() if isinstance(m, MoEMlp)]

    def step(tok, kernel: bool):
        pools = lm_mod.PagedCache([k.clone() for k in cache.k], [v.clone() for v in cache.v])
        gates.clear()
        da.reset_launch_counts()
        kernel_route = lm_mod.fused_qkv_paged_attention
        if not kernel:
            lm_mod.fused_qkv_paged_attention = da.fused_qkv_paged_reference
        try:
            logits = model(tok, pools, table, index + 512)
        finally:
            lm_mod.fused_qkv_paged_attention = kernel_route
        return logits, dict(da.LAUNCHES), list(gates)

    try:
        with torch.inference_mode():
            model(prefix, cache, table, index)  # wide prefill: no kernel
            gates.clear()
            for draw in range(draws):
                tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device="cuda")
                got, launches, g_kernel = step(tok, True)
                want, _, g_plain = step(tok, False)
                if draws == 1:
                    break
                top = [torch.topk(g, 3, dim=-1) for g in g_plain]
                same = all(torch.equal(torch.topk(gk, cfg.expert_top_k, dim=-1).indices,
                                       t.indices[:, :cfg.expert_top_k])
                           for gk, t in zip(g_kernel, top))
                noise = max(float((gk - gp).abs().max()) for gk, gp in zip(g_kernel, g_plain))
                gap = min(float((t.values[:, :-1] - t.values[:, 1:]).min()) for t in top)
                if same:
                    break
            else:
                _fail(f"MoE decode step: in each of {draws} draws bf16 noise flipped a route")
    finally:
        for hnd in handles:
            hnd.remove()
    if launches["qkv_rope"] != cfg.num_layers or launches["paged_attention"] != cfg.num_layers:
        _fail(f"MoE decode step launched {launches}")
    err, ratio = _err(got, want, torch.bfloat16)
    if not ratio <= 1.0:
        _fail(f"MoE decode step ({b} slots): kernel route {err} from the plain route, "
              f"{ratio:.3g}x its per-slot tolerance")
    out = {"slots": b, "max_abs_err": err, "err_over_tol": ratio,
           "tol": "%g * max|plain| per slot + %g" % TOL[torch.bfloat16],
           "launches": launches}
    if draws > 1:
        out.update(draw=draw, min_top3_gate_gap=gap, max_gate_diff_between_routes=noise)
    return out


def moe_serving_phase(ContinuousBatcher, LMConfig, DecoderLM, make_generate_fn,
                      spec_mod, lm_mod, da, seed: int) -> dict:
    """The MoE model at TinyLlama width, bf16, at capacity factors 1.25
    and 4.0 (no drops): the paged engine (K2 + K1 once per layer per
    decode step), the dense engine (K7 once per layer per decode step),
    `make_generate_fn` (8 prompts of 128 tokens, 64 new) and speculative
    decoding (its `draft_config` draft: dense, 1 layer; K7 once per
    layer per verify round), each timed without instrumentation; at 4.0
    a request alone gives its batch tokens in both engines; at 1.25 an
    untimed second run of each path must repeat its tokens and records
    the tokens the capacity formula dropped and the inputs of one kernel
    call (K2 + K1 checked and timed on them for the paged engine, K7 for
    the three dense paths), and one decode step through the kernels is
    held against the plain route, with the routers pinned and with the
    random routers."""
    prompts = _serving_prompts(_tinyllama_cfg(LMConfig), seed)
    gen_prompts = _generate_prompts(_tinyllama_cfg(LMConfig), seed)[:, :128]
    new = 32
    out = {"model": f"TinyLlama-1.1B widths, {MOE_LAYERS} layers, 8 gelu experts "
                    f"on every second block, top-2, random bf16 weights"}
    for cf in MOE_CAPACITIES:
        cfg = _moe_cfg(LMConfig, cf)
        recorded = cf == 1.25
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        model = DecoderLM(cfg, device="cuda", seed=seed + 30)
        torch.cuda.synchronize()
        res = {"weights_init_s": time.monotonic() - t0}
        engine = ContinuousBatcher(cfg, model, **LM_ENGINE_KW)
        engine.warm()
        paged = _serve_timed(engine, prompts, new, da)
        want = cfg.num_layers * paged["decode_steps"]
        pl = paged["launches"]
        if pl["qkv_rope"] != want or pl["paged_attention"] != want or pl["decode_attention"]:
            _fail(f"MoE paged engine (cf {cf}): {pl} for {paged['decode_steps']} decode steps")
        tokens = [paged["records"][r]["tokens"] for r in paged["rids"]]
        dkw = dict(slots=8, cache_len=2048, paged=False)
        dense_engine = ContinuousBatcher(cfg, model, **dkw)
        dense_engine.warm()
        dense = _serve_timed(dense_engine, prompts, new, da)
        dl = dense["launches"]
        if dl["decode_attention"] != cfg.num_layers * dense["decode_steps"] \
                or dl["paged_attention"] or dl["qkv_rope"]:
            _fail(f"MoE dense engine (cf {cf}): {dl} for {dense['decode_steps']} decode steps")
        dtokens = [dense["records"][r]["tokens"] for r in dense["rids"]]
        if cf == MOE_CAPACITIES[-1]:
            _alone_equals_batched(ContinuousBatcher, cfg, model, LM_ENGINE_KW,
                                  prompts[-1], tokens[-1], "MoE paged engine, no drops")
            _alone_equals_batched(ContinuousBatcher, cfg, model, dkw,
                                  prompts[4], dtokens[4], "MoE dense engine, no drops")
            res["alone_equals_batched"] = True
        del engine, dense_engine
        caps = {}
        if recorded:
            calls = []
            caps["paged"] = _recorded_serve(
                ContinuousBatcher, cfg, model, LM_ENGINE_KW, prompts, new, lm_mod,
                tokens, "MoE paged engine (cf 1.25)", moe_calls=calls)
            drops = _drops(calls)
            del calls
            caps["dense"] = _recorded_serve(
                ContinuousBatcher, cfg, model, dkw, prompts, new, lm_mod, dtokens,
                "MoE dense engine (cf 1.25)", capture=("decode_attention", 20))
        g = make_generate_fn(cfg, tokens_per_dispatch=GENERATE_CHUNK)
        g(model, gen_prompts[:, :16], 2)
        torch.cuda.synchronize()
        da.reset_launch_counts()
        t0 = time.monotonic()
        gtok = g(model, gen_prompts, 64)
        torch.cuda.synchronize()
        gwall = time.monotonic() - t0
        glaunch = dict(da.LAUNCHES)
        gsteps = -(-63 // GENERATE_CHUNK) * GENERATE_CHUNK
        if glaunch["decode_attention"] != cfg.num_layers * gsteps or tuple(gtok.shape) != (8, 64):
            _fail(f"MoE generate (cf {cf}): {glaunch}, tokens {tuple(gtok.shape)}")
        t0 = time.monotonic()
        g(model, gen_prompts, 1)
        torch.cuda.synchronize()
        gprefill = time.monotonic() - t0
        if recorded:
            caps["generate"] = {}
            with _captured(lm_mod, "decode_attention", 32 * cfg.num_layers, caps["generate"]):
                if not torch.equal(g(model, gen_prompts, 64), gtok):
                    _fail("MoE generate (cf 1.25): a second run gave other tokens")
        dcfg = lm_mod.draft_config(cfg)
        draft = DecoderLM(dcfg, device="cuda", seed=seed + 4)
        sp = spec_mod.make_speculative_generate_fn(cfg, dcfg, k=4, return_stats=True)
        sp(model, draft, gen_prompts[:1, :16], 6)
        torch.cuda.synchronize()
        da.reset_launch_counts()
        t0 = time.monotonic()
        stok, stats = sp(model, draft, gen_prompts[:1], 64)
        torch.cuda.synchronize()
        swall = time.monotonic() - t0
        slaunch = dict(da.LAUNCHES)
        hist = stats["acceptance_hist"].tolist()
        if slaunch["decode_attention"] != cfg.num_layers * sum(hist) or tuple(stok.shape) != (1, 64):
            _fail(f"MoE speculative (cf {cf}): {slaunch} for {sum(hist)} rounds")
        if recorded:
            caps["speculative"] = {}
            with _captured(lm_mod, "decode_attention", 10 * cfg.num_layers,
                           caps["speculative"], steps=5):
                if not torch.equal(sp(model, draft, gen_prompts[:1], 64)[0], stok):
                    _fail("MoE speculative (cf 1.25): a second run gave other tokens")
        res.update({
            "paged": _public(paged), "dense": _public(dense),
            "dense_tokens_equal_to_paged_share": sum(
                a == b for t, u in zip(tokens, dtokens) for a, b in zip(t, u)) / (new * len(tokens)),
            "generate": {"batch": 8, "prompt_len": 128, "new_tokens": 64,
                         "wall_s": gwall, "prefill_s": gprefill,
                         "decode_tokens_per_s": 8 * 63 / (gwall - gprefill),
                         "step_ms": (gwall - gprefill) / gsteps * 1e3,
                         "launches": glaunch},
            "speculative": {"k": 4, "new_tokens": 64, "acceptance_hist": hist,
                            "wall_s": swall, "tokens_per_s": 64 / swall,
                            "launches": slaunch},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        })
        if recorded:
            res["repeatable"] = True
            res["drops"] = drops
            res["dropped_per_decode_step"] = drops["decode_dropped"] / paged["decode_steps"]
            res["kernels"] = _path_paged_kernels(
                da, caps.pop("paged"), "MoE paged engine at capacity 1.25: layer 0, "
                "decode step 48")
            for path, step in (("dense", "decode step 20"), ("generate", "decode step 32"),
                               ("speculative", "verify round 10")):
                args = caps.pop(path)["args"]
                kvs = [tuple(args[1:3])] + [tuple(t.clone() for t in args[1:3])
                                            for _ in range(ROTATE - 1)]
                check, row = _k7_case(da, f"moe_{path}", args[0], kvs, args[3],
                                      (args[0].dtype,))
                row.update(inputs=f"MoE {path} at capacity 1.25: layer 0, {step}",
                           max_abs_err=check[0]["max_abs_err"],
                           err_over_tol=check[0]["err_over_tol"], tol=check[0]["tol"])
                res["kernels"][f"decode_attention_{path}"] = row
            res["step_check"] = _moe_step_check(lm_mod, da, model, cfg, seed)
        del model, draft, caps
        torch.cuda.empty_cache()
        out[f"capacity_{cf:g}"] = res
    return out


def window_lm_serving_moe(seed: int) -> dict:
    """3 decode chunks of the MoE paged engine (capacity 1.25) with 8 live
    requests; sentinels K1 and K2; the MoE layers' share of the device
    time (each `MoEMlp.forward` under a profiler range: the device time of
    the kernels launched inside it, router and routing included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from walkai_nos_tpu_torch.models.lm import DecoderLM, LMConfig
    from walkai_nos_tpu_torch.models.moe import MoEMlp
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
    from walkai_nos_tpu_torch.ops import decode_attention as da

    cfg = _moe_cfg(LMConfig, 1.25)
    engine = ContinuousBatcher(cfg, DecoderLM(cfg, device="cuda", seed=seed + 30),
                               **LM_ENGINE_KW)
    engine.warm()
    rng = np.random.default_rng(seed + 32)
    for _ in range(8):
        engine.submit(rng.integers(0, cfg.vocab_size, 40), max_new_tokens=64)
    while engine._pending or engine._prefilling:
        engine.step()
    forward = MoEMlp.forward

    def ranged(self, *args):
        with record_function("moe_mlp"):
            return forward(self, *args)

    MoEMlp.forward = ranged
    torch.cuda.synchronize()
    da.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(3):
            engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    MoEMlp.forward = forward
    summary = _profile_summary(
        prof, wall, "moe_profile.txt", da.LAUNCHES,
        {"paged_attention": "decode_mma_kernel", "qkv_rope": "qkv_mma_kernel"})
    # The range's CPU-side row: the device time of the kernels launched
    # inside it (its GPU-side twin spans the range, gaps included).
    moe_us = sum(ev.device_time_total for ev in prof.key_averages()
                 if ev.key == "moe_mlp" and ev.device_type == DeviceType.CPU)
    summary["moe_device_ms"] = moe_us / 1e3
    summary["moe_share_of_device_time"] = moe_us / 1e6 / summary["device_kernel_s"]
    summary["decode_steps"] = 3 * engine.chunk_steps
    return summary


# The ViT detector at YOLOS-small width: batch 32, 196 patches + 100
# detection tokens, 6 heads of 64.
VIT_B, VIT_S, VIT_H, VIT_D = 32, 296, 6, 64
# The backward's second timing shape, at LM-training width: causal,
# (batch, seq, heads, head_dim), K/V repeated to all heads from
# TinyLlama's 4 kv heads (the LM training phase's shapes).
LM_TRAIN_SHAPE = (2, 2048, 32, 64)
LM_KV_HEADS = 4
# Gradients of the training phase's check: per parameter tensor, max
# |kernel path - plain path| <= GRAD_REL * max |plain path|. The two paths
# run the same bf16 model and differ only inside attention (the forward
# kernels round the unnormalised probabilities to bf16 where the plain
# version rounds the normalised ones; the backward kernels round P and dS
# to bf16 for the tensor cores where the plain version keeps them in f32),
# and that difference passes through 12 layers of bf16 backward.
GRAD_REL = 5e-2


@contextlib.contextmanager
def _plain_vit_attention(vit_mod, fa):
    """Runs the ViT's attention through its plain PyTorch version
    (`packed_reference`, differentiable by autograd) inside the block:
    the reference the checks hold the kernel path against."""
    kernel_path = vit_mod.flash_attention_packed
    vit_mod.flash_attention_packed = fa.packed_reference
    try:
        yield
    finally:
        vit_mod.flash_attention_packed = kernel_path


def backward_launch_check(fa, seed: int) -> dict:
    """A backward on the card is two device kernels, K5 then K6, and no
    other device work (no eager D' pass): three backward calls at the
    ViT's shape under the profiler, the process's first profiler session
    (later ones run in child processes: see `run_window`). The profiler
    must see exactly K5, K6, K5, K6, K5, K6 in time order (between ~1 ms
    spin kernels, left out of the count, that keep them away from the
    edges of the recording window, where the profiler was seen to drop a
    launch)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    q, k, v, g = (torch.randn(VIT_B, VIT_H, VIT_S, VIT_D, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    out, lse = fa._flash_fwd_cuda(q, k, v, False, VIT_S)
    fa._flash_bwd_cuda(q, k, v, out, lse, g, None, False, VIT_S)
    torch.cuda.synchronize()
    calls = 3

    def backward():
        torch.cuda._sleep(2_000_000)
        for _ in range(calls):
            fa._flash_bwd_cuda(q, k, v, out, lse, g, None, False, VIT_S)
        torch.cuda._sleep(2_000_000)

    prof = _profiled(backward)[0]
    kernels = [
        _demangled_name(e.name)
        for e in sorted(prof.events(), key=lambda e: e.time_range.start)
        if e.device_type.name == "CUDA" and "spin_kernel" not in e.name
    ]
    want = ["flash_dq", "flash_dkv"] * calls
    if len(kernels) != len(want) or not all(
            n.split("<")[0] == w + "_wgmma" for n, w in zip(kernels, want)):
        _fail(f"{calls} backward calls ran {kernels} on the device, not K5 "
              "then K6 once each")
    return {"kernel": "flash_dq+flash_dkv", "case": "vit", "dtype": "bfloat16",
            "device_kernels_in_order": kernels}


def attention_kernel_phase(fa, seed: int) -> tuple[list, list]:
    """K3-K6 against their plain versions at the ViT's shapes in bf16 and
    f32, plus a causal sq != sk shape and a kv_len < sk shape; bitwise
    repeatability of the backward; timings of kernel, plain version and
    SDPA at the ViT's shape in bf16. Returns (checks, timing rows)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    b, s, h, d = VIT_B, VIT_S, VIT_H, VIT_D
    bf = torch.bfloat16
    checks, rows = [], []

    def rnd(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(kernel, case, dtype, got, want, rule=None):
        e, ratio = _err(got, want, rule or dtype)
        checks.append({
            "kernel": kernel, "case": case, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": e, "err_over_tol": ratio,
            "tol": "%g * max|plain| per row + %g" % TOL[rule or dtype],
        })
        if not ratio <= 1.0:
            _fail(f"{kernel} {case} {dtype}: max err {e}, {ratio:.3g}x its tolerance")

    # (case, batch, sq, sk, head_dim, causal, kv_len)
    cases = (
        ("vit", b, s, s, d, False, s),
        ("causal_sq_lt_sk", 4, 200, s, d, True, s),
        ("causal_sq_gt_sk", 4, s, 100, d, True, 100),  # rows that see no key
        ("kv_len_lt_sk", 4, s, s, d, False, 250),
        ("causal_kv_tail", 4, 200, s, d, True, 250),
        ("d128", 4, s, s, 128, False, s),
    )
    for dtype in (bf, torch.float32):
        for case, bb, dd in (("vit", b, d), ("d128", 4, 128)):
            qkv = rnd(bb, s, 3 * h * dd, dtype=dtype)
            check("packed_attention", case, dtype,
                  [fa._packed_cuda(qkv, h)], [fa.packed_reference(qkv, h)])
        for case, bb, sq, sk, dd, causal, kv_len in cases:
            q, k, v = (rnd(bb, h, n, dd, dtype=dtype) for n in (sq, sk, sk))
            g = rnd(bb, h, sq, dd, dtype=dtype)
            out, lse = fa._flash_fwd_cuda(q, k, v, causal, kv_len)
            ro, rl = fa.flash_reference(q, k, v, causal=causal, kv_len=kv_len)
            check("flash_fwd", case, dtype, [out], [ro])
            # lse is f32 on both sides, from the same inputs.
            check("flash_fwd", case + "/lse", dtype, [lse], [rl], rule=torch.float32)
            g_lse = rnd(bb, h, sq, dtype=torch.float32) if causal else None
            dq, dcap = fa._flash_dq_cuda(q, k, v, g, ro, rl, g_lse, causal, kv_len)
            dk, dv = fa._flash_dkv_cuda(q, k, v, g, rl, dcap, causal, kv_len)
            wq, wk, wv = fa.flash_backward_reference(
                q, k, v, ro, rl, g, causal=causal, kv_len=kv_len, g_lse=g_lse
            )
            check("flash_dq", case, dtype, [dq], [wq])
            # K5's D' is f32 on both sides, from the same inputs.
            check("flash_dq", case + "/dcap", dtype, [dcap],
                  [fa._row_term(g, ro, g_lse)], rule=torch.float32)
            check("flash_dkv", case, dtype, [dk, dv], [wk, wv])
    torch.cuda.synchronize()

    # Bitwise repeatability of the backward (no atomics: a fixed order),
    # and the backward on the card is two kernels, K5 then K6.
    q, k, v, g = (rnd(b, h, s, d) for _ in range(4))
    out, lse = fa._flash_fwd_cuda(q, k, v, False, s)
    runs = [fa._flash_bwd_cuda(q, k, v, out, lse, g, None, False, s) for _ in range(2)]
    if not all(torch.equal(x, y) for x, y in zip(*runs)):
        _fail("two backward runs gave different gradients")
    checks.append({"kernel": "flash_dq+flash_dkv", "case": "vit", "dtype": "bfloat16",
                   "bitwise_repeatable": True})
    del q, k, v, g, out, lse, runs

    rows += _attention_timings(fa, rnd, b, s, h, d)
    rows.append(_lm_forward(fa, rnd, check, *LM_TRAIN_SHAPE))
    rows += _backward_timings(fa, rnd, "lm_causal", *LM_TRAIN_SHAPE, causal=True)
    torch.cuda.empty_cache()
    return checks, rows


def _attention_timings(fa, rnd, b, s, h, d) -> list:
    """K3-K6, the K5 + K6 pair and the eager D' pass at the ViT's shape,
    bf16, inputs cycled over ROTATE copies: kernel, plain version and
    SDPA (the backward rows: SDPA's whole backward, its D pass included)."""
    qkvs = [rnd(b, s, 3 * h * d) for _ in range(ROTATE)]
    packed_views = [fa.packed_unpack(x, h) for x in qkvs]
    qkv4 = [tuple(t.contiguous() for t in views) for views in packed_views]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def k3(i):
        fa._packed_cuda(qkvs[i % ROTATE], h)

    def k3_plain(i):
        fa.packed_reference(qkvs[i % ROTATE], h)

    def k3_lib(i):
        sdpa(*packed_views[i % ROTATE]).transpose(1, 2).reshape(b, s, h * d)

    def k4(i):
        fa._flash_fwd_cuda(*qkv4[i % ROTATE], False, s)

    def k4_plain(i):
        fa.flash_reference(*qkv4[i % ROTATE])

    def k4_lib(i):
        sdpa(*qkv4[i % ROTATE])

    bhsd = b * h * s * d * 2  # one bf16 [b, h, s, d] tensor
    pairs = b * h * s * s * d
    rows = []
    for name, fn, plain_ms, lib_ms, nbytes, flops in (
        ("packed_attention", k3, _timed(k3_plain, 3), _timed(k3_lib, 10),
         b * s * 3 * h * d * 2 + b * s * h * d * 2, 4.0 * pairs),
        ("flash_fwd", k4, _timed(k4_plain, 3), _timed(k4_lib, 10),
         4 * bhsd + b * h * s * 4, 4.0 * pairs),
    ):
        bound_ms, bound_by = _bound(nbytes, flops)
        rows.append({
            "kernel": name, "case": "vit", "shape": f"b{b} s{s} h{h} d{d} bf16",
            "ms": _timed(fn, 10), "plain_ms": plain_ms, "library_ms": lib_ms,
            "host_call_ms": _host_timed(fn, 20),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops,
        })
    del qkvs, packed_views, qkv4
    torch.cuda.empty_cache()
    return rows + _backward_timings(fa, rnd, "vit", b, s, h, d, causal=False)


def _lm_forward(fa, rnd, check, b, s, h, d) -> dict:
    """K4 causal at LM-training width (bf16): checked against its plain
    version (through `check`), then timed beside it and SDPA's causal
    forward. The bound counts the products over the visible (query, key)
    pairs. Between the two, K4, K5 and K6 are checked on the inputs the
    LM training path gives them: K/V of TinyLlama's 4 kv heads repeated
    to its 32 query heads (query head i reads kv head i // 8). Returns
    the timing row."""
    qkv4 = [tuple(rnd(b, h, s, d) for _ in range(3)) for _ in range(ROTATE)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out, lse = fa._flash_fwd_cuda(*qkv4[0], True, s)
    ro, rl = fa.flash_reference(*qkv4[0], causal=True)
    check("flash_fwd", "lm_causal", torch.bfloat16, [out], [ro])
    check("flash_fwd", "lm_causal/lse", torch.bfloat16, [lse], [rl], rule=torch.float32)
    del out, lse, ro, rl
    group = h // LM_KV_HEADS
    q, g = rnd(b, h, s, d), rnd(b, h, s, d)
    k, v = (rnd(b, LM_KV_HEADS, s, d).repeat_interleave(group, dim=1) for _ in range(2))
    out, lse = fa._flash_fwd_cuda(q, k, v, True, s)
    ro, rl = fa.flash_reference(q, k, v, causal=True)
    check("flash_fwd", "lm_training", torch.bfloat16, [out], [ro])
    check("flash_fwd", "lm_training/lse", torch.bfloat16, [lse], [rl], rule=torch.float32)
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, ro, rl, g, None, True, s)
    wq, wk, wv = fa.flash_backward_reference(q, k, v, ro, rl, g, causal=True)
    check("flash_dq", "lm_training", torch.bfloat16, [dq], [wq])
    check("flash_dkv", "lm_training", torch.bfloat16, [dk, dv], [wk, wv])
    del q, k, v, g, out, lse, ro, rl, dq, dk, dv, wq, wk, wv
    torch.cuda.empty_cache()

    def k4(i):
        fa._flash_fwd_cuda(*qkv4[i % ROTATE], True, s)

    def k4_plain(i):
        fa.flash_reference(*qkv4[i % ROTATE], causal=True)

    def k4_lib(i):
        sdpa(*qkv4[i % ROTATE], is_causal=True)

    bhsd = b * h * s * d * 2
    nbytes = 4 * bhsd + b * h * s * 4  # q, k, v read; out and lse written
    flops = 4.0 * b * h * (s * (s + 1) // 2) * d
    bound_ms, bound_by = _bound(nbytes, flops)
    row = {
        "kernel": "flash_fwd", "case": "lm_causal",
        "shape": f"b{b} s{s} h{h} d{d} bf16 causal",
        "ms": _timed(k4, 10), "plain_ms": _timed(k4_plain, 2),
        "library_ms": _timed(k4_lib, 10), "host_call_ms": _host_timed(k4, 20),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops,
    }
    del qkv4
    torch.cuda.empty_cache()
    return row


def _backward_timings(fa, rnd, case, b, s, h, d, *, causal) -> list:
    """K5, K6 and the pair (`_flash_bwd_cuda`) at one bf16 shape, beside
    the plain backward and SDPA's backward (both with their D pass); at
    the ViT's shape also the eager D' pass K5 absorbed. Bounds count each
    input read once and each output written once, and the products over
    the (query, key) pairs this shape's mask leaves visible."""
    qkv4 = [tuple(rnd(b, h, s, d) for _ in range(3)) for _ in range(ROTATE)]
    gs = [rnd(b, h, s, d) for _ in range(ROTATE)]
    fwd = [fa._flash_fwd_cuda(*t, causal, s) for t in qkv4]
    dcaps = [fa._flash_dq_cuda(*t, g_, o, lse, None, causal, s)[1]
             for t, g_, (o, lse) in zip(qkv4, gs, fwd)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_leaves = [[x.detach().clone().requires_grad_(True) for x in t] for t in qkv4]
    torch.cuda.synchronize()

    def k5(i):
        j = i % ROTATE
        fa._flash_dq_cuda(*qkv4[j], gs[j], fwd[j][0], fwd[j][1], None, causal, s)

    def k6(i):
        j = i % ROTATE
        fa._flash_dkv_cuda(*qkv4[j], gs[j], fwd[j][1], dcaps[j], causal, s)

    def pair(i):
        j = i % ROTATE
        fa._flash_bwd_cuda(*qkv4[j], fwd[j][0], fwd[j][1], gs[j], None, causal, s)

    def bwd_plain(i):
        j = i % ROTATE
        fa.flash_backward_reference(*qkv4[j], fwd[j][0], fwd[j][1], gs[j], causal=causal)

    def lib_fwd(i):
        sdpa(*lib_leaves[i % ROTATE], is_causal=causal)

    def lib_fwd_bwd(i):
        j = i % ROTATE
        o = sdpa(*lib_leaves[j], is_causal=causal)
        torch.autograd.grad(o, lib_leaves[j], gs[j])

    def row_term(i):
        j = i % ROTATE
        fa._row_term(gs[j], fwd[j][0], None)

    bhsd = b * h * s * d * 2  # one bf16 [b, h, s, d] tensor
    rows_f32 = b * h * s * 4  # one f32 [b, h, s] tensor
    # (query, key) pairs the mask leaves visible, times d.
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s) * d
    shape = f"b{b} s{s} h{h} d{d} bf16" + (" causal" if causal else "")
    bwd_plain_ms = _timed(bwd_plain, 2)
    # SDPA's backward (its D pass included): forward + backward captured
    # in a CUDA graph, less the same forward captured alone.
    bwd_lib_ms = _timed(lib_fwd_bwd, 10) - _timed(lib_fwd, 10)
    timed = [
        # K5: reads q, k, v, dO, O, lse; writes dq, D'.
        ("flash_dq", k5, bwd_plain_ms, bwd_lib_ms, 6 * bhsd + 2 * rows_f32, 6.0 * pairs),
        # K6: reads q, k, v, dO, lse, D'; writes dk, dv.
        ("flash_dkv", k6, bwd_plain_ms, bwd_lib_ms, 6 * bhsd + 2 * rows_f32, 8.0 * pairs),
        # The backward as a function: reads q, k, v, O, dO, lse; writes
        # dq, dk, dv; five products (S, dP, dq, dk, dv).
        ("flash_dq+flash_dkv", pair, bwd_plain_ms, bwd_lib_ms,
         8 * bhsd + rows_f32, 10.0 * pairs),
    ]
    if case == "vit":
        # The eager D' pass of the earlier design: reads dO and O, writes D'.
        timed.append(("row_term_eager", row_term, None, None, 2 * bhsd + rows_f32, 0.0))
    rows = []
    for name, fn, plain_ms, lib_ms, nbytes, flops in timed:
        bound_ms, bound_by = _bound(nbytes, flops)
        rows.append({
            "kernel": name, "case": case, "shape": shape,
            "ms": _timed(fn, 10), "plain_ms": plain_ms, "library_ms": lib_ms,
            "host_call_ms": _host_timed(fn, 20),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops,
        })
    del qkv4, gs, fwd, dcaps, lib_leaves
    torch.cuda.empty_cache()
    return rows


def _vit_server(vit_mod, vs, seed: int):
    """VIT_SMALL with bf16 weights cast once, behind the micro-batcher
    (max_batch 32, window 2 ms, max_inflight 8), every bucket warmed."""
    cfg = vit_mod.VIT_SMALL
    model = vit_mod.ViTDetector(cfg, device="cuda", seed=seed)
    server = vs.ViTServer(cfg, model, max_batch=32, window_ms=2.0,
                          max_inflight=8, seed=seed)
    del model
    for bucket in (1, 2, 4, 8, 16, 32):  # first calls allocate: warm them
        server.infer(server.model, server.images_of(bucket))
    torch.cuda.synchronize()
    return server


def _vit_clients(server, seed: int, clients: int = 8):
    """64 requests of 1-8 images (sizes from the seed) from `clients`
    closed-loop client threads: (requests, wall seconds, image counts)."""
    sizes = [int(n) for n in np.random.default_rng(seed).integers(1, 9, 64)]
    reqs, lock = [], threading.Lock()

    def client(chunk):
        for n in chunk:
            r = server.submit(n)
            with lock:
                reqs.append(r)
            if not r.done.wait(timeout=120):
                return

    threads = [threading.Thread(target=client, args=(sizes[i::clients],))
               for i in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.monotonic() - t0
    if any(t.is_alive() for t in threads) or not all(r.done.is_set() for r in reqs):
        _fail("ViT serving: a request was not answered")
    return reqs, wall, sizes


def vit_serving_phase(vit_mod, vs, fa, seed: int) -> dict:
    """VIT_SMALL with bf16 weights cast once, served through the
    micro-batcher (max_batch 32, window 2 ms, max_inflight 8) to 8
    closed-loop client threads, 64 requests of 1-8 images."""
    cfg = vit_mod.VIT_SMALL
    server = _vit_server(vit_mod, vs, seed)
    server.start()
    try:
        before = server.stats.snapshot()
        fa.reset_launch_counts()
        reqs, wall, sizes = _vit_clients(server, seed)
        launches = dict(fa.LAUNCHES)
        snap = server.stats.snapshot()
    finally:
        server.close()
    if snap["requests"] != len(sizes) or snap["images"] != sum(sizes):
        _fail(f"ViT serving counted {snap}")
    if launches["packed_attention"] != cfg.num_layers * snap["batches"]:
        _fail(f"ViT serving: {launches} for {snap['batches']} batches")
    if any(launches[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")):
        _fail(f"ViT serving launched backward kernels: {launches}")

    # Every bucket's served output against the plain path on its input.
    worst_err, worst_ratio = 0.0, 0.0
    with _plain_vit_attention(vit_mod, fa), torch.inference_mode():
        for bucket, out in sorted(server.last_outputs.items()):
            want = server.model(server.images_of(bucket))
            for key in ("logits", "boxes"):
                if not torch.isfinite(out[key]).all():
                    _fail(f"ViT serving: non-finite {key} at bucket {bucket}")
            e, ratio = _err([out["logits"], out["boxes"]],
                            [want["logits"], want["boxes"]], torch.bfloat16)
            worst_err, worst_ratio = max(worst_err, e), max(worst_ratio, ratio)
    if not worst_ratio <= 1.0:
        _fail(f"ViT serving: kernel path vs plain path {worst_err}, {worst_ratio:.3g}x tol")
    rtt, ceiling = vs.calibrate(server.infer, server.model, server.images_of(32),
                                window_s=1.0)
    lat = sorted(r.elapsed for r in reqs)
    images_per_s = snap["images"] / wall
    return {
        "model": "YOLOS-small widths (VIT_SMALL), random weights cast to bf16 once",
        "requests": snap["requests"], "images": snap["images"],
        "batches": snap["batches"], "padded_images": snap["padded_images"],
        "buckets_checked": sorted(server.last_outputs),
        "max_abs_err_vs_plain": worst_err, "err_over_tol": worst_ratio,
        "wall_s": wall, "fenced_images_per_s": images_per_s,
        "latency_p50_s": lat[len(lat) // 2],
        "latency_p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        # Both over the served run only (the counters start at server
        # construction, before the warm-up).
        "device_starved_s": snap["device_starved_s"] - before["device_starved_s"],
        "dispatcher_idle_s": snap["dispatcher_idle_s"] - before["dispatcher_idle_s"],
        "launches": launches,
        "fence_rtt_s": rtt, "ceiling_images_per_s": ceiling,
        "utilization_of_ceiling": images_per_s / ceiling,
    }


def _vit_batch(cfg, seed: int) -> dict:
    """One synthetic training batch of VIT_B images, labels and boxes."""
    rng = np.random.default_rng(seed + 2)
    labels = rng.integers(0, cfg.num_classes, (VIT_B, cfg.num_det_tokens)).astype(np.int32)
    labels[:, ::2] = cfg.num_classes - 1  # half the slots: no object
    return {
        "images": rng.standard_normal((VIT_B, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
        "labels": labels,
        "boxes": rng.random((VIT_B, cfg.num_det_tokens, 4)).astype(np.float32),
    }


def window_vit_serving(seed: int) -> dict:
    """The ViT serving phase's request mix through a warmed server;
    sentinel K3."""
    from walkai_nos_tpu_torch.models import vit as vit_mod
    from walkai_nos_tpu_torch.models import vit_serving as vs
    from walkai_nos_tpu_torch.ops import attention as fa

    server = _vit_server(vit_mod, vs, seed)
    server.start()
    try:
        fa.reset_launch_counts()
        prof, wall, _ = _profiled(lambda: _vit_clients(server, seed))
    finally:
        server.close()
    return _profile_summary(prof, wall, "vit_serving_profile.txt", fa.LAUNCHES,
                            {"packed_attention": "flash_fwd_wgmma"})


def window_vit_training(seed: int) -> dict:
    """3 training steps of the ViT training phase's model and batch after
    2 warm-up steps. Each step runs each of K3 (forward), K4 (the
    backward's recompute), K5 and K6 once per layer: the wrappers' counts
    must say so, and the profiler must see every one of those launches."""
    from walkai_nos_tpu_torch.models import data as data_mod
    from walkai_nos_tpu_torch.models import train as train_mod
    from walkai_nos_tpu_torch.models import trainer as trainer_mod
    from walkai_nos_tpu_torch.models import vit as vit_mod
    from walkai_nos_tpu_torch.ops import attention as fa

    cfg = vit_mod.VIT_SMALL
    batch = _vit_batch(cfg, seed)
    state = train_mod.init_train_state(cfg, seed=seed)
    step_fn = train_mod.make_train_step(cfg)

    def fit(n):
        return trainer_mod.fit(
            state, step_fn, data_mod.prefetch_to_device(itertools.repeat(batch, n)),
            num_steps=n, log_every=0,
        )

    fit(2)
    fa.reset_launch_counts()
    steps = 3
    prof, wall, _ = _profiled(lambda: fit(steps))
    launches = dict(fa.LAUNCHES)
    if any(n != cfg.num_layers * steps for n in launches.values()):
        _fail(f"ViT training window: {launches} in {steps} steps")
    # K3 and K4 are instantiations of one kernel.
    summary = _profile_summary(prof, wall, "vit_training_profile.txt", launches, {
        "packed_attention+flash_fwd": "flash_fwd_wgmma",
        "flash_dq": "flash_dq_wgmma",
        "flash_dkv": "flash_dkv_wgmma",
    })
    summary["steps"] = steps
    return summary


def _lm_batches(cfg, seed: int):
    """The LM training phase's data: the port's `token_batches` (batch 2,
    2048 tokens) over a corpus of 16 windows of tokens drawn from
    `seed`."""
    from walkai_nos_tpu_torch.models import data as data_mod

    b, s = LM_TRAIN_SHAPE[:2]
    corpus = np.random.default_rng(seed + 3).integers(
        0, cfg.vocab_size, 16 * b * s, dtype=np.int32)
    return data_mod.token_batches(corpus, batch_size=b, seq_len=s, seed=seed)


def window_lm_training(seed: int) -> dict:
    """3 training steps at TinyLlama width (22 layers, f32 masters, bf16
    compute, batch 2 x 2048 tokens) after 2 warm-up steps. Each step runs
    K4 (forward), K5 and K6 once per layer: the wrappers' counts must say
    so, and the profiler must see every one of those launches."""
    from walkai_nos_tpu_torch.models import data as data_mod
    from walkai_nos_tpu_torch.models import lm as lm_mod
    from walkai_nos_tpu_torch.models import trainer as trainer_mod
    from walkai_nos_tpu_torch.ops import attention as fa

    cfg = _tinyllama_cfg(lm_mod.LMConfig)
    state = lm_mod.init_lm_state(cfg, seed=seed)
    step_fn = lm_mod.make_lm_train_step(cfg)
    batches = data_mod.prefetch_to_device(_lm_batches(cfg, seed))

    def fit(n):
        return trainer_mod.fit(state, step_fn, batches, num_steps=n, log_every=0)

    fit(2)
    fa.reset_launch_counts()
    steps = 3
    prof, wall, _ = _profiled(lambda: fit(steps))
    launches = dict(fa.LAUNCHES)
    want = {"packed_attention": 0, "flash_fwd": cfg.num_layers * steps,
            "flash_dq": cfg.num_layers * steps, "flash_dkv": cfg.num_layers * steps}
    if launches != want:
        _fail(f"LM training window: {launches} in {steps} steps, not {want}")
    summary = _profile_summary(prof, wall, "lm_training_profile.txt", launches, {
        "flash_fwd": "flash_fwd_wgmma",
        "flash_dq": "flash_dq_wgmma",
        "flash_dkv": "flash_dkv_wgmma",
    })
    summary["steps"] = steps
    return summary


WINDOWS = {
    "decode_launches": window_decode_launches,
    "lm_serving": window_lm_serving,
    "generate": window_generate,
    "int8_serving": lambda seed: window_lm_serving(seed, "int8"),
    "vit_serving": window_vit_serving,
    "vit_training": window_vit_training,
    "lm_training": window_lm_training,
    "lm_serving_moe": window_lm_serving_moe,
    "loop_serving": window_loop_serving,
    "spec_serving": window_spec_serving,
    "obs_profile": window_obs_profile,
}


def vit_training_phase(vit_mod, train_mod, trainer_mod, data_mod, fa, seed: int) -> dict:
    """VIT_SMALL training (f32 masters, bf16 compute), batch 32: the
    step-1 gradients through K3-K6 against the plain attention's, 20
    steps through `fit` on one repeated synthetic batch with a checkpoint
    at step 10, a resume from step 10 that must replay the losses, and
    the launch counts."""
    cfg = vit_mod.VIT_SMALL
    b = VIT_B
    torch.cuda.reset_peak_memory_stats()
    batch = _vit_batch(cfg, seed)
    state = train_mod.init_train_state(cfg, seed=seed)
    model = state.params
    dev_batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}

    def grads():
        model.zero_grad(set_to_none=True)
        loss = train_mod.detection_loss(model(dev_batch["images"]), dev_batch,
                                        num_classes=cfg.num_classes)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    loss_k, g_kernel = grads()
    with _plain_vit_attention(vit_mod, fa):
        loss_p, g_plain = grads()
    model.zero_grad(set_to_none=True)
    worst, worst_name = 0.0, ""
    for name, gp in g_plain.items():
        gk = g_kernel[name]
        if not torch.isfinite(gk).all():
            _fail(f"ViT training: non-finite gradient of {name}")
        ratio = float((gk - gp).abs().max()) / (GRAD_REL * float(gp.abs().max()) + 1e-12)
        if ratio > worst:
            worst, worst_name = ratio, name
    if not worst <= 1.0:
        _fail(f"ViT training: gradient of {worst_name} is {worst:.3g}x its tolerance")
    del g_kernel, g_plain

    step_fn = train_mod.make_train_step(cfg)
    work = os.path.join("chip_smoke_work", "vit_ckpt")
    shutil.rmtree(work, ignore_errors=True)
    try:
        fa.reset_launch_counts()
        first = trainer_mod.fit(
            state, step_fn, data_mod.prefetch_to_device(itertools.repeat(batch, 20)),
            num_steps=20, checkpoint_dir=work, checkpoint_every=10, log_every=1,
        )
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        losses = first.losses
        if first.steps_run != 20 or len(losses) != 20 or not np.all(np.isfinite(losses)):
            _fail(f"ViT training: {first.steps_run} steps, losses {losses}")
        for name, n in launches.items():
            if n != cfg.num_layers * 20:
                _fail(f"ViT training: {name} launched {n} times in 20 steps")
        if not losses[-1] < losses[0]:
            _fail(f"ViT training: the loss did not fall on a repeated batch: {losses}")
        # Resume from the step-10 checkpoint on a template from another seed.
        shutil.rmtree(os.path.join(work, "20"))
        template = train_mod.init_train_state(cfg, seed=seed + 1)
        second = trainer_mod.fit(
            template, step_fn, data_mod.prefetch_to_device(itertools.repeat(batch, 10)),
            num_steps=10, checkpoint_dir=work, checkpoint_every=10, log_every=1,
        )
        if second.resumed_from != 10 or second.state.step != 20:
            _fail(f"ViT training: resumed from {second.resumed_from} to {second.state.step}")
        replay = np.asarray(second.losses)
        rel = float(np.max(np.abs(replay - losses[10:]) / np.abs(losses[10:])))
        if not rel <= 1e-3:
            _fail(f"ViT training: the resumed losses differ by {rel:.3g} relative")
        bitwise = bool(np.array_equal(replay, np.asarray(losses[10:])))
        del template, second
    finally:
        shutil.rmtree("chip_smoke_work", ignore_errors=True)

    # Throughput: 10 more steps, no checkpoint, one loss sync at the end.
    torch.cuda.synchronize()
    t0 = time.monotonic()
    timed = trainer_mod.fit(
        state, step_fn, data_mod.prefetch_to_device(itertools.repeat(batch, 10)),
        num_steps=10, log_every=0,
    )
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return {
        "model": "YOLOS-small widths (VIT_SMALL), f32 masters, bf16 compute",
        "batch": b, "step1_loss_kernel": loss_k, "step1_loss_plain": loss_p,
        "grad_worst_over_tol": worst, "grad_worst_param": worst_name,
        "grad_tol": f"{GRAD_REL} * max|plain grad| per parameter tensor",
        "losses": losses, "launches_20_steps": launches,
        "resumed_from": 10, "resume_max_rel_diff": rel, "resume_bitwise": bitwise,
        "step_ms": wall / timed.steps_run * 1e3,
        "images_per_s": b * timed.steps_run / wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


@contextlib.contextmanager
def _plain_lm_attention(lm_mod, fa):
    """Runs the LM's attention through the plain versions of K4
    (`flash_reference`) and K5 + K6 (`flash_backward_reference`) inside
    the blocks: the reference the checks hold the kernel path against.
    Like the kernels' autograd function it keeps only (out, lse) for the
    backward, so a 2048-token layer holds no [s, s] tensor between the
    passes."""

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = fa.flash_reference(q, k, v, causal=True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, g):
            return fa.flash_backward_reference(*ctx.saved_tensors, g, causal=True)

    kernel_path = lm_mod.flash_attention
    lm_mod.flash_attention = lambda q, k, v, causal: PlainFlash.apply(q, k, v)
    try:
        yield
    finally:
        lm_mod.flash_attention = kernel_path


def _lm_model_flops(cfg, model, b: int, s: int) -> tuple[float, str]:
    """Model FLOPs of one training step and the formula: 6 x N x tokens
    for the parameters in products (all but the embedding table), plus
    the causal attention's products, forward and backward (3 x the
    forward's 4 x b x h x s(s+1)/2 x head_dim, per layer)."""
    n_params = sum(p.numel() for name, p in model.named_parameters()
                   if name != "embed.embedding")
    attn = 3 * 4 * b * cfg.num_heads * (s * (s + 1) // 2) * cfg.head_dim * cfg.num_layers
    flops = 6 * n_params * b * s + attn
    formula = (f"(6 x N {n_params} x tokens {b * s} + causal attention "
               f"3 x 4 x b x h x s(s+1)/2 x d x layers = {attn:.4g}) / step time / "
               f"{BF16_FLOPS:.4g} FLOP/s (dense bf16 peak)")
    return float(flops), formula


def lm_training_phase(lm_mod, trainer_mod, data_mod, fa, seed: int) -> dict:
    """LM training at TinyLlama-1.1B width (f32 masters, bf16 compute,
    batch 2 x 2048 tokens from `token_batches`):
    - at 2 layers, the step-1 gradient of every parameter through K4-K6
      against the plain attention's; then 20 steps through `fit` on one
      repeated batch with a checkpoint at step 10 (the loss must fall),
      and a resume from step 10 that must replay the losses;
    - at 22 layers, 3 warm-up and 10 timed steps through `fit` (22 K4,
      K5 and K6 launches a step), then one step with `remat` on a fresh
      state from the same seed (44 K4, 22 K5, 22 K6; the loss of the
      warm-up's first step);
    - an MoE model (4 layers, 8 experts on every second block, top-2,
      capacity 1.25): 5 steps on a repeated batch, the loss falling, 4
      launches of each kernel a step."""
    import dataclasses

    cfg = _tinyllama_cfg(lm_mod.LMConfig)
    b, s = LM_TRAIN_SHAPE[:2]
    batch = next(_lm_batches(cfg, seed))
    tokens = torch.from_numpy(batch).cuda()

    # Gradients at 2 layers: kernel path against plain path.
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    state = lm_mod.init_lm_state(cfg2, seed=seed)
    model = state.params

    def grads():
        model.zero_grad(set_to_none=True)
        loss = lm_mod.lm_loss(model(tokens), tokens)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    fa.reset_launch_counts()
    loss_k, g_kernel = grads()
    grad_launches = dict(fa.LAUNCHES)
    with _plain_lm_attention(lm_mod, fa):
        loss_p, g_plain = grads()
    model.zero_grad(set_to_none=True)
    if any(grad_launches[k] != 2 for k in ("flash_fwd", "flash_dq", "flash_dkv")):
        _fail(f"LM training: the 2-layer gradient launched {grad_launches}")
    worst, worst_name = 0.0, ""
    for name, gp in g_plain.items():
        gk = g_kernel[name]
        if not torch.isfinite(gk).all():
            _fail(f"LM training: non-finite gradient of {name}")
        ratio = float((gk - gp).abs().max()) / (GRAD_REL * float(gp.abs().max()) + 1e-12)
        if ratio > worst:
            worst, worst_name = ratio, name
    if not worst <= 1.0:
        _fail(f"LM training: gradient of {worst_name} is {worst:.3g}x its tolerance")
    del g_kernel, g_plain

    # Fit and resume at 2 layers.
    step_fn = lm_mod.make_lm_train_step(cfg2)
    work = os.path.join("chip_smoke_work", "lm_ckpt")
    shutil.rmtree(work, ignore_errors=True)
    try:
        first = trainer_mod.fit(
            state, step_fn, data_mod.prefetch_to_device(itertools.repeat(batch, 20)),
            num_steps=20, checkpoint_dir=work, checkpoint_every=10, log_every=1,
        )
        losses = first.losses
        if first.steps_run != 20 or len(losses) != 20 or not np.all(np.isfinite(losses)):
            _fail(f"LM training: {first.steps_run} steps, losses {losses}")
        if not losses[-1] < losses[0]:
            _fail(f"LM training: the loss did not fall on a repeated batch: {losses}")
        shutil.rmtree(os.path.join(work, "20"))
        template = lm_mod.init_lm_state(cfg2, seed=seed + 1)
        second = trainer_mod.fit(
            template, step_fn, data_mod.prefetch_to_device(itertools.repeat(batch, 10)),
            num_steps=10, checkpoint_dir=work, checkpoint_every=10, log_every=1,
        )
        if second.resumed_from != 10 or second.state.step != 20:
            _fail(f"LM training: resumed from {second.resumed_from} to {second.state.step}")
        replay = np.asarray(second.losses)
        rel = float(np.max(np.abs(replay - losses[10:]) / np.abs(losses[10:])))
        if not rel <= 1e-3:
            _fail(f"LM training: the resumed losses differ by {rel:.3g} relative")
        bitwise = bool(np.array_equal(replay, np.asarray(losses[10:])))
        del template, second
    finally:
        shutil.rmtree("chip_smoke_work", ignore_errors=True)
    del state, model, first
    torch.cuda.empty_cache()

    # Timed steps at 22 layers.
    torch.cuda.reset_peak_memory_stats()
    state = lm_mod.init_lm_state(cfg, seed=seed)
    flops, formula = _lm_model_flops(cfg, state.params, b, s)
    step_fn = lm_mod.make_lm_train_step(cfg)
    batches = data_mod.prefetch_to_device(_lm_batches(cfg, seed))
    warm = trainer_mod.fit(state, step_fn, batches, num_steps=3, log_every=1)
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    timed = trainer_mod.fit(state, step_fn, batches, num_steps=10, log_every=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(fa.LAUNCHES)
    want = {"packed_attention": 0, "flash_fwd": 220, "flash_dq": 220, "flash_dkv": 220}
    if timed.steps_run != 10 or launches != want:
        _fail(f"LM training: {timed.steps_run} timed steps launched {launches}, not {want}")
    if not np.all(np.isfinite(warm.losses + timed.losses)):
        _fail(f"LM training: losses {warm.losses + timed.losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = wall / timed.steps_run
    warmup_losses = warm.losses
    step1_loss = warmup_losses[0]
    del state, warm, timed, batches
    torch.cuda.empty_cache()

    # One step with remat, from the same initial weights and first batch;
    # then 3 more, timed.
    torch.cuda.reset_peak_memory_stats()
    rcfg = dataclasses.replace(cfg, remat=True)
    rstate = lm_mod.init_lm_state(rcfg, seed=seed)
    rstep = lm_mod.make_lm_train_step(rcfg)
    rbatches = data_mod.prefetch_to_device(_lm_batches(cfg, seed))
    fa.reset_launch_counts()
    _, rloss = rstep(rstate, next(rbatches))
    rloss = float(rloss)
    remat_launches = dict(fa.LAUNCHES)
    want = {"packed_attention": 0, "flash_fwd": 44, "flash_dq": 22, "flash_dkv": 22}
    if remat_launches != want:
        _fail(f"LM training: the remat step launched {remat_launches}, not {want}")
    # Equal to one bf16 rounding (2**-8 relative) of the step without remat.
    if not abs(rloss - step1_loss) <= 2 ** -8 * abs(step1_loss):
        _fail(f"LM training: remat loss {rloss} against {step1_loss}")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    trainer_mod.fit(rstate, rstep, rbatches, num_steps=3, log_every=0)
    torch.cuda.synchronize()
    remat_s = (time.monotonic() - t0) / 3
    remat_peak = torch.cuda.max_memory_allocated() / 1e9
    del rstate, rbatches
    torch.cuda.empty_cache()

    # MoE: 4 layers, experts on blocks 2 and 4.
    mcfg = dataclasses.replace(cfg, num_layers=4, num_experts=8, moe_every=2,
                               expert_top_k=2, capacity_factor=1.25)
    mstate = lm_mod.init_lm_state(mcfg, seed=seed)
    fa.reset_launch_counts()
    moe = trainer_mod.fit(
        mstate, lm_mod.make_lm_train_step(mcfg),
        data_mod.prefetch_to_device(itertools.repeat(batch, 5)), num_steps=5, log_every=1,
    )
    torch.cuda.synchronize()
    moe_launches = dict(fa.LAUNCHES)
    want = {"packed_attention": 0, "flash_fwd": 20, "flash_dq": 20, "flash_dkv": 20}
    if moe_launches != want or not np.all(np.isfinite(moe.losses)) or not (
            moe.losses[-1] < moe.losses[0]):
        _fail(f"LM training, MoE: launches {moe_launches}, losses {moe.losses}")
    moe_losses = moe.losses
    del mstate, moe
    torch.cuda.empty_cache()
    return {
        "model": "TinyLlama-1.1B widths (22 layers), f32 masters, bf16 compute",
        "batch": b, "seq": s,
        "step1_loss_kernel_2_layers": loss_k, "step1_loss_plain_2_layers": loss_p,
        "grad_worst_over_tol": worst, "grad_worst_param": worst_name,
        "grad_tol": f"{GRAD_REL} * max|plain grad| per parameter tensor (2 layers)",
        "fit_losses_2_layers": losses, "resumed_from": 10,
        "resume_max_rel_diff": rel, "resume_bitwise": bitwise,
        "warmup_losses": warmup_losses, "launches_10_steps": launches,
        "step_ms": step_s * 1e3, "tokens_per_s": b * s / step_s,
        "peak_mem_gb": peak,
        "model_flops_per_step": flops,
        "model_flop_share": flops / step_s / BF16_FLOPS,
        "model_flop_share_formula": formula,
        "remat_step_ms": remat_s * 1e3, "remat_peak_mem_gb": remat_peak,
        "remat_loss": rloss, "remat_loss_bitwise": rloss == step1_loss,
        "remat_launches": remat_launches,
        "moe": {"layers": 4, "experts": 8, "moe_every": 2, "top_k": 2,
                "capacity_factor": 1.25, "losses": moe_losses,
                "launches_5_steps": moe_launches},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window", choices=sorted(WINDOWS),
                    help="run one profiled window and print its summary "
                         "(the script starts itself so, once per window)")
    args = ap.parse_args()
    start = time.monotonic()
    phase_end_s = {}  # seconds from the start to the end of each phase
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.window:
        print(json.dumps(WINDOWS[args.window](args.seed)), flush=True)
        return 0
    from walkai_nos_tpu_torch.models import hf as hf_mod
    from walkai_nos_tpu_torch.models import lm as lm_mod
    from walkai_nos_tpu_torch.models import lora as lora_mod
    from walkai_nos_tpu_torch.models.lm import DecoderLM, LMConfig
    from walkai_nos_tpu_torch.models import data as data_mod
    from walkai_nos_tpu_torch.models import speculative as spec_mod
    from walkai_nos_tpu_torch.models.decode import make_generate_fn
    from walkai_nos_tpu_torch.models import train as train_mod
    from walkai_nos_tpu_torch.models import trainer as trainer_mod
    from walkai_nos_tpu_torch.models import vit as vit_mod
    from walkai_nos_tpu_torch.models import vit_serving
    from walkai_nos_tpu_torch.models import serve as serve_mod
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
    from walkai_nos_tpu_torch.obs import anomaly as anomaly_mod
    from walkai_nos_tpu_torch.obs import capture as capture_mod
    from walkai_nos_tpu_torch.obs import federation as fed_mod
    from walkai_nos_tpu_torch import router as router_mod
    from walkai_nos_tpu_torch.ops import _build
    from walkai_nos_tpu_torch.sim import replay as replay_mod
    from walkai_nos_tpu_torch.ops import sp_prefill as sp_mod
    from walkai_nos_tpu_torch.ops import attention as fa
    from walkai_nos_tpu_torch.ops import decode_attention as da

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.monotonic()
    libs = _build.load_kernels()
    print(json.dumps({"build_s": time.monotonic() - t0}), flush=True)
    ptxas = {name: _ptxas_report(log) for name, log in _build.build_logs.items()}
    for name, lines in ptxas.items():
        for line in lines:
            print(f"ptxas {name}: {line}", flush=True)
    tensor_cores = {lib: _tensor_core_counts(libs[lib]._name)
                    for lib in ("flash_attention", "flash_attention_bwd",
                                "decode_attention", "paged_attention",
                                "qkv_rope")}
    print(json.dumps({"tensor_core_instructions": tensor_cores}), flush=True)
    # Every bf16 attention kernel (K3/K4 forward, K5, K6) runs its products
    # as wgmma, and every bf16 or int8-pool decode kernel (K1, K7) and every
    # bf16 or int8-weight QKV kernel (K2) as mma.sync: each of their
    # instantiations must hold HGMMA / HMMA instructions.
    for lib, prefixes, op in (
            ("flash_attention", ("flash_fwd_wgmma",), "HGMMA"),
            ("flash_attention_bwd", ("flash_dq_wgmma", "flash_dkv_wgmma"), "HGMMA"),
            ("decode_attention", ("decode_mma_kernel",), "HMMA"),
            ("paged_attention", ("decode_mma_kernel",), "HMMA"),
            ("qkv_rope", ("qkv_mma_kernel",), "HMMA")):
        for prefix in prefixes:
            found = {k: v for k, v in tensor_cores[lib].items() if prefix in k}
            if not found or not all(v.get(op) for v in found.values()):
                _fail(f"{lib}: no {op} in the kernel {prefix}: {tensor_cores[lib]}")

    phase_end_s['build_and_backward_check'] = time.monotonic() - start
    launch_check = backward_launch_check(fa, args.seed)
    print(json.dumps({"check": launch_check}), flush=True)
    checks, rows = kernel_phase(da, args.seed)
    qchecks, qrows, quant_dense = int8_kernel_phase(da, lm_mod, args.seed)
    dchecks, drows = dense_kernel_phase(da, args.seed)
    checks, rows = checks + qchecks + dchecks, rows + qrows + drows
    for c in checks:
        print(json.dumps({"check": c}), flush=True)
    for r in rows:
        print(json.dumps({"timing": r}), flush=True)
    phase_end_s['lm_kernel_phases'] = time.monotonic() - start
    decode_launches = run_window("decode_launches", args.seed)
    print(json.dumps({"decode_launches": decode_launches}), flush=True)
    phase_end_s['decode_launches_window'] = time.monotonic() - start

    serve = serving_phase(ContinuousBatcher, LMConfig, DecoderLM, da, args.seed)
    model, cfg = serve.pop("_model"), serve.pop("_cfg")
    serve_prompts = serve.pop("_prompts")
    serve_tokens = serve.pop("_tokens")
    obs_on = serve.pop("_obs_on")
    obs = obs_phase(ContinuousBatcher, da, model, cfg, serve_prompts, serve_tokens,
                    obs_on)
    del obs_on
    obs["profile"] = window = run_window("obs_profile", args.seed)
    print(json.dumps({"obs": obs}), flush=True)
    print(f"Obs on {smi}: step ms on {[round(x, 3) for x in obs['step_ms']['on']]}, "
          f"off {[round(x, 3) for x in obs['step_ms']['off']]} (order "
          f"{obs['order']}), obs_overhead_pct {obs['obs_overhead_pct']:.2f} (pairs "
          f"{[round(x, 2) for x in obs['pair_overhead_pct']]}); "
          f"{obs['checks']['exposition_lines']} exposition lines, dispatch kinds "
          f"{obs['checks']['dispatch_kinds']}; profile hook window: "
          f"{window['status']['completed_windows']} completed, K1/K2 kernel events "
          f"{window['sentinel_launches']['paged_attention']['launches']}/"
          f"{window['sentinel_launches']['qkv_rope']['launches']} over "
          f"{window['dispatches_armed']} dispatches at {window['layers']} layers, "
          f"trace {window['trace_bytes']} bytes", flush=True)
    sa = obs["slo_attrib"]
    print(f"SLO + attribution on {smi} (LM serving, eager): roofline_fraction "
          f"{sa['roofline_fraction']}, host_overhead_frac {sa['host_overhead_frac']}, "
          f"device_step_ms {sa['device_step_ms']} over {sa['window_dispatches']} "
          f"dispatches, kinds {sa['kinds']}; windows {sa['window_counts']}, "
          f"slo_ok {sa['slo_ok']}, burn {sa['burn_rate']}, saturation "
          f"{sa['saturation']} {sa['components']}", flush=True)
    phase_end_s['obs'] = time.monotonic() - start
    serve["profile"] = run_window("lm_serving", args.seed)
    print(json.dumps({"serving": serve}), flush=True)
    phase_end_s['lm_serving'] = time.monotonic() - start
    sp_serve = sp_serving_phase(ContinuousBatcher, lm_mod, serve_mod, sp_mod, da,
                                model, cfg, serve_prompts, args.seed)
    print(json.dumps({"sp_serving": sp_serve}), flush=True)
    tail = sp_serve["tail"]
    print(f"SP serving on {smi}: long prompts {SP_LONG} lane dispatches "
          f"{[x['lane_dispatches'] for x in sp_serve['sp_on']['long']]} sp on, "
          f"{[x['lane_dispatches'] for x in sp_serve['sp_off']['long']]} off; TTFT "
          f"{[round(x['ttft_s'], 3) for x in sp_serve['sp_on']['long']]} s on, "
          f"{[round(x['ttft_s'], 3) for x in sp_serve['sp_off']['long']]} off; "
          f"sp_stats {json.dumps(sp_serve['sp_on']['sp_stats'])}; wide tail "
          f"streamed {tail['streamed_ms']:.4f} ms, dense {tail['dense_ms']:.4f} ms",
          flush=True)
    phase_end_s['sp_serving'] = time.monotonic() - start
    xfer = transfer_phase(ContinuousBatcher, DecoderLM, lm_mod, da, model, cfg,
                          serve_prompts, serve_tokens, args.seed)
    print(json.dumps({"transfer": xfer}), flush=True)
    print(f"Transfer on {smi}: " + "; ".join(
        f"{k} {v['payload_mb']:.2f} MB, export {v['export_s']:.3f} s, import "
        f"{v['import_s']:.3f} s, {v['migrated']} migrated, {v['resubmitted']} resubmitted"
        for k, v in xfer.items() if "payload_mb" in v), flush=True)
    phase_end_s['transfer'] = time.monotonic() - start
    capture = capture_replay_phase(ContinuousBatcher, lm_mod, replay_mod, capture_mod,
                                   da, cfg, serve_prompts, args.seed)
    print(json.dumps({"capture_replay": capture}), flush=True)
    ring, runs = capture["ring"], (capture["uncaptured"], capture["captured"])
    print(f"Capture on {smi}: {ring['records']} records, {ring['bytes']} bytes, "
          f"{ring['files']} files (submit records {ring['submit_record_bytes']} B, "
          f"done {ring['done_record_bytes']} B), fingerprint {capture['fingerprint_id']}, "
          f"config_fingerprint() {capture['fingerprint_s']:.3f} s; step "
          f"{runs[1]['step_ms']:.2f} ms captured, {runs[0]['step_ms']:.2f} uncaptured; "
          f"TTFT p50 {runs[1]['ttft_p50_s']:.4f} s captured, "
          f"{runs[0]['ttft_p50_s']:.4f} uncaptured; K1/K2 launches captured "
          f"{runs[1]['launches']['paged_attention']}/{runs[1]['launches']['qkv_rope']}",
          flush=True)
    for what, rep in capture["replays"].items():
        if isinstance(rep, dict):
            print(f"Replay {what} on {smi}: {rep['verified']}/{rep['requests']} "
                  f"verified in {rep['wall_s']:.3f} s, K1/K2 launches "
                  f"{rep['launches']['paged_attention']}/{rep['launches']['qkv_rope']}",
                  flush=True)
    neg, spec = capture["negative_control"], capture["spec_f32"]
    print(f"Replay negative control on {smi}: {neg['divergent']} divergent, "
          f"{json.dumps(neg['verdict'])}; f32 spec capture replayed spec off "
          f"{spec['spec_off']['verified']} and random draft "
          f"{spec['spec_random_draft']['verified']} verified", flush=True)
    phase_end_s['capture_replay'] = time.monotonic() - start
    fleet = fleet_phase(ContinuousBatcher, lm_mod, router_mod, fed_mod, anomaly_mod,
                        da, cfg, args.seed)
    print(json.dumps({"fleet": fleet}), flush=True)
    print(f"Fleet on {smi} ({fleet['layers']} layers, one model): "
          f"{fleet['requests']} requests x {fleet['new_tokens_each']} in "
          f"{fleet['wall_s']:.3f} s (solo engine {fleet['solo_wall_s']:.3f} s, "
          f"round-robin fleet {fleet['round_robin_wall_s']:.3f} s); served by "
          f"{fleet['served_by']}; scale events {fleet['scale_events']}, drained "
          f"{fleet['drained'].get('name')} with "
          f"{fleet['drained']['resident']['resident_slots']} resident slots; prefix "
          f"hit rate {fleet['prefix_hit_rate']:.4f} affinity, "
          f"{fleet['round_robin_prefix_hit_rate']:.4f} round-robin; K1/K2 launches "
          f"{fleet['launches']['paged_attention']}/{fleet['launches']['qkv_rope']}, "
          f"per replica {fleet['launches_per_replica']}; flight bundles "
          f"{fleet['flight_triggers']}, anomaly flagged {fleet['anomaly_flagged']}",
          flush=True)
    phase_end_s['fleet'] = time.monotonic() - start
    server = server_phase(ContinuousBatcher, lm_mod, da, router_mod, args.seed)
    print(json.dumps({"server": server}), flush=True)
    inf, gen = server["infer"], server["generate"]
    print(f"Demo server on {smi} (YOLOS-small /infer, LM_SMALL /generate at "
          f"{server['model']['layers']} layers, loop_steps 8): startup "
          f"{server['startup_s']:.2f} s (beside the leg's in-process reference; "
          f"the leg waited {server['startup_waited_s']:.2f} s more); /infer {inf['images_per_s']:.1f} images/s "
          f"({inf['requests']} requests of {SERVER_INFER[2]} from {SERVER_INFER[0]} "
          f"clients in {inf['batches']} batches), p50 {inf['p50_s']:.4f} s, p99 "
          f"{inf['p99_s']:.4f} s, K3 per bucket {inf['k3_per_bucket']}; /generate "
          f"{gen['tokens_per_s']:.1f} tokens/s ({gen['requests']} x "
          f"{gen['new_tokens_each']}), TTFT p50 {gen['ttft_engine_p50_s']:.4f} s in "
          f"the engine, SSE first token {gen['sse_first_token_s']:.4f} s over HTTP; "
          f"launches K1 {server['launches']['paged_attention']}, K2 "
          f"{server['launches']['qkv_rope']}, K7 {server['launches']['decode_attention']}, "
          f"K3 {server['launches']['packed_attention']}; profile window K1/K2 "
          f"{server['profile']['window_launches']}; capture replayed in "
          f"{server['capture']['replay_s']:.2f} s", flush=True)
    phase_end_s['server'] = time.monotonic() - start
    loop_serve = loop_serving_phase(ContinuousBatcher, da, model, cfg, serve_prompts)
    loop_serve["profile"] = window = run_window("loop_serving", args.seed)
    print(json.dumps({"loop_serving": loop_serve}), flush=True)
    print(f"Loop serving on {smi}: {loop_serve['step_ms']:.2f} ms a step "
          f"({loop_serve['loop_off']['step_ms']:.2f} with loop_steps 1), "
          f"{loop_serve['fold_ms_per_step']:.3f} ms a folded step over "
          f"{loop_serve['folds']} folds ({loop_serve['folded_step_share']:.3f} of "
          f"the steps); window: {window['folds']} folds, each one graph launch "
          f"and one sync, busy {window['device_busy_share']:.3f} "
          f"(folds {window['fold_device_busy_share']:.3f}); loop_steps 4 engine: "
          f"roofline_fraction {loop_serve['attrib']['roofline_fraction']}, "
          f"host_overhead_frac {loop_serve['attrib']['host_overhead_frac']}, "
          f"device_step_ms {loop_serve['attrib']['device_step_ms']}, kinds "
          f"{ {k: v['dispatches'] for k, v in loop_serve['attrib']['kinds'].items()} }",
          flush=True)
    phase_end_s['loop_serving'] = time.monotonic() - start
    spec_serve = spec_serving_phase(ContinuousBatcher, lm_mod, da, model, cfg,
                                    serve_prompts, serve_tokens, args.seed,
                                    "spec serving")
    spec_serve["profile"] = window = run_window("spec_serving", args.seed)
    print(json.dumps({"spec_serving": spec_serve}), flush=True)
    for name, leg in spec_serve.items():
        if isinstance(leg, dict) and "spec_stats" in leg:
            print(f"Spec serving {name} on {smi}: {leg['decode_tokens_per_s']:.2f} "
                  f"tokens/s, {leg['spec_stats']['emitted_per_round']} emitted a "
                  f"round, K2/K1 at steps {SPEC_K + 1} {leg['verify_launches']}, "
                  f"{leg['tokens_equal_spec_off_share']:.3f} of tokens equal to "
                  f"spec off", flush=True)
    print(f"Spec window on {smi}: {window['verify_rounds']} verify rounds, K1's "
          f"combine kernel seen {window['k1_combine_launches_seen']} times", flush=True)
    phase_end_s['spec_serving'] = time.monotonic() - start
    generate = generate_phase(make_generate_fn, da, model, cfg, args.seed)
    gen_prompts = generate.pop("_prompts")
    generate["profile"] = run_window("generate", args.seed)
    print(json.dumps({"generate": generate}), flush=True)
    phase_end_s['generate'] = time.monotonic() - start
    speculative = speculative_phase(spec_mod, lm_mod, da, model, cfg,
                                    gen_prompts[0], args.seed)
    print(json.dumps({"speculative": speculative}), flush=True)
    phase_end_s['speculative'] = time.monotonic() - start
    dense_serve = dense_serving_phase(ContinuousBatcher, da, model, cfg,
                                      serve_prompts)
    print(json.dumps({"dense_serving": dense_serve}), flush=True)
    phase_end_s['dense_serving'] = time.monotonic() - start
    del model
    torch.cuda.empty_cache()
    exact = exactness_phase(ContinuousBatcher, make_generate_fn, spec_mod, lm_mod,
                            da, cfg, serve_prompts, args.seed)
    print(json.dumps({"exactness_f32": exact}), flush=True)
    phase_end_s['exactness_f32'] = time.monotonic() - start
    spec_exact = spec_exactness_phase(ContinuousBatcher, lm_mod, da, cfg,
                                      serve_prompts, args.seed)
    print(json.dumps({"spec_exactness_f32": spec_exact}), flush=True)
    phase_end_s['spec_exactness_f32'] = time.monotonic() - start
    unfused = unfused_phase(ContinuousBatcher, DecoderLM, da, cfg, args.seed)
    print(json.dumps({"unfused": unfused}), flush=True)
    phase_end_s['unfused'] = time.monotonic() - start
    lora = lora_serving_phase(ContinuousBatcher, lm_mod, lora_mod, da, cfg,
                              serve_prompts, args.seed)
    print(json.dumps({"lora_serving": lora}), flush=True)
    free = lora["lora_free"]
    print(f"LoRA serving on {smi} ({lora['model']}): armed "
          f"{lora['armed']['decode_tokens_per_s']:.2f} tokens/s, "
          f"{lora['armed']['step_ms']:.2f} ms a step (LoRA-free: fused "
          f"{free['fused']['decode_tokens_per_s']:.2f} tokens/s, "
          f"{free['fused']['step_ms']:.2f} ms; unfused "
          f"{free['unfused']['decode_tokens_per_s']:.2f} tokens/s, "
          f"{free['unfused']['step_ms']:.2f} ms); folded step "
          f"{lora['armed_loop4'].get('fold_ms_per_step', float('nan')):.3f} ms armed, "
          f"{loop_serve['fold_ms_per_step']:.3f} ms LoRA-free (the loop leg's, 22 "
          f"layers); lora_stats {json.dumps(lora['lora_stats'])}", flush=True)
    phase_end_s['lora_serving'] = time.monotonic() - start
    int8_serve = int8_serving_phase(ContinuousBatcher, DecoderLM, lm_mod, da, cfg,
                                    serve_prompts, serve_tokens, args.seed)
    int8_serve["quant_dense"] = quant_dense
    int8_serve["profile"] = run_window("int8_serving", args.seed)
    print(json.dumps({"int8_serving": int8_serve}), flush=True)
    phase_end_s['int8_serving'] = time.monotonic() - start
    sim_exact = sim_exactness_phase(ContinuousBatcher, DecoderLM, da, cfg,
                                    serve_prompts, args.seed)
    print(json.dumps({"sim_exactness": sim_exact}), flush=True)
    phase_end_s['sim_exactness'] = time.monotonic() - start
    torch.cuda.empty_cache()
    gchecks, grows = gpt2_kernel_phase(da, args.seed)
    for c in gchecks:
        print(json.dumps({"check": c}), flush=True)
    for r in grows:
        print(json.dumps({"timing": r}), flush=True)
    phase_end_s['gpt2_kernel_phase'] = time.monotonic() - start
    hf_llama = hf_llama_phase(hf_mod, ContinuousBatcher, LMConfig, lm_mod, da, args.seed)
    print(json.dumps({"hf_llama": hf_llama}), flush=True)
    phase_end_s['hf_llama'] = time.monotonic() - start
    hf_gpt2 = hf_gpt2_phase(hf_mod, ContinuousBatcher, lm_mod, da, args.seed)
    print(json.dumps({"hf_gpt2": hf_gpt2}), flush=True)
    phase_end_s['hf_gpt2'] = time.monotonic() - start
    moe = moe_serving_phase(ContinuousBatcher, LMConfig, DecoderLM, make_generate_fn,
                            spec_mod, lm_mod, da, args.seed)
    moe["profile"] = run_window("lm_serving_moe", args.seed)
    print(json.dumps({"moe_serving": moe}), flush=True)
    phase_end_s['moe_serving'] = time.monotonic() - start
    torch.cuda.empty_cache()

    vchecks, vrows = attention_kernel_phase(fa, args.seed)
    for c in vchecks:
        print(json.dumps({"check": c}), flush=True)
    for r in vrows:
        print(json.dumps({"timing": r}), flush=True)
    phase_end_s['vit_kernel_phase'] = time.monotonic() - start
    vit_serve = vit_serving_phase(vit_mod, vit_serving, fa, args.seed)
    vit_serve["profile"] = run_window("vit_serving", args.seed)
    print(json.dumps({"vit_serving": vit_serve}), flush=True)
    phase_end_s['vit_serving'] = time.monotonic() - start
    torch.cuda.empty_cache()
    vit_train = vit_training_phase(vit_mod, train_mod, trainer_mod, data_mod, fa, args.seed)
    vit_train["profile_3_steps"] = run_window("vit_training", args.seed)
    print(json.dumps({"vit_training": vit_train}), flush=True)
    phase_end_s['vit_training'] = time.monotonic() - start
    torch.cuda.empty_cache()
    lm_train = lm_training_phase(lm_mod, trainer_mod, data_mod, fa, args.seed)
    lm_train["profile_3_steps"] = window = run_window("lm_training", args.seed)
    lm_train["kernel_device_ms_per_step"] = {
        name: seen["device_ms"] / window["steps"]
        for name, seen in window["sentinel_launches"].items()
    }
    print(json.dumps({"lm_training": lm_train}), flush=True)
    print(f"LM training on {smi}: {lm_train['step_ms']:.2f} ms a step, "
          f"{lm_train['tokens_per_s']:.1f} tokens/s, peak {lm_train['peak_mem_gb']:.2f} GB, "
          f"model-FLOP share {lm_train['model_flop_share']:.4f} = "
          f"{lm_train['model_flop_share_formula']}", flush=True)
    phase_end_s['lm_training'] = time.monotonic() - start

    src = "walkai_nos_tpu_torch/csrc/"
    replaces = {
        "paged_attention": "walkai_nos_tpu/ops/decode_attention.py:586",
        "qkv_rope": "walkai_nos_tpu/ops/decode_attention.py:1006",
    }
    kernels = []
    for name, source, launched in (
        ("paged_attention", "paged_attention", serve["launches"]),
        ("qkv_rope", "qkv_rope", serve["launches"]),
        ("paged_attention_int8", "paged_attention", int8_serve["launches"]),
        ("qkv_rope_int8", "qkv_rope", int8_serve["launches"]),
    ):
        t = next(r for r in rows if r["kernel"] == name and r["steps"] == 1)
        err = max(
            c["max_abs_err"] for c in checks
            if c["kernel"] == name and c["dtype"] == "bfloat16"
        )
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{source}.cu",
            "replaces": replaces[source],
            "launches": launched[name],
            "max_abs_err": err,
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    vit_src = {
        "packed_attention": ("flash_attention.cu", "walkai_nos_tpu/ops/attention.py:559",
                             vit_serve["launches"]["packed_attention"]),
        "flash_fwd": ("flash_attention.cu", "walkai_nos_tpu/ops/attention.py:648",
                      vit_train["launches_20_steps"]["flash_fwd"]),
        "flash_dq": ("flash_attention_bwd.cu", "walkai_nos_tpu/ops/attention.py:353",
                     vit_train["launches_20_steps"]["flash_dq"]),
        "flash_dkv": ("flash_attention_bwd.cu", "walkai_nos_tpu/ops/attention.py:372",
                      vit_train["launches_20_steps"]["flash_dkv"]),
    }
    for name, (source, replaces, launches) in vit_src.items():
        t = next(r for r in vrows if r["kernel"] == name and r["case"] == "vit")
        # The kernel's own output (not lse or D', held to the f32 rule).
        err = max(
            c["max_abs_err"] for c in vchecks
            if c["kernel"] == name and c["dtype"] == "bfloat16"
            and "max_abs_err" in c and "/" not in c["case"]
        )
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    t = next(r for r in rows if r["kernel"] == "decode_attention"
             and r["case"] == "generate")
    kernels.append({
        "name": "decode_attention", "route": "cuda",
        "source": f"{src}decode_attention.cu",
        "replaces": "walkai_nos_tpu/ops/decode_attention.py:313",
        "launches": generate["launches"]["decode_attention"],
        "max_abs_err": max(
            c["max_abs_err"] for c in checks
            if c["kernel"] == "decode_attention" and c["dtype"] == "bfloat16"
        ),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    })
    # K4, K5 and K6 on the LM training path: checked on its inputs (K/V
    # repeated from 4 kv heads), timed at its shape, launched by its 10
    # timed steps.
    for name, (source, replaces) in {
        "flash_fwd": ("flash_attention.cu", "walkai_nos_tpu/ops/attention.py:648"),
        "flash_dq": ("flash_attention_bwd.cu", "walkai_nos_tpu/ops/attention.py:353"),
        "flash_dkv": ("flash_attention_bwd.cu", "walkai_nos_tpu/ops/attention.py:372"),
    }.items():
        t = next(r for r in vrows if r["kernel"] == name and r["case"] == "lm_causal")
        err = next(c["max_abs_err"] for c in vchecks
                   if c["kernel"] == name and c["case"] == "lm_training")
        kernels.append({
            "name": name + "_lm_training", "route": "cuda", "source": f"{src}{source}",
            "replaces": replaces, "launches": lm_train["launches_10_steps"][name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    # The HF-import and MoE legs run K1 and K2 (and the MoE model's dense
    # paths K7) on paths of their own: each kernel checked and timed on
    # the inputs of one of its calls on that path.
    moe_low = moe["capacity_1.25"]
    decode_sites = {
        "paged_attention": ("paged_attention.cu", "walkai_nos_tpu/ops/decode_attention.py:586"),
        "qkv_rope": ("qkv_rope.cu", "walkai_nos_tpu/ops/decode_attention.py:1006"),
        "decode_attention": ("decode_attention.cu", "walkai_nos_tpu/ops/decode_attention.py:313"),
    }
    paths = [
        (f"{name}_{path}", name, launched[name], measured[name])
        for path, launched, measured in (
            ("hf_llama", hf_llama["launches"], hf_llama["kernels"]),
            ("gpt2_small", hf_gpt2["paged"]["launches"], hf_gpt2["kernels"]),
            ("moe", moe_low["paged"]["launches"], moe_low["kernels"]),
        )
        for name in ("paged_attention", "qkv_rope")
    ] + [
        (f"decode_attention_moe_{path}", "decode_attention",
         moe_low[path]["launches"]["decode_attention"],
         moe_low["kernels"][f"decode_attention_{path}"])
        for path in ("dense", "generate", "speculative")
    ]
    for entry, name, launches, t in paths:
        source, replaces = decode_sites[name]
        kernels.append({
            "name": entry, "route": "cuda", "source": f"{src}{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    # The device-resident loop runs K2 + K1 at the serving path's steps 1
    # (times of the kernel phase), launched by its graphs' replays; the
    # speculative legs at steps k+1 on a verify's own inputs, their
    # launches the wrappers' count at steps k+1 in the first leg (bf16
    # and int8).
    # The telemetry leg (4f) runs the serving path's K2 + K1 at steps 1 too
    # (times of the kernel phase), launched by its off, on, off runs.
    for leg, launched in (("loop", loop_serve["launches"]), ("obs", obs["launches"])):
        for name in ("paged_attention", "qkv_rope"):
            source, replaces = decode_sites[name]
            t = next(r for r in rows if r["kernel"] == name and r["steps"] == 1)
            kernels.append({
                "name": f"{name}_{leg}", "route": "cuda", "source": f"{src}{source}",
                "replaces": replaces, "launches": launched[name],
                "max_abs_err": next(k["max_abs_err"] for k in kernels
                                    if k["name"] == name),
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            })
    for arm, spec in (("", spec_serve), ("_int8", int8_serve["spec_serving"])):
        first = next(leg for leg in spec.values()
                     if isinstance(leg, dict) and "verify_launches" in leg)
        for name in ("paged_attention", "qkv_rope"):
            source, replaces = decode_sites[name]
            t = spec["kernels"][name + arm]
            kernels.append({
                "name": f"{name}{arm}_spec_verify", "route": "cuda",
                "source": f"{src}{source}", "replaces": replaces,
                "launches": first["verify_launches"][name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            })
    # The sp, transfer, capture, fleet and server legs run K2 + K1 at steps
    # 1: launches counted by the sp-on run, by the transfer leg's greedy
    # migration (source and target), by the captured run, by the fleet's
    # replicas and by the demo server's /generate traffic, each kernel
    # checked and timed on one of the leg's own calls (the server's: its
    # in-process reference engine's, at LM_SMALL's shape).
    for leg, launched, measured in (
            ("sp", sp_serve["sp_on"]["launches"], sp_serve["kernels"]),
            ("xfer", xfer["b_greedy"]["launches"], xfer["kernels"]),
            ("capture", capture["captured"]["launches"], capture["kernels"]),
            ("fleet", fleet["launches"], fleet["kernels"]),
            ("server", server["launches"], server["kernels"])):
        for name in ("paged_attention", "qkv_rope"):
            source, replaces = decode_sites[name]
            t = measured[name]
            kernels.append({
                "name": f"{name}_{leg}", "route": "cuda", "source": f"{src}{source}",
                "replaces": replaces, "launches": launched[name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            })
    # The demo server's /infer runs K3 at YOLOS-small's shape (times of the
    # ViT kernel phase), launched by the leg's /infer traffic.
    t = next(r for r in vrows if r["kernel"] == "packed_attention" and r["case"] == "vit")
    kernels.append({
        "name": "packed_attention_server", "route": "cuda",
        "source": f"{src}flash_attention.cu",
        "replaces": "walkai_nos_tpu/ops/attention.py:559",
        "launches": server["launches"]["packed_attention"],
        "max_abs_err": next(k["max_abs_err"] for k in kernels
                            if k["name"] == "packed_attention"),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    })
    # The LoRA leg runs K1 without injection, at steps 1 (armed decode) and
    # k+1 (armed verify), each checked and timed on one of its calls.
    for name, t in lora["kernels"].items():
        source, replaces = decode_sites["paged_attention"]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{source}",
            "replaces": replaces, "launches": t["launches"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({
            "card": smi, "ptxas": ptxas, "tensor_core_instructions": tensor_cores,
            "checks": [launch_check] + checks + gchecks + vchecks,
            "decode_launches": decode_launches,
            "timing": rows + grows + vrows,
            "hf_llama": hf_llama, "hf_gpt2": hf_gpt2, "moe_serving": moe,
            "serving": serve, "obs": obs, "loop_serving": loop_serve,
            "spec_serving": spec_serve,
            "sp_serving": sp_serve, "transfer": xfer, "capture_replay": capture,
            "fleet": fleet, "server": server,
            "generate": generate, "speculative": speculative,
            "dense_serving": dense_serve, "exactness_f32": exact,
            "spec_exactness_f32": spec_exact,
            "unfused": unfused, "lora_serving": lora, "int8_serving": int8_serve,
            "sim_exactness": sim_exact, "vit_serving": vit_serve,
            "vit_training": vit_train, "lm_training": lm_train, "kernels": kernels,
            "phase_end_s": phase_end_s,
        }, f, indent=1)
    print(json.dumps({"phase_end_s": phase_end_s}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
