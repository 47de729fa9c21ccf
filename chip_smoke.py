"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository on a machine with one CUDA GPU and
the CUDA toolkit (`nvcc`). It:

1. builds the port's kernels from `walkai_nos_tpu_torch/csrc/` (nvcc,
   sm_90a) and prints the build seconds, the ptxas resource report per
   kernel and, from `cuobjdump -sass`, the tensor-core instructions
   (HGMMA, HMMA) of each backward kernel; then counts, under
   `torch.profiler` and before any other profiler session, the device
   kernels of three attention backward calls at the ViT's shape: K5 and
   K6, once each a call, and nothing else;
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
   verify's (5 steps, batch 1) and an MHA shape, and times kernel, plain
   version and SDPA over the masked cache;
4. serves 8 greedy requests (prompts of 40-600 tokens, two sharing a
   256-token prefix, 32 new tokens each) through the port's
   `ContinuousBatcher` at TinyLlama-1.1B width (22 layers, random bf16
   weights from --seed), checks every request, the kernels' launch
   counts, a prefix-cache hit, and that one request re-served alone on
   a fresh engine gives the same tokens;
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
   token, the share of tokens equal to the bf16 engine's;
6c. in bf16 at 4 layers, "int8-sim" KV and weights give the unquantized
   engine's tokens on the fused route and on the unfused one;
7. holds K3 (packed ViT attention), K4 (flash forward + lse), K5 (dq and
   the row term D') and K6 (dk/dv) against their plain versions at the
   ViT's shapes (batch 32, 296 tokens, 6 heads of 64) in bf16 and f32,
   plus a causal sq != sk shape and a kv_len < sk shape; checks that two
   backward runs give bitwise-identical gradients; times kernel, plain
   version and SDPA,
   and for the backward also the K5 + K6 pair against SDPA's backward and
   the eager D' pass K5 absorbed, at the ViT's shape and at LM-training
   width (causal, batch 2, 2048 tokens, 32 heads of 64);
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
   K3-K6, then step time, images/s and a profiled window;
10. prints the card's name and power limit, one JSON line with every
    kernel's numbers, and as the last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed phase raises and the script exits non-zero; without a GPU it
exits non-zero before printing any result. Long outputs also go to
`chiprun_out/chip_smoke.json`.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

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
# (the plain attention rounds probabilities to bf16; the kernel keeps
# them f32): a few bf16 ulps (2**-8 relative). f32: summation order only.
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
    spills."""
    lines, name = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1])
        elif "registers" in line or "smem" in line or "spill" in line:
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


def serving_phase(ContinuousBatcher, LMConfig, DecoderLM, da, seed: int) -> dict:
    cfg = LMConfig(
        vocab_size=32000, hidden_dim=2048, num_layers=22, num_heads=32,
        num_kv_heads=4, mlp_dim=5632, max_seq_len=2048, dtype="bfloat16",
        norm="rmsnorm", mlp="swiglu", rope=True, rope_theta=10000.0,
        use_bias=False, head_bias=False, layer_norm_eps=1e-5,
    )
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = DecoderLM(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    engine_kw = dict(slots=8, cache_len=2048, prefill_chunk=64, prefill_lanes=4)
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, 256)
    prompts = [
        np.concatenate([shared, rng.integers(0, cfg.vocab_size, 44)]),
        rng.integers(0, cfg.vocab_size, 40),
        rng.integers(0, cfg.vocab_size, 60),
        rng.integers(0, cfg.vocab_size, 128),
        rng.integers(0, cfg.vocab_size, 600),
        rng.integers(0, cfg.vocab_size, 450),
        rng.integers(0, cfg.vocab_size, 200),
        np.concatenate([shared, rng.integers(0, cfg.vocab_size, 80)]),
    ]
    new = 32
    engine = ContinuousBatcher(cfg, model, **engine_kw)
    engine.warm()
    torch.cuda.synchronize()
    da.reset_launch_counts()
    d0 = engine.obs.dispatches.value()
    t0 = time.monotonic()
    rids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    records = {}
    while engine.has_work:
        engine.step()
        records.update(engine.drain_done_records())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(da.LAUNCHES)
    dispatches = int(engine.obs.dispatches.value() - d0)
    for r in rids:
        if len(records[r]["tokens"]) != new:
            _fail(f"request {r} returned {len(records[r]['tokens'])} tokens")
    for name in ("paged_attention", "qkv_rope"):
        if launches[name] <= 0:
            _fail(f"kernel {name} was not launched on the serving path")
    if launches["decode_attention"]:
        _fail(f"the paged engine launched the dense kernel: {launches}")
    prefix = engine.prefix_stats()
    if prefix["block_hits"] < 1:
        _fail(f"no prefix-cache hit: {prefix}")
    # The prefix-hit request alone, cold, on a fresh engine.
    alone = ContinuousBatcher(cfg, model, **engine_kw)
    rid = alone.submit(prompts[-1], max_new_tokens=new)
    alone_tokens = alone.run()[rid]
    if alone_tokens != records[rids[-1]]["tokens"]:
        _fail("the request alone gave other tokens than in the batch")
    profile = profile_window(alone, prompts[:4], new)
    ttft = sorted(records[r]["ttft_s"] for r in rids)
    toks = new * len(rids)
    return {
        "model": "TinyLlama-1.1B widths, 22 layers, random bf16 weights",
        "weights_init_s": init_s,
        "requests": len(rids), "new_tokens_each": new,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "wall_s": wall,
        "decode_tokens_per_s": toks / wall,
        "ttft_p50_s": ttft[len(ttft) // 2],
        "dispatches": dispatches,
        "step_ms": wall / max(1, dispatches * engine.chunk_steps) * 1e3,
        "launches": launches,
        "launches_per_decode_step": {
            k: v / max(1, dispatches * engine.chunk_steps) for k, v in launches.items()
        },
        "prefix": {
            k: prefix[k]
            for k in ("block_hits", "hit_rate", "prefill_tokens_saved")
        },
        "alone_equals_batched": True,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile,
        "_model": model,
        "_cfg": cfg,
        "_prompts": prompts,
        "_tokens": [records[r]["tokens"] for r in rids],
    }


def int8_serving_phase(ContinuousBatcher, DecoderLM, da, cfg, prompts,
                       bf16_tokens, seed: int) -> dict:
    """The paged engine with int8 KV and int8 weights at TinyLlama-1.1B
    width: the weights are the bf16 serving model's draws (same seed),
    quantized per output channel; 8 slots, cache_len 2048, the serving
    phase's 8 requests x 32 new tokens. Checks every request, launches of
    both int8 arms and of neither full-precision arm, and 11,968 KV bytes
    per token; reports the share of tokens equal to the bf16 engine's."""
    import dataclasses

    cfg8 = dataclasses.replace(cfg, kv_dtype="int8", w_dtype="int8")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = DecoderLM(cfg8, device="cuda", seed=seed)
    new = 32
    engine = ContinuousBatcher(cfg8, model, slots=8, cache_len=2048,
                               prefill_chunk=64, prefill_lanes=4)
    engine.warm()
    torch.cuda.synchronize()
    da.reset_launch_counts()
    d0 = engine.obs.dispatches.value()
    t0 = time.monotonic()
    rids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    records = {}
    while engine.has_work:
        engine.step()
        records.update(engine.drain_done_records())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(da.LAUNCHES)
    dispatches = int(engine.obs.dispatches.value() - d0)
    tokens = [records[r]["tokens"] for r in rids]
    if any(len(t) != new for t in tokens):
        _fail("int8 serving: a request came back short")
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
    decode_steps = max(1, dispatches * engine.chunk_steps)
    profile = profile_window(engine, prompts[:4], new, "int8_profile.txt")
    agree = sum(a == b for t, u in zip(tokens, bf16_tokens) for a, b in zip(t, u))
    ttft = sorted(records[r]["ttft_s"] for r in rids)
    out = {
        "model": "TinyLlama-1.1B widths, 22 layers, the bf16 phase's random "
                 "weights quantized to int8, int8 KV",
        "requests": len(rids), "new_tokens_each": new, "wall_s": wall,
        "decode_tokens_per_s": new * len(rids) / wall,
        "ttft_p50_s": ttft[len(ttft) // 2], "dispatches": dispatches,
        "step_ms": wall / decode_steps * 1e3,
        "launches": launches,
        "launches_per_decode_step": {
            k: v / decode_steps for k, v in launches.items()
        },
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "quant": stats,
        "kv_backing_bytes": engine.kv_stats()["kv_backing_bytes"],
        "tokens_equal_to_bf16_share": agree / (new * len(rids)),
        "profile": profile,
    }
    del model, engine
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


def dense_kernel_phase(da, seed: int) -> tuple[list, list]:
    """K7 (dense-cache decode attention) against its plain version in
    bf16 and f32 at the dense decode path's shapes: the generate step
    (TinyLlama, 8 rows over a 1024-row bucket, shared index 1000), the
    dense engine's step (2048-row cache, per-row indices at the edges and
    past the cache), the speculative verify (5 steps, batch 1) and an MHA
    model (32 heads over 32 kv heads). Times kernel, plain version and
    SDPA over the same masked cache (GQA enabled) in bf16, each against
    the byte bound of this case's visible rows. Returns (checks, rows)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    bf = torch.bfloat16
    ragged = [0, 127, 128, 1000, 1500, 2047, 2048, 2100]  # S = 2048
    # (case, b, h, kvh, S, steps, index)
    cases = (
        ("generate", 8, 32, 4, 1024, 1, 1000),
        ("ragged_2048", 8, 32, 4, 2048, 1, ragged),
        ("verify", 1, 32, 4, 1024, 5, 900),
        ("mha", 8, 32, 32, 1024, 1, 1000),
    )
    checks, rows = [], []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for case, b, h, kvh, S, steps, index in cases:
        hd = 64
        idx = torch.tensor(index, device=dev, dtype=torch.int32)
        q = torch.randn(b, h, steps, hd, generator=gen, device=dev).to(bf)
        kvs = [
            tuple(torch.randn(b, kvh, S, hd, generator=gen, device=dev).to(bf)
                  for _ in range(2))
            for _ in range(ROTATE)
        ]
        for dtype in (bf, torch.float32):
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
            da.decode_attention(q, *kvs[i % ROTATE], idx)

        def plain(i):
            da.decode_attention_reference(q, *kvs[i % ROTATE], idx)

        def lib(i):
            sdpa(q, *kvs[i % ROTATE], attn_mask=mask, enable_gqa=kvh != h)

        bound_ms, bound_by = _bound(nbytes, flops)
        rows.append({
            "kernel": "decode_attention", "case": case,
            "shape": f"b{b} h{h} kvh{kvh} d{hd} S{S} steps{steps} bf16",
            "ms": _timed(kern, 20), "plain_ms": _timed(plain, 5),
            "library_ms": _timed(lib, 20), "host_call_ms": _host_timed(kern, 50),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops,
        })
    torch.cuda.empty_cache()
    return checks, rows


def generate_phase(make_generate_fn, da, model, cfg, seed: int) -> dict:
    """One-shot generation (`make_generate_fn`, dense cache) at TinyLlama
    width, bf16: 8 prompts of one length drawn from 769-896 tokens (the
    cache bucket is then 1024 rows, K7's timed shape), 128 new tokens in
    chunks of 16 steps. Checks 22 K7 launches per decode step, no paged
    kernel, finite well-formed tokens and two identical runs; then a
    profiled run."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed + 3)
    length = int(rng.integers(769, 897))
    prompts = rng.integers(0, cfg.vocab_size, (8, length))
    new, chunk = 128, 16
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        again = gen(model, prompts, new)
        torch.cuda.synchronize()
        pwall = time.monotonic() - t0
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
        "profile": _profile_summary(prof, pwall, "generate_profile.txt"),
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


def profile_window(engine, prompts, new: int, table_name: str = "profile.txt") -> dict:
    """Serve a few requests under torch.profiler: device-busy share of
    the window and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    rids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = engine.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    if any(len(out[r]) != new for r in rids):
        _fail("profiled window: a request came back short")
    return _profile_summary(prof, wall, table_name)


def _device_rows(prof) -> list:
    """(device us, calls, name) of each device-side event kind (kernels,
    copies, sets) of a profile, largest first. Host ops, autograd nodes
    and annotated ranges (an optimizer step) carry the device time of the
    kernels inside them too, and are left out."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us > 0 and ev.key:
            rows.append((dev_us, ev.count, ev.key))
    return sorted(rows, reverse=True)


def _profile_summary(prof, wall: float, table_name: str) -> dict:
    """Device-busy share of a profiled window (device kernel time over
    wall time) and the kernels that took the most device time; the full
    table goes to chiprun_out/<table_name>."""
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", table_name), "w") as f:
        f.write(prof.key_averages().table(sort_by="device_time_total", row_limit=40))
    return {
        "wall_s": wall, "device_kernel_s": busy,
        "device_busy_share": busy / wall if wall else None,
        "top": [
            {"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
            for us, n, k in rows[:12]
        ],
    }


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


# The ViT detector at YOLOS-small width: batch 32, 196 patches + 100
# detection tokens, 6 heads of 64.
VIT_B, VIT_S, VIT_H, VIT_D = 32, 296, 6, 64
# The backward's second timing shape, at LM-training width: causal,
# (batch, seq, heads, head_dim), K/V repeated to all heads.
LM_TRAIN_SHAPE = (2, 2048, 32, 64)
# Gradients of the training phase's check: per parameter tensor, max
# |kernel path - plain path| <= GRAD_REL * max |plain path|. The two paths
# run the same bf16 model and differ only inside attention (the forward
# kernels keep probabilities in f32 where the plain version rounds them to
# bf16; the backward kernels round P and dS to bf16 for the tensor cores
# where the plain version keeps them in f32), and that difference passes
# through 12 layers of bf16 backward.
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
    ViT's shape under the profiler, run before any other profiler session
    of the script (after the serving phases' sessions it has been seen to
    record no kernel at all). Every kernel it sees must be K5 or K6, and
    neither may run more than once a call; if it sees none, the count is
    "not measured" and the card test `test_backward_is_two_launches`
    holds the rule."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    q, k, v, g = (torch.randn(VIT_B, VIT_H, VIT_S, VIT_D, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    out, lse = fa._flash_fwd_cuda(q, k, v, False, VIT_S)
    fa._flash_bwd_cuda(q, k, v, out, lse, g, None, False, VIT_S)
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fa._flash_bwd_cuda(q, k, v, out, lse, g, None, False, VIT_S)
        torch.cuda.synchronize()
    kernels = {n: c for _, c, n in _device_rows(prof)}
    if kernels and (
            not all("flash_dq" in n or "flash_dkv" in n for n in kernels)
            or max(kernels.values()) > calls):
        _fail(f"{calls} backward calls ran {kernels}, not K5 and K6 once each")
    return {"kernel": "flash_dq+flash_dkv", "case": "vit", "dtype": "bfloat16",
            "device_kernels_per_call": {
                _demangled_name(n): c / calls for n, c in kernels.items()}
            or "not measured"}


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

    # (case, batch, sq, sk, causal, kv_len)
    cases = (
        ("vit", b, s, s, False, s),
        ("causal_sq_lt_sk", 4, 200, s, True, s),
        ("kv_len_lt_sk", 4, s, s, False, 250),
    )
    for dtype in (bf, torch.float32):
        qkv = rnd(b, s, 3 * h * d, dtype=dtype)
        check("packed_attention", "vit", dtype,
              [fa._packed_cuda(qkv, h)], [fa.packed_reference(qkv, h)])
        for case, bb, sq, sk, causal, kv_len in cases:
            q, k, v = rnd(bb, h, sq, d, dtype=dtype), rnd(bb, h, sk, d, dtype=dtype), rnd(bb, h, sk, d, dtype=dtype)
            g = rnd(bb, h, sq, d, dtype=dtype)
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


def vit_serving_phase(vit_mod, vs, fa, seed: int) -> dict:
    """VIT_SMALL with bf16 weights cast once, served through the
    micro-batcher (max_batch 32, window 2 ms, max_inflight 8) to 8
    closed-loop client threads, 64 requests of 1-8 images."""
    from torch.profiler import ProfilerActivity, profile

    cfg = vit_mod.VIT_SMALL
    model = vit_mod.ViTDetector(cfg, device="cuda", seed=seed)
    server = vs.ViTServer(cfg, model, max_batch=32, window_ms=2.0,
                          max_inflight=8, seed=seed)
    del model
    for bucket in (1, 2, 4, 8, 16, 32):  # first calls allocate: warm them
        server.infer(server.model, server.images_of(bucket))
    torch.cuda.synchronize()
    sizes = [int(n) for n in np.random.default_rng(seed).integers(1, 9, 64)]
    clients = 8

    def run(chunks):
        reqs, lock = [], threading.Lock()

        def client(chunk):
            for n in chunk:
                r = server.submit(n)
                with lock:
                    reqs.append(r)
                if not r.done.wait(timeout=120):
                    return

        threads = [threading.Thread(target=client, args=(c,)) for c in chunks]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.monotonic() - t0
        if any(t.is_alive() for t in threads) or not all(r.done.is_set() for r in reqs):
            _fail("ViT serving: a request was not answered")
        return reqs, wall

    chunks = [sizes[i::clients] for i in range(clients)]
    server.start()
    try:
        before = server.stats.snapshot()
        fa.reset_launch_counts()
        reqs, wall = run(chunks)
        launches = dict(fa.LAUNCHES)
        snap = server.stats.snapshot()
        # The same request mix again, under the profiler.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, pwall = run(chunks)
            torch.cuda.synchronize()
    finally:
        server.close()
    if snap["requests"] != len(sizes) or snap["images"] != sum(sizes):
        _fail(f"ViT serving counted {snap}")
    if launches["packed_attention"] != cfg.num_layers * snap["batches"]:
        _fail(f"ViT serving: {launches} for {snap['batches']} batches")
    if any(launches[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")):
        _fail(f"ViT serving launched backward kernels: {launches}")
    profile_summary = _profile_summary(prof, pwall, "vit_serving_profile.txt")

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
        "profile": profile_summary,
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
    rng = np.random.default_rng(seed + 2)
    labels = rng.integers(0, cfg.num_classes, (b, cfg.num_det_tokens)).astype(np.int32)
    labels[:, ::2] = cfg.num_classes - 1  # half the slots: no object
    batch = {
        "images": rng.standard_normal((b, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
        "labels": labels,
        "boxes": rng.random((b, cfg.num_det_tokens, 4)).astype(np.float32),
    }
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        trainer_mod.fit(
            state, step_fn, data_mod.prefetch_to_device(itertools.repeat(batch, 3)),
            num_steps=3, log_every=0,
        )
        torch.cuda.synchronize()
        pwall = time.monotonic() - t0
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
        "profile_3_steps": _profile_summary(prof, pwall, "vit_training_profile.txt"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from walkai_nos_tpu_torch.models import lm as lm_mod
    from walkai_nos_tpu_torch.models.lm import DecoderLM, LMConfig
    from walkai_nos_tpu_torch.models import data as data_mod
    from walkai_nos_tpu_torch.models import speculative as spec_mod
    from walkai_nos_tpu_torch.models.decode import make_generate_fn
    from walkai_nos_tpu_torch.models import train as train_mod
    from walkai_nos_tpu_torch.models import trainer as trainer_mod
    from walkai_nos_tpu_torch.models import vit as vit_mod
    from walkai_nos_tpu_torch.models import vit_serving
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
    from walkai_nos_tpu_torch.ops import _build
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
    for name, log in _build.build_logs.items():
        for line in _ptxas_report(log):
            print(f"ptxas {name}: {line}", flush=True)
    print(json.dumps({"tensor_core_instructions": _tensor_core_counts(
        libs["flash_attention_bwd"]._name)}), flush=True)

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

    serve = serving_phase(ContinuousBatcher, LMConfig, DecoderLM, da, args.seed)
    model, cfg = serve.pop("_model"), serve.pop("_cfg")
    serve_prompts = serve.pop("_prompts")
    serve_tokens = serve.pop("_tokens")
    print(json.dumps({"serving": serve}), flush=True)
    generate = generate_phase(make_generate_fn, da, model, cfg, args.seed)
    gen_prompts = generate.pop("_prompts")
    print(json.dumps({"generate": generate}), flush=True)
    speculative = speculative_phase(spec_mod, lm_mod, da, model, cfg,
                                    gen_prompts[0], args.seed)
    print(json.dumps({"speculative": speculative}), flush=True)
    dense_serve = dense_serving_phase(ContinuousBatcher, da, model, cfg,
                                      serve_prompts)
    print(json.dumps({"dense_serving": dense_serve}), flush=True)
    del model
    torch.cuda.empty_cache()
    exact = exactness_phase(ContinuousBatcher, make_generate_fn, spec_mod, lm_mod,
                            da, cfg, serve_prompts, args.seed)
    print(json.dumps({"exactness_f32": exact}), flush=True)
    unfused = unfused_phase(ContinuousBatcher, DecoderLM, da, cfg, args.seed)
    print(json.dumps({"unfused": unfused}), flush=True)
    int8_serve = int8_serving_phase(ContinuousBatcher, DecoderLM, da, cfg,
                                    serve_prompts, serve_tokens, args.seed)
    int8_serve["quant_dense"] = quant_dense
    print(json.dumps({"int8_serving": int8_serve}), flush=True)
    sim_exact = sim_exactness_phase(ContinuousBatcher, DecoderLM, da, cfg,
                                    serve_prompts, args.seed)
    print(json.dumps({"sim_exactness": sim_exact}), flush=True)
    torch.cuda.empty_cache()

    vchecks, vrows = attention_kernel_phase(fa, args.seed)
    for c in vchecks:
        print(json.dumps({"check": c}), flush=True)
    for r in vrows:
        print(json.dumps({"timing": r}), flush=True)
    vit_serve = vit_serving_phase(vit_mod, vit_serving, fa, args.seed)
    print(json.dumps({"vit_serving": vit_serve}), flush=True)
    torch.cuda.empty_cache()
    vit_train = vit_training_phase(vit_mod, train_mod, trainer_mod, data_mod, fa, args.seed)
    print(json.dumps({"vit_training": vit_train}), flush=True)

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
        err = max(
            c["max_abs_err"] for c in vchecks
            if c["kernel"] == name and c["dtype"] == "bfloat16" and "max_abs_err" in c
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
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({
            "card": smi, "checks": [launch_check] + checks + vchecks,
            "timing": rows + vrows,
            "serving": serve, "generate": generate, "speculative": speculative,
            "dense_serving": dense_serve, "exactness_f32": exact,
            "unfused": unfused, "int8_serving": int8_serve,
            "sim_exactness": sim_exact, "vit_serving": vit_serve,
            "vit_training": vit_train, "kernels": kernels,
        }, f, indent=1)
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
