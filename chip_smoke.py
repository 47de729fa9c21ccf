"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository on a machine with one CUDA GPU and
the CUDA toolkit (`nvcc`). It:

1. builds the port's kernels from `walkai_nos_tpu_torch/csrc/` (nvcc,
   sm_90a) and prints the build seconds and the ptxas resource report;
2. holds each kernel (K1 paged attention, K2 QKV projection + RoPE) and
   the fused composition against its plain PyTorch version at the
   serving shapes of TinyLlama-1.1B (bf16, 32 heads, 4 kv heads,
   head_dim 64, 8 slots, steps 1 and 8, shuffled tables, ragged indices
   including a block edge and one past the table's capacity), and times
   kernel, plain version and a PyTorch library yardstick with CUDA
   events;
3. serves 8 greedy requests (prompts of 40-600 tokens, two sharing a
   256-token prefix, 32 new tokens each) through the port's
   `ContinuousBatcher` at TinyLlama-1.1B width (22 layers, random bf16
   weights from --seed), checks every request, the kernels' launch
   counts, a prefix-cache hit, and that one request re-served alone on
   a fresh engine gives the same tokens;
4. serves 2 requests through the unfused route (`fused_qkv=False`, 4
   layers), which runs K1 without fresh-row injection and no K2;
5. prints the card's name and power limit, one JSON line with every
   kernel's numbers, and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed phase raises and the script exits non-zero; without a GPU it
exits non-zero before printing any result. Long outputs also go to
`chiprun_out/chip_smoke.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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

    def err(got, want, dtype):
        """(max |got - want|, worst per-slot error over its tolerance)."""
        rel, floor = TOL[dtype]
        worst, ratio = 0.0, 0.0
        for g, w in zip(got, want):
            d = (g.float() - w.float()).abs().flatten(1).amax(1)
            tol = rel * w.float().abs().flatten(1).amax(1) + floor
            worst = max(worst, float(d.max()))
            ratio = max(ratio, float((d / tol).max()))
        return worst, ratio

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


def serving_phase(ContinuousBatcher, LMConfig, DecoderLM, da, seed: int) -> dict:
    cfg = LMConfig(
        vocab_size=32000, hidden_dim=2048, num_layers=22, num_heads=32,
        num_kv_heads=4, mlp_dim=5632, max_seq_len=2048, dtype="bfloat16",
        norm="rmsnorm", mlp="swiglu", rope=True, rope_theta=10000.0,
        use_bias=False, head_bias=False, layer_norm_eps=1e-5,
    )
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
    for name, n in launches.items():
        if n <= 0:
            _fail(f"kernel {name} was not launched on the serving path")
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
    }


def profile_window(engine, prompts, new: int) -> dict:
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
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us > 0 and ev.key and not ev.key.startswith(("aten::", "cuda")):
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile.txt"), "w") as f:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from walkai_nos_tpu_torch.models.lm import DecoderLM, LMConfig
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
    from walkai_nos_tpu_torch.ops import _build
    from walkai_nos_tpu_torch.ops import decode_attention as da

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.monotonic()
    _build.load_kernels()
    print(json.dumps({"build_s": time.monotonic() - t0}), flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    checks, rows = kernel_phase(da, args.seed)
    for c in checks:
        print(json.dumps({"check": c}), flush=True)
    for r in rows:
        print(json.dumps({"timing": r}), flush=True)

    serve = serving_phase(ContinuousBatcher, LMConfig, DecoderLM, da, args.seed)
    model, cfg = serve.pop("_model"), serve.pop("_cfg")
    print(json.dumps({"serving": serve}), flush=True)
    del model
    torch.cuda.empty_cache()
    unfused = unfused_phase(ContinuousBatcher, DecoderLM, da, cfg, args.seed)
    print(json.dumps({"unfused": unfused}), flush=True)

    src = "walkai_nos_tpu_torch/csrc/"
    replaces = {
        "paged_attention": "walkai_nos_tpu/ops/decode_attention.py:586",
        "qkv_rope": "walkai_nos_tpu/ops/decode_attention.py:1006",
    }
    kernels = []
    for name in ("paged_attention", "qkv_rope"):
        t = next(r for r in rows if r["kernel"] == name and r["steps"] == 1)
        err = max(
            c["max_abs_err"] for c in checks
            if c["kernel"] == name and c["dtype"] == "bfloat16"
        )
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": replaces[name],
            "launches": serve["launches"][name],
            "max_abs_err": err,
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({
            "card": smi, "checks": checks, "timing": rows, "serving": serve,
            "unfused": unfused, "kernels": kernels,
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
